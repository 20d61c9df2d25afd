"""The port's readers of the float and scientific rasters Pillow 12.1 opens
(io/netpbm's PFM and Pillow's netpbm extensions, io/fits, io/mcidas,
io/spider, io/im) against the JAX package's RasterReader, which opens the
same files through Pillow, on the CPU: every band equal bit for bit (float
bands compared as their bits, so NaNs count), the dtype, size, metadata,
gdal_metadata() and georeferencing equal, or both readers refuse the file.

Inputs are made from seeds with numpy and written by Pillow where it writes
the format (PFM, IM, SPIDER); FITS (with GZIP_1 tiles), McIdas AREA,
P0CMYK / PyP / PyRGBA / PyCMYK, big-endian SPIDER and the IM types Pillow
does not write are written here field by field. Pillow's quirks are kept:
FITS samples read little-endian and rows bottom-up, BITPIX -64 read as
4-byte floats, IM's bit decoder carrying bits into the next line."""
import dataclasses
import gzip
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import pilraster  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import RESAMPLE_TOL, _both_refuse  # noqa: E402
from test_torch_exact import native_both  # noqa: E402,F401
from test_torch_readers import WKT_32632, _same  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _bits(a: np.ndarray) -> np.ndarray:
    return a if a.dtype == bool else a.view(f"u{a.dtype.itemsize}")


def same_as_jax(path):
    """Both readers open `path` alike: every metadata and georeferencing
    field, gdal_metadata(), and the decoded array and each band equal in
    dtype, shape and bits. Returns the port's array."""
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        for got, want in ((t.metadata, j.metadata), (t.geo, j.geo)):
            for f in dataclasses.fields(want):
                assert _same(getattr(got, f.name), getattr(want, f.name)), \
                    f.name
        got, want = t._tiff._data, j._tiff._data
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
        for b in range(1, j.metadata.bands + 1):
            tb, jb = t.read_band(b), j.read_band(b)
            assert tb.dtype == jb.dtype == np.float32
            assert np.array_equal(_bits(tb), _bits(jb)), b
        assert t._tiff.gdal_metadata() == j._tiff.gdal_metadata()
        return got
    finally:
        t.close()
        j.close()


def agree(path, opens=None):
    """The port opens `path` as the JAX reader does, or both refuse it;
    `opens` (where given) says which the JAX reader does."""
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        assert opens in (None, False), "the JAX reader refuses it"
        _both_refuse(path)
        return None
    assert opens in (None, True), "the JAX reader opens it"
    return same_as_jax(path)


def write(tmp_path, blob: bytes, name: str = "x.img") -> Path:
    path = tmp_path / name
    path.write_bytes(blob)
    return path


def pil_bytes(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def flips(blob: bytes, rng, n: int, lo: int = 0, hi: int = None) -> list:
    """`n` copies of `blob`, each with one bit flipped in [lo, hi)."""
    hi = len(blob) if hi is None else min(hi, len(blob))
    out = []
    for _ in range(n):
        b = bytearray(blob)
        b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


SIZES = ((1, 1), (5, 7), (13, 4))


def _floats(rng, shape, nans=False):
    a = rng.lognormal(0.0, 1.0, shape).astype(np.float32)
    if nans and a.size > 2:
        a.reshape(-1)[[0, -1]] = [np.nan, -np.inf]
    return a


# ---------------------------------------------------------------------------
# PFM and Pillow's netpbm extensions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("order", ["little", "big"])
def test_pfm_equals_jax(tmp_path, rng, order, size):
    a = _floats(rng, size, nans=True)
    if order == "little":
        blob = chip_smoke.pfm_write(a)
    else:
        blob = (f"Pf\n{size[1]} {size[0]}\n2.5\n".encode()
                + np.ascontiguousarray(a[::-1], ">f4").tobytes())
    got = agree(write(tmp_path, blob, "a.pfm"), True)
    assert np.array_equal(_bits(got[..., 0]), _bits(a))


def test_pillow_pfm_equals_jax(tmp_path, rng):
    a = _floats(rng, (9, 11))
    path = write(tmp_path, pil_bytes(Image.fromarray(a), "PPM"), "p.pfm")
    assert path.read_bytes().startswith(b"Pf")
    assert np.array_equal(agree(path, True)[..., 0], a)


EXTENSIONS = [(magic, maxval) for magic in ("P0CMYK", "PyP", "PyRGBA",
                                            "PyCMYK")
              for maxval in (255, 100, 1000, 65535)]


@pytest.mark.parametrize("magic,maxval", EXTENSIONS)
def test_netpbm_extensions_equal_jax(tmp_path, rng, magic, maxval):
    bands = {"P0CMYK": 4, "PyP": 1, "PyRGBA": 4, "PyCMYK": 4}[magic]
    h, w = 5, 7
    v = rng.integers(0, maxval + 1, h * w * bands)
    data = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    blob = f"{magic}\n# a comment\n{w} {h}\n{maxval}\n".encode() + data
    got = agree(write(tmp_path, blob, "e.ppm"), True)
    assert got.shape == (h, w, 3 if magic == "PyP" else bands)


PFM_BROKEN = {
    "scale zero": b"Pf\n2 2\n0.0\n" + bytes(16),
    "scale inf": b"Pf\n2 2\ninf\n" + bytes(16),
    "scale nan": b"Pf\n2 2\nnan\n" + bytes(16),
    "scale text": b"Pf\n2 2\nabc\n" + bytes(16),
    "cut": b"Pf\n2 2\n-1.0\n" + bytes(15),
    "zero width": b"Pf\n0 2\n-1.0\n" + bytes(16),
    "cmyk cut": b"P0CMYK\n2 2\n255\n" + bytes(15),
    "cmyk rescaled cut": b"PyCMYK\n2 2\n100\n" + bytes(15),
    "unknown magic": b"PyQ\n2 2\n255\n" + bytes(16),
}


@pytest.mark.parametrize("name", list(PFM_BROKEN))
def test_broken_extensions_agree_with_jax(tmp_path, name):
    agree(write(tmp_path, PFM_BROKEN[name], "b.ppm"), False)


def test_pfm_scale_forms_agree(tmp_path, rng):
    a = _floats(rng, (3, 4))
    for scale in ("-1e0", "1_0", "+3", "-0.5", " -2"):
        blob = (f"Pf\n4 3\n{scale}\n".encode()
                + np.ascontiguousarray(a[::-1], "<f4" if "-" in scale
                                       else ">f4").tobytes())
        agree(write(tmp_path, blob, "s.pfm"), True)


# ---------------------------------------------------------------------------
# FITS
# ---------------------------------------------------------------------------
def _fits_data(rng, bitpix, shape):
    if bitpix == 8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    if bitpix == 16:
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    if bitpix == 32:  # read little-endian, these stay within u16
        return (rng.integers(0, 32768, shape) << 16).astype(np.int32)
    return _floats(rng, shape, nans=True).astype(
        np.float32 if bitpix == -32 else np.float64)


@pytest.mark.parametrize("size", SIZES + ((8, 1),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_fits_equals_jax(tmp_path, rng, bitpix, size):
    data = _fits_data(rng, bitpix, size)
    path = write(tmp_path, chip_smoke.fits_write(data, bitpix), "f.fits")
    got = agree(path, True)
    raw = np.ascontiguousarray(data, chip_smoke.FITS_DTYPES[bitpix])
    if bitpix == 16:  # Pillow's quirk: little-endian, bottom-up
        assert np.array_equal(got[..., 0], raw.view("<u2")[::-1])


def test_fits_bitpix_16_reads_as_pillow_does(tmp_path):
    """Pillow's quirk: a row holding 13552 20152 reads as
    61492 47182 (the bytes swapped), and the last row comes first."""
    data = np.array([[1, 2], [13552, 20152]], np.int16)
    path = write(tmp_path, chip_smoke.fits_write(data, 16), "q.fits")
    got = agree(path, True)[..., 0]
    assert got[0].tolist() == [61492, 47182]


def _gzip_fits(rng, zbitpix, shape, rows_in_table=1):
    """An empty primary HDU, then a ZIMAGE BINTABLE with ZCMPTYPE 'GZIP_1'
    whose heap is the gzip of the image as 4-byte big-endian entries."""
    h, w = shape
    data = rng.integers(0, 2 ** min(abs(zbitpix), 15), shape)
    data = (data << 16 if zbitpix == 32 else data).astype(">i4")

    def card(key, value):
        return f"{key:<8}= {value:>20}".ljust(80).encode()

    def unit(cards):
        head = b"".join(card(k, v) for k, v in cards) + b"END".ljust(80)
        return head + b" " * (-len(head) % 2880)

    primary = unit([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)])
    table = unit([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
                  ("NAXIS1", 8), ("NAXIS2", rows_in_table),
                  ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"),
                  ("ZBITPIX", zbitpix), ("ZNAXIS", 2), ("ZNAXIS1", w),
                  ("ZNAXIS2", h)])
    heap = bytes(8 * rows_in_table) + gzip.compress(data.tobytes(), mtime=0)
    return primary + table + heap + bytes(-len(heap) % 2880), data


@pytest.mark.parametrize("zbitpix", [8, 16, 32, -32])
@pytest.mark.parametrize("size", [(1, 1), (5, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fits_gzip_tiles_equal_jax(tmp_path, rng, zbitpix, size):
    blob, data = _gzip_fits(rng, zbitpix, size)
    path = write(tmp_path, blob, "z.fits")
    # a float ZBITPIX keeps no bytes of an entry: Pillow has no data
    agree(path, zbitpix > 0)


def _extension_fits(rng):
    """NAXIS 0 in the primary HDU, the image in an IMAGE extension."""
    data = rng.integers(0, 256, (3, 5)).astype(np.uint8)
    primary = chip_smoke.fits_write(np.zeros((1, 1), np.uint8), 8)
    primary = primary.replace(b"NAXIS   =                    2",
                              b"NAXIS   =                    0")
    ext = chip_smoke.fits_write(data, 8)
    ext = ext.replace(b"SIMPLE  =                    T",
                      b"XTENSION= 'IMAGE   '           ")
    return primary[:2880] + ext


FITS_CASES = {
    "image extension": (_extension_fits, True),
    "no image": (lambda rng: chip_smoke.fits_write(
        np.zeros((1, 1), np.uint8), 8).replace(
        b"NAXIS   =                    2", b"NAXIS   =                    0"),
        False),
    "naxis 1": (lambda rng: chip_smoke.fits_write(
        np.arange(6, dtype=np.uint8).reshape(1, 6), 8).replace(
        b"NAXIS   =                    2", b"NAXIS   =                    1"),
        True),
    "comment after value": (lambda rng: chip_smoke.fits_write(
        np.arange(6, dtype=np.uint8).reshape(2, 3), 8,
        (("OBJECT", "'sar / scene'"),)), True),
    "bitpix 32 past u16": (lambda rng: chip_smoke.fits_write(
        np.array([[70000, 1]], np.int32), 32), False),
    "bitpix 64": (lambda rng: chip_smoke.fits_write(
        np.zeros((2, 2), np.uint8), 8).replace(
        b"BITPIX  =                    8", b"BITPIX  =                   64"),
        False),
    "not simple": (lambda rng: chip_smoke.fits_write(
        np.zeros((2, 2), np.uint8), 8).replace(
        b"SIMPLE  =                    T", b"SIMPLE  =                    F"),
        False),
    "cut data": (lambda rng: chip_smoke.fits_write(
        np.zeros((40, 40), np.uint8), 8)[:2880 + 100], False),
    "cut header": (lambda rng: chip_smoke.fits_write(
        np.zeros((2, 2), np.uint8), 8)[:300], False),
    "short data card": (lambda rng: chip_smoke.fits_write(
        np.full((1, 1), 7, np.uint8), 8)[:2880 + 1], True),
    "naxis text": (lambda rng: chip_smoke.fits_write(
        np.zeros((2, 2), np.uint8), 8).replace(
        b"NAXIS2  =                    2", b"NAXIS2  =                  2.0"),
        False),
    "missing naxis2": (lambda rng: chip_smoke.fits_write(
        np.zeros((2, 2), np.uint8), 8).replace(b"NAXIS2", b"NAXISX"),
        False),
}


@pytest.mark.parametrize("name", list(FITS_CASES))
def test_fits_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = FITS_CASES[name]
    agree(write(tmp_path, make(rng), "c.fits"), opens)


def test_fits_bit_flips_agree_with_jax(tmp_path, rng):
    blob = chip_smoke.fits_write(_fits_data(rng, 16, (6, 5)), 16)
    for k, b in enumerate(flips(blob, rng, 40, 0, 480)):
        agree(write(tmp_path, b, f"flip{k}.fits"))
    gz, _ = _gzip_fits(rng, 16, (4, 6))
    for k, b in enumerate(flips(gz, rng, 20, 2880, 2880 + 900)):
        agree(write(tmp_path, b, f"gzflip{k}.fits"))


# ---------------------------------------------------------------------------
# McIdas AREA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prefix", [0, 3])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["u1", "u2", "i4"])
def test_mcidas_equals_jax(tmp_path, rng, dtype, size, prefix):
    data = rng.integers(0, 256 if dtype == "u1" else 65536,
                        size).astype(dtype)
    path = write(tmp_path, chip_smoke.mcidas_write(data, prefix), "a.area")
    got = agree(path, True)
    assert np.array_equal(got[..., 0], data)


def _mcidas_word(blob: bytes, k: int, value: int) -> bytes:
    return blob[:4 * (k - 1)] + struct.pack(">i", value) + blob[4 * k:]


MCIDAS_CASES = {
    "three bytes": (lambda b: _mcidas_word(b, 11, 3), False),
    "no bands": (lambda b: _mcidas_word(b, 14, 0), None),
    "two bands": (lambda b: _mcidas_word(b, 14, 2), None),
    "cut": (lambda b: b[:-1], False),
    "header only": (lambda b: b[:256], False),
    "short header": (lambda b: b[:200], False),
    "negative offset": (lambda b: _mcidas_word(b, 34, -1000), False),
    "i32 past u16": (lambda b: _mcidas_word(b, 11, 4), None),
    "stride past int": (lambda b: _mcidas_word(b, 14, -1291845631), False),
}


@pytest.mark.parametrize("name", list(MCIDAS_CASES))
def test_mcidas_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = MCIDAS_CASES[name]
    blob = chip_smoke.mcidas_write(rng.integers(0, 65536, (6, 5)).astype(
        np.uint16))
    agree(write(tmp_path, make(blob), "m.area"), opens)


@pytest.mark.parametrize("cut", [0, 5, 20])
@pytest.mark.parametrize("bands", [0, 1, 2, -1, -3])
@pytest.mark.parametrize("dtype", ["u1", "u2", "i4"])
def test_mcidas_strides_agree_with_jax(tmp_path, rng, dtype, bands, cut):
    """w[14] sets the stride: Pillow maps an "L" or "I;16B" file whose lines
    end within it, so a stride under a line's bytes overlaps the lines and
    one of 0 or less packs them; its raw decoder refuses such strides."""
    blob = chip_smoke.mcidas_write(rng.integers(0, 200, (6, 5)).astype(dtype),
                                   3)
    blob = _mcidas_word(blob, 14, bands)
    agree(write(tmp_path, blob[:len(blob) - cut], "s.area"))


def test_mcidas_bit_flips_agree_with_jax(tmp_path, rng):
    blob = chip_smoke.mcidas_write(rng.integers(0, 65536, (6, 5)).astype(
        np.uint16))
    for k, b in enumerate(flips(blob, rng, 40, 0, 160)):
        agree(write(tmp_path, b, f"flip{k}.area"))


# ---------------------------------------------------------------------------
# SPIDER
# ---------------------------------------------------------------------------
def _spider(a, big=False, stack=0, iform=1):
    """A SPIDER image header and data, as Pillow writes it (little-endian
    there), or big-endian, or a stack of one image."""
    h, w = a.shape
    hdr = [0.0] * 27
    labrec = max(1, -(-1024 // (4 * w)))
    lenbyt = 4 * w
    hdr[0], hdr[1], hdr[4], hdr[11] = 1.0, float(h), float(iform), float(w)
    hdr[12], hdr[21], hdr[22] = float(labrec), float(labrec * lenbyt), \
        float(lenbyt)
    if stack:
        hdr[23], hdr[25] = 2.0, float(stack)
    fmt = ">" if big else "<"
    head = struct.pack(f"{fmt}27f", *hdr)
    head += bytes(labrec * lenbyt - len(head))
    body = np.ascontiguousarray(a, f"{fmt}f4").tobytes()
    if stack:
        return head + head + body
    return head + body


@pytest.mark.parametrize("kind", ["pillow", "big", "stack", "1x1"])
def test_spider_equals_jax(tmp_path, rng, kind):
    a = _floats(rng, (1, 1) if kind == "1x1" else (7, 9), nans=True)
    if kind == "pillow":
        blob = pil_bytes(Image.fromarray(a), "SPIDER")
    else:
        blob = _spider(a, big=kind == "big", stack=3 * (kind == "stack"))
    got = agree(write(tmp_path, blob, "s.spi"), True)
    assert np.array_equal(_bits(got[..., 0]), _bits(a))


SPIDER_CASES = {
    "iform 3": (lambda a: _spider(a, iform=3), False),
    "cut": (lambda a: _spider(a)[:-2], False),
    "short": (lambda a: _spider(a)[:100], False),
    "image in a stack": (lambda a: _spider(a)[:26 * 4] + struct.pack(
        "<f", 1.0) + _spider(a)[27 * 4:], False),
}


@pytest.mark.parametrize("name", list(SPIDER_CASES))
def test_spider_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = SPIDER_CASES[name]
    agree(write(tmp_path, make(_floats(rng, (4, 6))), "s.spi"), opens)


def test_spider_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _spider(_floats(rng, (4, 6)))
    for k, b in enumerate(flips(blob, rng, 40, 0, 108)):
        agree(write(tmp_path, b, f"flip{k}.spi"))


# ---------------------------------------------------------------------------
# IM
# ---------------------------------------------------------------------------
def _pil_im(rng, mode, shape=(5, 7)):
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    if mode == "1":
        return Image.fromarray(rgb[..., 0] > 100)
    if mode == "F":
        return Image.fromarray(_floats(rng, shape, nans=True))
    if mode == "I":
        return Image.fromarray(rng.integers(0, 65536, shape).astype(np.int32))
    if mode.startswith("I;16"):
        return Image.fromarray(rng.integers(0, 65536, shape).astype(
            np.uint16)).convert(mode) if mode != "I;16" else \
            Image.fromarray(rng.integers(0, 65536, shape).astype(np.uint16))
    if mode == "P":
        return Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                            colors=13)
    if mode == "PA":
        return Image.fromarray(rgb).convert("P").convert("PA")
    return Image.fromarray(rgb).convert(mode)


IM_MODES = ["1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK",
            "YCbCr", "I", "I;16", "I;16L", "I;16B", "F"]


@pytest.mark.parametrize("size", [(1, 1), (5, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", IM_MODES)
def test_pillow_im_equals_jax(tmp_path, rng, mode, size):
    blob = pil_bytes(_pil_im(rng, mode, size), "IM")
    agree(write(tmp_path, blob, "p.im"))


def _im(lines, data: bytes, lut: bytes = b"", eol=b"\r\n") -> bytes:
    head = b"".join(line.encode("latin-1") + eol for line in lines)
    head = head + bytes(max(0, 511 - len(head))) + b"\x1a"
    return head + lut + data


def _im_case(rng, mode_line, w=5, h=3, nbytes=None, extra=(), lut=b""):
    n = nbytes if nbytes is not None else w * h
    return _im([f"Image type: {mode_line}", f"Image size (x*y): {w}*{h}",
                *extra], rng.integers(0, 256, n).astype(np.uint8).tobytes(),
               lut)


GRAY_LUT = bytes(range(256)) * 3
COLOUR_LUT = bytes(np.random.default_rng(5).integers(0, 256, 768).astype(
    np.uint8))

IM_CASES = {
    "L*12": (lambda rng: _im_case(rng, "L*12 image", nbytes=8 * 3), True),
    "L*5 one column": (lambda rng: _im_case(rng, "L*5 image", w=1, h=4,
                                            nbytes=4), True),
    "L*27": (lambda rng: _im_case(rng, "L*27 image", w=3, nbytes=11 * 3),
             True),
    "L 8S": (lambda rng: _im_case(rng, "L 8S image"), True),
    "L 16S": (lambda rng: _im_case(rng, "L 16S image", nbytes=30), True),
    "L 32S": (lambda rng: _im_case(rng, "L 32S image", nbytes=60), None),
    "L 32 F": (lambda rng: _im_case(rng, "L 32 F image", nbytes=60), True),
    "L*32F": (lambda rng: _im_case(rng, "L*32F image", nbytes=60), True),
    "L 16B": (lambda rng: _im_case(rng, "L 16B image", nbytes=30), True),
    "B2": (lambda rng: _im_case(rng, "B2 image", w=9, nbytes=9), True),
    "B4 with lut": (lambda rng: _im_case(rng, "B4 image", nbytes=15,
                                         lut=COLOUR_LUT, extra=("Lut: 1",)),
                    True),
    "L with colour lut": (lambda rng: _im_case(
        rng, "Greyscale image", lut=COLOUR_LUT, extra=("Lut: rgb",)), True),
    "L with gray lut": (lambda rng: _im_case(
        rng, "Greyscale image", lut=GRAY_LUT[::-1], extra=("Lut: g",)), True),
    "P with gray lut": (lambda rng: _im_case(
        rng, "P", lut=GRAY_LUT, extra=("Lut: g",)), True),
    "LA with colour lut": (lambda rng: _im_case(
        rng, "LA image", nbytes=30, lut=COLOUR_LUT, extra=("Lut: x",)),
        True),
    "short lut": (lambda rng: _im_case(rng, "Greyscale image", nbytes=0,
                                       lut=COLOUR_LUT[:600],
                                       extra=("Lut: x",)), None),
    "RGB3": (lambda rng: _im_case(rng, "RGB3 image", nbytes=45), True),
    "RLB": (lambda rng: _im_case(rng, "RLB image", nbytes=45), False),
    "PA type": (lambda rng: _im_case(rng, "PA image", nbytes=30), False),
    "X 24": (lambda rng: _im_case(rng, "X 24 image", nbytes=45), True),
    "YCC": (lambda rng: _im_case(rng, "YCC image", nbytes=45), True),
    "LAB": (lambda rng: _im_case(rng, "LAB"), True),
    "unknown type": (lambda rng: _im_case(rng, "Foo image"), False),
    "names and comments": (lambda rng: _im_case(
        rng, "Greyscale image", extra=("Name: scene 7", "Comment: one",
                               "Comment: two", "Date: 2025-07-06",
                               "Station: sar-1", "Scale (x,y): 10,10")),
        True),
    "lf only": (lambda rng: _im([f"Image type: Greyscale image",
                                 "Image size (x*y): 3*2"], bytes(6),
                                eol=b"\n"), True),
    "float size": (lambda rng: _im_case(rng, "Greyscale image", extra=(
        "Image size (x*y): 5.5*3",)), False),
    "one number size": (lambda rng: _im_case(rng, "Greyscale image", extra=(
        "Image size (x*y): 15",)), False),
    "bad number": (lambda rng: _im_case(rng, "Greyscale image", extra=(
        "Scale (x,y): a,b",)), False),
    "no tag": (lambda rng: _im(["Foo: bar"], bytes(15)), False),
    "cut": (lambda rng: _im_case(rng, "Greyscale image", nbytes=14), False),
    "no 1a": (lambda rng: b"Image type: Greyscale image\r\nImage size (x*y): 2*2\r\n",
              False),
    "long line": (lambda rng: _im(["Image type: Greyscale image", "Name: " + "x" * 120],
                                  bytes(512)), False),
    "bad line": (lambda rng: _im(["Image type: Greyscale image", "no colon"],
                                 bytes(512)), False),
}


@pytest.mark.parametrize("name", list(IM_CASES))
def test_im_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = IM_CASES[name]
    agree(write(tmp_path, make(rng), "c.im"), opens)


def test_im_metadata_is_pillows_strings(tmp_path, rng):
    path = write(tmp_path, IM_CASES["names and comments"][0](rng), "m.im")
    same_as_jax(path)
    md = traster.RasterReader(path)._tiff.gdal_metadata()
    assert md == {"Image type": "L", "Name": "scene 7",
                  "Date": "2025-07-06", "Station": "sar-1"}


def test_im_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _im_case(rng, "L*12 image", nbytes=8 * 3,
                    extra=("Name: x",))
    for k, b in enumerate(flips(blob, rng, 30, 0, 60)):
        agree(write(tmp_path, b, f"flip{k}.im"))
    for k, b in enumerate(flips(blob, rng, 10, 512)):
        agree(write(tmp_path, b, f"data{k}.im"))


# ---------------------------------------------------------------------------
# the slice: a decoded band of each format read decimated onto the device
# (the CPU here) and saved as a CLAHE gray JPEG, against the JAX package
# ---------------------------------------------------------------------------
def science_files(tmp_path) -> dict:
    """The chip_smoke writers' PFM, FITS and McIdas bands at a small size,
    with a world file and a .prj."""
    dn = chip_smoke.formats_dn(chip_smoke.FORMATS_SEED, 90, 120)
    files = {
        "pfm f32": ("a.pfm", chip_smoke.pfm_write(dn.astype(np.float32))),
        "fits i16": ("a.fits", chip_smoke.fits_write(
            np.minimum(dn, 32767).astype(np.int16), 16)),
        "mcidas u16": ("a.area", chip_smoke.mcidas_write(dn)),
    }
    out = {}
    for kind, (name, blob) in files.items():
        path = write(tmp_path, blob, name)
        for ext in (".wld",):
            path.with_suffix(ext).write_text(
                "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
        path.with_suffix(".prj").write_text(WKT_32632)
        out[kind] = path
    return out


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("kind", ["pfm f32", "fits i16", "mcidas u16"])
def test_decimated_read_equals_jax(tmp_path, kind, alg):
    path = science_files(tmp_path)[kind]
    same_as_jax(path)
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        assert t.metadata.epsg == 32632
        before = dict(traster.ROUTES)
        got = traster.read_band_resampled_to_device(t, 1, 40, 30, "cpu", alg)
        want = j.read_band_resampled(1, 40, 30, alg)
    finally:
        t.close()
        j.close()
    assert traster.ROUTES["device_resample"] == before["device_resample"] + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (30, 40)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


@pytest.mark.parametrize("kind", ["pfm f32", "fits i16", "mcidas u16"])
def test_clahe_gray_jpeg_equals_jax(tmp_path, kind, native_both):
    """The port's cubic read of the decoded band saved as a CLAHE gray JPEG
    by both packages' api.save_image: Pillow's decodes of the two files
    within the CLAHE level bound of tests/test_torch_exact.py (the reads
    themselves differ within RESAMPLE_TOL, test_decimated_read_equals_jax,
    which CLAHE's bins may widen past that bound)."""
    from sarpro_tpu import api as japi
    from sarpro_tpu import types as jtypes
    from sarpro_tpu_torch import api as tapi
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )
    from test_torch_exact import S, _level_bound, _within

    path = science_files(tmp_path)[kind]
    t = traster.RasterReader(path)
    band = traster.read_band_resampled_to_device(t, 1, 64, 48, "cpu",
                                                 "cubic")
    tapi.save_image(band + 1.0, tmp_path / "t.jpg", OutputFormat.JPEG,
                    BitDepth.U8, autoscale=AutoscaleStrategy.CLAHE,
                    device="cpu")
    japi.save_image(band.numpy() + 1.0, tmp_path / "j.jpg",
                    jtypes.OutputFormat.JPEG, jtypes.BitDepth.U8,
                    autoscale=jtypes.AutoscaleStrategy.CLAHE)
    a = np.asarray(Image.open(tmp_path / "t.jpg"))
    b = np.asarray(Image.open(tmp_path / "j.jpg"))
    assert a.shape == b.shape == (48, 64)
    back = traster.RasterReader(tmp_path / "t.jpg")._tiff._data[..., 0]
    assert np.array_equal(back, a)
    _within(f"{kind} clahe gray jpeg", a, b,
            _level_bound(band.numpy(), S.CLAHE, 255.0))


def test_pilraster_reads_the_new_formats():
    for name in ("FITS", "IM", "MCIDAS", "SPIDER"):
        assert name in [p[0] for p in pilraster.PLUGINS]
    with pytest.raises(RasterError, match="cannot identify"):
        pilraster.open_image(b"\x01" * 40)
