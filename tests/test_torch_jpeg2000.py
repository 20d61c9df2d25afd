"""The port's JPEG 2000 reader (io/jpeg2000.py, _native/j2kdec.cpp) against
the JAX package's RasterReader, which opens the same files through Pillow
12.1 and OpenJPEG 2.5.4, on the CPU: every band bit-equal (dtype included),
equal size, bands, geotransform, EPSG and gdal_metadata(), and RasterError
where the JAX reader raises it. The reversible cases also equal the array
written. No tolerance is needed anywhere: the 9/7 cases are bit-equal too.

Inputs are written by Pillow from seeded numpy arrays (every mode, both
containers, the encoder's codings), and built around Pillow's codestreams
for what Pillow does not write: SIZ patched to 12, 15 and other precisions
(Pillow's shift of the samples to 16 or 8 bits), JP2 boxes made here
(palettes, colour spaces, component counts against the JP2 header's),
tile-parts split at packet boundaries, SOP markers, tiles out of order,
files cut short, a header patched for each feature the port refuses, and
the same patches for the code-block styles, RGN, POC, PPM, PPT, CAP, Rsiz
bits, sub-sampling and 17-bit samples the port decodes
(tests/test_torch_jpeg2000_styles.py and
tests/test_torch_jpeg2000_subsampling.py hold OpenJPEG's own codestreams
of those).
The committed codestreams of tests/data/jpeg2000 (chip_smoke.py's jpeg2000
phase) are re-encoded here from their seeds."""
import hashlib
import io
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import jpeg2000  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    RESAMPLE_TOL,
    _both_refuse,
    _equal_to_jax,
)
from test_torch_readers import WKT_32632  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BANDS = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,), "I;16": (),
         "I;16 signed": ()}
SIZES = ((1, 1), (13, 21), (37, 50))


def _scene(rng, shape, hi=255):
    """Speckled gradients: busy code-blocks in every band."""
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    g = (x * 5 + y * 3) % (hi + 1)
    if len(shape) == 3:
        g = g[..., None] + (hi // 6) * np.arange(shape[2])
    dtype = np.uint16 if hi > 255 else np.uint8
    return np.clip(0.6 * g + rng.gamma(4.0, hi / 32, shape), 0, hi).astype(
        dtype)


def _encode(a, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(a, mode).save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def _write(tmp_path, blob: bytes, name: str = "x.jp2") -> Path:
    path = tmp_path / name
    path.write_bytes(blob)
    return path


# ---------------------------------------------------------------------------
# what Pillow writes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("container", ["jp2", "j2k"])
@pytest.mark.parametrize("size", SIZES, ids=["1x1", "13x21", "37x50"])
@pytest.mark.parametrize("mode", list(BANDS))
def test_pillow_modes_equal_jax(tmp_path, rng, mode, size, container,
                                irreversible):
    signed = mode.endswith("signed")
    pil_mode = mode.split()[0]
    a = _scene(rng, size + BANDS[mode], 65535 if pil_mode == "I;16" else 255)
    blob = _encode(a, pil_mode, irreversible=irreversible, signed=signed,
                   no_jp2=container == "j2k")
    got = _equal_to_jax(_write(tmp_path, blob, f"x.{container}"))
    assert got.shape == size + ((BANDS[mode] or (1,))[0],)
    if not irreversible:
        # signed samples are the written bits read as two's complement,
        # offset by half their range (Pillow's unpacker)
        want = a ^ 0x8000 if signed else a
        assert np.array_equal(got, want.reshape(got.shape))


CODINGS = {
    **{f"resolutions {n}": {"num_resolutions": n} for n in range(1, 7)},
    **{f"codeblock {w}x{h}": {"codeblock_size": (w, h)}
       for w, h in ((4, 4), (16, 64), (64, 64))},
    "precinct 16 4 levels": {"precinct_size": (16, 16),
                             "num_resolutions": 4},
    "precinct 32x64 3 levels": {"precinct_size": (32, 64),
                                "num_resolutions": 3},
    "tiles 32": {"tile_size": (32, 32)},
    "tiles offsets": {"tile_size": (40, 24), "tile_offset": (3, 5),
                      "offset": (7, 11)},
    **{p: {"progression": p} for p in ("LRCP", "RLCP", "RPCL", "PCRL",
                                       "CPRL")},
    **{f"{p} precincts tiles offsets": {
        "progression": p, "precinct_size": (16, 16), "tile_size": (40, 24),
        "tile_offset": (3, 5), "offset": (7, 11)}
       for p in ("RPCL", "PCRL", "CPRL")},
    "1 layer rates": {"quality_layers": [20]},
    "2 layers rates": {"quality_layers": [40, 10]},
    "3 layers rates": {"quality_layers": [60, 20, 5],
                       "progression": "RLCP"},
    "1 layer dB": {"quality_layers": [30], "quality_mode": "dB"},
    "3 layers dB": {"quality_layers": [30, 40, 50], "quality_mode": "dB"},
    "plt": {"plt": True},
    "comment": {"comment": "sarpro"},
    "mct 1": {"mct": 1},
}


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("coding", list(CODINGS))
def test_pillow_codings_equal_jax(tmp_path, rng, coding, irreversible):
    kw = CODINGS[coding]
    a = _scene(rng, (64, 90, 3))
    got = _equal_to_jax(_write(tmp_path, _encode(
        a, "RGB", irreversible=irreversible, **kw)))
    if not irreversible and "quality_layers" not in kw:
        assert np.array_equal(got, a)


def test_precinct_of_one_sample_is_refused_as_by_jax(tmp_path, rng):
    """16^2 precincts over 6 resolutions: OpenJPEG's encoder halves them to
    1 sample at resolution 1, which its decoder refuses; so does the
    port."""
    blob = _encode(_scene(rng, (64, 90, 3)), "RGB", precinct_size=(16, 16))
    _both_refuse(_write(tmp_path, blob), "invalid precinct size")


@pytest.mark.parametrize("kw", [
    {"irreversible": True},
    {"irreversible": True, "num_resolutions": 6, "codeblock_size": (16, 64)},
    {"irreversible": True, "quality_layers": [50, 20, 8],
     "progression": "CPRL", "precinct_size": (64, 32)},
    {"quality_layers": [12, 3], "tile_size": (128, 96)},
], ids=["9-7", "9-7 6 res", "9-7 layers CPRL", "5-3 layers tiles"])
@pytest.mark.parametrize("mode", ["I;16", "RGB", "RGBA"])
def test_pillow_large_lossy_equal_jax(tmp_path, rng, mode, kw):
    """Bands of 300 px with many code-blocks, at u16 and with the ICT: the
    9/7 wavelet's float rounding bit-equal to OpenJPEG's."""
    shape = {"I;16": (300, 257), "RGB": (300, 257, 3),
             "RGBA": (257, 300, 4)}[mode]
    a = _scene(rng, shape, 65535 if mode == "I;16" else 255)
    if mode != "I;16":
        kw = dict(kw, mct=1)
    _equal_to_jax(_write(tmp_path, _encode(a, mode, **kw), "x.j2k"))


def test_jp2_world_file_and_prj(tmp_path, rng):
    """tests/test_io.py's .j2w case, with a .prj: the port's geotransform
    and EPSG are the JAX reader's."""
    path = _write(tmp_path, _encode(_scene(rng, (16, 20)), "L"), "g.jp2")
    path.with_suffix(".j2w").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
    path.with_suffix(".prj").write_text(WKT_32632)
    _equal_to_jax(path)
    t = traster.RasterReader(path)
    assert t.metadata.geotransform == [500000.0, 10.0, 0.0, 4000000.0, 0.0,
                                       -10.0]
    assert t.metadata.epsg == 32632 and t.metadata.metadata == {}


# ---------------------------------------------------------------------------
# Pillow's codestreams with their precision patched in SIZ
# ---------------------------------------------------------------------------
def _patch_precision(code: bytes, prec: int, signed: bool = False) -> bytes:
    b = bytearray(code)
    for c in range(struct.unpack_from(">H", b, 40)[0]):
        b[42 + 3 * c] = (prec - 1) | (0x80 if signed else 0)
    return bytes(b)


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("prec", [12, 15, 9])
def test_patched_precision_reads_shifted_as_jax(tmp_path, rng, prec,
                                                irreversible):
    """A band of `prec` bits (coded from a + 32768 - 2^(prec-1) at 16 bits,
    then SIZ patched): the same samples, which Pillow's I;16 unpacker
    shifts up to 16 bits; the JAX package reads a << (16 - prec), and so
    does the port."""
    a = rng.integers(0, 1 << prec, (37, 50)).astype(np.uint16)
    coded = (a.astype(np.int64) + 32768 - (1 << (prec - 1))).astype(np.uint16)
    code = _encode(coded, "I;16", no_jp2=True, irreversible=irreversible)
    got = _equal_to_jax(_write(tmp_path, _patch_precision(code, prec),
                               "p.j2k"))
    if not irreversible:
        assert np.array_equal(got[..., 0], a << (16 - prec))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("prec", [4, 7, 12, 16])
def test_patched_precision_rgb_equals_jax(tmp_path, rng, prec, signed):
    """Colour components of 4 to 16 bits: Pillow shifts them to 8, rounding
    where it shifts down, and offsets signed ones."""
    code = _encode(_scene(rng, (20, 30, 3)), "RGB", no_jp2=True)
    _equal_to_jax(_write(tmp_path, _patch_precision(code, prec, signed),
                         "p.j2k"))


# ---------------------------------------------------------------------------
# JP2 boxes made here around Pillow's codestreams
# ---------------------------------------------------------------------------
def _box(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(data), kind) + data


def _jp2(code: bytes, shape, nc: int, bpc: int = 8, enumcs=None,
         extra: bytes = b"") -> bytes:
    ihdr = struct.pack(">IIHBBBB", shape[0], shape[1], nc, bpc - 1, 7, 0, 0)
    colr = b"" if enumcs is None else _box(
        b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", _box(b"ihdr", ihdr) + colr + extra)
            + _box(b"jp2c", code))


def _components(rng, n, shape=(6, 9)):
    """n distinct components and Pillow's codestream of them."""
    a = np.stack([40 * c + rng.integers(0, 30, shape) for c in range(n)],
                 -1).astype(np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[n]
    return _encode(a[..., 0] if n == 1 else a, mode, no_jp2=True)


@pytest.mark.parametrize("enumcs", [None, 16, 17, 18, 12, 24, 99],
                         ids=["no colr", "sRGB", "gray", "sYCC", "CMYK",
                              "e-YCC", "unknown"])
def test_unpacker_table_equals_jax(tmp_path, rng, enumcs):
    """Every pairing of the JP2 header's component count (the mode) with
    the codestream's, under each colour space: the port opens what the
    JAX reader opens, to the same array (sYCC taken to RGB as Pillow
    takes it), and refuses what it refuses."""
    codes = {n: _components(rng, n) for n in (1, 2, 3, 4)}
    opened = 0
    for nc in (1, 2, 3, 4):
        for comps in (1, 2, 3, 4):
            path = _write(tmp_path, _jp2(codes[comps], (6, 9), nc, 8, enumcs))
            try:
                jraster.RasterReader(path).close()
            except jraster.RasterError:
                _both_refuse(path)
                continue
            _equal_to_jax(path)
            opened += 1
    assert opened == {None: 10, 16: 4, 17: 7, 18: 4, 12: 1, 24: 0, 99: 10}[
        enumcs]


def test_sixteen_bit_ihdr_over_eight_bit_components_equals_jax(tmp_path,
                                                                rng):
    """An ihdr of 16 bits makes the mode I;16: 8-bit samples read << 8."""
    code = _components(rng, 1)
    for enumcs in (None, 17, 99, 16):
        path = _write(tmp_path, _jp2(code, (6, 9), 1, 16, enumcs))
        if enumcs == 16:
            _both_refuse(path)
        else:
            _equal_to_jax(path)


def _pclr(entries, npc=3, depth=8) -> bytes:
    """pclr and cmap boxes: `entries` of `npc` columns at `depth` bits (one
    byte a value up to 8 bits, two above)."""
    fmt = ">" + ("B" if depth <= 8 else "H") * npc
    return (_box(b"pclr", struct.pack(">HB", len(entries), npc)
                 + bytes([depth - 1] * npc)
                 + b"".join(struct.pack(fmt, *e) for e in entries))
            + _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                     for k in range(npc))))


@pytest.mark.parametrize("case", ["full", "short", "repeats", "la",
                                  "gray colr", "deep entries",
                                  "deep entries srgb", "cut pclr",
                                  "cmap first"])
def test_palette_jp2_equals_jax(tmp_path, rng, case):
    """A pclr box on L (mode P, expanded to RGB: indices past the palette
    black, repeated entries kept once as Pillow's getcolor keeps them) and
    on LA (mode PA, kept as index and alpha); a gray colr has no P
    unpacker; entries over 8 bits leave the mode L (which an sRGB colr has
    no unpacker for); a pclr box shorter than its entries, and a cmap box
    before it, are refused by OpenJPEG and by the port."""
    n = 1 if case != "la" else 2
    shape = (12, 17)
    a = rng.integers(0, 200, shape + (n,)).astype(np.uint8)
    code = _encode(a[..., 0] if n == 1 else a, "L" if n == 1 else "LA",
                   no_jp2=True)
    entries = [((7 * i) % 256, (13 * i) % 256, 255 - i) for i in range(200)]
    if case == "short":
        entries = entries[:120]
    elif case == "repeats":
        entries = [entries[i % 50] for i in range(200)]
    extra = _pclr(entries, depth=12 if case.startswith("deep") else 8)
    if case == "cut pclr":
        extra = _box(b"pclr", extra[8:struct.unpack_from(">I", extra)[0] - 3])
    elif case == "cmap first":
        k = struct.unpack_from(">I", extra)[0]
        extra = extra[k:] + extra[:k]
    colr = 17 if case in ("gray colr", "deep entries") else 16
    path = _write(tmp_path, _jp2(code, shape, n, 8, colr, extra))
    if case in ("gray colr", "deep entries srgb", "cut pclr", "cmap first"):
        _both_refuse(path)
        return
    got = _equal_to_jax(path)
    if case == "full":
        table = np.array(entries, np.uint8)
        assert np.array_equal(got, table[a[..., 0]])
    if case == "short":
        assert (got[a[..., 0] >= 120] == 0).all()


def test_cmyk_colr_equals_jax(tmp_path, rng):
    a = _scene(rng, (12, 17, 4))
    code = _encode(a, "RGBA", no_jp2=True)
    path = _write(tmp_path, _jp2(code, (12, 17), 4, 8, 12))
    assert Image.open(path).mode == "CMYK"
    assert np.array_equal(_equal_to_jax(path), a)


@pytest.mark.parametrize("shape", [(10, 17), (12, 16), (13, 17), (12, 18)],
                         ids=["fewer rows", "fewer cols", "more rows",
                              "more cols"])
def test_ihdr_size_against_siz_is_refused_as_by_jax(tmp_path, rng, shape):
    """An ihdr box whose size is not the codestream's: both refuse."""
    code = _encode(_scene(rng, (12, 17)), "L", no_jp2=True)
    _both_refuse(_write(tmp_path, _jp2(code, shape, 1, 8, 17)), "ihdr")


# ---------------------------------------------------------------------------
# codestream surgery: tile-parts, SOP markers, tile order
# ---------------------------------------------------------------------------
def _main_header_end(code: bytes) -> int:
    pos = 2
    while struct.unpack_from(">H", code, pos)[0] not in (0xFF90, 0xFFD9):
        pos += 2 + struct.unpack_from(">H", code, pos + 2)[0]
    return pos


def _tile_parts(code: bytes):
    """(tile index, header bytes, data bytes, PLT packet lengths) of each
    tile-part."""
    pos = _main_header_end(code)
    parts = []
    while struct.unpack_from(">H", code, pos)[0] == 0xFF90:
        isot, psot = struct.unpack_from(">HI", code, pos + 4)
        tp = code[pos:pos + psot]
        q, lengths = 12, []
        while struct.unpack_from(">H", tp, q)[0] != 0xFF93:
            n = struct.unpack_from(">H", tp, q + 2)[0]
            if tp[q + 1] == 0x58:  # PLT: Iplt, then 7-bit groups
                v = 0
                for byte in tp[q + 5:q + 2 + n]:
                    v = (v << 7) | (byte & 0x7F)
                    if not byte & 0x80:
                        lengths.append(v)
                        v = 0
            q += 2 + n
        parts.append((isot, tp[12:q], tp[q + 2:], lengths))
        pos += psot
    return parts


def _sot(isot, tpsot, tnsot, header, data) -> bytes:
    return (struct.pack(">HHHIBB", 0xFF90, 10, isot,
                        14 + len(header) + len(data), tpsot, tnsot)
            + header + b"\xff\x93" + data)


def _rebuilt(code: bytes, parts) -> bytes:
    return code[:_main_header_end(code)] + b"".join(parts) + b"\xff\xd9"


def _set_scod(code: bytes, bit: int) -> bytes:
    b = bytearray(code)
    pos = 2
    while True:
        marker, n = struct.unpack_from(">HH", b, pos)
        if marker == 0xFF52:
            b[pos + 4] |= bit
            return bytes(b)
        pos += 2 + n


SURGERY_CODES = {"5-3": {}, "9-7 layers": {"irreversible": True,
                                           "quality_layers": [30, 10]},
                 "tiles RPCL": {"tile_size": (32, 48), "progression": "RPCL"}}


SURGERIES = [(s, c) for s in ("split", "sop", "sop flag only")
             for c in SURGERY_CODES] + [("tiles reversed", "tiles RPCL")]


@pytest.mark.parametrize("surgery,coding", SURGERIES)
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_codestream_surgery_equals_jax(tmp_path, rng, mode, coding,
                                       surgery):
    """Each tile-part cut in two at a packet boundary (PLT), SOP markers
    before every packet, the SOP flag with no markers, and the tiles in
    reverse order."""
    a = _scene(rng, (70, 90) + ((3,) if mode == "RGB" else ()))
    code = _encode(a, mode, no_jp2=True, plt=True, **SURGERY_CODES[coding])
    parts = _tile_parts(code)
    if surgery == "split":
        new = []
        for isot, header, data, lengths in parts:
            cut = sum(lengths[:len(lengths) // 2])
            new += [_sot(isot, 0, 2, header, data[:cut]),
                    _sot(isot, 1, 2, b"", data[cut:])]
        code = _rebuilt(code, new)
    elif surgery == "sop":
        new = []
        for isot, header, data, lengths in parts:
            out, pos = b"", 0
            for i, n in enumerate(lengths):
                out += struct.pack(">HHH", 0xFF91, 4, i) + data[pos:pos + n]
                pos += n
            new.append(_sot(isot, 0, 1, header, out))
        code = _set_scod(_rebuilt(code, new), 2)
    elif surgery == "sop flag only":
        code = _set_scod(code, 2)
    else:
        assert len(parts) == 6
        code = _rebuilt(code, [_sot(i, 0, 1, h, d)
                               for i, h, d, _ in parts[::-1]])
    got = _equal_to_jax(_write(tmp_path, code, "s.j2k"))
    if coding != "9-7 layers":
        assert np.array_equal(got, a.reshape(got.shape))


def test_decode_does_not_hang_on_the_thread_count(monkeypatch, rng):
    """Code-blocks and wavelet lines on 1, 3 or 8 threads, one tile or
    many: the same image."""
    a = _scene(rng, (300, 280, 3))
    for kw in ({}, {"tile_size": (64, 64)}):
        code = _encode(a, "RGB", irreversible=True, mct=1, no_jp2=True, **kw)
        outs = []
        for k in (1, 3, 8):
            monkeypatch.setattr(_native, "_threads", lambda k=k: k)
            outs.append(jpeg2000.read(code).array)
        assert all(np.array_equal(outs[0], o) for o in outs[1:])


# ---------------------------------------------------------------------------
# files cut short, and what the port refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("container", ["jp2", "j2k"])
@pytest.mark.parametrize("cut", ["50%", "90%", "2 bytes short"])
def test_cut_files_are_refused_as_by_jax(tmp_path, rng, container, cut):
    blob = _encode(_scene(rng, (64, 64)), "L", no_jp2=container == "j2k")
    n = {"50%": len(blob) // 2, "90%": len(blob) * 9 // 10,
         "2 bytes short": len(blob) - 2}[cut]
    _both_refuse(_write(tmp_path, blob[:n], f"c.{container}"), "cut short")


def _insert_main_marker(code: bytes, segment: bytes) -> bytes:
    pos = _main_header_end(code)
    return code[:pos] + segment + code[pos:]


def _style(code: bytes, bits: int) -> bytes:
    b = bytearray(code)
    pos = 2
    while True:
        marker, n = struct.unpack_from(">HH", b, pos)
        if marker == 0xFF52:  # Scod, SGcod (4), levels, xcb, ycb, style
            b[pos + 12] |= bits
            return bytes(b)
        pos += 2 + n


def _rsiz(code: bytes, value: int) -> bytes:
    return code[:6] + struct.pack(">H", value) + code[8:]


# headers patched for what the port once refused and now decodes: the
# code-block styles set on a codestream written without them, an RGN of
# shift 0, a POC over resolutions 0-4 of 6, PPM and PPT segments of one
# byte, a CAP segment, the Part-2 and HTJ2K bits of Rsiz over Part-1
# code-blocks, the first component sub-sampled 2 x 2, 17-bit samples
DECODED_PATCHES = {
    "bypass": lambda c: _style(c, 0x01),
    "reset": lambda c: _style(c, 0x02),
    "termall": lambda c: _style(c, 0x04),
    "causal": lambda c: _style(c, 0x08),
    "pterm": lambda c: _style(c, 0x10),
    "segsym": lambda c: _style(c, 0x20),
    "rgn": lambda c: _insert_main_marker(
        c, struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, 0)),
    "poc": lambda c: _insert_main_marker(
        c, struct.pack(">HHBBHBBB", 0xFF5F, 9, 0, 0, 1, 5, 1, 0)),
    "ppm": lambda c: _insert_main_marker(
        c, struct.pack(">HHB", 0xFF60, 3, 0)),
    "ppt": lambda c: _rebuilt(c, [_sot(
        i, 0, 1, h + struct.pack(">HHB", 0xFF61, 3, 0), d)
        for i, h, d, _ in _tile_parts(c)]),
    "cap": lambda c: _insert_main_marker(
        c, struct.pack(">HHIH", 0xFF50, 8, 0x00020000, 0)),
    "part 2 rsiz": lambda c: _rsiz(c, 0x8000),
    "htj2k rsiz": lambda c: _rsiz(c, 0x4000),
    "sub-sampling": lambda c: c[:43] + b"\x02\x02" + c[45:],
    "17 bits": lambda c: _patch_precision(c, 17),
}


def _patched_held_to_jax(tmp_path, rng, feature, mode):
    shape = (24, 32) + ((3,) if mode == "RGB" else ())
    code = DECODED_PATCHES[feature](
        _encode(_scene(rng, shape), mode, no_jp2=True))
    path = _write(tmp_path, code, "r.j2k")
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        _both_refuse(path)
        return
    _equal_to_jax(path)


@pytest.mark.parametrize("feature", list(DECODED_PATCHES))
def test_patched_feature_equals_jax(tmp_path, rng, feature):
    """The same patched headers the port refused until it decoded these
    features: it now gives the JAX reader's pixels, or refuses where that
    refuses (a style read from data coded without it decodes to what
    OpenJPEG makes of it; PPM / PPT segments of one byte OpenJPEG
    refuses; Pillow has no unpacker for a sub-sampled gray component)."""
    _patched_held_to_jax(tmp_path, rng, feature, "L")


@pytest.mark.parametrize("feature", list(DECODED_PATCHES))
def test_patched_feature_rgb_equals_jax(tmp_path, rng, feature):
    """The same patches on an RGB codestream: the first component
    sub-sampled opens (Pillow's sRGB unpacker takes sub-sampled
    components), 17-bit samples land in 8 bits."""
    _patched_held_to_jax(tmp_path, rng, feature, "RGB")


REFUSALS = {
    "ht mixed blocks": (lambda c: _style(c, 0xC0), "HTJ2K"),
    "32 bits": (lambda c: _patch_precision(c, 32), "above 31 bits"),
}


@pytest.mark.parametrize("feature", list(REFUSALS))
def test_refused_feature_is_named(tmp_path, rng, feature):
    """A header patched for each feature the port does not decode: the
    port raises RasterError naming it, and so does the JAX reader (HT
    code-blocks mixed with Part-1 ones; more bits than OpenJPEG's 31)."""
    patch, match = REFUSALS[feature]
    code = patch(_encode(_scene(rng, (24, 32)), "L", no_jp2=True))
    _both_refuse(_write(tmp_path, code, "r.j2k"), match)


# the HT style bit patched over Part-1 data, which the port once refused
# by name and now decodes as OpenJPEG does (tests/test_torch_jpeg2000_ht.py
# holds real HT code-blocks)
HT_OVER_PART1 = {
    "ht blocks": lambda c: _style(c, 0x40),
    "ht vsc blocks": lambda c: _style(c, 0x48),
}


@pytest.mark.parametrize("feature", list(HT_OVER_PART1))
def test_ht_style_over_part1_data_is_read_as_by_jax(tmp_path, rng, feature):
    """Part-1 code-blocks read as HT ones: each block's Part-1 passes (up
    to 3 a bit-plane) count as HT passes, more than 3 of which OpenJPEG's
    HT decoder refuses; both readers refuse the file, the port naming the
    HTJ2K pass count."""
    code = HT_OVER_PART1[feature](
        _encode(_scene(rng, (24, 32)), "L", no_jp2=True))
    _both_refuse(_write(tmp_path, code, "r.j2k"), "HTJ2K")


def _retag_com(code: bytes, marker: int) -> bytes:
    """The main header's COM marker code replaced by `marker`."""
    pos = code.index(b"\xff\x64")
    return code[:pos] + struct.pack(">H", marker) + code[pos + 2:]


def _qcd_style(code: bytes, sqcd: int) -> bytes:
    pos = code.index(b"\xff\x5c")
    return code[:pos + 4] + bytes([sqcd]) + code[pos + 5:]


HEADER_FAULTS = {
    # OpenJPEG reads past an unknown marker word by word, not by its length
    "unknown marker": lambda c: _retag_com(c, 0xFF6B),
    "marker out of place": lambda c: _retag_com(c, 0xFF58),
    "tile-part index 1 first": lambda c: _rebuilt(c, [
        _sot(i, 1, 0, h, d) for i, h, d, _ in _tile_parts(c)]),
    "tile-part index past TNsot": lambda c: _rebuilt(c, [
        _sot(i, 0, 1, h, d[:len(d) // 2]) + _sot(i, 1, 1, b"", d[len(d) // 2:])
        for i, h, d, _ in _tile_parts(c)]),
    "QCD bytes left over": lambda c: _qcd_style(c, 0x41),
}


@pytest.mark.parametrize("fault", list(HEADER_FAULTS))
def test_header_faults_are_refused_as_by_jax(tmp_path, rng, fault):
    """Headers OpenJPEG refuses: a marker it does not know (it then scans
    the following words for one it knows, here into the tile's data), a
    PLT in the main header, tile-parts whose TPsot is out of order or past
    TNsot, a QCD whose style leaves bytes unread."""
    code = _encode(_scene(rng, (40, 52)), "L", no_jp2=True)
    _both_refuse(_write(tmp_path, HEADER_FAULTS[fault](code), "h.j2k"))


def test_unknown_and_too_many_components(tmp_path, rng):
    """Five components: Pillow cannot name a mode, and neither can the
    port; a codestream not starting SOC SIZ inside a JP2 is refused."""
    code = _encode(_scene(rng, (8, 8)), "L", no_jp2=True)
    five = bytearray(code[:40] + struct.pack(">H", 5) + code[42:45] * 5
                     + code[45:])
    struct.pack_into(">H", five, 4, 38 + 15)
    _both_refuse(_write(tmp_path, bytes(five), "f.j2k"), "image mode")
    _both_refuse(_write(tmp_path, _jp2(b"\0" * 64, (8, 8), 1, 8, 17),
                        "z.jp2"))


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("kind", ["u16", "rgb"])
def test_decimated_read_of_jpeg2000_band_equals_jax(tmp_path, rng, kind,
                                                    alg):
    """tests/test_io.py's read_band_resampled(1, 30, 20, ...) on a JPEG 2000
    band: the port's device route against the JAX package's."""
    a = (_scene(rng, (60, 90), 65535) if kind == "u16"
         else _scene(rng, (60, 90, 3)))
    path = _write(tmp_path, _encode(a, "I;16" if kind == "u16" else "RGB"))
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got = traster.read_band_resampled_to_device(t, 1, 30, 20, "cpu", alg)
        want = j.read_band_resampled(1, 30, 20, alg)
    finally:
        t.close()
        j.close()
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 30)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


# ---------------------------------------------------------------------------
# the committed codestreams of chip_smoke.py's jpeg2000 phase
# ---------------------------------------------------------------------------
def fixture_codestreams() -> dict:
    """tests/data/jpeg2000's files, as Pillow writes them from their seeds:
    (a) the SAR-like u16 tile, lossless with Pillow's defaults and one
    512^2 tile; (b) the RGB tile, 9/7 with the ICT, two layers, RPCL,
    128^2 precincts, 32^2 code-blocks, one 256^2 tile."""
    return {
        chip_smoke.J2K_BAND: _encode(chip_smoke.j2k_band_tile(), "I;16",
                                     tile_size=(512, 512), no_jp2=True),
        chip_smoke.J2K_RGB: _encode(
            chip_smoke.j2k_rgb_tile(), "RGB", irreversible=True, mct=1,
            quality_layers=[40, 10], progression="RPCL",
            precinct_size=(128, 128), codeblock_size=(32, 32),
            tile_size=(256, 256), no_jp2=True),
    }


def test_committed_codestreams_are_pillows(tmp_path):
    """The committed bytes are Pillow's re-encode from the seeds; both
    decode bit-equal to the JAX reader's; (a) to its seeded DN; Pillow's
    decode of (b) has the SHA-256 chip_smoke.py holds the card's to."""
    sizes = 0
    for name, blob in fixture_codestreams().items():
        committed = (chip_smoke.J2K_DIR / name).read_bytes()
        assert committed == blob, name
        sizes += len(blob)
        got = _equal_to_jax(_write(tmp_path, blob, name))
        if name == chip_smoke.J2K_BAND:
            assert np.array_equal(got[..., 0], chip_smoke.j2k_band_tile())
        else:
            pil = np.asarray(Image.open(io.BytesIO(blob)))
            assert hashlib.sha256(pil.tobytes()).hexdigest() == \
                chip_smoke.J2K_RGB_SHA256
    assert sizes < 1 << 20


@pytest.mark.parametrize("name", ["band", "rgb"])
def test_spliced_codestreams_equal_jax(tmp_path, name):
    """chip_smoke.py's splice, at 3 x 2 tiles here: Pillow and the port
    decode it to np.tile of the one tile; the band also in chip_smoke's
    JP2 box with its world file."""
    fname = chip_smoke.J2K_BAND if name == "band" else chip_smoke.J2K_RGB
    code = (chip_smoke.J2K_DIR / fname).read_bytes()
    tile = jpeg2000.read(code).array
    spliced = chip_smoke.j2k_splice(code, 3, 2)
    if name == "band":
        side = tile.shape[0]
        path = _write(tmp_path, chip_smoke.jp2_wrap(
            spliced, 3 * side, 2 * side, 1, 16, 17), "band.jp2")
        path.with_suffix(".j2w").write_text(
            "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
        path.with_suffix(".prj").write_text("EPSG:32632")
    else:
        path = _write(tmp_path, spliced, "rgb.j2k")
    got = _equal_to_jax(path)
    want = np.tile(tile if tile.ndim == 3 else tile[..., None], (2, 3, 1))
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="one tile"):
        chip_smoke.j2k_splice(spliced, 2, 2)
