"""The port's readers of block-compressed and texture formats Pillow 12.1
opens (io/bcn with sarpro_tpu_torch/_native/bcndec.cpp, io/dds, io/ftex,
io/blp) against the JAX package's RasterReader, which opens the same files
through Pillow, on the CPU: every band equal bit for bit, the dtype, size,
gdal_metadata() and georeferencing equal, or both readers refuse the file.

The BC1-BC7 decoder is held block by block to its plain numpy version
(io/bcn.decode_blocks) and to Pillow's `bcn` decoder on seeded random
blocks of every format, every BC7 mode and the reserved one, and every
BC6H mode code (the reserved ones too). Inputs are made from seeds with
numpy and written by Pillow where it writes the format (DDS raw and
DXT1 / DXT3 / DXT5 / BC2 / BC3 / BC5, BLP palettes); the rest are written
here field by field. BLP2's DXT blocks read through Pillow's own Python
decoders, which differ from the bcn decoder's on the same block."""
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.io import bcn, blp  # noqa: E402
from test_torch_science_rasters import (  # noqa: E402
    agree,
    flips,
    pil_bytes,
    write,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SIZES = ((1, 1), (5, 7), (13, 4), (3, 130))
# format -> (n, signed, DXGI format)
BCN = {"BC1": (1, False, 71), "BC2": (2, False, 74), "BC3": (3, False, 77),
       "BC4": (4, False, 80), "BC5": (5, False, 83), "BC5S": (5, True, 84),
       "BC6H": (6, False, 95), "BC6HS": (6, True, 96), "BC7": (7, False, 98)}
BC6_CODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27,
             31)


def _ids(s):
    return f"{s[0]}x{s[1]}"


def _u8(rng, shape, levels=256):
    a = rng.integers(0, levels, shape).astype(np.uint8)
    if a.ndim >= 2 and a.shape[1] > 3:
        a[:, 1:a.shape[1] // 2] = a[:, :1]
    return a


def dds_header(width, height, pfflags, fourcc=b"\0\0\0\0", bitcount=0,
               masks=(0, 0, 0, 0)) -> bytes:
    return b"DDS " + struct.pack(
        "<7I", 124, 0x1007, height, width, 0, 0, 0) + bytes(44) \
        + struct.pack("<2I4s5I", 32, pfflags, fourcc, bitcount, *masks) \
        + struct.pack("<5I", 0x1000, 0, 0, 0, 0)


def dds_dx10(width, height, dxgi: int, data: bytes) -> bytes:
    return dds_header(width, height, 4, b"DX10") + struct.pack(
        "<5I", dxgi, 3, 0, 1, 0) + data


def random_blocks(rng, fmt: str, count: int) -> np.ndarray:
    n = BCN[fmt][0]
    blocks = rng.integers(0, 256, (count, bcn.BLOCK[n][0]), dtype=np.uint8)
    if n == 7:  # modes 0-7 by their lowest set bit, and the reserved 0
        k = np.arange(count) % 9
        blocks[:, 0] = np.where(k < 8, (blocks[:, 0] | 1) << k, 0)
    if n == 6:
        codes = np.array(BC6_CODES, np.uint8)
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | codes[np.arange(count)
                                                     % len(codes)]
    return blocks


def _pillow_blocks(fmt: str, blocks: np.ndarray) -> np.ndarray:
    """(count, 16, bands) of Pillow's decode of the blocks in a row."""
    count = len(blocks)
    im = Image.open(io.BytesIO(dds_dx10(4 * count, 4, BCN[fmt][2],
                                        blocks.tobytes())))
    a = np.asarray(im)
    a = a[..., None] if a.ndim == 2 else a
    return a.reshape(4, count, 4, -1).transpose(1, 0, 2, 3).reshape(
        count, 16, -1)


# ---------------------------------------------------------------------------
# BCn blocks: the C++ decoder, its numpy version and Pillow's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fmt", list(BCN))
def test_bcn_blocks_equal_pillow_and_plain(rng, fmt, seed):
    n, signed, _ = BCN[fmt]
    blocks = random_blocks(np.random.default_rng(seed), fmt, 360)
    want = _pillow_blocks(fmt, blocks)
    plain = bcn.decode_blocks(blocks, n, signed)
    assert plain.shape == want.shape
    assert np.array_equal(plain, want)
    native, done = _native.bcn_decode(blocks.tobytes(), 4 * len(blocks), 4,
                                      n, signed, bcn.BLOCK[n][1])
    native = native.reshape(4, len(blocks), 4, -1).transpose(1, 0, 2, 3)
    assert done and np.array_equal(native.reshape(want.shape), want)


@pytest.mark.parametrize("mode", list(range(8)) + ["reserved"])
def test_bc7_every_mode_equals_pillow(rng, mode):
    blocks = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    blocks[:, 0] = 0 if mode == "reserved" else (blocks[:, 0] | 1) << mode
    want = _pillow_blocks("BC7", blocks)
    assert np.array_equal(bcn.decode_blocks(blocks, 7), want)
    assert np.array_equal(bcn.decode_plain(blocks.tobytes(), 256, 4, 7)[0],
                          np.asarray(Image.open(io.BytesIO(dds_dx10(
                              256, 4, 98, blocks.tobytes())))))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("code", BC6_CODES)
def test_bc6h_every_mode_code_equals_pillow(rng, code, signed):
    blocks = rng.integers(0, 256, (48, 16), dtype=np.uint8)
    blocks[:, 0] = (blocks[:, 0] & 0xE0) | code
    fmt = "BC6HS" if signed else "BC6H"
    want = _pillow_blocks(fmt, blocks)
    assert np.array_equal(bcn.decode_blocks(blocks, 6, signed), want)


@pytest.mark.parametrize("fmt", ["BC5S", "BC6HS"])
def test_signed_formats_ends_equal_pillow(fmt):
    """The signed end points' extremes: -128 / 127 bytes for BC5S, the
    sign bits of every BC6HS end point and delta."""
    n, signed, _ = BCN[fmt]
    rows = []
    for a0 in (0x80, 0x7F, 0x00, 0xFF, 0x81):
        for a1 in (0x80, 0x7F, 0x00, 0xFF, 0x81):
            if n == 5:
                rows.append([a0, a1] + [0x88] * 6 + [a1, a0] + [0x1F] * 6)
            else:
                rows.append([0x0B, a0, a1, a0, a1, a0, a1, a0, a1, 0xFF,
                             0x80, 0x7F, a0, a1, 0, 0])
                rows.append([0x02, a0, a1, a0, a1, a0, a1, a0, a1, a0, a1,
                             a0, a1, a0, a1, 0x55])
    blocks = np.array(rows, np.uint8)
    want = _pillow_blocks(fmt, blocks)
    assert np.array_equal(bcn.decode_blocks(blocks, n, signed), want)
    native, _ = _native.bcn_decode(blocks.tobytes(), 4 * len(blocks), 4, n,
                                   signed, bcn.BLOCK[n][1])
    assert np.array_equal(native.reshape(4, len(blocks), 4, -1).transpose(
        1, 0, 2, 3).reshape(want.shape), want)


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (9, 13), (4, 130)],
                         ids=_ids)
@pytest.mark.parametrize("fmt", list(BCN))
def test_dds_dx10_bcn_equals_jax(tmp_path, rng, fmt, size):
    h, w = size
    n = BCN[fmt][0]
    count = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = random_blocks(rng, fmt, count)
    path = write(tmp_path, dds_dx10(w, h, BCN[fmt][2], blocks.tobytes()),
                 "a.dds")
    got = agree(path, True)
    want = bcn.decode_plain(blocks.tobytes(), w, h, n, BCN[fmt][1])[0]
    assert np.array_equal(got[..., 0] if want.ndim == 2 else got, want)


FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4",
           b"ATI1": "BC4", b"BC5U": "BC5", b"ATI2": "BC5", b"BC5S": "BC5S"}


@pytest.mark.parametrize("fourcc", list(FOURCCS))
def test_dds_fourcc_equals_jax(tmp_path, rng, fourcc):
    fmt = FOURCCS[fourcc]
    blocks = random_blocks(rng, fmt, 12)
    path = write(tmp_path, dds_header(13, 9, 4, fourcc) + blocks.tobytes(),
                 "f.dds")
    agree(path, True)


# ---------------------------------------------------------------------------
# DDS: what Pillow writes, and the uncompressed forms written here
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pillow_dds_raw_equals_jax(tmp_path, rng, mode, size):
    a = _u8(rng, size + ((len(mode),) if len(mode) > 1 else ()))
    path = write(tmp_path, pil_bytes(Image.fromarray(a, mode), "DDS"), "r.dds")
    got = agree(path, True)
    assert np.array_equal(got[..., 0] if mode == "L" else got, a)


@pytest.mark.parametrize("size", [(4, 4), (5, 7), (13, 4)], ids=_ids)
@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5", "BC2", "BC3",
                                 "BC5"])
def test_pillow_dds_bcn_equals_jax(tmp_path, rng, fmt, size):
    mode = "RGB" if fmt == "BC5" else "RGBA"
    a = _u8(rng, size + (len(mode),))
    blob = pil_bytes(Image.fromarray(a, mode), "DDS", pixel_format=fmt)
    agree(write(tmp_path, blob, "b.dds"), True)


MASKS = {
    "bgr 24": (24, 0x40, (0xFF0000, 0xFF00, 0xFF)),
    "565": (16, 0x40, (0xF800, 0x7E0, 0x1F)),
    "4444": (16, 0x41, (0xF00, 0xF0, 0xF, 0xF000)),
    "1555": (16, 0x41, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    "gappy": (16, 0x40, (0x5, 0xA0, 0x0)),
    "10 10 10 2": (32, 0x41, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)),
    "wide pixels": (48, 0x40, (0xFF, 0xFF00, 0xFF0000)),
    "under a byte": (4, 0x40, (0x3, 0xC, 0x0)),
}


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("cut", [0, 5])
def test_dds_masked_rgb_equals_jax(tmp_path, rng, name, cut):
    bits, flags, masks = MASKS[name]
    w, h = 6, 5
    data = rng.integers(0, 256, max(1, bits // 8) * w * h,
                        dtype=np.uint8).tobytes()
    blob = dds_header(w, h, flags, bitcount=bits,
                      masks=masks + (0,) * (4 - len(masks))) + data
    agree(write(tmp_path, blob[:len(blob) - cut], "m.dds"), True)


@pytest.mark.parametrize("palette_bytes", [1024, 600, 0])
def test_dds_palette_equals_jax(tmp_path, rng, palette_bytes):
    w, h = 7, 5
    pal = rng.integers(0, 256, palette_bytes, dtype=np.uint8).tobytes()
    idx = rng.integers(0, 256, (h, w), dtype=np.uint8)
    blob = dds_header(w, h, 0x20, bitcount=8) + pal + idx.tobytes()
    agree(write(tmp_path, blob, "p.dds"))


@pytest.mark.parametrize("dxgi", [27, 28, 29])
def test_dds_dx10_rgba_equals_jax(tmp_path, rng, dxgi):
    a = _u8(rng, (5, 7, 4))
    got = agree(write(tmp_path, dds_dx10(7, 5, dxgi, a.tobytes()), "x.dds"),
                True)
    assert np.array_equal(got, a)


DDS_CASES = {
    "header 120": lambda: b"DDS " + struct.pack("<I", 120) + bytes(120),
    "header cut": lambda: dds_header(4, 4, 0x40, bitcount=24)[:100],
    "fourcc DXT2": lambda: dds_header(4, 4, 4, b"DXT2") + bytes(16),
    "dxgi BC4 snorm": lambda: dds_dx10(4, 4, 81, bytes(8)),
    "dxgi BC1 srgb": lambda: dds_dx10(4, 4, 72, bytes(8)),
    "dxgi float": lambda: dds_dx10(4, 4, 2, bytes(256)),
    "no flags": lambda: dds_header(4, 4, 0) + bytes(64),
    "luminance 16": lambda: dds_header(4, 4, 0x20000, bitcount=16)
    + bytes(32),
    "bcn short": lambda: dds_header(8, 8, 4, b"DXT1") + bytes(24),
    "raw short": lambda: dds_header(4, 4, 0x20000, bitcount=8) + bytes(15),
    "dx10 cut": lambda: dds_header(4, 4, 4, b"DX10") + b"\x47",
    "only magic": lambda: b"DDS \x7c",
}


@pytest.mark.parametrize("name", list(DDS_CASES))
def test_dds_cases_agree_with_jax(tmp_path, name):
    agree(write(tmp_path, DDS_CASES[name](), "c.dds"))


def test_dds_bit_flips_agree_with_jax(tmp_path, rng):
    blocks = random_blocks(rng, "BC3", 6)
    blob = dds_header(11, 6, 4, b"DXT5") + blocks.tobytes()
    for k, b in enumerate(flips(blob, rng, 30, 0, 128)):
        agree(write(tmp_path, b, f"f{k}.dds"))
    blob = dds_header(5, 3, 0x41, bitcount=32,
                      masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) \
        + _u8(rng, (3, 5, 4)).tobytes()
    for k, b in enumerate(flips(blob, rng, 20, 76, 128)):
        agree(write(tmp_path, b, f"g{k}.dds"))


# ---------------------------------------------------------------------------
# FTEX
# ---------------------------------------------------------------------------
def ftex_write(width, height, fmt: int, data: bytes, count=1) -> bytes:
    where = 32
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, width, height, 1, count,
                                  fmt, where)
            + struct.pack("<i", len(data)) + data)


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("fmt", [0, 1])
def test_ftex_equals_jax(tmp_path, rng, fmt, size):
    h, w = size
    if fmt == 0:
        data = random_blocks(rng, "BC1", ((w + 3) // 4) * ((h + 3) // 4))
        data = data.tobytes()
    else:
        data = _u8(rng, (h, w, 3)).tobytes()
    agree(write(tmp_path, ftex_write(w, h, fmt, data), "a.ftc"), True)


FTEX_CASES = {
    "format 2": lambda: ftex_write(4, 4, 2, bytes(48)),
    "two formats": lambda: ftex_write(4, 4, 0, bytes(8), count=2),
    "short": lambda: ftex_write(8, 8, 0, bytes(24)),
    "negative size": lambda: ftex_write(4, 4, 1, bytes(48))[:32]
    + struct.pack("<i", -1) + bytes(48),
    "size -7": lambda: ftex_write(4, 4, 1, bytes(48))[:32]
    + struct.pack("<i", -7) + bytes(48),
    "negative offset": lambda: ftex_write(4, 4, 1, bytes(48))[:28]
    + struct.pack("<i", -4) + bytes(52),
    "cut header": lambda: b"FTEX" + bytes(10),
}


@pytest.mark.parametrize("name", list(FTEX_CASES))
def test_ftex_cases_agree_with_jax(tmp_path, name):
    agree(write(tmp_path, FTEX_CASES[name](), "c.ftc"))


# ---------------------------------------------------------------------------
# BLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("alpha", [False, True])
def test_pillow_blp_equals_jax(tmp_path, rng, version, alpha, size):
    a = _u8(rng, size, 40)
    im = Image.fromarray(a, "L").convert("P")
    pal = rng.integers(0, 256, 1024 if alpha else 768, dtype=np.uint8)
    im.putpalette(pal.tobytes(), "RGBA" if alpha else "RGB")
    blob = pil_bytes(im, "BLP", blp_version=version)
    got = agree(write(tmp_path, blob, "a.blp"), True)
    assert got.shape == size + (4 if alpha else 3,)


def blp2(width, height, encoding, alpha, alpha_encoding, data: bytes,
         palette=b"") -> bytes:
    offset = 20 + 128 + 1024
    return (b"BLP2" + struct.pack("<i4b", 1, encoding, alpha, alpha_encoding,
                                  0)
            + struct.pack("<II", width, height)
            + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(data), *[0] * 15)
            + palette.ljust(1024, b"\0") + data)


@pytest.mark.parametrize("size", [(4, 4), (5, 7), (13, 4), (3, 130)],
                         ids=_ids)
@pytest.mark.parametrize("kind,alpha_encoding", [(1, 0), (2, 1), (3, 7)])
@pytest.mark.parametrize("alpha", [0, 8])
def test_blp2_dxt_equals_jax(tmp_path, rng, kind, alpha_encoding, alpha,
                             size):
    h, w = size
    count = ((w + 3) // 4) * ((h + 3) // 4)
    data = random_blocks(rng, f"BC{kind}", count).tobytes()
    agree(write(tmp_path, blp2(w, h, 2, alpha, alpha_encoding, data),
                "d.blp"), True)


def test_blp_dxt_differs_from_bcn_on_one_block(tmp_path):
    """The same DXT1 block through BLP2 (Pillow's Python decode_dxt1) and
    DDS (the bcn decoder): the 5-6-5 colours are shifted in one and widened
    in the other."""
    block = struct.pack("<HHI", 0xFFFF, 0x0841, 0xE4E4E4E4)
    via_blp = agree(write(tmp_path, blp2(4, 4, 2, 8, 0, block), "b.blp"),
                    True)
    via_dds = agree(write(tmp_path, dds_header(4, 4, 4, b"DXT1") + block,
                          "d.dds"), True)
    assert via_blp[0, 0, 0] == 248 and via_dds[0, 0, 0] == 255
    assert not np.array_equal(via_blp, via_dds)
    plain = blp._dxt(block, 1, 1, 1, True)
    assert np.frombuffer(plain, np.uint8)[:4].tolist() == [248, 252, 248, 255]


def blp1_jpeg(width, height, jpeg: bytes, alpha=0, split=20) -> bytes:
    header, body = jpeg[:split], jpeg[split:]
    offset = 28 + 128 + 4 + len(header) + 3
    return (b"BLP1" + struct.pack("<iI", 0, alpha)
            + struct.pack("<II", width, height) + struct.pack("<ii", 5, 0)
            + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15)
            + struct.pack("<I", len(header)) + header + b"pad" + body)


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
@pytest.mark.parametrize("alpha", [0, 1])
def test_blp1_jpeg_equals_jax(tmp_path, rng, mode, alpha):
    a = _u8(rng, (16, 24, len(mode)) if len(mode) > 1 else (16, 24))
    jpg = pil_bytes(Image.fromarray(a, mode), "JPEG", quality=95)
    agree(write(tmp_path, blp1_jpeg(24, 16, jpg, alpha), "j.blp"), True)


@pytest.mark.parametrize("transform", ["adobe cmyk", "adobe ycck", "cmyk"])
def test_blp1_jpeg_colour_transform_equals_jax(tmp_path, rng, transform):
    """Pillow tells libjpeg a BLP's four-component JPEG holds CMYK, so an
    Adobe YCCK file's samples are not converted."""
    from test_torch_decoders import TRANSFORMS, _coded_jpeg, _planes

    n, app, ids = TRANSFORMS[transform]
    factors = [(1, 1)] * n
    jpg = _coded_jpeg(_planes(rng, 16, 24, factors), factors, ids=ids,
                      app=app)
    agree(write(tmp_path, blp1_jpeg(24, 16, jpg), "y.blp"), True)


BLP_CASES = {
    "jpeg smaller": lambda r: blp1_jpeg(24, 17, pil_bytes(
        Image.fromarray(_u8(r, (16, 24))), "JPEG")),
    "jpeg other width": lambda r: blp1_jpeg(12, 16, pil_bytes(
        Image.fromarray(_u8(r, (16, 24))), "JPEG")),
    "not jpeg": lambda r: blp1_jpeg(4, 4, b"\xff\xd9" + bytes(40)),
    "blp1 encoding 3": lambda r: b"BLP1" + struct.pack("<iIIIii", 1, 0, 4, 4,
                                                       3, 0) + bytes(1300),
    "blp2 compression 2": lambda r: blp2(4, 4, 1, 0, 0, bytes(16))[:4]
    + struct.pack("<i", 2) + blp2(4, 4, 1, 0, 0, bytes(16))[8:],
    "blp2 encoding 3": lambda r: blp2(4, 4, 3, 0, 0, bytes(64)),
    "blp2 alpha encoding 2": lambda r: blp2(4, 4, 2, 8, 2, bytes(16)),
    "palette short": lambda r: blp2(4, 4, 1, 0, 0, b"")[:700],
    "indices short": lambda r: blp2(4, 4, 1, 0, 0, bytes(10)),
    "dxt short": lambda r: blp2(8, 8, 2, 0, 0, bytes(24)),
    "dxt3 as rgb": lambda r: blp2(5, 3, 2, 0, 1, r.integers(
        0, 256, 32, dtype=np.uint8).tobytes()),
    "bad magic": lambda r: b"BLP3" + bytes(200),
    "cut header": lambda r: b"BLP2" + bytes(9),
}


@pytest.mark.parametrize("name", list(BLP_CASES))
def test_blp_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, BLP_CASES[name](rng), "c.blp"))


def test_blp_bit_flips_agree_with_jax(tmp_path, rng):
    data = random_blocks(rng, "BC3", 6).tobytes()
    blob = blp2(11, 6, 2, 8, 7, data, rng.integers(0, 256, 1024,
                                                   dtype=np.uint8).tobytes())
    for k, b in enumerate(flips(blob, rng, 30, 0, 148)):
        agree(write(tmp_path, b, f"f{k}.blp"))
