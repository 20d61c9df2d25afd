"""The port's readers of Pillow 12.1's bitmap containers (io/bmp's DIB,
io/ico for ICO and CUR, io/icns with the run-length loop of
sarpro_tpu_torch/_native/rledec.cpp) against the JAX package's
RasterReader, which opens the same files through Pillow, on the CPU: every
band equal bit for bit, the dtype, size, gdal_metadata() and
georeferencing equal, or both readers refuse the file.

Inputs are made from seeds with numpy and written by Pillow where it writes
the format (DIB, ICO with PNG and BMP frames, ICNS with PNG blocks); CUR
files, ICO tables Pillow does not write and ICNS's run-length and JPEG
2000 blocks are written here field by field. Pillow's quirks are kept: the
least colour depth among the largest icons is the one read, a 32-bit
icon's alpha taken from its pixels where its entry says 32 bits, a cursor's
32-bit bitmap at offset 22 read as BGRA."""
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from test_torch_science_rasters import (  # noqa: E402
    agree,
    flips,
    pil_bytes,
    write,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SIZES = ((1, 1), (5, 7), (13, 4), (3, 130))
MODES = ["1", "L", "P", "RGB", "RGBA"]


def _ids(s):
    return f"{s[0]}x{s[1]}"


def _u8(rng, shape, levels=256):
    a = rng.integers(0, levels, shape).astype(np.uint8)
    if a.ndim >= 2 and a.shape[1] > 3:
        a[:, 1:a.shape[1] // 2] = a[:, :1]
    return a


def _image(rng, mode, size):
    h, w = size
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, size).astype(bool))
    if mode == "L":
        return Image.fromarray(_u8(rng, size))
    if mode == "P":
        im = Image.fromarray(_u8(rng, size, 12)).convert("P")
        im.putpalette(rng.integers(0, 256, 36, dtype=np.uint8).tobytes())
        return im
    return Image.fromarray(_u8(rng, size + (len(mode),)), mode)


def _format(path) -> str:
    with Image.open(path) as im:
        return im.format


# ---------------------------------------------------------------------------
# DIB: a bitmap without its file header
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("mode", MODES[:4])
def test_pillow_dib_equals_jax(tmp_path, rng, mode, size):
    path = write(tmp_path, pil_bytes(_image(rng, mode, size), "DIB"),
                 "a.dib")
    assert _format(path) == "DIB"
    agree(path, True)


def _dib(width, height, bits, data: bytes, *, header=40, compression=0,
         palette=b"", masks=b"", colors=0) -> bytes:
    if header == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0)
        head += bytes(header - 40) if header > 40 else b""
    return head + masks + palette + data


DIB_CASES = {
    "bgra 32": lambda r: _dib(3, 2, 32, _u8(r, (2, 3, 4)).tobytes()),
    "top-down": lambda r: _dib(4, -2, 24, _u8(r, (2, 12)).tobytes()),
    "bitfields 565": lambda r: _dib(2, 2, 16, _u8(r, (2, 4)).tobytes(),
                                    compression=3, masks=struct.pack(
                                        "<3I", 0xF800, 0x7E0, 0x1F)),
    "v5 rgba": lambda r: _dib(2, 2, 32, _u8(r, (2, 8)).tobytes(), header=124,
                              compression=3)[:40] + struct.pack(
        "<4I", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + bytes(68)
    + _u8(r, (2, 8)).tobytes(),
    "rle8": lambda r: _dib(4, 2, 8, b"\x04\x01\x00\x00\x02\x02\x02\x03"
                           b"\x00\x01", compression=1, palette=_u8(
                               r, (256, 4)).tobytes()),
    "os2": lambda r: _dib(3, 2, 24, _u8(r, (2, 12)).tobytes(), header=12),
    "masks cut": lambda r: _dib(2, 2, 16, b"", compression=3,
                                masks=b"\x00\xf8"),
    "depth 7": lambda r: _dib(2, 2, 7, bytes(16)),
    "short": lambda r: _dib(4, 4, 24, bytes(40)),
    "palette short": lambda r: _dib(4, 1, 8, b"", palette=bytes(30)),
}


@pytest.mark.parametrize("name", list(DIB_CASES))
def test_dib_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, DIB_CASES[name](rng), "c.dib"))


# ---------------------------------------------------------------------------
# ICO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frames", ["bmp", "png"])
@pytest.mark.parametrize("mode", MODES)
def test_pillow_ico_equals_jax(tmp_path, rng, mode, frames):
    im = _image(rng, mode, (20, 30))
    blob = pil_bytes(im, "ICO", sizes=[(16, 16), (32, 32), (8, 8)],
                     bitmap_format=frames)
    path = write(tmp_path, blob, "a.ico")
    with Image.open(path) as im:
        size = im.size
    got = agree(path, True)
    assert got.shape[:2] == size[::-1]


def ico_write(frames: list) -> bytes:
    """An ICO of (entry width, entry height, bpp, colours, frame bytes, size
    or None for the frame's) frames, in order."""
    head = struct.pack("<HHH", 0, 1, len(frames))
    offset = 6 + 16 * len(frames)
    table, body = b"", b""
    for w, h, bpp, colours, data, size in frames:
        table += struct.pack("<BBBBHHII", w & 255, h & 255, colours, 0, 1,
                             bpp, len(data) if size is None else size,
                             offset + len(body))
        body += data
    return head + table + body


def icon_dib(rgb: np.ndarray, bits: int, mask: np.ndarray = None,
             palette: np.ndarray = None) -> bytes:
    """An icon frame: a 40-byte DIB header of twice the height, the pixels
    bottom-up (BGR(A), or palette indices), then the AND mask."""
    h, w = rgb.shape[:2]
    if bits <= 8:
        pal = palette.astype(np.uint8)
        table = np.concatenate([pal[:, ::-1], np.zeros((len(pal), 1),
                                                       np.uint8)], 1)
        idx = rgb.astype(np.uint8)
        stride = ((w * bits + 31) >> 3) & ~3
        lines = np.zeros((h, stride), np.uint8)
        packed = np.packbits(np.unpackbits(idx[..., None], axis=2)[
            ..., 8 - bits:].reshape(h, -1), axis=1)
        lines[:, :packed.shape[1]] = packed
        data, pal_bytes = lines[::-1].tobytes(), table.tobytes()
    else:
        n = bits // 8
        px = rgb[..., [2, 1, 0] + ([3] if n == 4 else [])]
        stride = ((w * bits + 31) >> 3) & ~3
        lines = np.zeros((h, stride), np.uint8)
        lines[:, :w * n] = px.reshape(h, -1)
        data, pal_bytes = lines[::-1].tobytes(), b""
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       len(pal_bytes) // 4 if bits <= 8 else 0, 0)
    if mask is None:
        mask = np.zeros((h, w), bool)
    mstride = ((w + 31) // 32) * 4
    mlines = np.zeros((h, mstride), np.uint8)
    packed = np.packbits(mask, axis=1)
    mlines[:, :packed.shape[1]] = packed
    return head + pal_bytes + data + mlines[::-1].tobytes()


def _ico_cases(r) -> dict:
    rgba = _u8(r, (6, 5, 4))
    rgb = _u8(r, (6, 5, 3))
    mask = r.integers(0, 2, (6, 5)).astype(bool)
    pal = _u8(r, (16, 3))
    idx = r.integers(0, 16, (6, 5))
    big = _u8(r, (9, 10, 3))
    frame32 = icon_dib(rgba, 32)
    frame24 = icon_dib(rgb, 24, mask)
    frame4 = icon_dib(idx, 4, mask, pal)
    frame1 = icon_dib(r.integers(0, 2, (6, 5)), 1, mask,
                      np.array([[0, 0, 0], [255, 255, 255]]))
    png = pil_bytes(Image.fromarray(big), "PNG")
    return {
        "32 bit": ico_write([(5, 6, 32, 0, frame32, None)]),
        "24 bit mask": ico_write([(5, 6, 24, 0, frame24, None)]),
        "4 bit": ico_write([(5, 6, 4, 16, frame4, None)]),
        "1 bit": ico_write([(5, 6, 1, 2, frame1, None)]),
        "least depth first": ico_write([(5, 6, 32, 0, frame32, None),
                                        (5, 6, 24, 0, frame24, None)]),
        "largest first": ico_write([(5, 6, 24, 0, frame24, None),
                                    (10, 9, 0, 0, png, None)]),
        "colour count depth": ico_write([(5, 6, 0, 16, frame4, None),
                                         (5, 6, 0, 0, frame24, None)]),
        "entry says 32": ico_write([(5, 6, 32, 0, frame24, None)]),
        "entry size short": ico_write([(5, 6, 24, 0, frame24,
                                        len(frame24) - 8)]),
        "entry size long": ico_write([(5, 6, 24, 0, frame24,
                                       len(frame24) + 400)]),
        "frame not its entry's size": ico_write([(7, 7, 24, 0, frame24,
                                                  None)]),
        "png frame": ico_write([(10, 9, 32, 0, png, None)]),
        "no entries": struct.pack("<HHH", 0, 1, 0),
        "table cut": ico_write([(5, 6, 24, 0, frame24, None)])[:15],
        "frame cut": ico_write([(5, 6, 24, 0, frame24, None)])[:-60],
        "bad dib header": ico_write([(5, 6, 24, 0, b"\x20\0\0\0"
                                      + frame24[4:], None)]),
        "height 1": ico_write([(5, 1, 24, 0, icon_dib(rgb[:1], 24)[:4]
                                + struct.pack("<i", 5) + struct.pack(
                                    "<i", 1) + icon_dib(rgb[:1], 24)[12:],
                                None)]),
    }


@pytest.mark.parametrize("name", list(_ico_cases(np.random.default_rng(0))))
def test_ico_cases_agree_with_jax(tmp_path, rng, name):
    path = write(tmp_path, _ico_cases(rng)[name], "c.ico")
    agree(path)


def test_ico_bit_flips_agree_with_jax(tmp_path, rng):
    cases = _ico_cases(rng)
    for which in ("least depth first", "4 bit", "largest first"):
        for k, b in enumerate(flips(cases[which], rng, 30, 4)):
            agree(write(tmp_path, b, f"f{k}.ico"))


# ---------------------------------------------------------------------------
# CUR
# ---------------------------------------------------------------------------
def cur_write(frames: list, offset_zero=False) -> bytes:
    """A CUR of (width, height, frame bytes) frames; with `offset_zero` the
    first entry's offset is 0 (its bitmap then read after the table)."""
    head = struct.pack("<HHH", 0, 2, len(frames))
    offset = 6 + 16 * len(frames)
    table, body = b"", b""
    for k, (w, h, data) in enumerate(frames):
        at = 0 if offset_zero and k == 0 else offset + len(body)
        table += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 1, len(data), at)
        body += data
    return head + table + body


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("size", [(6, 5), (1, 1), (3, 33)], ids=_ids)
def test_cur_equals_jax(tmp_path, rng, bits, size):
    h, w = size
    if bits <= 8:
        frame = icon_dib(rng.integers(0, 1 << bits, size), bits,
                         palette=_u8(rng, (1 << bits, 3)))
    else:
        frame = icon_dib(_u8(rng, size + (bits // 8,)), bits)
    path = write(tmp_path, cur_write([(w, h, frame)]), "a.cur")
    assert _format(path) == "CUR"
    agree(path, True)


def _cur_cases(r) -> dict:
    small = icon_dib(_u8(r, (4, 4, 3)), 24)
    large = icon_dib(_u8(r, (6, 8, 4)), 32)
    wide = icon_dib(_u8(r, (4, 9, 3)), 24)
    return {
        "largest": cur_write([(4, 4, small), (8, 6, large)]),
        "wider only": cur_write([(4, 4, small), (9, 4, wide)]),
        "offset zero": cur_write([(4, 4, small)], offset_zero=True),
        "32 bit not at 22": cur_write([(4, 4, small), (8, 6, large)]),
        "no cursors": struct.pack("<HHH", 0, 2, 0) + bytes(40),
        "bitmap cut": cur_write([(4, 4, small)])[:-20],
    }


@pytest.mark.parametrize("name", list(_cur_cases(np.random.default_rng(0))))
def test_cur_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, _cur_cases(rng)[name], "c.cur"))


def test_cur_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _cur_cases(rng)["largest"]
    for k, b in enumerate(flips(blob, rng, 30, 4, 120)):
        agree(write(tmp_path, b, f"f{k}.cur"))


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------
def icns_write(blocks: list) -> bytes:
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data
                    for kind, data in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rle(channel: np.ndarray) -> bytes:
    """read_32's run-length coding of one channel: runs of 3 to 130 equal
    bytes, literals of 1 to 128."""
    flat = channel.reshape(-1)
    out, i = b"", 0
    while i < len(flat):
        j = i
        while j < len(flat) and flat[j] == flat[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + j - i - 3, flat[i]])
        else:
            j = min(i + 128, len(flat))
            k = i + 1
            while k < j and not (k + 2 < len(flat) and flat[k] == flat[k + 1]
                                 == flat[k + 2]):
                k += 1
            j = k
            out += bytes([j - i - 1]) + flat[i:j].tobytes()
        i = j
    return out


RLE_KINDS = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"),
             48: (b"ih32", b"h8mk"), 128: (b"it32", b"t8mk")}


def _rgb_block(rgb: np.ndarray, kind: bytes, raw=False) -> bytes:
    data = rgb.tobytes() if raw else b"".join(
        icns_rle(rgb[..., k]) for k in range(3))
    return (bytes(4) if kind == b"it32" else b"") + data


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("side", [16, 32, 48, 128])
def test_icns_rgb_blocks_equal_jax(tmp_path, rng, side, raw, mask):
    rgb = _u8(rng, (side, side, 3), 8)
    kind, mkind = RLE_KINDS[side]
    blocks = [(kind, _rgb_block(rgb, kind, raw))]
    if mask:
        blocks.append((mkind, _u8(rng, (side, side)).tobytes()))
    path = write(tmp_path, icns_write(blocks), "a.icns")
    got = agree(path, True)
    assert np.array_equal(got[..., :3], rgb)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P"])
def test_icns_png_block_equals_jax(tmp_path, rng, mode):
    im = _image(rng, mode, (32, 32))
    blob = icns_write([(b"icp5", pil_bytes(im, "PNG"))])
    agree(write(tmp_path, blob, "p.icns"), True)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_icns_jpeg2000_block_equals_jax(tmp_path, rng, mode):
    im = _image(rng, mode, (16, 16))
    j2k = pil_bytes(im, "JPEG2000", irreversible=False, no_jp2=True)
    agree(write(tmp_path, icns_write([(b"icp4", j2k)]), "j.icns"), True)


def test_pillow_icns_equals_jax(tmp_path, rng):
    im = Image.fromarray(_u8(rng, (64, 64, 4)), "RGBA")
    path = write(tmp_path, pil_bytes(im, "ICNS"), "w.icns")
    agree(path, True)


def _icns_cases(r) -> dict:
    rgb = _u8(r, (16, 16, 3), 8)
    rle = _rgb_block(rgb, b"is32")
    png32 = pil_bytes(Image.fromarray(_u8(r, (32, 32, 4)), "RGBA"), "PNG")
    png64 = pil_bytes(Image.fromarray(_u8(r, (64, 64, 4)), "RGBA"), "PNG")
    return {
        "largest size": icns_write([(b"is32", rle), (b"icp5", png32)]),
        "png of another size": icns_write([(b"icp5", png64)]),
        "png of a listed size": icns_write([(b"icp5", png64),
                                            (b"icp6", png64)]),
        "png and rle": icns_write([(b"ic07", pil_bytes(Image.fromarray(
            _u8(r, (128, 128, 4)), "RGBA"), "PNG")), (b"it32", bytes(4))]),
        "it32 signature": icns_write([(b"it32", b"\1\0\0\0" + bytes(60))]),
        "mask only": icns_write([(b"s8mk", bytes(256))]),
        "rle overrun": icns_write([(b"is32", b"\xff\x01" * 200)]),
        "rle short": icns_write([(b"is32", rle[:-30])]),
        "mask short": icns_write([(b"is32", rle), (b"s8mk", bytes(100))]),
        "unknown subimage": icns_write([(b"icp4", b"GIF89a" + bytes(40))]),
        "no sizes": icns_write([(b"TOC ", bytes(8))]),
        "block size 0": b"icns" + struct.pack(">I", 100) + b"is32" + bytes(4),
        "size past data": b"icns" + struct.pack(">I", 1000) + b"is32"
        + struct.pack(">I", 8 + len(rle)) + rle,
        "small block": icns_write([(b"is32", rle)])[:8] + b"s8mk"
        + struct.pack(">I", 4) + icns_write([(b"is32", rle)])[8:],
    }


@pytest.mark.parametrize("name", list(_icns_cases(np.random.default_rng(0))))
def test_icns_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, _icns_cases(rng)[name], "c.icns"))


def test_icns_bit_flips_agree_with_jax(tmp_path, rng):
    rgb = _u8(rng, (16, 16, 3), 8)
    blob = icns_write([(b"is32", _rgb_block(rgb, b"is32")),
                       (b"s8mk", _u8(rng, (16, 16)).tobytes())])
    for k, b in enumerate(flips(blob, rng, 40)):
        agree(write(tmp_path, b, f"f{k}.icns"))
