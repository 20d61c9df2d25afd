"""The port's readers of the small legacy formats Pillow 12.1 opens (io/xbm,
io/xpm, io/msp, io/pixar, io/gbr, io/fli, io/pcd, io/xvthumb, io/imt,
io/iptc, and the C++ loops of sarpro_tpu_torch/_native/rledec.cpp) against
the JAX package's RasterReader, which opens the same files through Pillow,
on the CPU: every band equal bit for bit, the dtype, size, gdal_metadata()
and georeferencing equal, or both readers refuse the file.

Inputs are made from seeds with numpy and written by Pillow where it writes
the format (XBM, MSP version 1); the rest are written here field by field.
Pillow's quirks are kept: XBM's bytes read least significant bit first,
MSP's run-length rows read as one byte stream, an FLI frame decoded at
offset 128 even past a prefix chunk, PhotoCD's YCC tables, IMT and IPTC
tried on every file that reaches them."""
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_avif  # noqa: E402
from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import pcd, pilraster  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_science_rasters import (  # noqa: E402
    agree,
    flips,
    pil_bytes,
    write,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SIZES = ((1, 1), (5, 7), (13, 4), (3, 130))


def _ids(s):
    return f"{s[0]}x{s[1]}"


def _u8(rng, shape, levels=256):
    a = rng.integers(0, levels, shape).astype(np.uint8)
    if a.ndim >= 2 and a.shape[1] > 3:
        a[:, 1:a.shape[1] // 2] = a[:, :1]
    return a


def _format(path) -> str:
    with Image.open(path) as im:
        return im.format


# ---------------------------------------------------------------------------
# XBM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_pillow_xbm_equals_jax(tmp_path, rng, size):
    a = rng.integers(0, 2, size).astype(bool)
    path = write(tmp_path, pil_bytes(Image.fromarray(a), "XBM"), "a.xbm")
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


def _xbm(width, height, data: bytes, hot=None, sep=b", ") -> bytes:
    head = b"#define im_width %d\n#define im_height %d\n" % (width, height)
    if hot:
        head += b"#define im_x_hot %d\n#define im_y_hot %d\n" % hot
    body = sep.join(b"0x%02x" % v for v in data)
    return head + b"static char im_bits[] = {\n" + body + b"\n};\n"


XBM_CASES = {
    "hotspot": lambda r: _xbm(9, 3, bytes(r.integers(0, 256, 6)), (2, 1)),
    "upper hex": lambda r: _xbm(8, 2, b"\xab\xcd").replace(b"0xab", b"0XAB"),
    "one digit": lambda r: _xbm(8, 2, b"\x05\x06", sep=b",").replace(
        b"0x05", b"0x5"),
    "no hex": lambda r: _xbm(8, 2, b"\x00\x01").replace(b"0x00", b"0xzz"),
    "short": lambda r: _xbm(8, 3, b"\x01\x02"),
    "leading space": lambda r: b"  \n" + _xbm(4, 1, b"\x0f"),
    "two bits arrays": lambda r: _xbm(8, 1, b"\x01") + b"x_bits[] 0x7f",
    "header past 512": lambda r: b"#define a_width 8\n" + b" " * 520
    + b"#define a_height 1\nx_bits[] = {0x01};",
}


@pytest.mark.parametrize("name", list(XBM_CASES))
def test_xbm_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, XBM_CASES[name](rng), "c.xbm"))


def test_xbm_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _xbm(13, 4, bytes(rng.integers(0, 256, 8)))
    for k, b in enumerate(flips(blob, rng, 40)):
        agree(write(tmp_path, b, f"f{k}.xbm"))


# ---------------------------------------------------------------------------
# XPM
# ---------------------------------------------------------------------------
def _xpm(width, height, colours: list, rows: list, cpp=1,
         pixels_comment=True) -> bytes:
    out = [b"/* XPM */", b"static char *x[] = {",
           b'"%d %d %d %d",' % (width, height, len(colours), cpp)]
    out += [b'"%s c %s",' % (k, v) for k, v in colours]
    if pixels_comment:
        out.append(b"/* pixels */")
    out += [b'"%s",' % r for r in rows]
    return b"\n".join(out) + b"\n};\n"


def _xpm_image(rng, width, height, ncolours, cpp=1):
    chars = [bytes([c]) for c in range(ord("!"), ord("~")) if c != ord('"')]
    keys = []
    while len(keys) < ncolours:
        k = b"".join(rng.choice(chars, cpp))
        if k not in keys:
            keys.append(k)
    colours = [(k, b"#%06x" % int(rng.integers(0, 1 << 24))) for k in keys]
    idx = rng.integers(0, ncolours, (height, width))
    rows = [b"".join(keys[i] for i in r) for r in idx]
    return colours, rows


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("ncolours,cpp", [(2, 1), (16, 1), (40, 2),
                                          (300, 2)])
def test_xpm_equals_jax(tmp_path, rng, size, ncolours, cpp):
    h, w = size
    colours, rows = _xpm_image(rng, w, h, ncolours, cpp)
    got = agree(write(tmp_path, _xpm(w, h, colours, rows, cpp), "a.xpm"),
                True)
    assert got.shape == (h, w, 3)


XPM_CASES = {
    "None colour": lambda r: _xpm(2, 1, [(b"a", b"None"), (b"b", b"#ff0000")],
                                  [b"bb"]),
    "None used": lambda r: _xpm(2, 1, [(b"a", b"None"), (b"b", b"#ff0000")],
                                [b"ab"]),
    "named colour": lambda r: _xpm(1, 1, [(b"a", b"red")], [b"a"]),
    "no c key": lambda r: _xpm(1, 1, [(b"a", b"#ff0000")], [b"a"]).replace(
        b"a c #", b"a m #"),
    "unknown key": lambda r: _xpm(2, 1, [(b"a", b"#102030")], [b"ax"]),
    "short rows": lambda r: _xpm(4, 2, [(b"a", b"#102030")], [b"aa", b"aaaa"]),
    "too few rows": lambda r: _xpm(2, 3, [(b"a", b"#102030")], [b"aa"]),
    "no pixels comment": lambda r: _xpm(2, 1, [(b"a", b"#102030"),
                                               (b"b", b"#405060")], [b"ab"],
                                        pixels_comment=False),
    "repeated key": lambda r: _xpm(2, 1, [(b"a", b"#102030"),
                                          (b"a", b"#405060"),
                                          (b"b", b"#708090")], [b"ba"]),
    "no values line": lambda r: b"/* XPM */\nstatic char *x[] = {\n};\n",
    "bad hex": lambda r: _xpm(1, 1, [(b"a", b"#zz")], [b"a"]),
    "short hex": lambda r: _xpm(1, 1, [(b"a", b"#1234")], [b"a"]),
    "c last": lambda r: _xpm(1, 1, [(b"a", b"#123456")], [b"a"]).replace(
        b"a c #123456", b"a c"),
}


@pytest.mark.parametrize("name", list(XPM_CASES))
def test_xpm_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, XPM_CASES[name](rng), "c.xpm"))


def test_xpm_bit_flips_agree_with_jax(tmp_path, rng):
    colours, rows = _xpm_image(rng, 6, 4, 5)
    blob = _xpm(6, 4, colours, rows)
    for k, b in enumerate(flips(blob, rng, 40, 9)):
        agree(write(tmp_path, b, f"f{k}.xpm"))


# ---------------------------------------------------------------------------
# MSP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_pillow_msp_equals_jax(tmp_path, rng, size):
    a = rng.integers(0, 2, size).astype(bool)
    path = write(tmp_path, pil_bytes(Image.fromarray(a), "MSP"), "a.msp")
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


def _msp2(width, height, rows: list) -> bytes:
    """A version 2 ("LinS") MSP: the header with a zero checksum, the row
    map and the rows' bytes."""
    head = bytearray(struct.pack("<4sHHHHHHHHHHHH", b"LinS", width, height,
                                 1, 1, 1, 1, 0, 0, 0, 0, 0, 0) + bytes(4))
    check = 0
    for i in range(0, 32, 2):
        check ^= struct.unpack_from("<H", head, i)[0]
    struct.pack_into("<H", head, 30, check)
    return (bytes(head) + struct.pack(f"<{height}H", *map(len, rows))
            + b"".join(rows))


def _msp_rows(lines: np.ndarray) -> list:
    """Each packed row as runs of equal bytes (0, n, v) and literals."""
    out = []
    for line in lines:
        row, i = b"", 0
        while i < len(line):
            j = i
            while j < len(line) and line[j] == line[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                row += bytes([0, j - i, line[i]])
            else:
                j = min(i + 1, len(line))
                row += bytes([1, line[i]])
            i = j
        out.append(row)
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_rle_msp_equals_jax(tmp_path, rng, size):
    a = rng.integers(0, 2, size).astype(bool)
    a[:, : size[1] // 2] = True
    lines = np.packbits(a, axis=1)
    path = write(tmp_path, _msp2(size[1], size[0], _msp_rows(lines)), "r.msp")
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


MSP_CASES = {
    "blank rows": lambda: _msp2(16, 3, [b"", b"\x00\x02\x0f", b""]),
    "long row": lambda: _msp2(8, 3, [b"\x00\x02\x0f", b"\x01\x33",
                                     b"\x01\x44"]),
    "row bytes spill": lambda: _msp2(8, 3, [b"\x00\x03\x0f", b"\x01\x33",
                                            b""]),
    "short stream": lambda: _msp2(16, 2, [b"\x01\x33", b"\x01\x44"]),
    "literal past row": lambda: _msp2(8, 2, [b"\x05\x33", b"\x01\x44"]),
    "run cut": lambda: _msp2(8, 2, [b"\x01\x33", b"\x00\x02"]),
    "row cut": lambda: _msp2(8, 2, [b"\x01\x33", b"\x01\x44"])[:-1],
    "map cut": lambda: _msp2(8, 40, [b""] * 40)[:60],
    "bad checksum": lambda: b"LinS" + bytes(28),
    "v1 short": lambda: pil_bytes(Image.new("1", (16, 4)), "MSP")[:-3],
}


@pytest.mark.parametrize("name", list(MSP_CASES))
def test_msp_cases_agree_with_jax(tmp_path, name):
    agree(write(tmp_path, MSP_CASES[name](), "c.msp"))


def test_msp_bit_flips_agree_with_jax(tmp_path, rng):
    a = rng.integers(0, 2, (6, 21)).astype(bool)
    blob = _msp2(21, 6, _msp_rows(np.packbits(a, axis=1)))
    for k, b in enumerate(flips(blob, rng, 40, 32)):
        agree(write(tmp_path, b, f"f{k}.msp"))


# ---------------------------------------------------------------------------
# PIXAR, GBR, XV thumbnails
# ---------------------------------------------------------------------------
def _pixar(rgb: np.ndarray, mode=(14, 2)) -> bytes:
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + rgb.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_pixar_equals_jax(tmp_path, rng, size):
    a = _u8(rng, size + (3,))
    got = agree(write(tmp_path, _pixar(a), "a.pxr"), True)
    assert np.array_equal(got, a)


@pytest.mark.parametrize("case", ["other mode", "short"])
def test_pixar_cases_agree_with_jax(tmp_path, rng, case):
    a = _u8(rng, (4, 5, 3))
    blob = _pixar(a, (15, 2)) if case == "other mode" else _pixar(a)[:-2]
    agree(write(tmp_path, blob, "c.pxr"), False)


def _gbr(pixels_: np.ndarray, version=2, comment=b"sar brush\0") -> bytes:
    h, w = pixels_.shape[:2]
    depth = 1 if pixels_.ndim == 2 else 4
    extra = b"GIMP" + struct.pack(">I", 25) if version == 2 else b""
    header = 20 + len(extra) + len(comment)
    return (struct.pack(">5I", header, version, w, h, depth) + extra
            + comment + pixels_.tobytes())


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("bands", [1, 4])
def test_gbr_equals_jax(tmp_path, rng, size, version, bands):
    a = _u8(rng, size if bands == 1 else size + (4,))
    got = agree(write(tmp_path, _gbr(a, version), "a.gbr"), True)
    assert np.array_equal(got[..., 0] if bands == 1 else got, a)


GBR_CASES = {
    "short": lambda a: _gbr(a)[:-1],
    "bad magic": lambda a: _gbr(a).replace(b"GIMP", b"PMIG"),
    "depth 3": lambda a: _gbr(a)[:16] + struct.pack(">I", 3) + _gbr(a)[20:],
    "version 3": lambda a: _gbr(a)[:4] + struct.pack(">I", 3) + _gbr(a)[8:],
    "header 20 v2": lambda a: struct.pack(">I", 20) + _gbr(a)[4:],
    "header 27 v2": lambda a: struct.pack(">I", 27) + _gbr(a)[4:],
    "no comment": lambda a: _gbr(a, 1, b""),
}


@pytest.mark.parametrize("name", list(GBR_CASES))
def test_gbr_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, GBR_CASES[name](_u8(rng, (3, 4))), "c.gbr"))


def _xv(a: np.ndarray, comments=(b"#XVVERSION:Version 2.28\n",)) -> bytes:
    h, w = a.shape
    return (b"P7 332\n" + b"".join(comments) + b"#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + a.tobytes())


@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_xvthumb_equals_jax(tmp_path, rng, size):
    a = _u8(rng, size)
    got = agree(write(tmp_path, _xv(a), "a.xv"), True)
    assert got.shape == size + (3,)


@pytest.mark.parametrize("case", ["short", "no size", "eof in comments",
                                  "bad width"])
def test_xvthumb_cases_agree_with_jax(tmp_path, rng, case):
    a = _u8(rng, (3, 4))
    blob = {"short": _xv(a)[:-1],
            "no size": b"P7 332\n#c\n7\n" + a.tobytes(),
            "eof in comments": b"P7 332\n#c\n#d",
            "bad width": b"P7 332\nx 3 255\n" + a.tobytes()}[case]
    agree(write(tmp_path, blob, "c.xv"))


# ---------------------------------------------------------------------------
# FLI / FLC
# ---------------------------------------------------------------------------
def _chunk(kind: int, data: bytes) -> bytes:
    body = data + bytes(len(data) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def _fli(width, height, chunks: list, *, magic=0xAF12, frames=1,
         prefix=b"") -> bytes:
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 0, magic, frames, width, height,
                     8, 0, 5)
    body = b"".join(chunks)
    frame = struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) \
        + bytes(8) + body
    pre = struct.pack("<IHH", 16 + len(prefix), 0xF100, 0) + bytes(8) \
        + prefix if prefix else b""
    blob = bytes(head) + pre + frame
    return struct.pack("<I", len(blob)) + blob[4:]


def _colour(entries: np.ndarray, skip=0) -> bytes:
    n = len(entries)
    return struct.pack("<HBB", 1, skip, n & 255) + entries.tobytes()


def _brun(a: np.ndarray) -> bytes:
    out = b""
    for line in a:
        out += b"\0"
        x = 0
        while x < len(line):
            j = x
            while j < len(line) and line[j] == line[x] and j - x < 127:
                j += 1
            if j - x >= 2:
                out += bytes([j - x, line[x]])
            else:
                j = min(x + 3, len(line))
                out += bytes([256 - (j - x)]) + line[x:j].tobytes()
            x = j
    return out


def _lc(a: np.ndarray, y0: int) -> bytes:
    out = struct.pack("<HH", y0, len(a))
    for line in a:
        out += bytes([2, 1, 256 - 2, line[0]]) \
            + bytes([0, len(line) - 3]) + line[3:].tobytes()
    return out


def _ss2(a: np.ndarray, skip_first=0) -> bytes:
    out = struct.pack("<H", len(a))
    for k, line in enumerate(a):
        if k == 0 and skip_first:
            out += struct.pack("<H", 65536 - skip_first)
        pairs = len(line) // 2
        out += struct.pack("<H", 2) + bytes([0, 256 - 1]) \
            + line[:2].tobytes() + bytes([0, pairs - 1]) \
            + line[2:2 * pairs].tobytes()
    return out


FLI_W, FLI_H = 10, 6


def _fli_cases(r) -> dict:
    a = _u8(r, (FLI_H, FLI_W))
    pal = _u8(r, (256, 3))
    low = (pal // 4).astype(np.uint8)
    return {
        "brun 256": _fli(FLI_W, FLI_H, [_chunk(4, _colour(pal)),
                                        _chunk(15, _brun(a))]),
        "brun 64": _fli(FLI_W, FLI_H, [_chunk(11, _colour(low)),
                                       _chunk(15, _brun(a))], magic=0xAF11),
        "copy": _fli(FLI_W, FLI_H, [_chunk(16, a.tobytes())]),
        "black": _fli(FLI_W, FLI_H, [_chunk(16, a.tobytes()),
                                     _chunk(13, b"")]),
        "lc": _fli(FLI_W, FLI_H, [_chunk(15, _brun(a)),
                                  _chunk(12, _lc(a[2:5][::-1], 2))]),
        "ss2": _fli(FLI_W, FLI_H, [_chunk(7, _ss2(a[1:4], 1))]),
        "pstamp": _fli(FLI_W, FLI_H, [_chunk(18, bytes(20)),
                                      _chunk(16, a.tobytes())]),
        "no chunks": _fli(FLI_W, FLI_H, []),
        "no palette": _fli(FLI_W, FLI_H, [_chunk(15, _brun(a))]),
        "colour past 256": _fli(FLI_W, FLI_H, [_chunk(4, _colour(
            pal[:20], 250)), _chunk(15, _brun(a))]),
        "prefix chunk": _fli(FLI_W, FLI_H, [_chunk(4, _colour(pal)),
                                            _chunk(15, _brun(a))],
                             prefix=bytes(8)),
        "unknown chunk": _fli(FLI_W, FLI_H, [_chunk(99, bytes(4))]),
        "copy short": _fli(FLI_W, FLI_H, [_chunk(16, a.tobytes()[:-8])]),
        "no frames": _fli(FLI_W, FLI_H, [_chunk(16, a.tobytes())], frames=0),
        "cut": _fli(FLI_W, FLI_H, [_chunk(16, a.tobytes())])[:-5],
        "brun short line": _fli(FLI_W, FLI_H, [_chunk(15, b"\0\x03\x07" * 6)]),
        "lc past height": _fli(FLI_W, FLI_H, [_chunk(12, _lc(a[:3], 4))]),
        "ss2 skip past": _fli(FLI_W, FLI_H, [_chunk(7, _ss2(a[:2], 9))]),
        "odd width ss2": _fli(9, FLI_H, [_chunk(7, struct.pack(
            "<HHH", 1, 0x8000 | 0x77, 0))]),
    }


@pytest.mark.parametrize("name", list(_fli_cases(np.random.default_rng(0))))
def test_fli_cases_agree_with_jax(tmp_path, rng, name):
    blob = _fli_cases(rng)[name]
    path = write(tmp_path, blob, "c.fli")
    agree(path)


def test_fli_frames_decode_as_pillow(tmp_path, rng):
    """The written cases that Pillow opens, each an FLI there too."""
    opened = 0
    for name, blob in _fli_cases(rng).items():
        path = write(tmp_path, blob, f"{len(name)}.fli")
        if agree(path) is not None:
            assert _format(path) == "FLI", name
            opened += 1
    assert opened >= 9


def test_fli_bit_flips_agree_with_jax(tmp_path, rng):
    cases = _fli_cases(rng)
    for which in ("brun 256", "lc", "ss2"):
        blob = cases[which]
        for k, b in enumerate(flips(blob, rng, 25, 128 + 16)):
            agree(write(tmp_path, b, f"f{k}.fli"))


# ---------------------------------------------------------------------------
# PhotoCD
# ---------------------------------------------------------------------------
def _pcd(y, c1, c2, orientation=0) -> bytes:
    head = bytearray(pcd.OFFSET)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    chunks = np.zeros((256, 2304), np.uint8)
    chunks[:, :768], chunks[:, 768:1536] = y[0::2], y[1::2]
    chunks[:, 1536:1920], chunks[:, 1920:] = c1, c2
    return bytes(head) + chunks.tobytes()


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 5, 7])
def test_pcd_equals_jax(tmp_path, rng, orientation):
    y = rng.integers(0, 256, (512, 768), dtype=np.uint8)
    c1, c2 = (rng.integers(0, 256, (256, 384), dtype=np.uint8)
              for _ in range(2))
    got = agree(write(tmp_path, _pcd(y, c1, c2, orientation), "a.pcd"), True)
    assert got.shape == ((768, 512, 3) if orientation & 3 in (1, 3)
                         else (512, 768, 3))


def test_pcd_colour_tables_cover_every_chroma_pair(tmp_path):
    """Every (C1, C2) pair once, under four lumas of 64 apart."""
    pairs = np.zeros(256 * 384, np.int64)
    pairs[:65536] = np.arange(65536)
    c1 = (pairs & 255).astype(np.uint8).reshape(256, 384)
    c2 = (pairs >> 8).astype(np.uint8).reshape(256, 384)
    y = np.zeros((512, 768), np.uint8)
    for k, (dy, dx) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        y[dy::2, dx::2] = 17 + 64 * k
    agree(write(tmp_path, _pcd(y, c1, c2), "p.pcd"), True)


def test_pcd_cut_short_agrees_with_jax(tmp_path, rng):
    y = rng.integers(0, 256, (512, 768), dtype=np.uint8)
    c = np.zeros((256, 384), np.uint8)
    agree(write(tmp_path, _pcd(y, c, c)[:-100], "s.pcd"), False)


# ---------------------------------------------------------------------------
# IM Tools
# ---------------------------------------------------------------------------
def imt_write(a: np.ndarray, extra=b"") -> bytes:
    h, w = a.shape
    return (b"width %d\nheight %d\n" % (w, h) + extra + b"pixel n8\n\x0c"
            + a.tobytes())


@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_imt_equals_jax(tmp_path, rng, size):
    a = _u8(rng, size)
    path = write(tmp_path, imt_write(a, b"* a comment\n"), "a.imt")
    assert _format(path) == "IMT"
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


IMT_CASES = {
    "no form feed": b"width 4\nheight 2\npixel n8\n",
    "no pixel": b"width 4\nheight 2\n\x0c" + bytes(8),
    "bad width": b"width four\nheight 2\npixel n8\n\x0c" + bytes(8),
    "short": b"width 4\nheight 2\npixel n8\n\x0c" + bytes(7),
    "long line": b"width 4\n" + b"x" * 120 + b"\nheight 2\npixel n8\n\x0c"
    + bytes(8),
    "empty line": b"width 4\n\nheight 2\npixel n8\n\x0c" + bytes(8),
    "header past 100": b"*" + b" " * 150 + b"\nwidth 4\nheight 2\npixel n8"
    b"\n\x0c" + bytes(8),
    "cr lf": b"width 4\r\nheight 2\r\npixel n8\r\n\x0c" + bytes(8),
}


@pytest.mark.parametrize("name", list(IMT_CASES))
def test_imt_cases_agree_with_jax(tmp_path, name):
    agree(write(tmp_path, IMT_CASES[name], "c.imt"))


def test_imt_bit_flips_agree_with_jax(tmp_path, rng):
    blob = imt_write(_u8(rng, (5, 9)), b"* x\n")
    for k, b in enumerate(flips(blob, rng, 40, 0, 40)):
        agree(write(tmp_path, b, f"f{k}.imt"))


# ---------------------------------------------------------------------------
# IPTC / NAA
# ---------------------------------------------------------------------------
def _field(record: int, dataset: int, data: bytes, long=False) -> bytes:
    if long or len(data) >= 0x8000:  # Pillow reads 0x84's 4 bytes after 5
        return bytes([0x1C, record, dataset, 0x84, 4]) + struct.pack(
            ">I", len(data)) + data
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) \
        + data


def iptc_write(data: bytes, width, height, layers=1, component=0,
               compression=1, band=None, split=1, extra=b"") -> bytes:
    out = _field(2, 0, b"\0\2") + _field(3, 20, struct.pack(">H", width)) \
        + _field(3, 30, struct.pack(">H", height)) \
        + _field(3, 60, bytes([layers, component])) \
        + _field(3, 120, bytes([compression])) + extra
    if band is not None:
        out += _field(3, 65, bytes([band]))
    step = -(-len(data) // split)
    for k in range(split):
        out += _field(8, 10, data[k * step:(k + 1) * step], long=k % 2 == 1)
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("split", [1, 3])
def test_iptc_raw_equals_jax(tmp_path, rng, size, split):
    a = _u8(rng, size)
    path = write(tmp_path, iptc_write(a.tobytes(), size[1], size[0],
                                      split=split), "a.iim")
    assert _format(path) == "IPTC"
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


@pytest.mark.parametrize("layers,band", [(3, None), (3, 1), (3, 3), (4, 2),
                                         (4, 0), (3, 7)])
def test_iptc_band_equals_jax(tmp_path, rng, layers, band):
    a = _u8(rng, (5, 7))
    path = write(tmp_path, iptc_write(a.tobytes(), 7, 5, layers, 1,
                                      band=band), "b.iim")
    agree(path)


def test_iptc_jpeg_equals_jax(tmp_path, rng):
    a = _u8(rng, (24, 31))
    jpg = pil_bytes(Image.fromarray(a), "JPEG", quality=90)
    path = write(tmp_path, iptc_write(jpg, 31, 24, compression=5, split=2),
                 "j.iim")
    agree(path, True)


IPTC_CASES = {
    "compression 3": lambda a: iptc_write(a.tobytes(), 4, 3, compression=3),
    "no layers": lambda a: iptc_write(a.tobytes(), 4, 3).replace(
        _field(3, 60, b"\1\0"), b""),
    "repeated tag": lambda a: iptc_write(a.tobytes(), 4, 3, extra=_field(
        3, 60, b"\1\0")),
    "short data": lambda a: iptc_write(a.tobytes()[:-2], 4, 3),
    "zero size": lambda a: iptc_write(a.tobytes(), 4, 3).replace(
        _field(3, 20, b"\0\4"), _field(3, 20, b"")),
    "no data field": lambda a: iptc_write(b"", 4, 3)[:-5],
    "trailing zeros": lambda a: iptc_write(a.tobytes(), 4, 3) + bytes(7),
    "trailing garbage": lambda a: iptc_write(a.tobytes(), 4, 3) + b"xyzzy",
    "trailing field": lambda a: iptc_write(a.tobytes(), 4, 3)
    + _field(2, 5, b"name"),
    "field length 133": lambda a: iptc_write(a.tobytes(), 4, 3)[:3] + b"\x85"
    + bytes(20),
}


@pytest.mark.parametrize("name", list(IPTC_CASES))
def test_iptc_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, IPTC_CASES[name](_u8(rng, (3, 4))), "c.iim"))


def test_iptc_bit_flips_agree_with_jax(tmp_path, rng):
    blob = iptc_write(_u8(rng, (4, 6)).tobytes(), 6, 4, split=2)
    for k, b in enumerate(flips(blob, rng, 40)):
        agree(write(tmp_path, b, f"f{k}.iim"))


# ---------------------------------------------------------------------------
# the plugin loop: IMT, IPTC and PCD take no prefix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["MSP", "SGI", "SUN", "XBM", "XPM",
                                 "XVTHUMB"])
def test_file_imt_tries_first_opens_as_its_format(tmp_path, rng, fmt):
    """IMT (and IPTC and PCD) try every file before these formats; a line
    feed in the first 100 bytes makes IMT read a header, which ends without
    a size, and the file opens as its own format."""
    a = rng.integers(0, 2, (10, 12)).astype(bool)
    u8 = _u8(rng, (10, 12))
    u8[0] = 10
    blob = {
        "MSP": lambda: pil_bytes(Image.fromarray(a), "MSP"),
        "SGI": lambda: chip_smoke.sgi_rle_write(u8),
        "SUN": lambda: struct.pack(">8I", 0x59A66A95, 12, 10, 8, 120, 1, 0,
                                   0) + u8.tobytes(),
        "XBM": lambda: pil_bytes(Image.fromarray(a), "XBM"),
        "XPM": lambda: _xpm(2, 1, [(b"a", b"#102030")], [b"aa"]),
        "XVTHUMB": lambda: _xv(u8),
    }[fmt]()
    assert b"\n" in blob[:100]
    path = write(tmp_path, blob, "x.bin")
    assert _format(path).upper() == fmt
    agree(path, True)


def test_iptc_lookalike_hands_on(tmp_path, rng):
    """A file starting 0x1C with a record IPTC does not know is handed on
    (here to TGA, which takes it)."""
    a = _u8(rng, (4, 5))
    blob = bytes([0x1C, 0, 3]) + struct.pack("<HHB", 0, 0, 0) \
        + struct.pack("<HHHHBB", 0, 0, 5, 4, 8, 0x20) + bytes(0x1C) \
        + a.tobytes()
    path = write(tmp_path, blob, "t.bin")
    agree(path)


def test_plugin_table_refuses_only_avif_and_stubs():
    """The formats the plugin table refuses outright: Pillow's stubs and the
    unreachable TIFF entry (AVIF is read now: its features the port does
    not read yet are refused by name, test_avif_is_refused_by_name)."""
    refused = [name for name, _, opener in pilraster.PLUGINS
               if opener.__name__ == "refuse"]
    assert refused == ["BUFR", "EPS", "GRIB", "HDF5", "MPEG", "TIFF", "WMF"]


@pytest.mark.parametrize("name", list(test_torch_avif.REFUSALS))
def test_avif_is_refused_by_name(name):
    """Each AVIF feature the port does not read yet, in a file Pillow
    writes with it (tests/data/avif/refuse_*.avif; test_torch_avif holds
    them equal to what Pillow writes): the JAX reader opens it, the port
    names the feature."""
    path = test_torch_avif.AVIF_DIR / name
    words = test_torch_avif.REFUSALS[name]
    jraster.RasterReader(path).close()
    with pytest.raises(RasterError, match=f"{words} not read by the port "
                       "yet"):
        traster.RasterReader(path)


# ---------------------------------------------------------------------------
# tests/data/formats: the small files of Pillow's long tail that
# chip_smoke's longtail phase decodes on the card, against the SHA-256 of
# Pillow's decode of each
# ---------------------------------------------------------------------------
def longtail_fixture_files() -> dict:
    """One small file of each long-tail format, from chip_smoke.FORMATS_SEED:
    the files of tests/data/formats that chip_smoke.LONGTAIL_FIXTURES
    names."""
    import test_torch_icon_rasters as icon
    import test_torch_texture_rasters as tex

    seed = chip_smoke.FORMATS_SEED
    rng = np.random.default_rng(seed + 10)
    u8 = chip_smoke.formats_u8(chip_smoke.formats_dn(seed, 24, 37))
    rgb = np.dstack([u8, u8[::-1], 255 - u8])
    rgba = np.dstack([rgb, u8])
    sq = chip_smoke.formats_u8(chip_smoke.formats_dn(seed, 32, 32))
    sq_rgb = np.dstack([sq, sq[:, ::-1], sq // 2])
    b24 = u8[:, :36]
    dxt5 = pil_bytes(Image.fromarray(rgba[:, :36], "RGBA"), "DDS",
                     pixel_format="DXT5")
    dxt1 = pil_bytes(Image.fromarray(rgba[:, :36], "RGBA"), "DDS",
                     pixel_format="DXT1")
    pal = Image.fromarray(u8 // 16).convert("P")
    pal.putpalette(rng.integers(0, 256, 48, dtype=np.uint8).tobytes())
    keys = [bytes([65 + k]) for k in range(16)]
    colours = [(k, b"#%06x" % int(rng.integers(0, 1 << 24))) for k in keys]
    bits = u8 > 128
    return {
        "sar.dib": pil_bytes(Image.fromarray(u8), "DIB"),
        "sar_bmp.ico": pil_bytes(Image.fromarray(rgba, "RGBA"), "ICO",
                                 sizes=[(16, 16), (24, 24)],
                                 bitmap_format="bmp"),
        "sar_png.ico": pil_bytes(Image.fromarray(rgb), "ICO",
                                 sizes=[(24, 24)]),
        "sar.cur": icon.cur_write([(37, 24, icon.icon_dib(rgb, 24))]),
        "sar_rle.icns": icon.icns_write([
            (b"il32", icon._rgb_block(sq_rgb, b"il32")),
            (b"l8mk", sq.tobytes())]),
        "sar_bc4.dds": chip_smoke.dds_write(36, 24, chip_smoke.bc4_write(b24),
                                            b"ATI1"),
        "sar_bc7.dds": chip_smoke.dds_write(
            36, 24, chip_smoke.bc7_mode6_write(b24), b"DX10", 98),
        "sar_bc6h.dds": tex.dds_dx10(37, 24, 95, tex.random_blocks(
            rng, "BC6H", 60).tobytes()),
        "sar_dxt5.dds": dxt5,
        "sar_565.dds": tex.dds_header(37, 24, 0x40, bitcount=16, masks=(
            0xF800, 0x7E0, 0x1F, 0)) + (u8.astype("<u2") * 257).tobytes(),
        "sar_dxt1.ftc": tex.ftex_write(36, 24, 0, dxt1[128:]),
        "sar_pal.blp": pil_bytes(pal, "BLP"),
        "sar_dxt5.blp": tex.blp2(36, 24, 2, 8, 7, dxt5[128:]),
        "sar.xbm": pil_bytes(Image.fromarray(bits), "XBM"),
        "sar.xpm": _xpm(37, 24, colours, [b"".join(keys[v] for v in row)
                                          for row in u8 // 16]),
        "sar_rle.msp": _msp2(37, 24, _msp_rows(np.packbits(bits, axis=1))),
        "sar.pxr": _pixar(rgb),
        "sar.gbr": _gbr(rgba),
        "sar_brun.fli": _fli(37, 24, [_chunk(4, _colour(_u8(rng, (256, 3)))),
                                      _chunk(15, _brun(u8))]),
        "sar.xv": _xv(u8),
        "sar.imt": chip_smoke.imt_write(u8),
        "sar_raw.iim": iptc_write(u8.tobytes(), 37, 24),
    }


def _digest(path) -> str:
    return chip_smoke.decode_digest(jraster.RasterReader(path)._tiff._data)


def test_longtail_fixtures_are_pillows():
    """The committed files are longtail_fixture_files(), and chip_smoke
    holds the SHA-256 of Pillow's decode of each (the JAX reader's array),
    which the port's decode matches."""
    from test_torch_science_rasters import same_as_jax

    files = longtail_fixture_files()
    assert set(chip_smoke.LONGTAIL_FIXTURES) == set(files)
    for name, blob in files.items():
        path = chip_smoke.FORMATS_DIR / name
        assert path.read_bytes() == blob, name
        assert _digest(path) == chip_smoke.LONGTAIL_FIXTURES[name], name
        same_as_jax(path)


@pytest.mark.parametrize("label", ["DDS BC4", "DDS DX10 BC7", "IMT L"])
def test_longtail_band_writers_equal_pillow(tmp_path, label):
    """chip_smoke's band writers at a small side: Pillow reads each as the
    port does, and as the format it is."""
    bands = {lab: (name, w) for lab, name, w in
             chip_smoke._longtail_bands(96)}
    name, writer = bands[label]
    path = write(tmp_path, writer(), name)
    assert _format(path) == label.split()[0]
    agree(path, True)
