"""The port's readers of the run-length formats Pillow 12.1 opens (io/sgi,
io/tga, io/pcx for PCX and DCX, io/sun, io/psd, io/qoi, and the C++ loops
of sarpro_tpu_torch/_native/rledec.cpp), and the plugin loop of
io/pilraster, against the JAX package's RasterReader, which opens the same
files through Pillow, on the CPU: every band equal bit for bit, the dtype,
size, gdal_metadata() and georeferencing equal, or both readers refuse the
file.

Inputs are made from seeds with numpy and written by Pillow where it
writes the format (SGI 8-bit, TGA with and without RLE, PCX, QOI); 16-bit
SGI, RLE SGI, Sun rasters, PSD, DCX and the TGA and PCX variants Pillow
does not write are written here field by field. Pillow's quirks are kept:
SGI's bpc 2 read as its high bytes, TGA literal packets running on across
rows, the planes of narrow PCX lines moved, Sun RLE lines without padding.
"""
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import pcx, pilraster, pixels  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import RESAMPLE_TOL  # noqa: E402
from test_torch_exact import native_both  # noqa: E402,F401
from test_torch_readers import WKT_32632  # noqa: E402
from test_torch_science_rasters import (  # noqa: E402
    agree,
    flips,
    pil_bytes,
    same_as_jax,
    write,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SIZES = ((1, 1), (5, 7), (13, 4), (3, 130))


def _ids(s):
    return f"{s[0]}x{s[1]}"


def _u8(rng, shape, levels=256):
    """u8 samples with runs: each row repeats values in stretches."""
    a = rng.integers(0, levels, shape).astype(np.uint8)
    if a.ndim >= 2 and a.shape[1] > 3:
        a[:, 1:a.shape[1] // 2] = a[:, :1]
    return a


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------
def _sgi16(planes, rle=False):
    """A 16-bit SGI file (bpc 2, which Pillow does not write): verbatim, or
    RLE with one literal chunk of at most 127 samples at a time."""
    rows, cols, z = planes.shape
    head = struct.pack(">hBBHHHHll4s80sl", 474, int(rle), 2,
                       3 if z > 1 else 2, cols, rows, z, 0, 65535, b"",
                       b"", 0)
    head += bytes(512 - len(head))
    lines = planes[::-1].transpose(2, 0, 1).reshape(z * rows, cols)
    if not rle:
        return head + np.ascontiguousarray(lines, ">u2").tobytes()
    chunks, starts, lengths = [], [], []
    at = 512 + 8 * lines.shape[0]
    for line in lines:
        out = b""
        for i in range(0, cols, 127):
            seg = line[i:i + 127]
            out += struct.pack(">H", 0x80 | len(seg)) + seg.astype(
                ">u2").tobytes()
        out += b"\0\0"
        starts.append(at)
        lengths.append(len(out) // 2)  # expandrow2 counts chunks
        chunks.append(out)
        at += len(out)
    return (head + np.array(starts, ">u4").tobytes()
            + np.array(lengths, ">u4").tobytes() + b"".join(chunks))


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_pillow_sgi_equals_jax(tmp_path, rng, bands, size):
    a = _u8(rng, size + ((bands,) if bands > 1 else ()))
    got = agree(write(tmp_path, pil_bytes(Image.fromarray(a), "SGI"),
                      "p.sgi"), True)
    assert np.array_equal(got[..., 0] if bands == 1 else got, a)


@pytest.mark.parametrize("seg", [16, 5, 127])
@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_rle_sgi_equals_jax(tmp_path, rng, bands, size, seg):
    a = _u8(rng, size + ((bands,) if bands > 1 else ()))
    blob = chip_smoke.sgi_rle_write(a, seg)
    got = agree(write(tmp_path, blob, "r.sgi"), True)
    assert np.array_equal(got[..., 0] if bands == 1 else got, a)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_sgi_16_bit_keeps_the_high_byte(tmp_path, rng, bands, rle):
    """Pillow reads bpc 2 through "L;16B": each sample's high byte, in an
    8-bit mode (ROADMAP queue 3)."""
    planes = rng.integers(0, 65536, (6, 9, bands)).astype(np.uint16)
    got = agree(write(tmp_path, _sgi16(planes, rle), "w.sgi"), True)
    assert got.dtype == np.uint8
    assert np.array_equal(got, (planes >> 8).astype(np.uint8))


def _sgi_table_word(blob, index, value):
    at = 512 + 4 * index
    return blob[:at] + struct.pack(">I", value) + blob[at + 4:]


SGI_CASES = {
    "storage 2": (lambda b: b[:2] + b"\x02" + b[3:], False),
    "bpc 3": (lambda b: b[:3] + b"\x03" + b[4:], False),
    "zsize 2": (lambda b: b[:10] + b"\x00\x02" + b[12:], False),
    "cut tables": (lambda b: b[:530], False),
    "cut data": (lambda b: b[:-3], False),
    "offset in header": (lambda b: _sgi_table_word(b, 0, 100), False),
    "offset past end": (lambda b: _sgi_table_word(b, 0, 1 << 20), False),
    "length past end": (lambda b: _sgi_table_word(b, 6, 1 << 20), True),
    "short length": (lambda b: _sgi_table_word(b, 6, 1), None),
    "zero length": (lambda b: _sgi_table_word(b, 7, 0), None),
    "header only": (lambda b: b[:512], False),
    "short header": (lambda b: b[:11], False),
}


@pytest.mark.parametrize("name", list(SGI_CASES))
def test_sgi_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = SGI_CASES[name]
    blob = chip_smoke.sgi_rle_write(_u8(rng, (6, 40)), 16)
    agree(write(tmp_path, make(blob), "c.sgi"), opens)


def test_sgi_bit_flips_agree_with_jax(tmp_path, rng):
    blob = chip_smoke.sgi_rle_write(_u8(rng, (6, 40, 3)), 16)
    for k, b in enumerate(flips(blob, rng, 30, 0, 12)):
        agree(write(tmp_path, b, f"h{k}.sgi"))
    for k, b in enumerate(flips(blob, rng, 30, 512)):
        agree(write(tmp_path, b, f"d{k}.sgi"))
    wide = _sgi16(rng.integers(0, 65536, (4, 9, 1)).astype(np.uint16), True)
    for k, b in enumerate(flips(wide, rng, 20, 512)):
        agree(write(tmp_path, b, f"w{k}.sgi"))


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------
def _tga(image_type, depth, width, height, data, *, cmap=b"",
         map_start=0, map_depth=0, descriptor=0x20, id_field=b""):
    n = len(cmap) // max(1, map_depth // 8) if cmap else 0
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap else 0,
                       image_type, map_start, n, map_depth, 0, 0, width,
                       height, depth, descriptor)
    return head + id_field + cmap + data


def _tga_rle(pixels_: np.ndarray, size: int, runs=True) -> bytes:
    """RLE packets over the flat pixel stream (each pixel `size` bytes):
    runs of equal pixels where `runs`, literals of up to 128 otherwise."""
    px = pixels_.reshape(-1, size)
    out, i = b"", 0
    while i < len(px):
        j = i + 1
        while runs and j < len(px) and j - i < 128 and (px[j] == px[i]).all():
            j += 1
        if j - i > 1:
            out += bytes([0x80 | (j - i - 1)]) + px[i].tobytes()
        else:
            j = min(i + 128, len(px))
            out += bytes([j - i - 1]) + px[i:j].tobytes()
        i = j
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA", "1"])
def test_pillow_tga_equals_jax(tmp_path, rng, mode, rle, size):
    if mode == "1":
        im = Image.fromarray(rng.random(size) > 0.5)
    elif mode == "P":
        im = Image.fromarray(_u8(rng, size + (3,))).convert(
            "P", palette=Image.ADAPTIVE, colors=17)
    else:
        im = Image.fromarray(_u8(rng, size + (len(mode),) if len(mode) > 1
                                 else size), mode)
    kw = {"compression": "tga_rle"} if rle else {}
    # a 1-bit RLE file has pixels of depth // 8 = 0 bytes for Pillow, so it
    # never reads one back
    got = agree(write(tmp_path, pil_bytes(im, "TGA", **kw), "p.tga"),
                not (rle and mode == "1"))
    if got is None:
        return
    if rle:
        md = traster.RasterReader(tmp_path / "p.tga")._tiff.gdal_metadata()
        assert md == {"compression": "tga_rle"}
    assert got.shape[:2] == size


@pytest.mark.parametrize("seg", [16, 5, 128])
@pytest.mark.parametrize("top_down", [True, False])
@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_rle_tga_writer_equals_jax(tmp_path, rng, size, top_down, seg):
    """chip_smoke's vectorised writer: literal packets run on across rows
    (Pillow splits them), runs stay within a row."""
    a = _u8(rng, size)
    got = agree(write(tmp_path, chip_smoke.tga_rle_write(a, seg, top_down),
                      "w.tga"), True)
    assert np.array_equal(got[..., 0], a)


def _bgr15(rgb):
    r, g, b = (rgb[..., k].astype(np.uint16) >> 3 for k in range(3))
    return ((r << 10) | (g << 5) | b).astype("<u2")


TGA_CASES = {
    "15 bit": lambda rng: _tga(2, 16, 5, 3, _bgr15(_u8(rng, (3, 5, 3)))
                               .tobytes()),
    "15 bit alpha bit": lambda rng: _tga(2, 16, 5, 3, (_bgr15(_u8(
        rng, (3, 5, 3))) | 0x8000).tobytes()),
    "mirrored": lambda rng: _tga(3, 8, 5, 3, _u8(rng, (3, 5)).tobytes(),
                                 descriptor=0x30),
    "bottom-up mirrored": lambda rng: _tga(3, 8, 5, 3, _u8(rng, (3, 5))
                                           .tobytes(), descriptor=0x10),
    "map 16": lambda rng: _tga(1, 8, 5, 3, _u8(rng, (3, 5), 20).tobytes(),
                               cmap=_bgr15(_u8(rng, (20, 3))).tobytes(),
                               map_depth=16),
    "map 32": lambda rng: _tga(1, 8, 5, 3, _u8(rng, (3, 5), 20).tobytes(),
                               cmap=_u8(rng, (20, 4)).tobytes(),
                               map_depth=32),
    "map start": lambda rng: _tga(1, 8, 5, 3, _u8(rng, (3, 5), 30).tobytes(),
                                  cmap=_u8(rng, (20, 3)).tobytes(),
                                  map_start=6, map_depth=24),
    "short map": lambda rng: _tga(1, 8, 5, 3, _u8(rng, (3, 5)).tobytes(),
                                  cmap=_u8(rng, (4, 3)).tobytes(),
                                  map_depth=24),
    "id field": lambda rng: _tga(3, 8, 5, 3, _u8(rng, (3, 5)).tobytes(),
                                 id_field=b"sar scene"),
    "map 8": lambda rng: _tga(1, 8, 5, 3, bytes(15), cmap=bytes(20),
                              map_depth=8),
    "mapped without map": lambda rng: _tga(1, 8, 5, 3, bytes(15)),
    "gray 24": lambda rng: _tga(3, 24, 5, 3, bytes(45)),
    "rgb 8": lambda rng: _tga(2, 8, 5, 3, bytes(15)),
    "type 4": lambda rng: _tga(4, 8, 5, 3, bytes(15)),
    "depth 7": lambda rng: _tga(3, 7, 5, 3, bytes(15)),
    "cut": lambda rng: _tga(3, 8, 5, 3, bytes(14)),
    "short header": lambda rng: bytes([0, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    "rle run across rows": lambda rng: _tga(11, 8, 5, 3, bytes(
        [0x80 | 6, 9, 0x80 | 7, 4])),
    "rle literal across rows": lambda rng: _tga(11, 8, 5, 3, bytes(
        [14]) + bytes(range(15))),
    "rle rgb": lambda rng: _tga(10, 24, 5, 3, _tga_rle(
        _u8(rng, (3, 5, 3), 3), 3)),
    "rle 1 bit": lambda rng: _tga(11, 1, 19, 3, _tga_rle(
        _u8(rng, (3, 3), 4), 1)),
    "rle la": lambda rng: _tga(11, 16, 5, 3, _tga_rle(
        _u8(rng, (3, 5, 2), 3), 2)),
    "rle mapped": lambda rng: _tga(9, 8, 5, 3, _tga_rle(
        _u8(rng, (3, 5), 4), 1), cmap=_u8(rng, (4, 3)).tobytes(),
        map_depth=24),
    "rle cut": lambda rng: _tga(11, 8, 5, 3, bytes([0x80 | 6, 9])),
    "rle extra data": lambda rng: _tga(11, 8, 5, 3, bytes(
        [0x80 | 4, 1, 0x80 | 4, 2, 0x80 | 4, 3, 7, 7, 7])),
}


@pytest.mark.parametrize("name", list(TGA_CASES))
def test_tga_cases_agree_with_jax(tmp_path, rng, name):
    agree(write(tmp_path, TGA_CASES[name](rng), "c.tga"))


def test_tga_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _tga(10, 24, 9, 4, _tga_rle(_u8(rng, (4, 9, 3), 3), 3))
    for k, b in enumerate(flips(blob, rng, 30, 0, 18)):
        agree(write(tmp_path, b, f"h{k}.tga"))
    for k, b in enumerate(flips(blob, rng, 30, 18)):
        agree(write(tmp_path, b, f"d{k}.tga"))


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------
def _pcx_rle(lines: np.ndarray) -> bytes:
    """PCX's RLE over each line: runs of up to 63, bytes of 0xC0 and more
    as runs of one."""
    out = bytearray()
    for line in lines:
        i = 0
        while i < len(line):
            j = i + 1
            while j < len(line) and j - i < 63 and line[j] == line[i]:
                j += 1
            if j - i > 1 or line[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), line[i]])
            else:
                out.append(line[i])
            i = j
    return bytes(out)


def _pcx(width, height, bits, planes, lines, *, version=5, stride=None,
         palette16=b"", tail=b"", origin=(0, 0)):
    stride = stride if stride is not None else (width * bits + 7) // 8
    head = struct.pack("<BBBBHHHHHH48sBBHH58s", 10, version, 1, bits,
                       origin[0], origin[1], origin[0] + width - 1,
                       origin[1] + height - 1, 72, 72,
                       palette16.ljust(48, b"\0"), 0, planes, stride, 1,
                       b"")
    return head + _pcx_rle(lines) + tail


def _bitplanes(idx, planes, stride):
    h, w = idx.shape
    out = np.zeros((h, planes * stride), np.uint8)
    for k in range(planes):
        bits = np.packbits((idx >> k) & 1, axis=1)
        out[:, k * stride:k * stride + bits.shape[1]] = bits
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_pillow_pcx_equals_jax(tmp_path, rng, mode, size):
    if mode == "1":
        im = Image.fromarray(rng.random(size) > 0.5)
    elif mode == "P":
        im = Image.fromarray(_u8(rng, size + (3,))).convert(
            "P", palette=Image.ADAPTIVE, colors=50)
    else:
        im = Image.fromarray(_u8(rng, size + ((3,) if mode == "RGB" else ())))
    blob = pil_bytes(im, "PCX")
    # an 8-bit PCX under 769 bytes is refused: Pillow seeks to its palette;
    # Pillow cannot read its own 1 x 1 RGB file (it pads the line it reads)
    agree(write(tmp_path, blob, "p.pcx"),
          (mode not in ("L", "P") or len(blob) >= 769)
          and (mode, size) != ("RGB", (1, 1)))


@pytest.mark.parametrize("width", [1, 3, 8, 13])
@pytest.mark.parametrize("planes", [2, 4])
def test_pcx_bit_planes_equal_jax(tmp_path, rng, planes, width):
    """1 bit in 2 or 4 planes ("P" with the header's 16 colours); at widths
    of 1 to 3 Pillow moves the padded planes and reads what lands there."""
    idx = rng.integers(0, 1 << planes, (4, width)).astype(np.uint8)
    stride = (width + 7) // 8
    stride += stride % 2
    blob = _pcx(width, 4, 1, planes, _bitplanes(idx, planes, stride),
                stride=stride, palette16=_u8(rng, (16, 3)).tobytes())
    agree(write(tmp_path, blob, "b.pcx"), True)


def _pcx8(rng, w=30, h=5, ramp=False):
    lines = _u8(rng, (h, w + w % 2))
    pal = (np.repeat(np.arange(256, dtype=np.uint8), 3) if ramp
           else _u8(rng, (256, 3)).reshape(-1))
    return _pcx(w, h, 8, 1, lines, stride=w + w % 2,
                tail=b"\x0c" + pal.tobytes())


PCX_CASES = {
    "gray ramp": (lambda rng: _pcx8(rng, ramp=True), True),
    "palette": (lambda rng: _pcx8(rng), True),
    "origin": (lambda rng: _pcx(5, 3, 8, 3, _u8(rng, (3, 15)),
                                origin=(7, 2), tail=bytes(769)), True),
    "odd rgb stride": (lambda rng: _pcx(5, 3, 8, 3, _u8(rng, (3, 18)),
                                        stride=6, tail=bytes(769)), True),
    "rgb 1 wide": (lambda rng: _pcx(1, 3, 8, 3, _u8(rng, (3, 6)), stride=2,
                                    tail=bytes(769)), True),
    "rgb 3 wide": (lambda rng: _pcx(3, 3, 8, 3, _u8(rng, (3, 12)), stride=4,
                                    tail=bytes(769)), True),
    "run past line": (lambda rng: _pcx(4, 2, 8, 1, np.zeros((0, 4),
                                                           np.uint8),
                                       tail=bytes([0xC6, 1, 0xC2, 1])
                                       + bytes(769)), False),
    "cut": (lambda rng: _pcx8(rng)[:200], False),
    "small 8 bit": (lambda rng: _pcx(3, 2, 8, 1, _u8(rng, (2, 4)),
                                     stride=4), False),
    "version 3 8 bit": (lambda rng: _pcx(3, 2, 8, 1, _u8(rng, (2, 4)),
                                         version=3, tail=bytes(769)), False),
    "bad box": (lambda rng: _pcx(3, 2, 8, 1, _u8(rng, (2, 4)),
                                 tail=bytes(769))[:4] + struct.pack(
        "<4H", 5, 0, 2, 1) + _pcx(3, 2, 8, 1, _u8(rng, (2, 4)),
                                  tail=bytes(769))[12:], False),
}


@pytest.mark.parametrize("name", list(PCX_CASES))
def test_pcx_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = PCX_CASES[name]
    agree(write(tmp_path, make(rng), "c.pcx"), opens)


def _dcx(frames: list) -> bytes:
    at = 4 + 4 * (len(frames) + 1)
    offsets = []
    for f in frames:
        offsets.append(at)
        at += len(f)
    return (struct.pack("<I", pcx.DCX_MAGIC) + struct.pack(
        f"<{len(frames) + 1}I", *offsets, 0) + b"".join(frames))


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("mode", ["1", "RGB", "P"])
def test_dcx_equals_jax(tmp_path, rng, mode, frames):
    ims = []
    for _ in range(frames):
        a = _u8(rng, (40, 33, 3))
        im = Image.fromarray(a)
        if mode == "1":
            im = im.convert("1")
        elif mode == "P":
            im = im.convert("P", palette=Image.ADAPTIVE, colors=40)
        ims.append(pil_bytes(im, "PCX"))
    got = agree(write(tmp_path, _dcx(ims), "d.dcx"), True)
    assert got.shape[:2] == (40, 33)


def test_dcx_without_frames_agrees_with_jax(tmp_path):
    agree(write(tmp_path, struct.pack("<II", pcx.DCX_MAGIC, 0),
                "e.dcx"), False)


def test_pcx_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _pcx8(rng)
    for k, b in enumerate(flips(blob, rng, 30, 0, 128)):
        agree(write(tmp_path, b, f"h{k}.pcx"))
    for k, b in enumerate(flips(blob, rng, 30, 128, len(blob) - 769)):
        agree(write(tmp_path, b, f"d{k}.pcx"))


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------
def _sun_rle(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i + 1
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        n = j - i
        if n > 2 or data[i] == 0x80:
            out += bytes([0x80, n - 1, data[i]])
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def _sun(width, height, depth, data, *, kind=1, cmap=b""):
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(data),
                       kind, 1 if cmap else 0, len(cmap)) + cmap + data


def _sun_rows(a, depth):
    """Rows padded to 16 bits, as Sun rasters store them."""
    h = a.shape[0]
    if depth == 1:
        rows = np.packbits(a, axis=1)
    elif depth == 4:
        p = np.zeros((h, a.shape[1] + a.shape[1] % 2), np.uint8)
        p[:, :a.shape[1]] = a
        rows = (p[:, 0::2] << 4) | p[:, 1::2]
    else:
        rows = a.reshape(h, -1)
    pad = np.zeros((h, rows.shape[1] + rows.shape[1] % 2), np.uint8)
    pad[:, :rows.shape[1]] = rows
    return pad


# widths of 1 and 2 stay out: GBR's `_accept` takes many such headers
@pytest.mark.parametrize("size", [(1, 3), (5, 7), (4, 130)], ids=_ids)
@pytest.mark.parametrize("kind", [1, 2, 3])
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_equals_jax(tmp_path, rng, depth, kind, size):
    shape = size + ({24: (3,), 32: (4,)}.get(depth, ()))
    a = _u8(rng, shape, {1: 2, 4: 16}.get(depth, 256))
    rows = _sun_rows(a, depth)
    if kind == 2:  # the RLE lines are not padded
        rows = rows[:, :(size[1] * depth + 7) // 8]
    data = rows.tobytes()
    blob = _sun(size[1], size[0], depth, _sun_rle(data) if kind == 2
                else data, kind=kind)
    agree(write(tmp_path, blob, "s.ras"), True)


@pytest.mark.parametrize("depth", [1, 4, 8, 24])
def test_sun_colour_map_equals_jax(tmp_path, rng, depth):
    """A colour map makes "L" a "P" image; Pillow cannot load one on a "1"
    or "RGB" image."""
    a = _u8(rng, (5, 7) + ((3,) if depth == 24 else ()),
            1 << min(depth, 8))
    cmap = _u8(rng, (3, 1 << min(depth, 8))).tobytes()
    agree(write(tmp_path, _sun(7, 5, depth, _sun_rows(a, depth).tobytes(),
                               cmap=cmap), "m.ras"), depth in (4, 8))


SUN_CASES = {
    "depth 16": (lambda rng: _sun(4, 2, 16, bytes(16)), False),
    "type 6": (lambda rng: _sun(4, 2, 8, bytes(8), kind=6), False),
    "map too long": (lambda rng: _sun(4, 2, 8, bytes(8), cmap=bytes(1200)),
                     False),
    "raw map type": (lambda rng: _sun(4, 2, 8, bytes(8), cmap=bytes(6))[
        :24] + struct.pack(">I", 2) + _sun(4, 2, 8, bytes(8),
                                           cmap=bytes(6))[28:], False),
    "cut": (lambda rng: _sun(4, 2, 8, bytes(7)), False),
    "rle cut": (lambda rng: _sun(4, 2, 8, bytes([0x80, 5, 1]), kind=2),
                False),
    "rle run across rows": (lambda rng: _sun(4, 2, 8, bytes([0x80, 6, 9, 3]),
                                             kind=2), True),
    "rle escape": (lambda rng: _sun(3, 1, 8, bytes([0x80, 0, 1, 0x80, 0]),
                                    kind=2), True),
    "short map": (lambda rng: _sun(4, 2, 8, bytes(0), cmap=bytes(6))[:40],
                  False),
}


@pytest.mark.parametrize("name", list(SUN_CASES))
def test_sun_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = SUN_CASES[name]
    agree(write(tmp_path, make(rng), "c.ras"), opens)


def test_sun_bit_flips_agree_with_jax(tmp_path, rng):
    a = _u8(rng, (6, 11, 3))
    blob = _sun(11, 6, 24, _sun_rle(a.tobytes()), kind=2)
    for k, b in enumerate(flips(blob, rng, 30, 0, 32)):
        agree(write(tmp_path, b, f"h{k}.ras"))
    for k, b in enumerate(flips(blob, rng, 30, 32)):
        agree(write(tmp_path, b, f"d{k}.ras"))


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------
def _packbits(line: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(line):
        j = i + 1
        while j < len(line) and j - i < 128 and line[j] == line[i]:
            j += 1
        if j - i > 1:
            out += bytes([257 - (j - i), line[i]])
        else:
            j = min(i + 128, len(line))
            out += bytes([j - i - 1]) + line[i:j]
        i = j
    return bytes(out)


def _psd(planes: list, mode: int, bits=8, *, rle=False, colour=b"",
         resources=b"", channels=None):
    h, w = planes[0].shape
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or len(planes), h,
                                 w, bits, mode)
    body = struct.pack(">I", len(colour)) + colour
    body += struct.pack(">I", len(resources)) + resources
    body += struct.pack(">I", 0)
    if not rle:
        return head + body + struct.pack(">H", 0) + b"".join(
            p.tobytes() for p in planes)
    rows = [_packbits(row.tobytes()) for p in planes for row in p]
    return (head + body + struct.pack(">H", 1)
            + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows))


def _resource(rid, data, name=b""):
    out = b"8BIM" + struct.pack(">H", rid) + bytes([len(name)]) + name
    if not len(name) & 1:
        out += b"\0"
    out += struct.pack(">I", len(data)) + data
    return out + b"\0" * (len(data) & 1)


PSD_MODES = {"1": (0, 1, 1), "L": (1, 8, 1), "P": (2, 8, 1),
             "RGB": (3, 8, 3), "RGBA": (3, 8, 4), "CMYK": (4, 8, 4),
             "LAB": (9, 8, 3), "duotone": (8, 8, 1), "multichannel": (7, 8, 1)}


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (3, 300)], ids=_ids)
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode", list(PSD_MODES))
def test_psd_equals_jax(tmp_path, rng, mode, rle, size):
    code, bits, n = PSD_MODES[mode]
    if bits == 1:
        planes = [np.packbits(_u8(rng, size, 2), axis=1)]
        planes = [np.ascontiguousarray(p) for p in planes]
        width = size[1]
    else:
        planes = [_u8(rng, size) for _ in range(n)]
        width = None
    colour = _u8(rng, (768,)).tobytes() if mode == "P" else b""
    resources = _resource(1039, b"icc bytes") + _resource(1005, b"x", b"ab")
    blob = _psd(planes, code, bits, rle=rle, colour=colour,
                resources=resources)
    if width is not None:  # the header's width is the pixels'
        blob = blob[:18] + struct.pack(">I", width) + blob[22:]
    agree(write(tmp_path, blob, "p.psd"), True)


PSD_CASES = {
    "16 bits": (lambda rng: _psd([_u8(rng, (2, 3))], 1, 16), False),
    "too few channels": (lambda rng: _psd([_u8(rng, (2, 3))] * 2, 3), False),
    "extra channels": (lambda rng: _psd([_u8(rng, (2, 3))] * 5, 3), True),
    "short palette": (lambda rng: _psd([_u8(rng, (2, 3))], 2,
                                       colour=bytes(600)), True),
    "compression 2": (lambda rng: _psd([_u8(rng, (2, 3))], 1)[:-8]
                      + b"\0\x02" + bytes(6), False),
    "cut raw": (lambda rng: _psd([_u8(rng, (2, 3))], 1)[:-1], False),
    "cut rle": (lambda rng: _psd([_u8(rng, (4, 9))], 1, rle=True)[:-2],
                False),
    "version 2": (lambda rng: _psd([_u8(rng, (2, 3))], 1)[:4] + b"\0\2"
                  + _psd([_u8(rng, (2, 3))], 1)[6:], False),
    "rle over long row": (lambda rng: _psd([_u8(rng, (2, 3))], 1)[:-8]
                          + b"\0\x01\0\x03\0\x02" + bytes([0xFB, 7, 0x80, 1,
                                                           0]), None),
}


@pytest.mark.parametrize("name", list(PSD_CASES))
def test_psd_cases_agree_with_jax(tmp_path, rng, name):
    make, opens = PSD_CASES[name]
    agree(write(tmp_path, make(rng), "c.psd"), opens)


def test_psd_bit_flips_agree_with_jax(tmp_path, rng):
    blob = _psd([_u8(rng, (4, 9)) for _ in range(3)], 3, rle=True,
                resources=_resource(1039, b"icc"))
    for k, b in enumerate(flips(blob, rng, 30, 0, 60)):
        agree(write(tmp_path, b, f"h{k}.psd"))
    for k, b in enumerate(flips(blob, rng, 30, 60)):
        agree(write(tmp_path, b, f"d{k}.psd"))


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pillow_qoi_equals_jax(tmp_path, rng, mode, size):
    a = _u8(rng, size + (len(mode),), 8)
    got = agree(write(tmp_path, pil_bytes(Image.fromarray(a), "QOI"),
                      "q.qoi"), True)
    assert np.array_equal(got, a)


def _qoi(width, height, channels, ops: bytes) -> bytes:
    return (b"qoif" + struct.pack(">IIBB", width, height, channels, 0)
            + ops + bytes(7) + b"\1")


QOI_CASES = {
    "run first": (lambda: _qoi(3, 2, 4, bytes([0xC0 | 5])), True),
    "index unseen": (lambda: _qoi(2, 1, 4, bytes([0x05, 0x00])), True),
    "diff and luma": (lambda: _qoi(4, 1, 3, bytes([0x40 | 0x3F, 0x80 | 40,
                                                   0x9F, 0xFE, 1, 2, 3,
                                                   0x00])), True),
    "channels 5": (lambda: _qoi(1, 1, 5, bytes([0xFF, 1, 2, 3, 4])), True),
    "run past end": (lambda: _qoi(2, 1, 3, bytes([0xC0 | 60])), True),
    "cut": (lambda: b"qoif" + struct.pack(">IIBB", 4, 4, 3, 0)
            + bytes([0xFE, 1, 2]), False),
    "short header": (lambda: b"qoif\0\0\0\1", False),
}


@pytest.mark.parametrize("name", list(QOI_CASES))
def test_qoi_cases_agree_with_jax(tmp_path, name):
    make, opens = QOI_CASES[name]
    agree(write(tmp_path, make(), "c.qoi"), opens)


def test_qoi_bit_flips_agree_with_jax(tmp_path, rng):
    blob = pil_bytes(Image.fromarray(_u8(rng, (6, 9, 4), 6)), "QOI")
    for k, b in enumerate(flips(blob, rng, 40, 12)):
        agree(write(tmp_path, b, f"d{k}.qoi"))


# ---------------------------------------------------------------------------
# the plugin loop
# ---------------------------------------------------------------------------
def test_plugins_follow_pillows_order():
    """Image.open in a new process: the preinit plugins, then the rest as
    Image.init() registers them (a process that imported a plugin before
    has it earlier in Image.ID)."""
    import subprocess

    ids = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); "
         "Image.init(); print(' '.join(Image.ID))"],
        capture_output=True, text=True, check=True).stdout.split()
    assert [p[0] for p in pilraster.PLUGINS] == ids


@pytest.mark.parametrize("fmt", ["MCIDAS", "PSD", "QOI", "SGI", "SUN"])
def test_file_im_tries_first_opens_as_its_format(tmp_path, rng, fmt):
    """IM (and IMT, IPTC and PCD, which take no prefix either) try every
    file before these formats; a line feed in the first 100 bytes makes IM
    read a header, which it refuses, and the file opens as its own format."""
    a = _u8(rng, (10, 12))
    a[0, :] = 10  # a line feed among the first bytes of the data
    blob = {
        "MCIDAS": lambda: chip_smoke.mcidas_write(a),
        "PSD": lambda: _psd([a], 1),
        "QOI": lambda: pil_bytes(Image.fromarray(np.dstack([a] * 3)), "QOI"),
        "SGI": lambda: chip_smoke.sgi_rle_write(a),
        "SUN": lambda: _sun(12, 10, 8, a.tobytes()),
    }[fmt]()
    assert b"\n" in blob[:100]  # the height, 10, is a line feed
    path = write(tmp_path, blob, "x.bin")
    with Image.open(path) as im:
        assert im.format == fmt
    agree(path, True)


def test_file_spider_tries_first_opens_as_tga(tmp_path, rng):
    """SPIDER (no prefix) reads the first 108 bytes of a TGA as floats and
    refuses them; the file opens as TGA, the plugin after it."""
    a = _u8(rng, (12, 12))
    path = write(tmp_path, _tga(3, 8, 12, 12, a.tobytes()), "t.bin")
    with Image.open(path) as im:
        assert im.format == "TGA"
    got = agree(path, True)
    assert np.array_equal(got[..., 0], a)


@pytest.mark.parametrize("name,blob", [
    ("DDS", b"DDS " + bytes(124)),
    ("ICNS", b"icns" + bytes(60)),
    ("MSP", b"DanM" + bytes(60)),
    ("XPM", b"/* XPM */\n" + bytes(40)),
    ("BLP", b"BLP2" + bytes(200)),
    ("AVIF", b"\0\0\0\x1cftypavif" + bytes(60)),
])
def test_unported_formats_are_named(tmp_path, name, blob):
    """The header-only blobs of the formats the port now reads, AVIF among
    them, are read (or refused) as the JAX reader does."""
    path = write(tmp_path, blob, "u.bin")
    agree(path)


@pytest.mark.parametrize("name,blob", [
    ("EPS", b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 10\n"),
    ("BUFR", b"BUFR" + bytes(60)),
    ("GRIB", b"GRIB\0\0\0\1" + bytes(60)),
    ("WMF", b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60)),
])
def test_formats_pillow_reads_no_pixels_of_are_refused(tmp_path, name, blob):
    """Both readers refuse them: Pillow opens the file but has no handler,
    Ghostscript or decoder for its pixels here."""
    path = write(tmp_path, blob, "n.bin")
    with pytest.raises(jraster.RasterError):
        jraster.RasterReader(path)
    with pytest.raises(RasterError, match=f"{name}"):
        traster.RasterReader(path)


@pytest.mark.parametrize("map_start", [0, 0x300, 0x7F00])
def test_plain_tga_passes_cur(tmp_path, rng, map_start):
    """CUR takes every file starting 0 0 2 0 (a true-colour TGA without an
    ID field): it finds no cursors, or reads a cursor entry whose bitmap
    lies past the file's end, and hands it on."""
    a = _u8(rng, (4, 5, 3))
    blob = _tga(2, 24, 5, 4, a[..., ::-1].tobytes())
    blob = blob[:3] + struct.pack("<H", map_start) + blob[5:]
    assert blob.startswith(b"\0\0\2\0")
    agree(write(tmp_path, blob, "c.tga"), True)


def test_decompression_bomb_limits_apply(tmp_path, caplog):
    import logging

    big = _sun(10848, 10848, 8, b"")
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        agree(write(tmp_path, big, "big.ras"), False)
    assert any("Image size (117679104 pixels) exceeds limit" in
               r.getMessage() for r in caplog.records)
    agree(write(tmp_path, _sun(20000, 20000, 8, b""), "bomb.ras"), False)
    with pytest.raises(RasterError, match="decompression bomb"):
        traster.RasterReader(tmp_path / "bomb.ras")


def test_fits_no_image_data_is_worded_as_jax(tmp_path):
    blob = chip_smoke.fits_write(np.zeros((1, 1), np.uint8), 8).replace(
        b"NAXIS   =                    2", b"NAXIS   =                    0")
    path = write(tmp_path, blob + b"XXXX".ljust(80), "n.fits")
    with pytest.raises(jraster.RasterError) as je:
        jraster.RasterReader(path)
    with pytest.raises(RasterError) as te:
        traster.RasterReader(path)
    assert "No image data" in str(je.value)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# rledec.cpp: no fallback, and the slice
# ---------------------------------------------------------------------------
def test_rle_decoder_build_failure_raises(tmp_path, monkeypatch, rng):
    bad = tmp_path / "rledec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "RLE_SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_RASTER", None)
    monkeypatch.setattr(_native, "_RASTER_WHY", None)
    path = write(tmp_path, chip_smoke.sgi_rle_write(_u8(rng, (4, 5))),
                 "r.sgi")
    with pytest.raises(RasterError, match="could not be built") as ei:
        traster.RasterReader(path)
    assert "rledec.cpp" in str(ei.value)


def rle_files(tmp_path) -> dict:
    dn = chip_smoke.formats_dn(chip_smoke.FORMATS_SEED, 90, 120)
    u8 = chip_smoke.formats_u8(dn)
    out = {}
    for kind, name, blob in (("sgi rle", "a.sgi", chip_smoke.sgi_rle_write(
            u8)), ("tga rle", "a.tga", chip_smoke.tga_rle_write(u8))):
        path = write(tmp_path, blob, name)
        path.with_suffix(".wld").write_text(
            "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
        path.with_suffix(".prj").write_text(WKT_32632)
        out[kind] = path
    return out


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("kind", ["sgi rle", "tga rle"])
def test_decimated_read_equals_jax(tmp_path, kind, alg):
    path = rle_files(tmp_path)[kind]
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
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


@pytest.mark.parametrize("kind", ["sgi rle", "tga rle"])
def test_clahe_gray_jpeg_equals_jax(tmp_path, kind, native_both):
    """As tests/test_torch_science_rasters.py's test of the same name."""
    from sarpro_tpu import api as japi
    from sarpro_tpu import types as jtypes
    from sarpro_tpu_torch import api as tapi
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )
    from test_torch_exact import S, _level_bound, _within

    path = rle_files(tmp_path)[kind]
    band = traster.read_band_resampled_to_device(
        traster.RasterReader(path), 1, 64, 48, "cpu", "cubic")
    tapi.save_image(band + 1.0, tmp_path / "t.jpg", OutputFormat.JPEG,
                    BitDepth.U8, autoscale=AutoscaleStrategy.CLAHE,
                    device="cpu")
    japi.save_image(band.numpy() + 1.0, tmp_path / "j.jpg",
                    jtypes.OutputFormat.JPEG, jtypes.BitDepth.U8,
                    autoscale=jtypes.AutoscaleStrategy.CLAHE)
    a = np.asarray(Image.open(tmp_path / "t.jpg"))
    b = np.asarray(Image.open(tmp_path / "j.jpg"))
    assert a.shape == b.shape == (48, 64)
    _within(f"{kind} clahe gray jpeg", a, b,
            _level_bound(band.numpy(), S.CLAHE, 255.0))


def test_pixels_raw_lines_refuse_short_data():
    with pytest.raises(RasterError, match="truncated"):
        pixels.raw_lines(bytes(10), 2, 4, 3)
    assert pixels.raw_lines(bytes(range(10)), 2, 4, 2)[1].tolist() == [
        6, 7, 8, 9]


# ---------------------------------------------------------------------------
# tests/data/formats: the small files chip_smoke's formats phase decodes on
# the card, against the SHA-256 of Pillow's decode of each
# ---------------------------------------------------------------------------
def fixture_files() -> dict:
    """One small file of each format and of its main modes, from
    chip_smoke.FORMATS_SEED: the committed tests/data/formats."""
    import test_torch_science_rasters as sci

    rng = np.random.default_rng(chip_smoke.FORMATS_SEED)
    dn = chip_smoke.formats_dn(chip_smoke.FORMATS_SEED, 24, 37)
    u8 = chip_smoke.formats_u8(dn)
    rgb = np.dstack([u8, u8[::-1], 255 - u8])
    f32 = sci._floats(rng, (24, 37), nans=True)
    files = {
        "sar_f32.pfm": chip_smoke.pfm_write(f32),
        "sar_cmyk.ppm": b"P0CMYK\n37 24\n255\n" + np.dstack(
            [u8, rgb]).tobytes(),
        "sar_i16.fits": chip_smoke.fits_write(
            np.minimum(dn, 32767).astype(np.int16), 16),
        "sar_f64.fits": chip_smoke.fits_write(f32.astype(np.float64), -64),
        "sar_gzip.fits": sci._gzip_fits(rng, 16, (24, 37))[0],
        "sar_u16.area": chip_smoke.mcidas_write(dn, 4),
        "sar_f32.spi": pil_bytes(Image.fromarray(f32), "SPIDER"),
        "sar_l12.im": sci._im_case(rng, "L*12 image", w=37, h=24,
                                   nbytes=56 * 24, extra=("Name: sar",)),
        "sar_f32.im": pil_bytes(Image.fromarray(f32), "IM"),
        "sar_rgb.im": pil_bytes(Image.fromarray(rgb), "IM"),
        "sar_rle_rgb.sgi": chip_smoke.sgi_rle_write(rgb, 7),
        "sar_u16.sgi": _sgi16(dn[..., None], rle=True),
        "sar_rle.tga": chip_smoke.tga_rle_write(u8, 5, top_down=False),
        "sar_rle_rgba.tga": pil_bytes(Image.fromarray(np.dstack([rgb, u8])),
                                      "TGA", compression="tga_rle"),
        "sar_map16.tga": _tga(1, 8, 37, 24, (u8 // 16).tobytes(),
                              cmap=_bgr15(_u8(rng, (16, 3))).tobytes(),
                              map_depth=16, descriptor=0x10),
        "sar_rgb.pcx": pil_bytes(Image.fromarray(rgb), "PCX"),
        "sar_planes.pcx": _pcx(37, 24, 1, 4, _bitplanes(u8 // 16, 4, 6),
                               stride=6, palette16=_u8(rng, (16, 3))
                               .tobytes()),
        "sar_two.dcx": _dcx([pil_bytes(Image.fromarray(u8).convert("P"),
                                       "PCX")] * 2),
        "sar_rle.ras": _sun(37, 24, 24, _sun_rle(rgb.tobytes()), kind=2),
        "sar_rle_rgb.psd": _psd([rgb[..., k] for k in range(3)], 3,
                                rle=True),
        "sar_lab.psd": _psd([u8, u8[::-1], 255 - u8], 9),
        "sar_rgba.qoi": pil_bytes(Image.fromarray(np.dstack([rgb, u8])),
                                  "QOI"),
    }
    return files


def _digest(path) -> str:
    import hashlib

    return hashlib.sha256(jraster.RasterReader(path)._tiff._data.tobytes()) \
        .hexdigest()


def test_format_fixtures_are_pillows():
    """The committed files are fixture_files(), and chip_smoke holds the
    SHA-256 of Pillow's decode of each (the JAX reader's array), which the
    port's decode matches."""
    files = fixture_files()
    # the long-tail formats' files beside them: test_torch_legacy_rasters
    assert sorted(p.name for p in chip_smoke.FORMATS_DIR.iterdir()) == \
        sorted([*files, *chip_smoke.LONGTAIL_FIXTURES])
    assert set(chip_smoke.FORMATS_FIXTURES) == set(files)
    for name, blob in files.items():
        path = chip_smoke.FORMATS_DIR / name
        assert path.read_bytes() == blob, name
        assert _digest(path) == chip_smoke.FORMATS_FIXTURES[name], name
        same_as_jax(path)
