"""IFUNC IM reader: the image Pillow 12.1 opens from an IM file
(PIL/ImImagePlugin.py), quirks included:

  * the text header: a line feed within the first 100 bytes, then
    "key: value" lines of at most 100 bytes (CR LF or LF; a lone CR before
    a line is skipped) up to a NUL, a 0x1A or the end; at least one of the
    standard tags; the data after the next 0x1A. "Image size", "Scale" and
    "File size" values are numbers ("*" or "," between them), comments
    gather in a list, and every other value stays a string;
  * the "Image type" table (OPEN below): 1-bit, 8-bit, 2- and 4-bit palette
    ("B2" / "B4"), packed and line-interleaved ("RGB;L", "RGBA;L",
    "CMYK;L", "YCbCr;L", "LA;L", "RGBX;L") colour, 16- and 32-bit integers
    and floats, the ifunc95 "L*n" samples (the bit decoder below 8, 16 and
    32 bits) and the old three-plane "RGB3" / "RYB3". A type outside the
    table becomes the mode itself with rawmode "L", which only "L", "P" and
    "LAB" unpack. Rows run bottom-up;
  * a "Lut" turns an "L" / "P" image with a colour table into "P" (an
    "LA" / "PA" one into "PA"); a gray table leaves the mode, and gives a
    "P" image no palette at all;
  * Pillow's `info` keeps "Image type" as the mode string and every string
    value of the header, which `gdal_metadata()` reports.
Refusals are Pillow's: a header that is no IM header tries the next plugin;
a value that is no number, a mode and rawmode Pillow cannot unpack, and
data cut short raise RasterError."""
from __future__ import annotations

import re

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode

COMMENT, DATE, EQUIPMENT, FRAMES = ("Comment", "Date",
                                    "Digitalization equipment",
                                    "File size (no of images)")
LUT, NAME, SCALE, SIZE, MODE = ("Lut", "Name", "Scale (x,y)",
                                "Image size (x*y)", "Image type")
TAGS = {COMMENT, DATE, EQUIPMENT, FRAMES, LUT, NAME, SCALE, SIZE, MODE}

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
for _i in ["32S"]:
    OPEN[f"L {_i} image"] = ("I", f"I;{_i}")
    OPEN[f"L*{_i} image"] = ("I", f"I;{_i}")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# (mode, rawmode) pairs Pillow unpacks from the table above: the rawmode
# of every other pair is unknown to it for the mode
UNPACKS = {
    ("1", "1"), ("L", "L"), ("P", "L"), ("LAB", "L"), ("P", "P"),
    ("RGB", "RGB;L"), ("P", "P;2"), ("P", "P;4"), ("RGB", "RGB"),
    ("I", "I;32"), ("F", "F;32"), ("LA", "LA;L"), ("PA", "PA;L"),
    ("RGBA", "RGBA;L"), ("RGB", "RGBX;L"), ("CMYK", "CMYK;L"),
    ("YCbCr", "YCbCr;L"), ("I;16", "I;16"), ("I;16L", "I;16L"),
    ("I;16B", "I;16B"), ("I", "I;32S"),
} | {("F", f"F;{i}") for i in ["8", "8S", "16", "16S", "32", "32F"]}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(blob: bytes):
    """(info, rawmode, position after the 0x1A) of the text header."""
    if b"\n" not in blob[:100]:
        raise SyntaxError("not an IM file")
    info: dict = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    raw, n, pos = "L", 0, 0
    while True:
        s = blob[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        end = blob.find(b"\n", pos)
        end = len(blob) if end < 0 else end + 1
        s, pos = s + blob[pos:end], end
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header: "
                              + s.decode("ascii", "replace"))
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, raw = OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        if k in TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = blob[pos:pos + 1]
        pos += len(s)
    if not s:
        raise SyntaxError("File truncated")
    return info, raw, pos


def open_image(blob: bytes) -> pixels.Opened:
    info, raw, pos = _header(blob)
    size, mode = info[SIZE], info[MODE]
    palette = b""
    if LUT in info:
        lut = blob[pos:pos + 768]
        pos += len(lut)
        grey, linear = True, True
        for i in range(256):  # IndexError on a short table, as in Pillow
            if lut[i] == lut[i + 256] == lut[i + 512]:
                if lut[i] != i:
                    linear = False
            else:
                grey = False
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = raw = "P"
            else:
                mode, raw = "PA", "PA;L"
            palette = pixels.planar_palette(lut)
    # ImageFile's checks after _open (size[0] of a number is a TypeError)
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this plugin")
    width, height = size
    offset = pos
    strings = {k: v for k, v in info.items() if isinstance(v, str)}

    def load() -> pixels.Decoded:
        if not (isinstance(width, int) and isinstance(height, int)):
            raise RasterError("'float' object cannot be interpreted as an "
                              "integer")
        bits = raw[2:] if raw.startswith("F;") else ""
        if bits.isdigit() and int(bits) not in (8, 16, 32):
            if not 1 <= int(bits) < 32:
                raise RasterError("codec configuration error when reading "
                                  "image file")
            lines, done = _native.bit_decode(blob, offset, int(bits), width,
                                             height)
            if done < height:
                raise RasterError(pixels.TRUNCATED)
            return pixels.Decoded(mode, lines[::-1].copy(), palette, strings)
        if raw in ("RGB;T", "RYB;T"):
            plane = width * height
            out = np.zeros((height, width, 3), np.uint8)
            for k, band in enumerate((1, 0, 2)):  # tiles "G", "R", "B"
                out[..., band] = pixels.raw_lines(
                    blob, offset + k * plane, width, height, ystep=-1)
            return pixels.Decoded(mode, out, palette, strings)
        if (mode, raw) not in UNPACKS:
            raise RasterError("unknown raw mode for given image mode")
        unpack = "L" if (mode, raw) == ("LAB", "L") else raw
        lines = pixels.raw_lines(blob, offset,
                                 rawmode.linebytes(unpack, width), height,
                                 ystep=-1)
        arr = rawmode.unpack(lines, unpack, width)
        if mode == "LAB":
            arr = np.stack([arr, np.full_like(arr, 128),
                            np.full_like(arr, 128)], axis=-1)
        return pixels.Decoded(mode, arr, palette, strings)

    return pixels.Opened(mode, (width, height), load)
