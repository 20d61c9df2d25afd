"""Sun raster reader: the image Pillow 12.1 opens from a Sun raster file
(PIL/SunImagePlugin.py), quirks included:

  * the 32-byte big-endian header; depth 1 ("1", a set bit black), 4 ("L"
    in 4-bit steps), 8 ("L"), 24 and 32 ("RGB"; BGR order unless the type
    is 3); a colour map (type 1, at most 1024 bytes, each band's entries
    after the other's) turns "L" into "P", and fails Pillow's load of a
    "1" or "RGB" image;
  * raw rows (types 0, 1, 3, 4 and 5) padded to 16 bits; type 2's RLE
    through the C++ copy of SunRleDecode (rledec.cpp): 0x80 0 is a literal
    0x80, 0x80 n v is n + 1 copies of v, runs go on across lines, and the
    lines of the RLE stream are not padded.
Pillow's `info` holds no strings for a Sun raster."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode

MAGIC = 0x59A66A95


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == MAGIC


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:32]
    if not accept(s):
        raise SyntaxError("not an SUN raster file")
    width, height, depth, _, file_type, palette_type, palette_length = \
        struct.unpack_from(">7I", s, 4)
    offset = 32
    if depth == 1:
        mode, raw = "1", "1;I"
    elif depth == 4:
        mode, raw = "L", "L;4"
    elif depth == 8:
        mode = raw = "L"
    elif depth == 24:
        mode, raw = "RGB", "RGB" if file_type == 3 else "BGR"
    elif depth == 32:
        mode, raw = "RGB", "RGBX" if file_type == 3 else "BGRX"
    else:
        raise SyntaxError("Unsupported Mode/Bit Depth")
    palette = b""
    if palette_length:
        if palette_length > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if palette_type != 1:
            raise SyntaxError("Unsupported Palette Type")
        offset += palette_length
        palette = pixels.planar_palette(blob[32:32 + palette_length])
        if mode == "L":
            mode, raw = "P", raw.replace("L", "P")
    stride = ((width * depth + 15) // 16) * 2
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")

    def load() -> pixels.Decoded:
        if palette_length:
            pixels.check_palette_mode(mode)
            pixels.check_palette_size(len(blob[32:32 + palette_length]), 24)
        linebytes = rawmode.linebytes(raw, width)
        if file_type == 2:
            try:
                lines, done = _native.rle_lines("sun", blob, offset,
                                                linebytes, height)
            except ValueError as e:
                raise RasterError(str(e)) from e
            if done < height:
                raise RasterError(pixels.TRUNCATED)
        else:
            lines = pixels.raw_lines(blob, offset, linebytes, height, stride)
        return pixels.Decoded(mode, rawmode.unpack(lines, raw, width),
                              palette)

    return pixels.Opened(mode, (width, height), load)
