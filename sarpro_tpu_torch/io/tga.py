"""TGA reader: the image Pillow 12.1 opens from a Truevision Targa file
(PIL/TgaImagePlugin.py), quirks included:

  * no magic: every file that reaches the plugin is tried. The 18-byte
    header must have a colour map type of 0 or 1, a positive size and a
    depth of 1, 8, 16, 24 or 32; image types 1 / 9 (colour-mapped: "P", or
    "L" without a map, which Pillow cannot unpack), 2 / 10 ("RGB" at 24
    bits, else "RGBA", 16 bits as 5-5-5 with an inverted alpha bit) and
    3 / 11 ("L", "1" at 1 bit, "LA" at 16). A type and depth outside
    Pillow's table leaves no tile, which it cannot load;
  * the descriptor's bits 4 and 5: rows bottom-up unless bit 5 is set, and
    columns mirrored where bit 4 is;
  * colour maps of 16 (5-5-5), 24 and 32 bits, the first entry's index
    counted as that many zero entries before the map;
  * RLE (types 9 to 11) through the C++ copy of TgaRleDecode (rledec.cpp):
    a packet's pixels are depth // 8 bytes (none for a 1-bit image, which
    therefore never completes), literal packets run on across lines and a
    run past a line's end fails the decode;
  * a colour map with a 32-bit entry, or on an image of mode "1", "RGB" or
    "RGBA", fails Pillow's load;
  * `info["compression"]` is "tga_rle" for RLE files, the only string in
    Pillow's `info`.
"""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode

MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
MAP_RAWMODES = {16: ("BGRA;15Z", 2), 24: ("BGR", 3), 32: ("BGRA", 4)}


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:18]
    id_len, colormaptype, imagetype = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    width, height = struct.unpack_from("<HH", s, 12)
    if (colormaptype not in (0, 1) or width <= 0 or height <= 0
            or depth not in (1, 8, 16, 24, 32)):
        raise SyntaxError("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    orientation = flags & 0x30
    mirror = orientation in (0x10, 0x30)
    ystep = 1 if orientation in (0x20, 0x30) else -1
    info = {"compression": "tga_rle"} if imagetype & 8 else {}
    pos = 18 + len(blob[18:18 + id_len])
    palette = table = b""
    entry = 1
    if colormaptype:
        start, size = struct.unpack_from("<HH", s, 3)
        mapdepth = s[7]
        if mapdepth not in MAP_RAWMODES:
            raise SyntaxError("unknown TGA map depth")
        raw, entry = MAP_RAWMODES[mapdepth]
        table = bytes(entry * start) + blob[pos:pos + entry * size]
        pos += len(blob[pos:pos + entry * size])
        n = len(table) // entry
        palette = rawmode.unpack(np.frombuffer(table, np.uint8, n * entry)
                                 .reshape(1, -1), raw, n)[0, :, :3].tobytes()
    raw = MODES.get((imagetype & 7, depth))
    offset = pos

    def load() -> pixels.Decoded:
        if raw is None:
            raise RasterError("cannot load this image")
        if colormaptype and s[7] == 32:
            raise RasterError("unrecognized raw mode")
        if colormaptype:
            pixels.check_palette_mode(mode)
            pixels.check_palette_size(len(table), 8 * entry)
        if mode == "L" and raw == "P":
            raise RasterError("unknown raw mode for given image mode")
        linebytes = rawmode.linebytes(raw, width)
        if imagetype & 8:
            try:
                lines, done = _native.rle_lines("tga", blob, offset,
                                                linebytes, height,
                                                depth=depth // 8)
            except ValueError as e:
                raise RasterError(str(e)) from e
            if done < height:
                raise RasterError(pixels.TRUNCATED)
            lines = lines[::-1] if ystep < 0 else lines
        else:
            lines = pixels.raw_lines(blob, offset, linebytes, height,
                                     ystep=ystep)
        arr = rawmode.unpack(lines, raw, width)
        if mirror:
            arr = np.ascontiguousarray(arr[:, ::-1])
        return pixels.Decoded(mode, arr, palette, dict(info))

    return pixels.Opened(mode, (width, height), load)
