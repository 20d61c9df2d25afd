"""GBR reader: the image Pillow 12.1 opens from a GIMP brush
(PIL/GbrImagePlugin.py): a big-endian header (size of at least 20,
version 1 or 2, width, height and a colour depth of 1 ("L") or 4
("RGBA"); version 2 adds the "GIMP" magic and a spacing), the comment to
the header's end, then the pixels, which Pillow reads with `frombytes`:
too few of them fail the load. Pillow's `info` holds no strings for a GBR
(the comment is bytes, the spacing an integer)."""
from __future__ import annotations

import struct

import numpy as np

from ..errors import RasterError
from . import pixels


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20
            and struct.unpack_from(">I", prefix, 4)[0] in (1, 2))


def open_image(blob: bytes) -> pixels.Opened:
    def i32(pos):
        return struct.unpack(">I", blob[pos:pos + 4])[0]

    header = i32(0)
    if header < 20:
        raise SyntaxError("not a GIMP brush")
    version = i32(4)
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height, depth = i32(8), i32(12), i32(16)
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    pos = 20
    if version == 1:
        comment = header - 20
    else:
        comment = header - 28
        if blob[20:24] != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        i32(24)
        pos = 28
    if comment < -1:
        raise ValueError("read length must be non-negative or -1")
    pos = len(blob) if comment == -1 else min(len(blob), pos + comment)
    mode = "L" if depth == 1 else "RGBA"
    pixels.check_size(width, height)

    def load() -> pixels.Decoded:
        need = width * height * depth
        data = blob[pos:pos + need]
        if len(data) < need:
            raise RasterError("not enough image data")
        arr = np.frombuffer(data, np.uint8)
        arr = arr.reshape((height, width) if depth == 1 else
                          (height, width, 4))
        return pixels.Decoded(mode, arr.copy())

    return pixels.Opened(mode, (width, height), load)
