"""FTEX reader: the image Pillow 12.1 opens from a Texture File Format
file (PIL/FtexImagePlugin.py): the size and a single format record, the
first mipmap's bytes at the record's offset, read as DXT1 ("RGBA", through
io/bcn) or raw RGB. A format count other than 1 fails Pillow's assertion
(the open fails); an unknown format raises its ValueError. Pillow's `info`
holds no strings for an FTEX."""
from __future__ import annotations

import struct

from ..errors import RasterError
from . import bcn, pixels, rawmode

MAGIC = b"FTEX"


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def open_image(blob: bytes) -> pixels.Opened:
    if not blob.startswith(MAGIC):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", blob[4:8])
    width, height = struct.unpack("<2i", blob[8:16])
    _, format_count = struct.unpack("<2i", blob[16:24])
    if format_count != 1:
        raise RasterError("FTEX: more than one format (Pillow asserts one)")
    fmt, where = struct.unpack("<2i", blob[24:32])
    if where < 0:
        raise OSError("[Errno 22] Invalid argument")
    (size,) = struct.unpack("<i", blob[where:where + 4])
    if size < -1:
        raise ValueError("read length must be non-negative or -1")
    start = where + 4
    data = blob[start:] if size == -1 else blob[start:start + size]
    if fmt == 0:
        mode = "RGBA"
    elif fmt == 1:
        mode = "RGB"
    else:
        raise ValueError(f"Invalid texture compression format: {fmt!r}")

    def load() -> pixels.Decoded:
        if fmt == 0:
            return pixels.Decoded(mode, bcn.decode(data, width, height, 1))
        lines = pixels.raw_lines(data, 0, rawmode.linebytes("RGB", width),
                                 height)
        return pixels.Decoded(mode, rawmode.unpack(lines, "RGB", width))

    return pixels.Opened(mode, (width, height), load)
