"""PIXAR reader: the image Pillow 12.1 opens from a PIXAR raster
(PIL/PixarImagePlugin.py): the size at 418 and 416 of the 512-byte header,
and "RGB" raw rows at 1024 only where the channel and depth words at 424
and 426 are (14, 2); any other pair leaves no mode, so the file is handed
to the next plugin. Pillow's `info` holds no strings for a PIXAR."""
from __future__ import annotations

import struct

from . import pixels, rawmode

MAGIC = b"\200\350\000\000"


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def open_image(blob: bytes) -> pixels.Opened:
    if not blob.startswith(MAGIC):
        raise SyntaxError("not a PIXAR file")
    s = blob[:512]
    height, width = struct.unpack_from("<HH", s, 416)
    mode = "RGB" if struct.unpack_from("<HH", s, 424) == (14, 2) else ""

    def load() -> pixels.Decoded:
        lines = pixels.raw_lines(blob, 1024, rawmode.linebytes("RGB", width),
                                 height)
        return pixels.Decoded(mode, rawmode.unpack(lines, "RGB", width))

    return pixels.Opened(mode, (width, height), load)
