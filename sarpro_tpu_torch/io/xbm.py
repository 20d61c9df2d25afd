"""XBM reader: the image Pillow 12.1 opens from an X11 bitmap
(PIL/XbmImagePlugin.py and its C `xbm` decoder): the header's width and
height `#define`s matched in the first 512 bytes (the regex below, greedy
up to the last "_bits[]" there), then the bytes of each row (width + 7) //
8 of them, each the two characters after an 'x' (C++, _native/rledec.cpp),
unpacked least significant bit first ("1;R": a set bit is white). Data
that ends before the last row fails the load. Pillow's `info` holds no
strings for an XBM (the hot spot is a tuple)."""
from __future__ import annotations

import re

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def open_image(blob: bytes) -> pixels.Opened:
    m = HEAD.match(blob[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    offset = m.end()

    def load() -> pixels.Decoded:
        linebytes = (width + 7) // 8
        try:
            lines, done = _native.xbm_decode(blob, offset, linebytes, height)
        except RuntimeError as e:
            raise RasterError(str(e)) from e
        if done < height:
            raise RasterError(pixels.TRUNCATED)
        bits = np.unpackbits(lines, axis=1, bitorder="little")[:, :width]
        return pixels.Decoded("1", bits.astype(bool))

    return pixels.Opened("1", (width, height), load)
