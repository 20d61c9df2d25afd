"""SPIDER reader: the image Pillow 12.1 opens from a SPIDER file
(PIL/SpiderImagePlugin.py): no magic, so the first 27 words are tried as
big-endian floats, then little-endian, against isSpiderHeader (words 1, 2,
5, 12, 13, 22 and 23 whole numbers, iform in [1, 3, -11, -12, -21, -22],
labbyt = labrec * lenbyt); only iform 1 (a 2-D image) opens. The image is
mode "F", float32 samples in the header's byte order after `labbyt` bytes,
or, for a stack (istack > 0, imgnumber 0), the first image after twice
that. Pillow's `info` holds no strings for a SPIDER file."""
from __future__ import annotations

import struct

from . import pixels, rawmode

IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def header_length(t: tuple) -> int:
    """isSpiderHeader: the header's length in bytes, 0 where `t` is not a
    SPIDER header."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    if labbyt != labrec * lenbyt:
        return 0
    return labbyt


def open_image(blob: bytes) -> pixels.Opened:
    f = blob[:108]
    try:
        bigendian = True
        t = struct.unpack(">27f", f)
        hdrlen = header_length(t)
        if hdrlen == 0:
            bigendian = False
            t = struct.unpack("<27f", f)
            hdrlen = header_length(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    width, height = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        # Pillow reads self.stkoffset, which an image opened on its own
        # does not have
        raise AttributeError("'SpiderImageFile' object has no attribute "
                             "'stkoffset'")
    else:
        raise SyntaxError("inconsistent stack header values")
    raw = "F;32BF" if bigendian else "F;32F"

    def load() -> pixels.Decoded:
        lines = pixels.raw_lines(blob, offset, 4 * width, height)
        return pixels.Decoded("F", rawmode.unpack(lines, raw, width))

    return pixels.Opened("F", (width, height), load)
