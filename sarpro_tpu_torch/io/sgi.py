"""SGI reader: the image Pillow 12.1 opens from an SGI image file
(PIL/SgiImagePlugin.py), quirks included:

  * the 512-byte header: magic 474, storage (0 verbatim, 1 RLE; any other
    leaves no tile, which Pillow cannot load), bpc, dimension, size and
    zsize; modes "L" (dimension 1 or 2), "RGB" and "RGBA";
  * rows bottom-up; verbatim 8-bit data as one plane a band, verbatim
    16-bit data through Pillow's SGI16 decoder ("L;16B"), and RLE data
    through the C++ copy of SgiRleDecode (rledec.cpp);
  * bpc 2 reads through "L;16B" and its kind, so only the high byte of each
    sample is kept, and the mode stays 8-bit.
Pillow's `info` holds no strings for an SGI file."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
HEADER = 512


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack_from(">H", prefix)[0] == 474


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:HEADER]
    if not accept(s):
        raise ValueError("Not an SGI image file")
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", s, 4)
    try:
        raw = MODES[(bpc, dimension, zsize)]
    except KeyError:
        raise ValueError("Unsupported SGI image mode") from None
    mode = raw.split(";")[0]
    bands = len(mode)

    def load() -> pixels.Decoded:
        if compression == 0:
            plane = xsize * ysize * bpc
            out = np.empty((ysize, xsize, bands), np.uint8)
            for b in range(bands):
                if bpc == 2 and HEADER + (b + 1) * plane > len(blob):
                    raise RasterError("not enough image data")
                lines = pixels.raw_lines(blob, HEADER + b * plane,
                                         xsize * bpc, ysize, ystep=-1)
                out[..., b] = lines[:, ::bpc]
        elif compression == 1:
            try:
                lines = _native.sgi_rle_decode(blob, xsize, ysize, bands, bpc)
            except ValueError as e:
                raise RasterError(str(e)) from e
            out = lines[::-1, ::bpc].reshape(ysize, xsize, bands)
        else:
            raise RasterError("cannot load this image")
        return pixels.Decoded(mode, out[..., 0] if bands == 1 else out)

    return pixels.Opened(mode, (xsize, ysize), load)
