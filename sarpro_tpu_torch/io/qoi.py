"""QOI reader: the image Pillow 12.1 opens from a Quite OK Image file
(PIL/QoiImagePlugin.py). Pillow decodes QOI in Python; the port runs the
same op loop in C++ (rledec.cpp's qoi_decode), quirks included: "RGB" where
the channel byte is 3 and "RGBA" for any other value, the index table
filled by every op but a run (so a run before any other op leaves it
empty), a missing index entry read as (0, 0, 0, 0), and data that ends
before the image does refused. Pillow's `info` holds no strings for a QOI
file."""
from __future__ import annotations

import struct

from .. import _native
from ..errors import RasterError
from . import pixels


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"qoif")


def open_image(blob: bytes) -> pixels.Opened:
    if not accept(blob[:4]):
        raise SyntaxError("not a QOI file")
    width, height = struct.unpack(">II", blob[4:12])
    mode = "RGB" if blob[12:13][0] == 3 else "RGBA"
    bands = len(mode)

    def load() -> pixels.Decoded:
        try:
            data = _native.qoi_decode(blob, 14, width * height, bands)
        except ValueError as e:
            raise RasterError(str(e)) from e
        return pixels.Decoded(mode, data.reshape(height, width, bands))

    return pixels.Opened(mode, (width, height), load)
