"""MSP reader: the image Pillow 12.1 opens from a Windows Paint file
(PIL/MspImagePlugin.py): a 32-byte header whose 16-bit words XOR to 0,
mode "1"; version 1 ("DanM") raw rows after the header, version 2
("LinS") MspDecoder's run-length rows (C++, _native/rledec.cpp): a row map
of one length a row, each row's runs and literals (a length of 0 a white
row), every row's bytes into one stream read as the image's packed rows.
A row map, row or run cut short fails the load with Pillow's OSError, too
little data with its "not enough image data". Pillow's `info` holds no
strings for an MSP."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:32]
    if not accept(s):
        raise SyntaxError("not an MSP file")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= struct.unpack_from("<H", s, i)[0]
    if checksum != 0:
        raise SyntaxError("bad MSP checksum")
    width, height = struct.unpack_from("<HH", s, 4)
    linebytes = (width + 7) // 8

    def load() -> pixels.Decoded:
        if s.startswith(b"DanM"):
            lines = pixels.raw_lines(blob, 32, linebytes, height)
            return pixels.Decoded("1", rawmode.unpack(lines, "1", width))
        rowmap = blob[32:32 + 2 * height]
        if len(rowmap) < 2 * height:
            raise RasterError("Truncated MSP file in row map")
        need = linebytes * height
        try:
            stream, n = _native.msp_rle(
                blob, 32 + 2 * height, np.frombuffer(rowmap, "<u2"),
                linebytes, need)
        except (ValueError, RuntimeError) as e:
            raise RasterError(str(e)) from e
        if n < need:
            raise RasterError("not enough image data")
        lines = stream.reshape(height, linebytes)
        return pixels.Decoded("1", rawmode.unpack(lines, "1", width))

    return pixels.Opened("1", (width, height), load)
