"""PSD reader: the composite image Pillow 12.1 opens from a Photoshop file
(PIL/PsdImagePlugin.py; `load()` gives the composite, not the layers):

  * the 26-byte header (version 1), Pillow's (mode, bits) table: bitmap
    "1", gray / duotone / multichannel "L", indexed "P" (the colour-mode
    data as a palette, each band's entries after the other's, where it is
    768 bytes; no palette otherwise), "RGB" ("RGBA" with 4 channels),
    "CMYK" (inverted) and "LAB" (a and b with their top bit flipped), at 8
    bits (1 for bitmap);
  * the colour-mode data, image resources and layer sections are skipped
    by their lengths (a resource's name and data padded to even lengths);
  * the image data: one plane a channel, raw or PackBits (compression 1:
    the per-row byte counts of every channel first, each channel's rows
    then read from its own offset by the C++ copy of PackDecode,
    rledec.cpp, which drops bytes past a line's end).
`info["icc_profile"]` is bytes, so Pillow's `info` holds no strings."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"8BPS")


class _File:
    def __init__(self, blob: bytes):
        self.blob, self.pos = blob, 0

    def read(self, n: int) -> bytes:
        out = self.blob[self.pos:self.pos + max(0, n)]
        self.pos += len(out)
        return out

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]


def open_image(blob: bytes) -> pixels.Opened:
    f = _File(blob)
    s = f.read(26)
    if not accept(s) or struct.unpack_from(">H", s, 4)[0] != 1:
        raise SyntaxError("not a PSD file")
    psd_channels, height, width, psd_bits, psd_mode = struct.unpack_from(
        ">HIIHH", s, 12)
    mode, channels = MODES[(psd_mode, psd_bits)]
    if channels > psd_channels:
        raise OSError("not enough channels")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    palette = b""
    size = f.u32()
    if size:
        data = f.read(size)
        if mode == "P" and size == 768:
            palette = pixels.planar_palette(data)
    size = f.u32()
    if size:  # image resources
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.u16()
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            data = f.read(f.u32())
            if len(data) & 1:
                f.read(1)
    size = f.u32()
    if size:  # layer and mask information
        end = f.pos + size
        f.u32()
        f.pos = end
    compression = f.u16()
    offset = f.pos
    starts = []  # each channel's offset
    if compression == 0:
        for c in range(channels):
            starts.append(offset)
            offset += width * height
    elif compression == 1:
        counts = f.read(channels * height * 2)
        offset = f.pos
        for c in range(channels):
            starts.append(offset)
            for y in range(height):
                offset += struct.unpack_from(">H", counts,
                                             2 * (c * height + y))[0]
    # a channel of "1" and "P" unpacks as the mode, every other one as bytes
    raw = mode if mode in ("1", "P") else "L"

    def load() -> pixels.Decoded:
        if not starts:
            raise RasterError("cannot load this image")
        linebytes = rawmode.linebytes(raw, width)
        planes = []
        for start in starts:
            if compression == 0:
                lines = pixels.raw_lines(blob, start, linebytes, height)
            else:
                lines, done = _native.rle_lines("packbits", blob, start,
                                                linebytes, height)
                if done < height:
                    raise RasterError(pixels.TRUNCATED)
            planes.append(rawmode.unpack(lines, raw, width))
        if mode == "CMYK":
            planes = [255 - p for p in planes]
        elif mode == "LAB":  # Pillow's "A" and "B" unpackers flip the sign
            planes[1:] = [p ^ 0x80 for p in planes[1:]]
        arr = planes[0] if len(planes) == 1 else np.stack(planes, axis=-1)
        return pixels.Decoded(mode, arr, palette)

    return pixels.Opened(mode, (width, height), load)
