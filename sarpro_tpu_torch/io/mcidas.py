"""McIdas AREA reader: the image Pillow 12.1 opens from a McIdas area file
(PIL/McIdasImagePlugin.py): a 256-byte directory of 64 big-endian words
(w[1..64]); 1-, 2- or 4-byte samples by w[11] (modes "L", "I;16B" and "I"
through rawmode "I;32B"); size (w[10], w[9]); the first line at w[34] +
w[15] and one line every w[15] + w[10] * w[11] * w[14] bytes, whatever w[14]
says of bands. Pillow maps an "L" or "I;16B" file into memory where the
lines, a stride apart, end within the file: there a stride below a line's
bytes overlaps the lines (bytes past the end of the file read as zeros, as
the mapped page's tail does) and one of 0 or less packs them. Otherwise its
raw decoder reads the lines, and refuses a stride below a line's bytes.
Pillow's `info` holds no strings for an area file."""
from __future__ import annotations

import struct

import numpy as np

from ..errors import RasterError
from . import pixels, rawmode

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def _mapped(blob: bytes, offset: int, linebytes: int, rows: int,
            stride: int) -> np.ndarray:
    """The lines of Image.core.map_buffer: one every `stride` bytes (every
    `linebytes` where stride is 0 or less), the mapping no longer than the
    file."""
    step = stride if stride > 0 else linebytes
    if offset + rows * step > len(blob):
        raise RasterError("buffer is not large enough")
    need = offset + (rows - 1) * step + linebytes
    buf = np.zeros(max(need, len(blob)), np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    return np.lib.stride_tricks.as_strided(buf[offset:], (rows, linebytes),
                                           (step, 1))


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:256]
    if not accept(s) or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = [0, *struct.unpack("!64i", s)]
    if w[11] not in MODES:
        raise SyntaxError("unsupported McIdas format")
    mode, raw = MODES[w[11]]
    width, height = w[10], w[9]
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]

    def load() -> pixels.Decoded:
        if not -2 ** 31 <= stride < 2 ** 31:  # a C int in Pillow's decoders
            raise RasterError("signed integer is less than minimum"
                              if stride < 0 else
                              "signed integer is greater than maximum")
        linebytes = rawmode.linebytes(raw, width)
        if raw == mode and offset >= 0 and \
                offset + height * stride <= len(blob):
            lines = _mapped(blob, offset, linebytes, height, stride)
        else:
            lines = pixels.raw_lines(blob, offset, linebytes, height, stride)
        return pixels.Decoded(mode, rawmode.unpack(lines, raw, width))

    return pixels.Opened(mode, (width, height), load)
