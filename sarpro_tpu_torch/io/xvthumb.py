"""XV thumbnail reader: the image Pillow 12.1 opens from an XV thumbnail
(PIL/XVThumbImagePlugin.py): "P7 332", the rest of that line, comment
lines starting "#", then the width and height; "P" raw rows after that
line under the 3-3-2 palette. Pillow's `info` holds no strings for an XV
thumbnail."""
from __future__ import annotations

from . import pixels, rawmode

MAGIC = b"P7 332"
PALETTE = bytes(v for r in range(8) for g in range(8) for b in range(4)
                for v in ((r * 255) // 7, (g * 255) // 7, (b * 255) // 3))


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def open_image(blob: bytes) -> pixels.Opened:
    if not blob.startswith(MAGIC):
        raise SyntaxError("not an XV thumbnail file")
    _, pos = pixels.readline(blob, 6)
    while True:
        s, pos = pixels.readline(blob, pos)
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    width, height = int(w), int(h)

    def load() -> pixels.Decoded:
        lines = pixels.raw_lines(blob, pos, width, height)
        return pixels.Decoded("P", rawmode.unpack(lines, "P", width), PALETTE)

    return pixels.Opened("P", (width, height), load)
