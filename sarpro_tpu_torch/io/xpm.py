"""XPM reader: the image Pillow 12.1 opens from an X11 pixel map
(PIL/XpmImagePlugin.py), quirks included: the first line matching the
values line (`"w h colours cpp`), each colour line's key (its `cpp`
characters after the quote) and its "c" value (#rrggbb taken as an
integer, "None" marking transparency and entering no palette; any other
value, or no "c", fails the open with Pillow's ValueError), "P" with the
colours in order (a key repeated keeps its first place and its last
value), or "RGB" past 256 colours; the pixel lines from the end of the
header, the "/* pixels */" comment skipped once, each line's text between
its first and last quote read `cpp` characters at a time, until the image
is full (a key outside the palette fails the load, as does too little
data). Pillow's `info` holds no strings for an XPM."""
from __future__ import annotations

import re

import numpy as np

from ..errors import RasterError
from . import pixels

HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"/* XPM */")


def open_image(blob: bytes) -> pixels.Opened:
    if not blob.startswith(b"/* XPM */"):
        raise SyntaxError("not an XPM file")
    pos = 9
    while True:
        line, pos = pixels.readline(blob, pos)
        if not line:
            raise SyntaxError("broken XPM file")
        m = HEAD.match(line)
        if m:
            break
    width, height = int(m.group(1)), int(m.group(2))
    count, cpp = int(m.group(3)), int(m.group(4))
    palette: dict = {}
    for _ in range(count):
        line, pos = pixels.readline(blob, pos)
        line = line.rstrip()
        key = line[1:cpp + 1]
        s = line[cpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                          v & 255))
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    mode = "RGB" if count > 256 else "P"
    start = pos

    def load() -> pixels.Decoded:
        index = {k: i for i, k in enumerate(palette)}
        need = width * height
        out = bytearray()
        at, header = start, False
        while len(out) < need * (3 if mode == "RGB" else 1):
            line, at = pixels.readline(blob, at)
            if not line:
                break
            if line.rstrip() == b"/* pixels */" and not header:
                header = True
                continue
            line = b'"'.join(line.split(b'"')[1:-1])
            for i in range(0, len(line), cpp):
                key = line[i:i + cpp]
                if mode == "RGB":
                    if key not in palette:
                        raise RasterError(f"XPM: no colour {key!r}")
                    out += palette[key]
                else:
                    if key not in index:
                        raise RasterError(f"XPM: {key!r} is not in the "
                                          "palette")
                    out.append(index[key])
        bands = 3 if mode == "RGB" else 1
        if len(out) < need * bands:
            raise RasterError("not enough image data")
        arr = np.frombuffer(bytes(out), np.uint8, need * bands)
        arr = arr.reshape((height, width, 3) if bands == 3 else
                          (height, width))
        return pixels.Decoded(mode, arr.copy(), b"".join(palette.values()))

    return pixels.Opened(mode, (width, height), load)
