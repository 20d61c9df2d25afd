"""IM Tools reader: the image Pillow 12.1 opens from an IM Tools file
(PIL/ImtImagePlugin.py): no `_accept`, so every file with a line feed in
its first 100 bytes that reaches the plugin is read as "key value" lines
(a "*" line a comment) up to a form feed: "width n" and "height n" set the
size (an n that is no integer fails the open with Pillow's ValueError),
"pixel n8" the mode "L"; the raw rows follow the form feed. A line that
is empty, over 100 bytes or no "key value" pair ends the header without a
tile, which fails the load. Pillow's `info` holds no strings for an IMT."""
from __future__ import annotations

import re

from ..errors import RasterError
from . import pixels, rawmode

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_image(blob: bytes) -> pixels.Opened:
    buffer, pos = blob[:100], min(100, len(blob))
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    width = height = 0
    mode = ""
    offset = None
    while True:
        if buffer:
            c, buffer = buffer[:1], buffer[1:]
        else:
            c, pos = blob[pos:pos + 1], min(pos + 1, len(blob))
        if not c:
            break
        if c == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += blob[pos:pos + 100]
            pos = min(pos + 100, len(blob))
        lines = buffer.split(b"\n")
        c += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(c) == 1 or len(c) > 100:
            break
        if c[0] == ord(b"*"):
            continue
        m = FIELD.match(c)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"

    def load() -> pixels.Decoded:
        if offset is None:
            raise RasterError("cannot load this image")
        lines = pixels.raw_lines(blob, offset, rawmode.linebytes("L", width),
                                 height)
        return pixels.Decoded("L", rawmode.unpack(lines, "L", width))

    return pixels.Opened(mode, (width, height), load)
