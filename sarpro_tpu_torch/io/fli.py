"""FLI / FLC reader: the image Pillow 12.1 opens from an Autodesk
animation (PIL/FliImagePlugin.py and its C `fli` decoder), quirks
included:

  * the 128-byte header (the reserved ranges zero), "P" at its size, and a
    file of no frames handed to the next plugin (Pillow's seek to frame 0
    fails);
  * the palette `_open` takes from the first frame's first colour chunk
    (type 4, or 11 at a shift of 2, both masked to 8 bits), the gray ramp
    where there is none, a 0xF100 prefix chunk skipped while it looks;
  * only the first frame, decoded from offset 128 (even past a prefix
    chunk, which the decoder then refuses, as Pillow's does) by the C++
    copy of FliDecode.c (_native/rledec.cpp): BLACK, BRUN, COPY, LC and SS2
    chunks into a zeroed image, colour and PSTAMP chunks skipped, anything
    else refused; Pillow hands the decoder the frame in reads of the
    frame's size, which `load` replays.
Pillow's `info` holds no strings for an FLI (the duration is an
integer)."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

ERRORS = {-1: "image buffer overrun error", -2: "decoding error",
          -3: "unknown error"}


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 16
            and struct.unpack_from("<H", prefix, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", prefix, 14)[0] in (0, 3))


def _palette(blob: bytes, pos: int, palette: list, shift: int) -> None:
    i = 0
    (packets,) = struct.unpack("<H", blob[pos:pos + 2])
    pos += 2
    for _ in range(packets):
        s = blob[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = blob[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            palette[i] = (s[k] << shift & 255, s[k + 1] << shift & 255,
                          s[k + 2] << shift & 255)
            i += 1


def open_image(blob: bytes) -> pixels.Opened:
    s = blob[:128]
    if not (accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    frames = struct.unpack_from("<H", s, 6)[0]
    width, height = struct.unpack_from("<HH", s, 8)
    palette = [(a, a, a) for a in range(256)]
    pos = 128
    s = blob[pos:pos + 16]
    pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF100:
        pos = 128 + struct.unpack_from("<I", s)[0]
        s = blob[pos:pos + 16]
        pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
        size = None
        for _ in range(struct.unpack_from("<H", s, 6)[0]):
            if size is not None:
                pos += size - 6
                if pos < 0:
                    raise OSError("[Errno 22] Invalid argument")
            s = blob[pos:pos + 6]
            pos += len(s)
            kind = struct.unpack_from("<H", s, 4)[0]
            if kind in (4, 11):
                _palette(blob, pos, palette, 2 if kind == 11 else 0)
                break
            size = struct.unpack_from("<I", s)[0]
            if not size:
                break
    if frames == 0:
        raise EOFError("attempt to seek outside sequence")
    s = blob[128:132]
    if not s:
        raise EOFError("missing frame size")
    (framesize,) = struct.unpack("<I", s)
    table = bytes(v for rgb in palette for v in rgb)

    def load() -> pixels.Decoded:
        image = np.zeros((height, width), np.uint8)
        at, buf = 128, b""
        while True:
            chunk = blob[at:at + framesize]
            at += len(chunk)
            if not chunk:
                raise RasterError(f"image file is truncated ({len(buf)} "
                                  "bytes not processed)")
            buf += chunk
            try:
                n, err = _native.fli_decode(buf, image)
            except RuntimeError as e:
                raise RasterError(str(e)) from e
            if n < 0:
                break
            buf = buf[n:]
        if err < 0:
            raise RasterError(ERRORS.get(err, f"decoder error {err}"))
        return pixels.Decoded("P", image, table)

    return pixels.Opened("P", (width, height), load)
