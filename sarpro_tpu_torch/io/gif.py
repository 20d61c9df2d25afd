"""GIF reader: the first frame, as Pillow 12.1's `Image.open(...).load()`
gives it (PIL/GifImagePlugin.py's rules):

  * mode "P" with the frame's palette (local, else global), or "L" where
    neither exists or the palette is the identity gray ramp (Pillow drops
    such a palette);
  * the image is the logical screen, grown to hold the frame where the
    frame reaches past it; outside the frame it holds the frame's
    transparency index, or 0;
  * the LZW stream (the C++ library), interlaced rows in four passes.
Later frames are not read (`load()` loads frame 0). A stream cut short or
with a code past the table raises RasterError. Pillow's `info` holds no
strings for a GIF."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

SIGNATURES = (b"GIF87a", b"GIF89a")


def _palette_needed(p: bytes) -> bool:
    """False for the identity gray ramp, which Pillow does not keep."""
    if len(p) % 3:
        raise RasterError("image file is truncated")
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p), 3))


def read(blob: bytes) -> pixels.Decoded:
    if len(blob) < 13 or blob[:6] not in SIGNATURES:
        raise RasterError("not a GIF file")
    width, height = struct.unpack_from("<HH", blob, 6)
    flags = blob[10]
    pos = 13
    global_palette = None
    if flags & 128:
        p = blob[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p):
            global_palette = p

    def byte() -> int:
        nonlocal pos
        if pos >= len(blob):
            return -1
        pos += 1
        return blob[pos - 1]

    def sub_block():
        """The next data sub-block, None at a terminator or the file's
        end (Pillow's `data()`)."""
        nonlocal pos
        n = byte()
        if n <= 0:
            return None
        pos += n
        return blob[pos - n:pos]

    transparency = None
    frame = None
    first = True
    while True:
        c = byte()
        if c < 0 or c == 0x3B:
            if first:
                raise RasterError("no more images in GIF file")
            break
        first = False
        if c == 0x21:  # extension
            label = byte()
            block = sub_block()
            if label == 249 and block is not None:
                if block[0] & 1:
                    transparency = block[3]
            elif label == 254:
                while block:
                    block = sub_block()
                continue
            elif label == 255 and block is not None and \
                    block.startswith(b"NETSCAPE2.0"):
                sub_block()
            while sub_block():
                pass
        elif c == 0x2C:  # image descriptor
            if pos + 9 > len(blob):
                raise RasterError("image file is truncated")
            x0, y0, w, h, fl = struct.unpack_from("<HHHHB", blob, pos)
            pos += 9
            palette = None
            if fl & 128:
                p = blob[pos:pos + (3 << ((fl & 7) + 1))]
                pos += len(p)
                palette = p if _palette_needed(p) else False
            bits = byte()
            frame = (x0, y0, w, h, bool(fl & 64), palette, bits, pos)
            break
    if frame is None:
        raise RasterError("image not found in GIF frame")
    x0, y0, w, h, interlace, palette, bits, data = frame
    width, height = max(width, x0 + w), max(height, y0 + h)
    pixels.check_size(width, height)
    frame_palette = palette if palette is not None else global_palette
    image = np.full((height, width),
                    transparency if transparency is not None else 0, np.uint8)
    try:
        _native.gif_lzw_decode(blob, data, bits, interlace, image, x0, y0,
                               w, h)
    except (ValueError, RuntimeError) as e:
        raise RasterError(f"GIF: {e}") from e
    if frame_palette:
        return pixels.Decoded("P", image, frame_palette)
    return pixels.Decoded("L", image)
