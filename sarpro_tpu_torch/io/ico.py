"""ICO and CUR readers: the image Pillow 12.1 opens from a Windows icon or
cursor (PIL/IcoImagePlugin.py, PIL/CurImagePlugin.py), quirks included:

  * ICO: the entry table sorted by colour depth, then by area, largest
    first (both sorts stable: the least colour depth among the largest
    frames comes first), and the first entry's frame loaded while the file
    opens (Pillow's `_open` calls `load`), so an error of the frame's own
    opening hands the file to the next plugin as Pillow's does. A PNG frame
    is the PNG image as io/png reads it (its mode kept); any other frame is
    a DIB (io/bmp.bitmap) of twice the frame's height whose upper half is
    read, then taken to "RGBA" with an alpha from the 32-bit pixels' fourth
    bytes (where the entry, not the bitmap, says 32 bits) or from the
    1-bit AND mask that ends where the entry's size says, rows bottom-up;
  * a frame of another size than its entry's keeps its own size (Pillow
    warns);
  * CUR: the first of the largest cursors (a later one must be wider and
    taller), its bitmap at the entry's offset read at half its height, no
    mask (a 32-bit bitmap at offset 22 reads as BGRA).
A CUR that finds no cursors, or whose bitmap header lies past the file's
end, is handed on (a true-colour TGA starts like a CUR)."""
from __future__ import annotations

import math
import struct

import numpy as np

from ..errors import RasterError
from . import bmp, pixels, png

ICO_MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"


def _entries(blob: bytes) -> list:
    """IcoFile's entries after its sorts: (width, height, bpp, size,
    offset) each."""
    count = struct.unpack_from("<H", blob, 4)[0]
    out = []
    pos = 6
    for _ in range(count):
        s = blob[pos:pos + 16]
        pos += len(s)
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp = struct.unpack_from("<H", s, 6)[0]
        size, offset = struct.unpack_from("<II", s, 8)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) \
            or 256
        out.append((width * height, depth, (width, height, bpp, size,
                                            offset)))
    out.sort(key=lambda e: e[1])
    out.sort(key=lambda e: e[0], reverse=True)
    return [e[2] for e in out]


def _frame(blob: bytes, width: int, height: int, bpp: int, size: int,
           offset: int) -> pixels.Decoded:
    """IcoFile.frame of an entry."""
    if blob[offset:offset + 8] == png.SIGNATURE:
        return png.read(blob[offset:])
    bm = bmp.bitmap(blob, offset)
    if not bm.mode or bm.width <= 0 or bm.height <= 0:
        raise SyntaxError("not identified by this plugin")
    pixels.check_size(bm.width, bm.height)
    w, h = bm.width, int(bm.height / 2)
    if h <= 0:
        raise RasterError("tile cannot extend outside image")
    img = pixels.Decoded(bm.mode, bmp.decode(blob, bm, w, h, False),
                         bm.palette)
    if bpp == 32:
        alpha = blob[bm.offset:bm.offset + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise RasterError("buffer is not large enough")
        mask = np.frombuffer(alpha, np.uint8, w * h).reshape(h, w)[::-1]
    else:
        padded = w + (32 - w % 32 if w % 32 else 0)
        total = int(padded * h / 8)
        at = offset + size - total
        data = blob[at:at + total] if at >= 0 else b""
        rows = pixels.raw_lines(data, 0, (w + 7) // 8, h, int(padded / 8))
        mask = np.where(np.unpackbits(rows, axis=1)[:, :w] == 0, 255,
                        0).astype(np.uint8)[::-1]
    out = pixels.to_rgba(img).copy()
    out[..., 3] = mask
    return pixels.Decoded("RGBA", out)


def ico_read(blob: bytes) -> pixels.Decoded:
    if not blob.startswith(ICO_MAGIC):
        raise SyntaxError("not an ICO file")
    entries = _entries(blob)
    if not entries:
        raise IndexError("list index out of range")
    img = _frame(blob, *entries[0])
    pixels.check_size(img.array.shape[1], img.array.shape[0])
    return img


def cur_open(blob: bytes) -> pixels.Opened:
    if not blob.startswith(CUR_MAGIC):
        raise SyntaxError("not a CUR file")
    m, pos = b"", 6
    for _ in range(struct.unpack_from("<H", blob, 4)[0]):
        s = blob[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    header = struct.unpack_from("<I", m, 12)[0]
    bm = bmp.bitmap(blob, header or pos, header=header)
    w, h = bm.width, bm.height // 2
    return pixels.Opened(bm.mode, (w, h), lambda: pixels.Decoded(
        bm.mode, bmp.decode(blob, bm, w, h, True), bm.palette))
