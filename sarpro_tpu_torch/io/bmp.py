"""BMP reader: the image Pillow 12.1 opens from a Windows or OS/2 bitmap
(PIL/BmpImagePlugin.py's header, palette and mode rules, and its raw and
RLE decoders), quirks included:

  * 1, 4 and 8 bits with a palette: mode "1" for a two-colour black / white
    palette, "L" for a palette of grays (entry i is (i, i, i)), else "P";
    16 bits (5-5-5, or 5-6-5 by BI_BITFIELDS masks), 24 bits, 32 bits
    (RGB, or RGBA where the masks name an alpha channel);
  * bottom-up and top-down (negative height) rows, uncompressed, RLE8 and
    RLE4 (the C++ library's copy of Pillow's BmpRleDecoder: its delta
    record skips two bytes before the offsets it reads);
  * the data offset Pillow takes (the palette's size added where the
    header's offset points right after the header).
Headers, depths, masks and compressions Pillow refuses raise RasterError,
as does a file cut short. Pillow's `info` holds no strings for a BMP.

`bitmap` is Pillow's `_bitmap` on its own: the header and palette of a
bitmap without the file header, from any position (DIB files, the frames
of ICO and CUR files), which `decode` then reads at the size the caller
gives (an icon's frame is half its bitmap's height). Where Pillow's
`_bitmap` raises struct.error (a header size or a mask cut short) so does
`bitmap`, which hands the file to the next plugin."""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

SIGNATURE = b"BM"
# bits -> (mode, rawmode): PIL/BmpImagePlugin.py BIT2MODE
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
            16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# (bits, masks) -> rawmode of a BI_BITFIELDS file
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# PIL.Image._MAPMODES
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")
# rawmode -> bits a pixel
RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
            "BGR;16": 16, "BGR": 24}


def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """(rows, width[, bands]) pixels of (rows, linebytes) u8 scanlines, as
    Pillow's unpacker for `rawmode` gives them."""
    if rawmode in ("1", "P;1"):
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return bits.astype(bool) if rawmode == "1" else bits
    if rawmode == "P;4":
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(
            len(rows), -1)[:, :width]
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        p = rows[:, :2 * width].reshape(len(rows), width, 2).astype(np.int32)
        p = p[..., 0] | (p[..., 1] << 8)
        if rawmode == "BGR;15":
            r, g, b = (p >> 10) & 31, (p >> 5) & 31, p & 31
            rgb = (r * 255 // 31, g * 255 // 31, b * 255 // 31)
        else:
            r, g, b = (p >> 11) & 31, (p >> 5) & 63, p & 31
            rgb = (r * 255 // 31, g * 255 // 63, b * 255 // 31)
        return np.stack(rgb, axis=2).astype(np.uint8)
    n = len(rawmode)  # "BGR" and the 32-bit byte orders
    px = np.lib.stride_tricks.as_strided(rows, (len(rows), width, n),
                                         (rows.strides[0], n, 1))
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    if order == [2, 1, 0]:  # BGR, BGRX: a view, copied once by the caller
        return px[..., 2::-1]
    return px[..., order]


@dataclasses.dataclass
class Bitmap:
    """What Pillow's `_bitmap` reads: the mode, rawmode and palette, the
    size, the bits a pixel, the compression, the row direction (-1:
    bottom-up), the row stride, and where the pixels start."""

    mode: str
    rawmode: str
    width: int
    height: int
    bits: int
    compression: int
    direction: int
    palette: bytes
    offset: int
    stride: int


def bitmap(blob: bytes, pos: int, offset: int = 0,
           header: int = 0) -> Bitmap:
    """Pillow's `_bitmap(header, offset)` with the file at `pos` (`header`,
    where not 0, is also that position: a 32-bit raw bitmap at 22, a
    cursor's first, reads as BGRA)."""
    header_size = struct.unpack("<I", blob[pos:pos + 4])[0]
    pos += 4
    if header_size > 4 and len(blob) < pos + header_size - 4:
        raise RasterError("Truncated File Read")
    hd = blob[pos:pos + max(0, header_size - 4)]
    pos += len(hd)
    colors = 0
    masks = None
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<4H", hd, 0)
        compression, padding, direction = 0, 3, -1
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _u32(hd, 0)
        height = 2 ** 32 - _u32(hd, 4) if y_flip else _u32(hd, 4)
        bits = _u16(hd, 10)
        compression = _u32(hd, 12)
        colors = _u32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [_u32(hd, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:  # read(4) each: a mask cut short hands the file on
                masks = [struct.unpack("<I", blob[p:p + 4])[0]
                         for p in range(pos, pos + 12, 4)] + [0]
                pos += 12
    else:
        raise RasterError(f"Unsupported BMP header type ({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise RasterError(f"Unsupported BMP pixel depth ({bits})")
    mode, rawmode = BIT2MODE[bits]
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in MASK_MODES:
            raise RasterError("Unsupported BMP bitfields layout")
        rawmode = MASK_MODES[key]
        if bits == 32 and "A" in rawmode:
            mode = "RGBA"
    elif compression == 0:
        if bits == 32 and header == 22:
            mode, rawmode = "RGBA", "BGRA"
    elif compression not in (1, 2):
        raise RasterError(f"Unsupported BMP compression ({compression})")
    palette = b""
    if mode == "P":
        if not 0 < colors <= 65536:
            raise RasterError(f"Unsupported BMP Palette size ({colors})")
        raw = blob[pos:pos + padding * colors]
        pos += len(raw)
        indices = (0, 255) if colors == 2 else range(colors)
        if all(raw[i * padding:i * padding + 3] == bytes([v & 255]) * 3
               for i, v in enumerate(indices)):
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            entries = np.frombuffer(raw[:len(raw) // padding * padding],
                                    np.uint8).reshape(-1, padding)
            if len(entries) > 256:
                raise RasterError("invalid palette size")
            palette = entries[:, 2::-1].tobytes()  # BGR(X) -> RGB
    return Bitmap(mode, rawmode, width, height, bits, compression, direction,
                  palette, offset or pos, ((width * bits + 31) >> 3) & ~3)


def decode(blob: bytes, bm: Bitmap, width: int, height: int,
           mapped: bool) -> np.ndarray:
    """The (height, width[, bands]) pixels of the bitmap's tile at that
    size; `mapped`: Pillow may map the file's rows (a file opened by its
    path, not an icon's frame)."""
    mode, rawmode, bits, start = bm.mode, bm.rawmode, bm.bits, bm.offset
    if bm.compression in (1, 2):
        if mode == "1":
            raise RasterError("unknown raw mode for given image mode")
        try:
            data, n = _native.bmp_rle_decode(blob, start, width,
                                             width * height,
                                             bm.compression == 2)
        except (ValueError, RuntimeError) as e:
            raise RasterError(f"BMP: {e}") from e
        if n < width * height:
            raise RasterError("not enough image data")
        arr = data.reshape(height, width)
    else:
        stride = bm.stride
        linebytes = (RAW_BITS.get(rawmode, 32) * width + 7) // 8
        # Pillow maps a file's rows in place where the rawmode is the mode
        # and the rows fit in it (ImageFile.load): rows then start `stride`
        # apart whatever their length; its decoder refuses a short stride
        mapped = (mapped and rawmode == mode and mode in MAPMODES
                  and start + stride * height <= len(blob))
        if stride < linebytes and not mapped:
            raise RasterError("BMP: the row stride is shorter than a row of "
                              f"{rawmode} pixels")
        end = start + stride * (height - 1) + linebytes
        buf = np.frombuffer(blob, np.uint8)
        if height and end > len(blob):
            if not mapped:
                raise RasterError("image file is truncated")
            # a mapped last row runs on into the zeros past the file's end
            buf = np.concatenate([buf, np.zeros(end - len(blob), np.uint8)])
        rows = np.lib.stride_tricks.as_strided(
            buf[start:], (height, linebytes), (stride, 1)) if height else \
            np.zeros((0, linebytes), np.uint8)
        arr = _unpack(rows, rawmode, width)
    if bm.direction == -1:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)


def read(blob: bytes) -> pixels.Decoded:
    if not blob.startswith(SIGNATURE):
        raise SyntaxError("Not a BMP file")
    bm = bitmap(blob, 14, offset=struct.unpack("<I", blob[10:14])[0])
    pixels.check_size(bm.width, bm.height)
    return pixels.Decoded(bm.mode, decode(blob, bm, bm.width, bm.height,
                                          True), bm.palette)


def dib_open(blob: bytes) -> pixels.Opened:
    """A DIB file: a bitmap without its file header (DibImageFile)."""
    bm = bitmap(blob, 0)
    return pixels.Opened(bm.mode, (bm.width, bm.height),
                         lambda: pixels.Decoded(bm.mode, decode(
                             blob, bm, bm.width, bm.height, True),
                             bm.palette))
