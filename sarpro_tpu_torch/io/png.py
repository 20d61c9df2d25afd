"""A small PNG codec (stdlib zlib and struct, with numpy): the port's
stand-in for Pillow, which the machine with the GPU does not have.

Writer: `encode_gray8`, one 8-bit grayscale image in one IDAT, every row
filter type 0 (the GUI's preview).

Reader: `read`, to the image Pillow opens (`pixels.Decoded`), and
`decode`, to the array the JAX package's PilRaster keeps of it
(sarpro_tpu/io/pilraster.py:89-128), with Pillow's PNG modes
(PIL/PngImagePlugin.py `_MODES`):
  * grayscale at 1 bit ("1", bool), 2 and 4 bits ("L", the value times 85
    or 17, as Pillow's "L;2" / "L;4" unpackers scale it), 8 bits ("L") and
    16 bits ("I;16", the full value);
  * RGB, gray + alpha and RGBA at 8 bits; at 16 bits Pillow keeps the high
    byte of each sample, and reads 16-bit gray + alpha as RGBA (L, L, L, A);
  * palettes at 1, 2, 4 and 8 bits, expanded to RGB as `convert("RGB")`
    does: an index past the palette reads black;
  * all five row filters, and Adam7 interlacing (each pass filtered on its
    own, its pixels put in their places);
  * tEXt, zTXt and iTXt chunks as the text strings of Pillow's `info`
    (latin-1 keys and tEXt / zTXt values, UTF-8 iTXt values; the tEXt key
    "exif" holds bytes there, not a string).
The image data is inflated as Pillow's loader feeds it (`_inflate`: the
decode stops once the image is whole, so the zlib stream's end, its
checksum and the data's CRCs are never checked), and the chunks after it
are read as its `load_end` reads them (`_after_image`: leniently, text
into `info`). Anything that is not a PNG, whose chunks before the image
data are cut or fail their CRC, or whose image data runs out or is broken,
raises `RasterError`, as does an image over Pillow's decompression-bomb
limit.
"""
from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from ..errors import RasterError
from . import pixels

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, and the bit depths Pillow reads
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_gray8(u8: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of a (rows, cols) u8 array: one IDAT, filter
    type 0 on every row."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if u8.ndim != 2 or 0 in u8.shape:
        raise ValueError(f"a non-empty 2-D u8 array is needed, got shape "
                         f"{u8.shape}")
    rows, cols = u8.shape
    raw = np.zeros((rows, cols + 1), np.uint8)  # a filter byte a row
    raw[:, 1:] = u8
    ihdr = struct.pack(">IIBBBBB", cols, rows, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


# PngStream.read's chunk types, and ImageFile.load's read size (Pillow's
# MAXBLOCK), in which Pillow's load_read hands the decoder the image data
_CID = re.compile(rb"\w\w\w\w")
MAXBLOCK = 65536
TEXT = (b"tEXt", b"zTXt", b"iTXt")


def _header(blob: bytes, pos: int):
    """(length, kind) of the chunk header at pos, or None where fewer than 8
    bytes are left."""
    if pos + 8 > len(blob):
        return None
    return struct.unpack(">I4s", blob[pos:pos + 8])


def _inflate(blob: bytes, pos: int, need: int) -> tuple:
    """(data, end): the first `need` bytes of the image data that starts
    with the IDAT chunk at `pos`, inflated as Pillow's load feeds its zip
    decoder (MAXBLOCK bytes of a chunk at a time, the next chunk's CRC
    skipped unchecked, its header read only while data is needed), and the
    position of the end of the last block read. The zlib stream's end and
    checksum are never reached once the image is whole."""
    inflater = zlib.decompressobj()
    out = bytearray()
    length, kind = _header(blob, pos)
    at, left = pos + 8, length
    while len(out) < need:
        if left <= 0:  # the next chunk, past its predecessor's CRC
            head = _header(blob, at + 4)
            if head is None:
                raise RasterError(f"truncated PNG: {pixels.TRUNCATED}")
            length, kind = head
            if not _CID.match(kind):
                raise RasterError(f"broken PNG file (chunk {kind!r})")
            if kind not in (b"IDAT", b"DDAT", b"fdAT"):
                raise RasterError(f"truncated PNG: {pixels.TRUNCATED}")
            at += 12
            if kind == b"fdAT":
                at, length = at + 4, length - 4
            left = length
        step = min(MAXBLOCK, left)
        block = blob[at:at + step]
        if not block:
            raise RasterError(f"truncated PNG: {pixels.TRUNCATED}")
        at, left = at + len(block), left - step
        try:
            out += inflater.decompress(inflater.unconsumed_tail + block,
                                       need - len(out))
        except zlib.error as e:
            raise RasterError(f"broken PNG: {e}") from e
    return bytes(out), at


def _after_image(blob: bytes, pos: int, info: dict) -> None:
    """PngImageFile.load_end from the end of the last image data read: each
    chunk's CRC skipped, text chunks into `info` up to IEND; a header that
    is cut short or no chunk type ends it quietly, a chunk cut short fails
    the load, as Pillow's does."""
    while True:
        head = _header(blob, pos + 4)
        if head is None or not _CID.match(head[1]):
            return
        length, kind = head
        pos += 12
        if kind == b"IEND":
            return
        if kind == b"fdAT":
            length -= 4
        data = blob[pos:pos + length] if length > 0 else b""
        if len(data) < length:
            raise RasterError(f"truncated PNG: chunk {kind!r} is cut short")
        pos += max(0, length)
        if kind in TEXT:
            try:
                _text(kind, data, info)
            except UnicodeDecodeError:
                return
        elif kind == b"eXIf":
            info.pop("exif", None)


def _text(kind: bytes, data: bytes, info: dict) -> None:
    """A text chunk into `info` as Pillow's chunk_tEXt / zTXt / iTXt put
    its strings there."""
    key, sep, value = data.partition(b"\0")
    if kind == b"iTXt":
        if not sep or len(value) < 2:
            return
        flag, method, rest = value[0], value[1], value[2:]
        parts = rest.split(b"\0", 2)
        if len(parts) < 3:
            return
        value = parts[2]
        if flag:
            if method != 0:
                return
            try:
                value = zlib.decompress(value)
            except zlib.error:
                return
        if key == b"XML:com.adobe.xmp":
            info.pop("xmp", None)  # bytes in Pillow's info
        try:  # a language tag or keyword that is not UTF-8 drops it too
            k = key.decode("latin-1")
            v = value.decode("utf-8")
            parts[0].decode("utf-8")
            parts[1].decode("utf-8")
        except UnicodeError:
            return
        info[k] = v
        return
    if kind == b"zTXt":
        if value and value[0] != 0:
            raise RasterError(f"unknown compression method {value[0]} in "
                              "zTXt chunk")
        try:
            value = zlib.decompress(value[1:])
        except zlib.error:
            value = b""
    if key:
        k = key.decode("latin-1")
        if kind == b"tEXt" and key == b"exif":
            info.pop(k, None)  # bytes in Pillow's info, not a string
        else:
            info[k] = value.decode("latin-1", "replace")


def _paeth_row(f: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return out


def _average_row(f: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """The (rows, stride) u8 scanlines of the inflated image data. Sub is a
    cumulative sum in each byte lane, Up an add; Average and Paeth depend
    on the byte to their left and run along the row."""
    if len(raw) < rows * (stride + 1):
        raise RasterError(f"truncated PNG: {len(raw)} bytes of image data, "
                          f"{rows * (stride + 1)} expected")
    lines = np.frombuffer(raw, np.uint8, rows * (stride + 1)).reshape(
        rows, stride + 1)
    out = np.empty((rows, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(rows):
        kind, f = int(lines[r, 0]), lines[r, 1:]
        if kind == 0:
            cur = f
        elif kind == 1:
            # stride is a multiple of bpp: bpp is 1 below 8 bits a pixel
            cur = (np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   .astype(np.uint8).reshape(-1))
        elif kind == 2:
            cur = f + prior
        elif kind == 3:
            cur = np.frombuffer(_average_row(bytearray(f), prior.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(bytearray(f), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise RasterError(f"broken PNG: row filter type {kind}")
        out[r] = cur
        prior = out[r]
    return out


def _samples(lines: np.ndarray, cols: int, depth: int,
             channels: int) -> np.ndarray:
    """(rows, cols, channels) sample values of unfiltered scanlines: u8,
    or u16 at 16 bits."""
    rows = len(lines)
    if depth == 16:
        return (lines[:, :2 * cols * channels].reshape(rows, -1).view(">u2")
                .astype(np.uint16).reshape(rows, cols, channels))
    if depth == 8:
        return lines[:, :cols * channels].reshape(rows, cols, channels)
    idx = np.unpackbits(lines, axis=1).reshape(rows, -1, depth) @ (
        1 << np.arange(depth - 1, -1, -1))
    return idx[:, :cols, None].astype(np.uint8)


def _image(raw: bytes, rows: int, cols: int, depth: int, channels: int,
           interlace: bool) -> np.ndarray:
    """(rows, cols, channels) samples of the inflated image data."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    if not interlace:
        stride = (cols * bits + 7) // 8
        return _samples(_unfilter(raw, rows, stride, bpp), cols, depth,
                        channels)
    out = np.zeros((rows, cols, channels),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in ADAM7:
        ph, pw = -(-(rows - y0) // dy), -(-(cols - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        stride = (pw * bits + 7) // 8
        lines = _unfilter(raw[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _samples(lines, pw, depth, channels)
    return out


def read(blob: bytes) -> pixels.Decoded:
    """The image Pillow opens from a PNG: its mode, `np.asarray` of it, the
    palette of a "P" image and the string values of its `info`."""
    if not blob.startswith(SIGNATURE):
        raise RasterError("not a PNG file")
    header = None
    palette = b""
    info: dict = {}
    pos = len(SIGNATURE)
    while True:  # PngImageFile._open: the chunks before the image data
        head = _header(blob, pos)
        if head is None:
            raise RasterError("truncated PNG: no IDAT chunk")
        length, kind = head
        if not _CID.match(kind):
            raise RasterError(f"broken PNG file (chunk {kind!r})")
        if kind in (b"IDAT", b"IEND"):
            break
        end = pos + 8 + length
        if end + 4 > len(blob):
            raise RasterError(f"truncated PNG: chunk {kind!r} is cut short")
        data = blob[pos + 8:end]
        if zlib.crc32(kind + data) & 0xFFFFFFFF != \
                struct.unpack(">I", blob[end:end + 4])[0]:
            raise RasterError(f"broken PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            if len(data) < 13:
                raise RasterError("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"PLTE":
            palette = data
        elif kind in TEXT:
            _text(kind, data, info)
        elif kind == b"eXIf":
            info.pop("exif", None)  # bytes in Pillow's info
        pos = end + 4
    if header is None or kind != b"IDAT":
        raise RasterError("broken PNG: no IHDR or no IDAT chunk")
    cols, rows, depth, ctype, _, filt, interlace = header
    if ctype not in _SAMPLES or depth not in _DEPTHS[ctype]:
        raise RasterError(f"unsupported PNG: colour type {ctype} at "
                          f"{depth} bits")
    if filt:
        raise RasterError("unknown filter category")
    if rows == 0 or cols == 0:
        raise RasterError("broken PNG: empty image")
    pixels.check_size(cols, rows)
    bits = _SAMPLES[ctype] * depth
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    need = sum(-(-(rows - y0) // dy) * (1 + (-(-(cols - x0) // dx) * bits
                                             + 7) // 8)
               for y0, x0, dy, dx in passes
               if rows > y0 and cols > x0)
    raw, end = _inflate(blob, pos, need)
    _after_image(blob, end, info)
    img = _image(raw, rows, cols, depth, _SAMPLES[ctype], bool(interlace))
    if ctype == 3:
        return pixels.Decoded("P", img[..., 0], palette, info)
    if ctype == 0:
        gray = img[..., 0]
        if depth == 1:
            return pixels.Decoded("1", gray != 0, info=info)
        if depth == 16:
            return pixels.Decoded("I;16", gray, info=info)
        scale = {2: 85, 4: 17, 8: 1}[depth]  # Pillow's L;2 / L;4 unpackers
        return pixels.Decoded("L", gray * np.uint8(scale), info=info)
    if depth == 16:
        img = (img >> 8).astype(np.uint8)  # Pillow's RGB;16B / RGBA;16B / LA;16B
        if ctype == 4:
            return pixels.Decoded("RGBA", np.ascontiguousarray(
                img[..., [0, 0, 0, 1]]), info=info)
    return pixels.Decoded({2: "RGB", 4: "LA", 6: "RGBA"}[ctype], img,
                          info=info)


def decode(blob: bytes) -> tuple[np.ndarray, dict]:
    """(data, text) of a PNG: data (rows, cols, samples), u8, bool for 1-bit
    grayscale or u16 for 16-bit grayscale, as PilRaster normalizes Pillow's
    decode; text the string values of Pillow's `info`."""
    img = read(blob)
    return pixels.normalise(img, "PNG"), img.info
