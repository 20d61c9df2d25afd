"""FITS reader: the image Pillow 12.1 opens from a FITS file
(PIL/FitsImagePlugin.py), quirks included:

  * 80-byte header cards; a header unit (SIMPLE or XTENSION ... END) is
    padded to 2880 bytes, and the first header that gives a size decides.
    The first card must be SIMPLE = T. NAXIS 0 gives no image ("No image
    data" where the data starts, "Truncated FITS file" where the file ends
    first); NAXIS 1 reads as width 1 and height NAXIS1;
  * BITPIX 8 is mode "L", 16 "I;16", 32 "I" and -32 / -64 "F". The raw
    tile's rawmode is the mode itself, so Pillow reads FITS's big-endian
    samples as little-endian, rows bottom-up, and a BITPIX -64 image as
    4-byte floats from the first half of its data;
  * a ZIMAGE BINTABLE with ZCMPTYPE 'GZIP_1' (FitsGzipDecoder): the rest of
    the file is gunzipped, each 4-byte entry is cut to its last
    min(ZBITPIX // 8, 4) bytes (no bytes for a float ZBITPIX, which leaves
    too little data), and the rows are reversed;
  * the data offset is where the card after the last END was read, less 80
    bytes, even where that card was cut short.
Pillow's `info` holds no strings for a FITS file."""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from ..errors import RasterError
from . import pixels, rawmode

BLOCK = 2880
MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"SIMPLE")


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """FitsImageFile._parse_headers: (decoder, offset, mode, size, bits),
    decoder "" where the header gives no size."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, "", None, 0
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, MODES.get(bits, ""), size, bits


def open_image(blob: bytes) -> pixels.Opened:
    headers: dict = {}
    in_progress = False
    decoder = ""
    pos = 0
    while True:
        card = blob[pos:pos + 80]
        pos += len(card)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break  # a data unit
        elif keyword == b"END":
            pos = math.ceil(pos / BLOCK) * BLOCK
            if not decoder:
                decoder, offset, mode, size, bits = _parse(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accept(keyword) or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    offset += pos - 80
    width, height = size

    def load() -> pixels.Decoded:
        if decoder == "raw":
            lines = pixels.raw_lines(blob, offset,
                                     rawmode.linebytes(mode, width), height,
                                     ystep=-1)
            return pixels.Decoded(mode, rawmode.unpack(lines, mode, width))
        try:
            value = gzip.decompress(blob[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise RasterError(str(e)) from e
        keep = min(bits // 8, 4)  # bytes kept of each 4-byte entry
        if keep <= 0 or len(value) < 4 * width * height:
            raise RasterError("not enough image data")
        entries = np.frombuffer(value, np.uint8, 4 * width * height)
        entries = entries.reshape(-1, 4)[:, 4 - keep:].reshape(-1)
        row = width * keep
        lines = entries[:row * height].reshape(height, row)[::-1]
        return pixels.Decoded(mode, rawmode.unpack(lines, mode, width))

    return pixels.Opened(mode, (width, height), load)
