"""Netpbm reader: the image Pillow 12.1 opens from a P1-P6 file or one of
its extensions (PIL/PpmImagePlugin.py's header tokens, modes and decoders):

  * P1 / P4 give mode "1" (0 is white: True), P2 / P5 "L", or "I" (int32)
    where maxval is over 255, P3 / P6 "RGB";
  * raw files at maxval 255 (and P5 at 65535) are read as they are; other
    maxvals are rescaled to 255 (65535 for "I") with Python's round of
    value / maxval * top, as Pillow's PpmDecoder does;
  * plain files are read in Pillow's 1 MiB blocks with its comment rule (a
    comment runs from "#" to the next CR or LF and is cut out, joining what
    stood on its two sides), tokens of at most 10 characters, and values
    checked against maxval;
  * Pf gives mode "F": float32 samples, little-endian where the scale
    token is negative and big-endian where it is positive, rows bottom-up
    (`info["scale"]` is a float, so it adds no metadata);
  * P0CMYK and PyCMYK give "CMYK", PyRGBA "RGBA" and PyP "P" (a palette
    image with no palette: `convert("RGB")` makes it black), raw and
    rescaled as P5 / P6 are.
A file cut short raises RasterError. Pillow's `info` holds no strings for
these files."""
from __future__ import annotations

import numpy as np

from ..errors import RasterError
from . import pixels, rawmode

MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
         "CMYK": 4}
WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
BLOCK = 1024 * 1024  # PIL.ImageFile.SAFEBLOCK
MAX_TOKEN = 10


def accept(prefix: bytes) -> bool:
    """Pillow's PpmImagePlugin._accept."""
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in \
        b"0123456fy"


class _Reader:
    def __init__(self, blob: bytes):
        self.blob, self.pos = blob, 0

    def read(self, n: int) -> bytes:
        out = self.blob[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.read(1)
            if not c or c in WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= MAX_TOKEN:
            c = self.read(1)
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read(1) not in b"\r\n":  # b"" at the end stops too
                    pass
                continue
            token += c
        if not token:
            raise RasterError("Reached EOF while reading header")
        if len(token) > MAX_TOKEN:
            raise RasterError(f"Token too long in file header: {token!r}")
        return token


def _int(token: bytes, what: str) -> int:
    try:
        return int(token)
    except ValueError as e:
        raise RasterError(f"netpbm {what}: {e}") from e


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """Pillow's PpmPlainDecoder over the data from `reader`'s position."""

    def __init__(self, reader: _Reader):
        self.reader = reader
        self.spans = False

    def block(self) -> bytes:
        return self.reader.read(BLOCK)

    def drop_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> bytes:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.drop_comments(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise RasterError(
                    f"Invalid token for this mode: {bad[:1]!r}")
            data = (data + tokens)[:total]
        return data

    def values(self, total: int, maxval: int) -> list:
        values: list = []
        half = b""
        while len(values) != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "
            block = self.drop_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > MAX_TOKEN:
                    raise RasterError("Token too long found in data")
            for token in tokens:
                if len(token) > MAX_TOKEN:
                    raise RasterError("Token too long found in data")
                value = _int(token, "value")
                if value < 0:
                    raise RasterError(f"Channel value is negative: {value}")
                if value > maxval:
                    raise RasterError(
                        f"Channel value too large for this mode: {value}")
                values.append(value)
                if len(values) == total:
                    break
        return values


def _rescale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """min(top, round(v / maxval * top)) in float64, ties to even."""
    return np.minimum(top, np.rint(v.astype(np.float64) / maxval * top))


def read(blob: bytes) -> pixels.Decoded:
    r = _Reader(blob)
    magic = r.magic()
    if magic not in MODES:
        raise SyntaxError("not a PPM file")  # Pillow tries the next plugin
    mode = MODES[magic]
    width, height = _int(r.token(), "width"), _int(r.token(), "height")
    maxval = 1
    if mode == "F":
        token = r.token()
        try:
            scale = float(token)
        except ValueError as e:
            raise RasterError(str(e)) from e
        if scale == 0.0 or not np.isfinite(scale):
            raise RasterError("scale must be finite and non-zero")
    elif mode != "1":
        maxval = _int(r.token(), "maxval")
        if not 0 < maxval < 65536:
            raise RasterError("maxval must be greater than 0 and less than "
                              "65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise SyntaxError("not identified by this plugin")
    pixels.check_size(width, height)
    bands = BANDS[mode]
    shape = (height, width, bands) if bands > 1 else (height, width)
    count = width * height * bands
    top = 65535 if mode == "I" else 255
    if magic in (b"P1", b"P2", b"P3"):
        plain = _Plain(r)
        if mode == "1":
            data = plain.bitonal(count)
            if len(data) < count:
                raise RasterError("not enough image data")
            arr = np.frombuffer(data, np.uint8) == ord("0")
        else:
            values = plain.values(count, maxval)
            if len(values) < count:
                raise RasterError("not enough image data")
            arr = _rescale(np.asarray(values, np.int64), maxval, top)
        return pixels.Decoded(mode, arr.astype(
            bool if mode == "1" else np.int32 if mode == "I" else np.uint8)
            .reshape(shape))
    start = r.pos
    if mode == "1":
        stride = (width + 7) // 8
        if start + stride * height > len(blob):
            raise RasterError("image file is truncated")
        rows = np.frombuffer(blob, np.uint8, stride * height,
                             start).reshape(height, stride)
        arr = np.unpackbits(rows, axis=1)[:, :width] == 0
        return pixels.Decoded(mode, arr)
    if mode == "F":
        lines = pixels.raw_lines(blob, start, 4 * width, height, ystep=-1)
        return pixels.Decoded(mode, rawmode.unpack(
            lines, "F;32F" if scale < 0 else "F;32BF", width))
    size = 1 if maxval < 256 else 2
    if maxval == 255 or (maxval == 65535 and mode == "I"):
        if start + count * size > len(blob):
            raise RasterError("image file is truncated")
        raw = np.frombuffer(blob, np.uint8 if size == 1 else ">u2", count,
                            start)
        arr = raw.astype(np.int32 if mode == "I" else np.uint8)
        return pixels.Decoded(mode, arr.reshape(shape))
    # PpmDecoder: whole pixels while the data lasts
    got = min(count, (len(blob) - start) // (size * bands) * bands)
    if got < count:
        raise RasterError("not enough image data")
    raw = np.frombuffer(blob, np.uint8 if size == 1 else ">u2", count, start)
    arr = _rescale(raw, maxval, top).astype(
        np.int32 if mode == "I" else np.uint8)
    return pixels.Decoded(mode, arr.reshape(shape))
