"""Pillow 12.1's unpackers (libImaging/Unpack.c) for the rawmodes of the
formats read through io/pilraster's plugin loop: a (rows, bytes) array of
scanlines becomes the (rows, width[, bands]) array `np.asarray` gives of the
image's mode (bool for "1", int32 for "I", float32 for "F", uint16 for the
"I;16" modes). Float samples are moved as bits, so NaN payloads survive.

  * bit depths: "1" (MSB first, a set bit is white), "1;I" (inverted),
    "L;4" (4-bit gray times 17), "P;2" / "P;4" (packed indices) and "P;2L"
    / "P;4L" (bit planes, each (width + 7) // 8 bytes);
  * samples: "L", "P", "I;16" / "I;16L" / "I;16B", "I" / "I;32" / "I;32S"
    / "I;32B", "F" / "F;32F" / "F;32BF", and the integer-to-float "F;8" /
    "F;8S" / "F;16" / "F;16S" / "F;32";
  * pixels: "RGB", "BGR", "RGBA", "RGBX", "BGRX", "BGRA", "LA", "BGRA;15Z" (5-5-5
    with an inverted alpha bit), and the line-interleaved ";L" forms (each
    band's row after the other's).
Only the rawmodes the readers use are here.
"""
from __future__ import annotations

import numpy as np

from ..errors import RasterError

# rawmode -> bits a pixel (Pillow's unpacker table)
BITS = {
    "1": 1, "1;I": 1, "P;2": 2, "P;4": 4, "L;4": 4, "P;2L": 2, "P;4L": 4,
    "L": 8, "P": 8, "I;16": 16, "I;16L": 16, "I;16B": 16, "I": 32,
    "I;32": 32, "I;32S": 32, "I;32B": 32, "F": 32, "F;32F": 32,
    "F;32BF": 32, "F;8": 8, "F;8S": 8, "F;16": 16, "F;16S": 16, "F;32": 32,
    "RGB": 24, "BGR": 24, "RGBA": 32, "RGBX": 32, "BGRX": 32, "BGRA": 32, "LA": 16,
    "BGRA;15Z": 16, "RGB;L": 24, "RGBA;L": 32, "RGBX;L": 32, "CMYK;L": 32,
    "YCbCr;L": 24, "LA;L": 16, "PA;L": 16,
}

_SCALAR = {  # rawmode -> (file dtype, image dtype)
    "L": ("u1", np.uint8), "P": ("u1", np.uint8),
    "I;16": ("<u2", np.uint16), "I;16L": ("<u2", np.uint16),
    "I;16B": (">u2", np.uint16), "I": ("<i4", np.int32),
    "I;32": ("<i4", np.int32), "I;32S": ("<i4", np.int32),
    "I;32B": (">i4", np.int32), "F;8": ("u1", np.float32),
    "F;8S": ("i1", np.float32), "F;16": ("<u2", np.float32),
    "F;16S": ("<i2", np.float32), "F;32": ("<u4", np.float32),
}
_FLOAT_BITS = {"F": "<u4", "F;32F": "<u4", "F;32BF": ">u4"}
# interleaved pixels: rawmode -> the byte of each output band
_PIXELS = {
    "RGB": (3, (0, 1, 2)), "BGR": (3, (2, 1, 0)), "RGBA": (4, (0, 1, 2, 3)),
    "RGBX": (4, (0, 1, 2)),
    "BGRX": (4, (2, 1, 0)), "BGRA": (4, (2, 1, 0, 3)), "LA": (2, (0, 1)),
}
# line-interleaved: rawmode -> (planes in the line, planes kept)
_PLANES = {"RGB;L": (3, 3), "RGBA;L": (4, 4), "RGBX;L": (4, 3),
           "CMYK;L": (4, 4), "YCbCr;L": (3, 3), "LA;L": (2, 2),
           "PA;L": (2, 2)}


def linebytes(rawmode: str, width: int) -> int:
    """Bytes a scanline of `width` pixels takes in `rawmode`."""
    return (width * BITS[rawmode] + 7) // 8


def _bits(lines: np.ndarray, width: int, bits: int) -> np.ndarray:
    """MSB-first `bits`-bit fields of each line, `width` of them."""
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    n = (width + per - 1) // per
    fields = (lines[:, :n, None] >> shifts) & ((1 << bits) - 1)
    return fields.reshape(lines.shape[0], -1)[:, :width]


def unpack(lines: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """The pixels of (rows, >= linebytes) u8 `lines` in `rawmode`."""
    rows = lines.shape[0]
    need = linebytes(rawmode, width)
    if rawmode in ("P;2L", "P;4L"):  # the unpacker reads whole planes
        need = BITS[rawmode] * ((width + 7) // 8)
    if lines.shape[1] < need:
        raise RasterError(f"scanline of {lines.shape[1]} bytes is short of "
                          f"{need} for rawmode {rawmode}")
    lines = np.ascontiguousarray(lines[:, :need])
    if rawmode in ("1", "1;I"):
        bits = np.unpackbits(lines, axis=1)[:, :width]
        return bits == (1 if rawmode == "1" else 0)
    if rawmode == "L;4":
        return (_bits(lines, width, 4) * 17).astype(np.uint8)
    if rawmode in ("P;2", "P;4"):
        return _bits(lines, width, BITS[rawmode]).astype(np.uint8)
    if rawmode in ("P;2L", "P;4L"):
        planes, step = BITS[rawmode], (width + 7) // 8
        bits = np.unpackbits(lines, axis=1)
        out = np.zeros((rows, width), np.uint8)
        for k in range(planes):
            out |= bits[:, 8 * k * step:8 * k * step + width] << k
        return out
    if rawmode in _FLOAT_BITS:
        return lines.view(_FLOAT_BITS[rawmode]).astype("<u4").view(
            np.float32).reshape(rows, width)
    if rawmode in _SCALAR:
        src, dst = _SCALAR[rawmode]
        return lines.view(src).astype(dst).reshape(rows, width)
    if rawmode in _PIXELS:
        size, order = _PIXELS[rawmode]
        px = lines.reshape(rows, width, size)
        return np.ascontiguousarray(px[:, :, list(order)])
    if rawmode == "BGRA;15Z":
        v = lines.view("<u2").reshape(rows, width).astype(np.uint32)
        out = np.empty((rows, width, 4), np.uint8)
        for band, shift in ((0, 10), (1, 5), (2, 0)):
            out[..., band] = ((v >> shift) & 31) * 255 // 31
        out[..., 3] = np.where(v & 0x8000, 0, 255)
        return out
    if rawmode in _PLANES:
        planes, keep = _PLANES[rawmode]
        px = lines[:, :planes * width].reshape(rows, planes, width)
        return np.ascontiguousarray(px[:, :keep].transpose(0, 2, 1))
    raise RasterError(f"unknown raw mode {rawmode}")
