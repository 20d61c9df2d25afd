"""What the port's raster decoders (io/png, io/jpeg, io/bmp, io/gif,
io/netpbm, io/jpeg2000, io/webp and the modules of Pillow's other formats)
share: the image each one gives, as Pillow's `Image.open` and `load()` would
give it (its mode and `np.asarray` of it), the header a plugin's `_open`
reads before `load()` (Opened), Pillow's raw decoder over a file's bytes
(raw_lines), its decompression-bomb rule, and the normalisation the JAX
package's PilRaster applies to an opened image
(sarpro_tpu/io/pilraster.py:99-128)."""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from ..errors import RasterError

logger = logging.getLogger("sarpro")

# PIL.Image.MAX_IMAGE_PIXELS (Pillow 12.1): Image.open warns above it and
# raises above twice it
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)


@dataclasses.dataclass
class Decoded:
    """An opened image: Pillow's `mode`, `np.asarray` of it ((rows, cols)
    or (rows, cols, bands); bool for mode "1", int32 for "I"), the RGB
    palette of a "P" image, and the string values of Pillow's `info`."""

    mode: str
    array: np.ndarray
    palette: bytes = b""
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Opened:
    """What a Pillow plugin's `_open` establishes before `load()`: the
    mode, the (width, height) size, and the loader that decodes the pixels
    (RasterError where Pillow's `load()` fails)."""

    mode: str
    size: tuple
    load: Callable[[], Decoded]


TRUNCATED = "image file is truncated"


def raw_lines(blob, offset: int, linebytes: int, rows: int,
              stride: int = 0, ystep: int = 1) -> np.ndarray:
    """(rows, linebytes) u8 of Pillow's raw decoder from blob[offset:]: one
    line every `stride` bytes (every `linebytes` where stride is 0), the
    first one in the file the image's top row (its bottom row where ystep
    is -1). The last line needs no padding after it; data cut short raises
    RasterError."""
    stride = stride or linebytes
    if stride < linebytes:
        raise RasterError("codec configuration error when reading image file")
    if offset < 0:
        raise RasterError("Tile offset cannot be negative")
    if rows > 0 and offset + (rows - 1) * stride + linebytes > len(blob):
        raise RasterError(TRUNCATED)
    buf = np.frombuffer(blob, np.uint8)
    lines = np.lib.stride_tricks.as_strided(
        buf[offset:], (rows, linebytes), (stride, 1)) if rows else \
        np.zeros((0, linebytes), np.uint8)
    return lines[::-1] if ystep < 0 else lines


def check_size(width: int, height: int) -> None:
    """Pillow's `_decompression_bomb_check` on an image's size."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise RasterError(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS "
            "attack.")
    if pixels > MAX_IMAGE_PIXELS:
        logger.warning("Image size (%d pixels) exceeds limit of %d pixels, "
                       "could be decompression bomb DOS attack.", pixels,
                       MAX_IMAGE_PIXELS)


def palette_rgb(indices: np.ndarray, palette: bytes) -> np.ndarray:
    """`convert("RGB")` of a "P" image: each index's palette entry, black
    past the palette's end."""
    table = np.zeros((256, 3), np.uint8)
    n = min(len(palette) // 3, 256)
    table[:n] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
    return table[indices]


def to_rgba(img: Decoded) -> np.ndarray:
    """`convert("RGBA")` of an image of mode "1", "L", "LA", "P", "RGB" or
    "RGBA" (a palette's entries black past its end, alpha 255 where the
    mode has none)."""
    a = img.array
    if img.mode == "RGBA":
        return a
    if img.mode == "P":
        rgb = palette_rgb(a, img.palette)
    elif img.mode in ("1", "L", "LA"):
        gray = a.astype(np.uint8) * 255 if img.mode == "1" else (
            a if img.mode == "L" else a[..., 0])
        rgb = np.repeat(gray[..., None], 3, axis=2)
    elif img.mode == "RGB":
        rgb = a
    else:
        raise RasterError(f"no conversion of a {img.mode} image to RGBA")
    out = np.full(rgb.shape[:2] + (4,), 255, np.uint8)
    out[..., :3] = rgb
    if img.mode == "LA":
        out[..., 3] = a[..., 1]
    return out


def readline(blob: bytes, pos: int) -> tuple:
    """A file's readline() from `pos`: (the line with its line feed, the
    position after it)."""
    end = blob.find(b"\n", pos)
    end = len(blob) if end < 0 else end + 1
    return blob[pos:end], end


def check_palette_mode(mode: str) -> None:
    """Pillow realises a plugin's palette at load: only "L", "LA", "P" and
    "PA" images take one."""
    if mode not in ("L", "LA", "P", "PA"):
        raise RasterError("unrecognized image mode")


def check_palette_size(nbytes: int, bits: int) -> None:
    """Pillow's putpalette: a table of more than 256 entries of `bits` bits
    fails the load."""
    if nbytes * 8 // bits > 256:
        raise RasterError("invalid palette size")


def planar_palette(table: bytes) -> bytes:
    """An "RGB;L" palette (every red, then every green, then every blue) as
    RGB triples: len(table) // 3 entries, as Pillow unpacks it."""
    n = len(table) // 3
    return np.frombuffer(table, np.uint8, 3 * n).reshape(3, n).T.tobytes()


def normalise(img: Decoded, name) -> np.ndarray:
    """The (rows, cols, bands) array the JAX PilRaster keeps of an opened
    image: palettes expanded to RGB, "I" to u16 (values outside u16 refused
    with its message, naming `name`), "I;16*" to u16, the rest as
    `np.asarray` gives them (bool for "1")."""
    raw = img.array
    if img.mode == "P":
        data = palette_rgb(raw, img.palette)
    elif img.mode == "I":
        if raw.size and (raw.min() < 0 or raw.max() > 65535):
            raise RasterError(
                f"{name}: 32-bit integer raster exceeds uint16 range "
                f"({raw.min()}..{raw.max()}); convert to uint16 or GeoTIFF "
                "first")
        data = raw.astype(np.uint16)
    elif img.mode in ("I;16", "I;16B", "I;16L"):
        data = np.asarray(raw, np.uint16)
    else:
        data = raw
    return data[..., None] if data.ndim == 2 else data
