"""What the port's raster decoders (io/png, io/jpeg, io/bmp, io/gif,
io/netpbm, io/jpeg2000) share: the image each one gives, as Pillow's `Image.open` and
`load()` would give it (its mode and `np.asarray` of it), Pillow's
decompression-bomb rule, and the normalisation the JAX package's PilRaster
applies to an opened image (sarpro_tpu/io/pilraster.py:99-128)."""
from __future__ import annotations

import dataclasses
import logging

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
