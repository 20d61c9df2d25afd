"""GeoTIFF writers (reference: src/io/writers/tiff.rs:6-78).

Returns the open TiffWriter so metadata can be attached before the file is
materialized (the reference returns an open GDAL Dataset for the same
purpose; our writer defers the actual encode until `write`, so callers set
georeferencing/metadata first and then `flush`)."""
# A copy of sarpro_tpu/io/writers/tiff.py, so that the port imports nothing of
# the JAX package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..tiffio import TiffWriter


class PendingTiff:
    """A GeoTIFF write staged until metadata is attached — the equivalent of
    the reference's returned-open `Dataset` (tiff.rs:13-17)."""

    def __init__(self, path: Path, bands: list[np.ndarray]):
        self.writer = TiffWriter(path)
        self._bands = bands
        self._flushed = False

    def set_geo_transform(self, gt):
        self.writer.set_geotransform(gt)

    def set_projection(self, projection: str):
        self.writer.set_projection(projection)

    def set_metadata_item(self, key: str, value: str):
        self.writer.set_metadata_item(key, value)

    def flush(self):
        if not self._flushed:
            self.writer.write(self._bands)
            self._flushed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


def _as2d(data, cols: int, rows: int, dtype) -> np.ndarray:
    arr = np.asarray(data)
    return arr.reshape(rows, cols).astype(dtype, copy=False)


def write_tiff_u8(output, cols, rows, data) -> PendingTiff:
    """reference: tiff.rs:6-18."""
    return PendingTiff(Path(output), [_as2d(data, cols, rows, np.uint8)])


def write_tiff_u16(output, cols, rows, data) -> PendingTiff:
    """reference: tiff.rs:20-32."""
    return PendingTiff(Path(output), [_as2d(data, cols, rows, np.uint16)])


def write_tiff_multiband_u8(output, cols, rows, band1, band2) -> PendingTiff:
    """reference: tiff.rs:34-55 (2 bands, GrayIndex interpretation)."""
    return PendingTiff(Path(output), [
        _as2d(band1, cols, rows, np.uint8), _as2d(band2, cols, rows, np.uint8),
    ])


def write_tiff_multiband_u16(output, cols, rows, band1, band2) -> PendingTiff:
    """reference: tiff.rs:57-78."""
    return PendingTiff(Path(output), [
        _as2d(band1, cols, rows, np.uint16), _as2d(band2, cols, rows, np.uint16),
    ])
