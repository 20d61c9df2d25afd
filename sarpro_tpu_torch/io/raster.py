"""The raster reader and decimated band reads onto the device (port of
sarpro_tpu/io/raster.py).

`RasterReader` is the JAX package's reader of a (Geo)TIFF through the
self-contained codec (io/tiffio), copied without its jax paths and without
its read_band_resampled: the port's decimated read is
`read_band_resampled_to_device` below. Non-TIFF rasters (the JAX package's
Pillow and netCDF backends) are refused; SAFE measurements are TIFFs.

Two routes of the decimated read, chosen from the raster's layout before
the read:
  * host box reduce: an uncompressed-or-striped single-band u16 TIFF, the
    'average' filter, a true reduction and the native library built. Each
    chunk of output rows is read with `read_strip_range`, box-averaged on
    the host by `_native.box_reduce_u16`, and copied into its rows of a
    preallocated device tensor, so only the reduced f32 plane crosses to the
    card;
  * device resample: otherwise the band is read whole, uploaded as stored
    (u16 DN, else f32), and resampled on the device by the ported resample
    kernel with the same filter and the same windows ('nearest' picks the
    nearest source row and column, as sarpro_tpu/core/resize.resample_plane
    does).
`ROUTES` counts which route ran.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import _native
from ..core.fused import _resample_dn
from ..core.numerics import as_f32, u16_bits
from ..core.resize import _build_coeffs
from ..errors import RasterError
from . import geodesy
from .tiffio import GeoInfo, TiffReader

logger = logging.getLogger("sarpro")

ROUTES = {"host_reduce": 0, "device_resample": 0}


def _average_windows(in_size: int, out_size: int):
    """Contiguous uniform-weight source windows of the 'average' filter,
    from the device resampler's own coefficient builder, so host and device
    boxes match exactly: (starts, counts) int32, or None if the windows are
    not plain boxes (a copy of sarpro_tpu/io/raster._average_windows; a test
    holds the copy equal)."""
    starts, weights = _build_coeffs(in_size, out_size, "average")
    nz = weights > 0
    first = nz.argmax(axis=1).astype(np.int64)
    count = nz.sum(axis=1).astype(np.int64)
    if np.any(count <= 0):
        return None
    idx = np.arange(weights.shape[1])
    contiguous = (idx >= first[:, None]) & (idx < (first + count)[:, None])
    if not np.array_equal(contiguous, nz):
        return None
    ys = (starts.astype(np.int64) + first).astype(np.int32)
    return ys, count.astype(np.int32)


@dataclasses.dataclass
class RasterMetadata:
    """Mirror of the reference's GdalMetadata (gdal.rs:16-35)."""

    size_x: int
    size_y: int
    bands: int
    geotransform: list[float]
    projection: str
    epsg: Optional[int]
    metadata: dict[str, str]


def parse_epsg(wkt: str) -> Optional[int]:
    """EPSG code from a WKT AUTHORITY tag (reference: gdal.rs:43-53)."""
    key = 'AUTHORITY["EPSG","'
    idx = wkt.rfind(key)
    if idx < 0:
        return None
    start = idx + len(key)
    end = wkt.find('"', start)
    if end <= start:
        return None
    try:
        return int(wkt[start:end])
    except ValueError:
        return None


class RasterReader:
    """Opens a (Geo)TIFF raster via the self-contained codec (reference:
    GdalSarReader::open, gdal.rs:57-104)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        # content-probe first, like GDAL: a TIFF named scene.img must still
        # open through the native codec regardless of extension
        try:
            with open(self.path, "rb") as fh:
                magic = fh.read(4)
        except OSError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        if magic[:2] not in (b"II", b"MM"):
            raise RasterError(f"unsupported raster format: {self.path} is "
                              "not a TIFF")
        try:
            self._tiff = TiffReader(self.path)
        except RasterError:
            raise
        except Exception as e:  # pragma: no cover
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        gi: GeoInfo = self._tiff.geo_info()
        self.geo = gi
        # identity fallback (reference: gdal.rs:64-67)
        gt = gi.geotransform or [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
        # projection: dataset CRS, falling back to GCP projection (gdal.rs:68-83).
        # A GCP'd raster (multiple tiepoints) is itself UNprojected — its
        # geokeys describe the GCP SRS, so the dataset EPSG must stay None
        # (otherwise the skip-warp guard would wrongly fire).
        projection = ""
        epsg = gi.epsg
        if gi.gcps is not None:
            epsg = None
            gcp_epsg = gi.gcp_epsg or 4326
            projection = geodesy.epsg_to_wkt(gcp_epsg) or f"EPSG:{gcp_epsg}"
        elif epsg is not None:
            projection = geodesy.epsg_to_wkt(epsg) or f"EPSG:{epsg}"
        self.metadata = RasterMetadata(
            size_x=self._tiff.width,
            size_y=self._tiff.height,
            bands=self._tiff.samples,
            geotransform=gt,
            projection=projection,
            epsg=epsg,
            metadata=self._tiff.gdal_metadata(),
        )

    @property
    def gcps(self) -> Optional[np.ndarray]:
        return self.geo.gcps

    def read_band(self, band: int = 1) -> np.ndarray:
        """Full-window f32 read (reference: gdal.rs:107-141)."""
        return self._tiff.read(band).astype(np.float32)

    def close(self):
        self._tiff.close()


def _box_windows(reader, band: int, out_cols: int, out_rows: int, filt: str):
    """The host reducer's (ywin, xwin), or None where it does not apply (the
    conditions of sarpro_tpu/io/raster.py:211-220)."""
    t = reader._tiff
    if not (isinstance(t, TiffReader)
            and filt in ("average", "box") and t.samples == 1 and band == 1
            and t.dtype == np.dtype(np.uint16)
            and out_rows < t.height and out_cols < t.width
            and _native.available()):
        return None
    ywin = _average_windows(t.height, out_rows)
    xwin = _average_windows(t.width, out_cols)
    if ywin is None or xwin is None:
        return None
    return ywin, xwin


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    return np.minimum(((np.arange(out_size) + 0.5) * (in_size / out_size))
                      .astype(np.int64), in_size - 1)


def _nearest(x: torch.Tensor, out_rows: int, out_cols: int) -> torch.Tensor:
    """Nearest-neighbour decimation of a (rows, cols) band to f32."""
    ri = torch.from_numpy(_nearest_index(x.shape[0], out_rows)).to(x.device)
    ci = torch.from_numpy(_nearest_index(x.shape[1], out_cols)).to(x.device)
    y = u16_bits(x).index_select(0, ri).index_select(1, ci)
    return as_f32(y.view(x.dtype))


def read_band_resampled_to_device(reader, band: int, out_cols: int,
                                  out_rows: int, device,
                                  alg: str | None = None,
                                  chunk_out_rows: int = 512) -> torch.Tensor:
    """Decimated read of `band` of a `RasterReader` to an (out_rows,
    out_cols) f32 tensor on `device`."""
    device = torch.device(device)
    filt = alg or "average"
    wins = _box_windows(reader, band, out_cols, out_rows, filt)
    t = reader._tiff
    if wins is None:
        logger.info("decimated read: %dx%d -> %dx%d by device resample (%s)",
                    t.width, t.height, out_cols, out_rows, filt)
        arr = t.read(band)
        arr = (arr.astype(np.uint16, copy=False) if arr.dtype == np.uint16
               else arr.astype(np.float32))
        ROUTES["device_resample"] += 1
        x = torch.from_numpy(arr).to(device)
        if filt in ("nearest", "near"):
            return _nearest(x, out_rows, out_cols)
        return _resample_dn(x, out_rows, out_cols, filt)
    logger.info("decimated read: %dx%d -> %dx%d by host box reduce",
                t.width, t.height, out_cols, out_rows)
    (ys, yc), (xs, xc) = wins
    out = torch.empty((out_rows, out_cols), dtype=torch.float32,
                      device=device)
    pinned = device.type == "cuda"
    for o0 in range(0, out_rows, chunk_out_rows):
        o1 = min(o0 + chunk_out_rows, out_rows)
        r0, r1 = int(ys[o0]), int(ys[o1 - 1] + yc[o1 - 1])
        src = np.ascontiguousarray(t.read_strip_range(r0, r1, band),
                                   np.uint16)
        # a pinned chunk uploads asynchronously: the next chunk is read and
        # reduced while this one crosses (the caching host allocator keeps
        # the buffer alive until its copy has run)
        part = torch.empty((o1 - o0, out_cols), dtype=torch.float32,
                           pin_memory=pinned)
        _native.box_reduce_u16(src, part.numpy(), o0, o1, ys, yc, xs, xc,
                               src_row0=r0)
        out[o0:o1].copy_(part, non_blocking=pinned)
    ROUTES["host_reduce"] += 1
    return out
