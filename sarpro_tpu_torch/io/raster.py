"""The raster reader and decimated band reads onto the device (port of
sarpro_tpu/io/raster.py).

`RasterReader` is the JAX package's reader, copied without its jax paths
and without its read_band_resampled (the port's decimated read is
`read_band_resampled_to_device` below). It probes the content as the JAX
one does: a (Geo)TIFF opens through the self-contained codec (io/tiffio),
netCDF classic through `io/ncraster` (scipy), anything else through
`io/pilraster`, which decodes PNG with the port's own codec (io/png) and
refuses the other formats Pillow would open. Both backends are imported
only when a raster needs them. SAFE measurements are TIFFs.

Every load is two halves. The host half (`reduce_band`) reads and reduces
into host memory and touches no device: the batch driver's loader threads
run it. The device half (`band_to_device`) uploads and finishes the band on
the device, on the thread that owns the device work. The decimated read has
two routes, chosen from the raster's layout before the read:
  * host box reduce: an uncompressed-or-striped single-band u16 TIFF, the
    'average' filter, a true reduction and the native library built. Each
    chunk of output rows is read (with `read_strip_range`, or by O_DIRECT
    chunks where `DIRECT_IO` is set, as in the JAX package's batch loaders)
    and box-averaged on the host by `_native.box_reduce_u16`, so only the
    reduced f32 plane crosses to the card. On the single-scene route each
    chunk is copied to the device while the next one reduces
    (`ChunkUploads`);
  * device resample: otherwise the band is read whole, uploaded as stored
    (u16 DN, else f32), and resampled on the device by the ported resample
    kernel with the same filter and the same windows ('nearest' picks the
    nearest source row and column, as sarpro_tpu/core/resize.resample_plane
    does).
`ROUTES` counts which route ran (and `direct_io` the O_DIRECT reads), under
a lock: loader threads count concurrently.
"""
from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
import logging
import mmap
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import _native
from ..core.fused import _resample_dn
from ..core.numerics import as_f32, u16_bits
from ..core.resize import _build_coeffs
from ..errors import RasterError
from ..ops import warp_sample
from . import geodesy
from .tiffio import GeoInfo, TiffReader

logger = logging.getLogger("sarpro")

ROUTES = {"host_reduce": 0, "device_resample": 0, "direct_io": 0}
_ROUTES_LOCK = threading.Lock()

# Route the host box reduce of contiguous rasters through O_DIRECT chunked
# reads instead of the page cache (sarpro_tpu/io/raster.py:26-32). Set by
# the batch loader threads (parallel/batch.py), each for its own thread: a
# directory scan touches each scene once, so caching it gains nothing.
DIRECT_IO: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "DIRECT_IO", default=False)


def _count(route: str) -> None:
    """Count a read route; loader threads count concurrently."""
    with _ROUTES_LOCK:
        ROUTES[route] += 1


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
    """Opens any (Geo)TIFF raster via the self-contained codec, PNG, JPEG,
    BMP, GIF and netpbm (world file georeferencing) via the port's decoders
    (io/pilraster.py), and CF-convention netCDF classic grids via the scipy
    backend (reference:
    GdalSarReader::open, gdal.rs:57-104; the probe of
    sarpro_tpu/io/raster.py:97-122)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        # content-probe first, like GDAL: a TIFF named scene.img must still
        # open through the native codec regardless of extension
        try:
            with open(self.path, "rb") as fh:
                magic = fh.read(4)
        except OSError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        if magic[:2] in (b"II", b"MM"):
            try:
                self._tiff = TiffReader(self.path)
            except RasterError:
                raise
            except Exception as e:  # pragma: no cover
                raise RasterError(f"failed to open raster {self.path}: {e}") from e
        elif magic[:3] == b"CDF" or magic.startswith(b"\x89HDF"):
            from .ncraster import NetcdfRaster

            self._tiff = NetcdfRaster(self.path)
        else:
            from .pilraster import PIL_EXTENSIONS, PilRaster

            try:
                self._tiff = PilRaster(self.path)
            except RasterError as e:
                raise RasterError(
                    f"unsupported raster format: {self.path} is neither a "
                    f"TIFF nor PIL-decodable ({PIL_EXTENSIONS}): {e}"
                ) from e
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
    ri, ci = (torch.from_numpy(_nearest_index(n, m)).to(x.device,
                                                         non_blocking=True)
              for n, m in ((x.shape[0], out_rows), (x.shape[1], out_cols)))
    y = u16_bits(x).index_select(0, ri).index_select(1, ci)
    return as_f32(y.view(x.dtype))


def plan_grids_to_device(map_x: np.ndarray, map_y: np.ndarray, device):
    """A warp plan's f64 grids as f32 tensors on `device`: the cast of
    `jnp.asarray(g, jnp.float32)` (round to nearest)."""
    return tuple(torch.from_numpy(np.asarray(g, np.float32)).to(
        device, non_blocking=True) for g in (map_x, map_y))


@dataclasses.dataclass
class DeviceWarp:
    """The device half of a warp: the plan's (gh, gw) f64 inverse-mapping
    grids and its output, sampled by `ops.warp_sample`."""

    map_x: np.ndarray
    map_y: np.ndarray
    out_rows: int
    out_cols: int
    method: str


@dataclasses.dataclass
class HostBand:
    """One band read on the host (a loader's host half), and the device
    work that finishes it (`band_to_device`): the upload of `data`, then
    the resample to `resample` = (rows, cols, filter) and/or the warp."""

    data: torch.Tensor  # CPU: u16 DN or f32
    resample: Optional[tuple] = None
    warp: Optional[DeviceWarp] = None
    # `data` already on the device, uploaded chunk by chunk as it was
    # reduced (the single-scene route's overlap, `ChunkUploads`)
    uploaded: Optional[torch.Tensor] = None

    @property
    def shape(self) -> tuple:
        """The band's (rows, cols) once the device half has run."""
        if self.warp is not None:
            return self.warp.out_rows, self.warp.out_cols
        if self.resample is not None:
            return self.resample[:2]
        return tuple(self.data.shape)


class HostStaging:
    """Where the host half reduces a band: pageable memory. `rows(o0, o1)`
    is told as each chunk of output rows is done; `uploaded()` hands over
    the band if it already crossed to the device."""

    def host(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype)

    def rows(self, o0: int, o1: int) -> None:
        pass

    def uploaded(self) -> Optional[torch.Tensor]:
        return None


class ChunkUploads(HostStaging):
    """The single-scene route's overlap: the band is reduced into pinned
    memory and each chunk of rows is copied to its rows of a device tensor
    without waiting, so it crosses while the next chunk reduces (the caching
    host allocator keeps the buffer alive until its copies have run). Bands
    one after the other, on the thread that owns the device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self._host = self._dev = None

    def host(self, shape, dtype):
        self._host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self._dev = torch.empty(shape, dtype=dtype, device=self.device)
        return self._host

    def rows(self, o0, o1):
        self._dev[o0:o1].copy_(self._host[o0:o1], non_blocking=True)

    def uploaded(self):
        dev, self._host, self._dev = self._dev, None, None
        return dev


def upload_staging(device: torch.device) -> Optional[HostStaging]:
    """The single-scene staging for `device`: chunk uploads on a GPU."""
    return ChunkUploads(device) if device.type == "cuda" else None


def _read_average_direct(reader: RasterReader, out: np.ndarray, ywin, xwin,
                         on_rows) -> None:
    """O_DIRECT chunked pre-reduce for contiguous uncompressed rasters (a
    copy of sarpro_tpu/io/raster.py:302-379 that reports each chunk's
    output rows to `on_rows`).

    Bypasses the page cache: each ~32 MB source chunk is read by DMA into a
    page-aligned double buffer (a one-deep prefetch thread reads chunk i+1
    while chunk i reduces). Bit-identical to the buffered read: same
    windows, same native reducer. Raises OSError where O_DIRECT is
    unsupported (the caller then takes the buffered read)."""
    t = reader._tiff
    ys, yc = ywin
    xs, xc = xwin
    out_rows = out.shape[0]
    row_bytes = t.width * t.dtype.itemsize
    base = int(t.offsets[0])
    align = 4096
    budget = 32 << 20
    # group output rows into <= ~32 MB source-row chunks (window rows of
    # one output row never split across chunks)
    chunks = []
    oy0 = 0
    while oy0 < out_rows:
        r0 = int(ys[oy0])
        oy1 = oy0 + 1
        while (oy1 < out_rows
               and (int(ys[oy1] + yc[oy1]) - r0) * row_bytes <= budget):
            oy1 += 1
        chunks.append((oy0, oy1, r0, int(ys[oy1 - 1] + yc[oy1 - 1])))
        oy0 = oy1
    # one output row's window may alone exceed the budget (extreme
    # thumbnail reductions): size the double buffers for the largest
    buf_len = (max(r1 - r0 for _, _, r0, r1 in chunks) * row_bytes
               + 2 * align)
    fd = os.open(reader.path, os.O_RDONLY | os.O_DIRECT)
    bufs: list = [None, None]
    try:
        def fetch(i):
            o0, o1, r0, r1 = chunks[i]
            off0 = base + r0 * row_bytes
            off1 = base + r1 * row_bytes
            a0 = off0 & ~(align - 1)
            need = ((off1 - a0) + align - 1) & ~(align - 1)
            bi = i & 1
            if bufs[bi] is None:
                bufs[bi] = mmap.mmap(-1, buf_len)
            mv = memoryview(bufs[bi])[:need]
            got = 0
            while got < need:
                n = os.preadv(fd, [mv[got:]], a0 + got)
                if n <= 0:
                    break  # EOF: trailing bytes past off1 are slack
                got += n
            del mv
            if got < off1 - a0:
                raise OSError(f"short O_DIRECT read ({got} of "
                              f"{off1 - a0} bytes)")
            src = np.frombuffer(bufs[bi], dtype=t.dtype,
                                count=(r1 - r0) * t.width,
                                offset=off0 - a0).reshape(r1 - r0, t.width)
            return src, o0, o1, r0
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(fetch, 0)
            for i in range(len(chunks)):
                src, o0, o1, r0 = nxt.result()
                if i + 1 < len(chunks):
                    nxt = pool.submit(fetch, i + 1)
                _native.box_reduce_u16(src, out[o0:o1], o0, o1, ys, yc, xs,
                                       xc, src_row0=r0)
                del src
                on_rows(o0, o1)
    finally:
        os.close(fd)


def _read_average_buffered(reader: RasterReader, band: int, out: np.ndarray,
                           ywin, xwin, on_rows,
                           chunk_out_rows: int = 512) -> None:
    """The buffered host reduce: each chunk of output rows is read with
    `read_strip_range` and box-averaged by `_native.box_reduce_u16`."""
    t = reader._tiff
    (ys, yc), (xs, xc) = ywin, xwin
    out_rows = out.shape[0]
    for o0 in range(0, out_rows, chunk_out_rows):
        o1 = min(o0 + chunk_out_rows, out_rows)
        r0, r1 = int(ys[o0]), int(ys[o1 - 1] + yc[o1 - 1])
        src = np.ascontiguousarray(t.read_strip_range(r0, r1, band),
                                   np.uint16)
        _native.box_reduce_u16(src, out[o0:o1], o0, o1, ys, yc, xs, xc,
                               src_row0=r0)
        on_rows(o0, o1)


def reduce_band(reader, band: int, out_cols: int, out_rows: int,
                alg: str | None = None,
                staging: Optional[HostStaging] = None,
                chunk_out_rows: int = 512) -> HostBand:
    """The host half of the decimated read of `band` of a `RasterReader`
    to (out_rows, out_cols): the host box reduce into `staging` (O_DIRECT
    when `DIRECT_IO` is set and the raster is contiguous, else buffered), or
    the whole band as stored with the device resample to do. Touches no
    device."""
    staging = staging or HostStaging()
    filt = alg or "average"
    wins = _box_windows(reader, band, out_cols, out_rows, filt)
    t = reader._tiff
    if wins is None:
        logger.info("decimated read: %dx%d -> %dx%d by device resample (%s)",
                    t.width, t.height, out_cols, out_rows, filt)
        arr = t.read(band)
        # u16 DN crosses as stored; u8, bool (a mode "1" raster: 0 / 1) and
        # the rest as f32, the JAX read_band_resampled's astype(np.float32)
        arr = (arr.astype(np.uint16, copy=False) if arr.dtype == np.uint16
               else arr.astype(np.float32))
        _count("device_resample")
        return HostBand(torch.from_numpy(arr),
                        resample=(out_rows, out_cols, filt))
    logger.info("decimated read: %dx%d -> %dx%d by host box reduce",
                t.width, t.height, out_cols, out_rows)
    host = staging.host((out_rows, out_cols), torch.float32)
    out = host.numpy()
    done = False
    if (DIRECT_IO.get() and t._contiguous_uncompressed()
            and t.dtype.itemsize == 2):
        try:
            _read_average_direct(reader, out, *wins, staging.rows)
            done = True
            _count("direct_io")
        except OSError as e:
            logger.info("direct-I/O read unavailable (%s); using the "
                        "buffered read", e)
    if not done:
        _read_average_buffered(reader, band, out, *wins, staging.rows,
                               chunk_out_rows)
    _count("host_reduce")
    return HostBand(host, uploaded=staging.uploaded())


def band_to_device(hb: HostBand, device,
                   shard_devices: int = 0) -> torch.Tensor:
    """The device half of a band: upload (unless its chunks already
    crossed), then the device resample and/or the warp. Runs on the thread
    that owns the device work; queues copies and kernels, waits for none.
    A pageable source is staged by the driver before the copy returns, a
    pinned one is read by DMA in stream order. `shard_devices` (0 none, -1
    all) splits the warp's output rows over that many of the caller's
    devices (`parallel.warp`), where there are 2 or more."""
    device = torch.device(device)
    x = (hb.uploaded if hb.uploaded is not None
         else hb.data.to(device, non_blocking=True))
    if hb.resample is not None:
        rows, cols, filt = hb.resample
        x = (_nearest(x, rows, cols) if filt in ("nearest", "near")
             else _resample_dn(x, rows, cols, filt))
    if hb.warp is not None:
        w = hb.warp
        from ..parallel import warp as pwarp

        mesh = pwarp.shard_mesh(shard_devices, device)
        if mesh is not None:
            return pwarp.warp_sample_sharded(
                x, w.map_x, w.map_y, w.out_rows, w.out_cols, w.method,
                mesh).to(device)
        gx, gy = plan_grids_to_device(w.map_x, w.map_y, device)
        x = warp_sample(x, gx, gy, w.out_rows, w.out_cols, w.method)
    return x


def read_band_resampled_to_device(reader, band: int, out_cols: int,
                                  out_rows: int, device,
                                  alg: str | None = None,
                                  chunk_out_rows: int = 512) -> torch.Tensor:
    """Decimated read of `band` of a `RasterReader` to an (out_rows,
    out_cols) f32 tensor on `device`: the host half, then the device half
    (on a GPU each reduced chunk uploads while the next one reduces)."""
    device = torch.device(device)
    hb = reduce_band(reader, band, out_cols, out_rows, alg,
                     upload_staging(device), chunk_out_rows)
    return band_to_device(hb, device)
