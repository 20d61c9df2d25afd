"""netCDF (classic / 64-bit-offset) raster backend.

Format-breadth parity with the reference's GdalSarReader, whose GDAL open
accepts netCDF rasters (reference: src/io/gdal.rs:57-104). Sentinel-1 GRD
measurements are always TIFF; this backend covers the *generic raster*
capability for CF-convention gridded netCDF files:

  * data variable: the largest numeric variable whose trailing two
    dimensions are spatial (like GDAL's subdataset selection, collapsed to
    the primary variable); a leading third dimension (time / band / level)
    exposes one raster band per slice
  * georeferencing: 1D coordinate variables for the trailing (y, x) dims
    with uniform spacing -> GDAL geotransform (pixel-center convention,
    like GDAL's netCDF driver)
  * CRS: the variable's ``grid_mapping`` target (``spatial_ref`` WKT or
    ``epsg_code``), else degree-unit lon/lat coordinates -> EPSG:4326

netCDF-4 files are HDF5 containers and are rejected with a clear error
(the classic parser cannot read them; GDAL links libnetcdf for those).
"""
# A copy of sarpro_tpu/io/ncraster.py, so that the port imports nothing of
# the JAX package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..errors import RasterError
from .tiffio import GeoInfo

NC_EXTENSIONS = (".nc", ".cdf", ".nc4")

_Y_NAMES = ("y", "lat", "latitude", "northing", "rlat")
_X_NAMES = ("x", "lon", "longitude", "easting", "rlon")


def _attr_str(var, name):
    v = getattr(var, name, None)
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, str):
        return v
    return None


def _attr_num(var, name):
    v = getattr(var, name, None)
    if v is None:
        return None
    try:
        arr = np.asarray(v).reshape(-1)
        return float(arr[0]) if arr.size else None
    except (TypeError, ValueError):
        return None


def _is_spatial(dim_name: str, names) -> bool:
    d = dim_name.lower()
    return any(d == n or d.startswith(n + "_") or d.endswith("_" + n)
               for n in names)


def _axis_geolocation(coord: np.ndarray):
    """(start, step) of a uniformly spaced 1D coordinate axis, else None."""
    c = np.asarray(coord, np.float64).reshape(-1)
    if c.size < 2:
        return None
    steps = np.diff(c)
    step = steps[0]
    if step == 0 or not np.allclose(steps, step, rtol=1e-6, atol=0):
        return None
    return float(c[0]), float(step)


class NetcdfRaster:
    """TiffReader-shaped adapter over a CF-convention netCDF grid.

    Implements the subset RasterReader drives: width/height/samples/dtype,
    read(band), geo_info(), gdal_metadata(), close(). Strip-streaming fast
    paths are TIFF-codec-only and stay disabled for this backend."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        try:
            with open(self.path, "rb") as fh:
                magic = fh.read(4)
        except OSError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        if magic.startswith(b"\x89HDF"):
            raise RasterError(
                f"{self.path}: netCDF-4 (HDF5 container) is not supported by "
                f"the classic-format reader; re-save as netCDF classic "
                f"(CDF-1/2) or GeoTIFF"
            )
        try:
            from scipy.io import netcdf_file
        except ImportError as e:  # pragma: no cover
            raise RasterError("scipy unavailable for netCDF rasters") from e
        try:
            # mmap=False: fully load so close() releases the file handle
            self._nc = netcdf_file(str(self.path), "r", mmap=False)
        except Exception as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        var_name, var = self._pick_variable()
        self._var_name = var_name
        data = np.asarray(var.data)
        # netCDF classic stores big-endian; normalize to native order
        if data.dtype.byteorder not in ("=", "|",
                                        "<" if np.little_endian else ">"):
            data = data.astype(data.dtype.newbyteorder("="))
        if data.ndim == 2:
            data = data[None]
        elif data.ndim > 3:
            # collapse leading dims (time x level x y x x -> bands)
            data = data.reshape(-1, *data.shape[-2:])
        self._data = data
        self.samples, self.height, self.width = data.shape
        self.dtype = data.dtype
        self._dims = tuple(var.dimensions[-2:])
        self._geo = self._extract_geo(var)
        self._meta = self._collect_metadata(var)

    # -- variable / georeferencing extraction -------------------------------

    def _pick_variable(self):
        """Largest numeric variable with >=2 dims whose trailing two dims are
        not both coordinate axes of something else; coordinate variables
        (name == own dimension) and grid-mapping scalars are excluded."""
        best = None
        for name, var in self._nc.variables.items():
            dims = getattr(var, "dimensions", ())
            if len(dims) < 2 or name in dims:
                continue
            if getattr(var, "data", None) is None:
                continue
            arr = var.data
            if not isinstance(arr, np.ndarray) or arr.dtype.kind not in "iuf":
                continue
            size = int(np.prod(arr.shape[-2:]))
            if best is None or size > best[2]:
                best = (name, var, size)
        if best is None:
            raise RasterError(
                f"{self.path}: no 2D+ numeric data variable found")
        return best[0], best[1]

    def _coord(self, dim_name):
        v = self._nc.variables.get(dim_name)
        if v is None or getattr(v, "data", None) is None:
            return None
        arr = np.asarray(v.data).reshape(-1)
        return v, arr

    def _extract_geo(self, var) -> GeoInfo:
        ydim, xdim = self._dims
        gt = None
        ycoord = self._coord(ydim)
        xcoord = self._coord(xdim)
        if ycoord is not None and xcoord is not None:
            ya = _axis_geolocation(ycoord[1])
            xa = _axis_geolocation(xcoord[1])
            if (ya is not None and xa is not None
                    and ycoord[1].size == self.height
                    and xcoord[1].size == self.width):
                y0, dy = ya
                x0, dx = xa
                # coordinates are pixel centers; GDAL geotransform anchors
                # the outer corner of the first pixel
                gt = [x0 - 0.5 * dx, dx, 0.0, y0 - 0.5 * dy, 0.0, dy]
        epsg = None
        is_geographic = False
        gm_name = _attr_str(var, "grid_mapping")
        gm = self._nc.variables.get(gm_name) if gm_name else None
        if gm is not None:
            code = _attr_num(gm, "epsg_code")
            if code is None:
                wkt = (_attr_str(gm, "spatial_ref")
                       or _attr_str(gm, "crs_wkt"))
                if wkt:
                    from .raster import parse_epsg

                    epsg = parse_epsg(wkt)
            else:
                epsg = int(code)
            if (epsg is None and _attr_str(gm, "grid_mapping_name")
                    == "latitude_longitude"):
                epsg = 4326
        if epsg is None and ycoord is not None and xcoord is not None:
            yunits = (_attr_str(ycoord[0], "units") or "").lower()
            xunits = (_attr_str(xcoord[0], "units") or "").lower()
            if yunits.startswith("degree") and xunits.startswith("degree"):
                epsg = 4326
        if epsg == 4326:
            is_geographic = True
        return GeoInfo(geotransform=gt, epsg=epsg,
                       is_geographic=is_geographic)

    def _collect_metadata(self, var) -> dict:
        """GDAL-netCDF-style flat metadata: global attrs as ``NC_GLOBAL#k``,
        variable attrs as ``<var>#k`` (numbers stringified)."""
        meta = {}

        def put(prefix, obj):
            for k, v in getattr(obj, "_attributes", {}).items():
                if isinstance(v, bytes):
                    v = v.decode("utf-8", "replace")
                elif isinstance(v, np.ndarray):
                    v = " ".join(str(x) for x in v.reshape(-1).tolist())
                meta[f"{prefix}#{k}"] = str(v)

        put("NC_GLOBAL", self._nc)
        put(self._var_name, var)
        return meta

    # -- TiffReader-shaped surface ------------------------------------------

    def read(self, band: int = 1) -> np.ndarray:
        if not 1 <= band <= self.samples:
            raise RasterError(
                f"band {band} out of range (raster has {self.samples})")
        return self._data[band - 1]

    def geo_info(self) -> GeoInfo:
        return self._geo

    def gdal_metadata(self) -> dict:
        return dict(self._meta)

    def close(self):
        if self._nc is not None:
            try:
                self._nc.close()
            finally:
                self._nc = None
        self._data = None
