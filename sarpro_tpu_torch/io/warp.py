"""Reprojection on the GPU (port of sarpro_tpu/io/warp.py, whose module
imports jax at its top).

The host half is carried over unchanged as jax-free copies, held equal to
the originals by tests/test_torch_warp.py:
  1. the source -> lon/lat mapping (affine + projection, or a thin-plate
     spline fitted on the GCPs or the annotation's geolocation grid, the
     `gdalwarp -tps` equivalent);
  2. the output grid (gdalwarp's suggested resolution, or the reference's
     `-ts` sizing from the source dims);
  3. the inverse mapping (target pixel -> source pixel) in f64 on a coarse
     grid, and the two-stage decision: a strong reduction is first
     box-averaged on the host to ~1.25x the output resolution.
`plan_to_host` runs these steps and reads the source, touching no device
(the batch driver's loader threads run it). The device half
(`raster.band_to_device`) uploads the source and grids and runs one kernel,
`ops.warp_sample`: the grid is upsampled to every output pixel and the
source sampled there. With `shard_devices` the output rows split over the
caller's devices (`parallel.warp`), each block one launch with its row
offset. There is no fallback sampler.

The reference's `-r` mapping quirk is preserved: lanczos (and anything else
unrecognized) falls back to bilinear (sentinel1.rs:937-942).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..errors import ProcessingError
from . import geodesy
from .raster import (
    DeviceWarp,
    HostBand,
    HostStaging,
    band_to_device,
    plan_grids_to_device,  # noqa: F401 (the warp's grids, for callers)
    reduce_band,
    upload_staging,
)

logger = logging.getLogger("sarpro")

GRID_STEP = 32  # output pixels per mapping-grid cell (<~0.05 px interp error)
MAX_GRID = 257


@dataclasses.dataclass
class WarpResult:
    data: torch.Tensor  # f32 (rows, cols) on the device
    geotransform: list[float]
    projection: str
    epsg: int


def _resample_name(alg: Optional[str]) -> str:
    """gdalwarp -r mapping with the lanczos->bilinear quirk
    (reference: sentinel1.rs:937-942)."""
    if alg in ("nearest", "near"):
        return "near"
    if alg == "cubic":
        return "cubic"
    return "bilinear"


class _SourceMapping:
    """source pixel <-> lon/lat, from an affine+CRS, GCP TPS, or -- when the
    measurement TIFF carries no GCPs -- the annotation XML's geolocation grid
    points as TPS control points (reference: sentinel1.rs:1017-1028)."""

    def __init__(self, reader, geolocation_grid: Optional[np.ndarray] = None):
        gt = reader.metadata.geotransform
        self.is_affine = (
            reader.metadata.epsg is not None
            and gt is not None
            and not (gt[0] == 0 and gt[1] == 1 and gt[2] == 0
                     and gt[3] == 0 and gt[4] == 0 and gt[5] == 1)
        )
        if self.is_affine:
            self.src_epsg = reader.metadata.epsg
            self.gt = gt
            det = gt[1] * gt[5] - gt[2] * gt[4]
            if det == 0:
                raise ProcessingError("degenerate source geotransform")
            self.inv = np.array([
                [gt[5] / det, -gt[2] / det],
                [-gt[4] / det, gt[1] / det],
            ])
            return
        gcps = reader.gcps
        if gcps is not None and len(gcps) >= 3:
            # GCP SRS fallback to EPSG:4326 (reference: sentinel1.rs:1020-1025)
            self.src_epsg = reader.geo.gcp_epsg or 4326
            pix = gcps[:, :2]
            lonlat = np.stack(
                geodesy.project_inverse(gcps[:, 2], gcps[:, 3], self.src_epsg),
                axis=-1)
        elif geolocation_grid is not None and len(geolocation_grid) >= 3:
            # annotation geolocationGridPointList: [pixel, line, lon, lat],
            # already geographic
            self.src_epsg = 4326
            pix = np.asarray(geolocation_grid[:, :2], np.float64)
            lonlat = np.asarray(geolocation_grid[:, 2:4], np.float64)
            logger.info("Warp: TPS from %d annotation geolocation grid points",
                        len(pix))
        else:
            raise ProcessingError(
                "source raster has neither a projection, GCPs, nor an "
                "annotation geolocation grid; cannot warp"
            )
        self.fwd_tps = geodesy.ThinPlateSpline2D(pix, lonlat)
        self.inv_tps = geodesy.ThinPlateSpline2D(lonlat, pix)

    def pixels_to_lonlat(self, cols, rows):
        if self.is_affine:
            gt = self.gt
            x = gt[0] + cols * gt[1] + rows * gt[2]
            y = gt[3] + cols * gt[4] + rows * gt[5]
            return geodesy.project_inverse(x, y, self.src_epsg)
        out = self.fwd_tps(np.stack([cols, rows], axis=-1).reshape(-1, 2))
        return (out[:, 0].reshape(np.shape(cols)),
                out[:, 1].reshape(np.shape(rows)))

    def lonlat_to_pixels(self, lon, lat):
        if self.is_affine:
            x, y = geodesy.project_forward(lon, lat, self.src_epsg)
            dx = np.asarray(x) - self.gt[0]
            dy = np.asarray(y) - self.gt[3]
            col = self.inv[0, 0] * dx + self.inv[0, 1] * dy
            row = self.inv[1, 0] * dx + self.inv[1, 1] * dy
            return col, row
        pts = np.stack([np.ravel(lon), np.ravel(lat)], axis=-1)
        out = self.inv_tps(pts)
        return (out[:, 0].reshape(np.shape(lon)),
                out[:, 1].reshape(np.shape(lat)))


def _suggest_output_grid(mapping: _SourceMapping, src_cols: int,
                         src_rows: int, dst_epsg: int,
                         target_size: Optional[int]):
    """Output bbox + size. Resolution follows gdalwarp's suggested-output
    heuristic (preserve approximate source sampling); `-ts`-style sizing from
    the source dims replicates the reference's single-pass path
    (sentinel1.rs:1005-1015)."""
    # sample the source border + interior on a coarse lattice
    ns = 21
    cs = np.linspace(0, src_cols, ns)
    rs = np.linspace(0, src_rows, ns)
    cc, rr = np.meshgrid(cs, rs)
    lon, lat = mapping.pixels_to_lonlat(cc.ravel(), rr.ravel())
    tx, ty = geodesy.project_forward(lon, lat, dst_epsg)
    tx = np.asarray(tx).reshape(ns, ns)
    ty = np.asarray(ty).reshape(ns, ns)
    # out-of-domain lattice corners come back nan from the proj_pipe
    # backend (gdalwarp likewise drops failed transformer samples)
    if not (np.isfinite(tx).any() and np.isfinite(ty).any()):
        raise ProcessingError(
            "warp: no source sample projects into the target CRS domain")
    xmin, xmax = float(np.nanmin(tx)), float(np.nanmax(tx))
    ymin, ymax = float(np.nanmin(ty)), float(np.nanmax(ty))

    if target_size is not None:
        long_side = max(src_cols, src_rows)
        scale = min(target_size / long_side, 1.0)
        out_cols = max(int(np.floor(src_cols * scale + 0.5)), 1)
        out_rows = max(int(np.floor(src_rows * scale + 0.5)), 1)
    else:
        # mean step length along the lattice ~ source ground sampling
        dxs = np.hypot(np.diff(tx, axis=1), np.diff(ty, axis=1))
        dys = np.hypot(np.diff(tx, axis=0), np.diff(ty, axis=0))
        px_per_cell_x = src_cols / (ns - 1)
        px_per_cell_y = src_rows / (ns - 1)
        with np.errstate(invalid="ignore"):
            res = float((np.nanmean(dxs) / px_per_cell_x
                         + np.nanmean(dys) / px_per_cell_y) / 2.0)
        if not np.isfinite(res) or res <= 0:
            raise ProcessingError("could not suggest warp output resolution")
        out_cols = max(int(np.ceil((xmax - xmin) / res)), 1)
        out_rows = max(int(np.ceil((ymax - ymin) / res)), 1)

    gt = [xmin, (xmax - xmin) / out_cols, 0.0, ymax, 0.0,
          -(ymax - ymin) / out_rows]
    return out_cols, out_rows, gt


@dataclasses.dataclass
class WarpPlan:
    """Host-side warp plan: output grid + coarse f64 inverse-mapping grid."""

    out_cols: int
    out_rows: int
    geotransform: list[float]
    dst_epsg: int
    method: str
    mapping: _SourceMapping
    map_x: np.ndarray  # (gh, gw) source col (pixel-center) per grid node
    map_y: np.ndarray  # (gh, gw) source row

    def exact_source_pixels(self, out_cols_f: np.ndarray,
                            out_rows_f: np.ndarray):
        """f64 target pixel -> source pixel (pixel-center), no
        interpolation."""
        gt = self.geotransform
        tx = gt[0] + (np.asarray(out_cols_f, np.float64) + 0.5) * gt[1]
        ty = gt[3] + (np.asarray(out_rows_f, np.float64) + 0.5) * gt[5]
        lon, lat = geodesy.project_inverse(tx, ty, self.dst_epsg)
        scol, srow = self.mapping.lonlat_to_pixels(lon, lat)
        return (np.asarray(scol, np.float64) - 0.5,
                np.asarray(srow, np.float64) - 0.5)

    def interp_source_pixels(self, out_cols_f: np.ndarray,
                             out_rows_f: np.ndarray):
        """Bilinear interpolation of the coarse grid in f64, the function
        the device sampler computes in f32 for each output pixel."""
        gh, gw = self.map_x.shape
        gr = np.asarray(out_rows_f, np.float64) * (
            (gh - 1) / max(self.out_rows - 1, 1))
        gc = np.asarray(out_cols_f, np.float64) * (
            (gw - 1) / max(self.out_cols - 1, 1))
        gr0 = np.clip(np.floor(gr), 0, gh - 2).astype(np.int64)
        gc0 = np.clip(np.floor(gc), 0, gw - 2).astype(np.int64)
        fr = gr - gr0
        fc = gc - gc0

        def interp(grid):
            i00 = grid[gr0, gc0]
            i01 = grid[gr0, gc0 + 1]
            i10 = grid[gr0 + 1, gc0]
            i11 = grid[gr0 + 1, gc0 + 1]
            return ((i00 * (1 - fc) + i01 * fc) * (1 - fr)
                    + (i10 * (1 - fc) + i11 * fc) * fr)

        return interp(self.map_x), interp(self.map_y)


def plan_warp(reader, target_crs: str, resample_alg: Optional[str] = None,
              target_size: Optional[int] = None,
              geolocation_grid: Optional[np.ndarray] = None) -> WarpPlan:
    """Host planning half of the warp (steps 1-3 of the module docstring)."""
    dst_epsg = geodesy.parse_epsg_code(target_crs)
    dst_kind = None if dst_epsg is None else geodesy.epsg_kind(dst_epsg)
    if dst_kind is None:
        reason = (geodesy.unsupported_reason(dst_epsg)
                  if dst_epsg is not None else None)
        why = f" ({reason})" if reason else ""
        raise ProcessingError(
            f"unsupported target CRS: {target_crs}{why}; supported: "
            f"{geodesy.SUPPORTED_CRS_FAMILIES}"
        )
    method = _resample_name(resample_alg)

    mapping = _SourceMapping(reader, geolocation_grid)
    if dst_kind.get("dynamic"):
        # late-bind the area-specific datum op for the scene's location,
        # like cs2cs/gdalwarp do per point
        clon, clat = mapping.pixels_to_lonlat(
            np.asarray([reader.metadata.size_x / 2.0]),
            np.asarray([reader.metadata.size_y / 2.0]))
        geodesy.refine_dynamic_crs_area(
            dst_epsg, float(np.ravel(clon)[0]), float(np.ravel(clat)[0]))
    src_cols = reader.metadata.size_x
    src_rows = reader.metadata.size_y
    out_cols, out_rows, gt = _suggest_output_grid(
        mapping, src_cols, src_rows, dst_epsg, target_size
    )
    logger.info("Warp output: %dx%d in EPSG:%d (%s)", out_cols, out_rows,
                dst_epsg, method)

    # coarse inverse-mapping grid (host f64 -> f32 for the device)
    gh = min(out_rows // GRID_STEP + 2, MAX_GRID)
    gw = min(out_cols // GRID_STEP + 2, MAX_GRID)
    gy = np.linspace(0.0, out_rows - 1.0, gh)
    gx = np.linspace(0.0, out_cols - 1.0, gw)
    gxx, gyy = np.meshgrid(gx, gy)
    # target pixel center -> target CRS coords
    tx = gt[0] + (gxx + 0.5) * gt[1]
    ty = gt[3] + (gyy + 0.5) * gt[5]
    lon, lat = geodesy.project_inverse(tx, ty, dst_epsg)
    scol, srow = mapping.lonlat_to_pixels(lon, lat)
    # pixel-center convention for sampling
    map_x = np.asarray(scol, np.float64) - 0.5
    map_y = np.asarray(srow, np.float64) - 0.5
    return WarpPlan(out_cols=out_cols, out_rows=out_rows, geotransform=gt,
                    dst_epsg=dst_epsg, method=method, mapping=mapping,
                    map_x=map_x, map_y=map_y)


def two_stage_plan(plan: WarpPlan, src_cols: int, src_rows: int):
    """Two-stage pre-reduce decision for strong-reduction warps.

    Returns None (sample the full-resolution source directly), or
    `(mid_rows, mid_cols, map_x, map_y)`: the area-average intermediate size
    (~1.25x the output resolution) and the plan's inverse mapping rescaled
    from source pixels into intermediate pixels (pixel-center convention:
    centers map by the size ratio)."""
    # nan-aware: proj_pipe targets can leave out-of-domain grid nodes nan
    with np.errstate(invalid="ignore"):
        sx_est = ((np.nanmax(plan.map_x) - np.nanmin(plan.map_x) + 1)
                  / max(plan.out_cols, 1))
        sy_est = ((np.nanmax(plan.map_y) - np.nanmin(plan.map_y) + 1)
                  / max(plan.out_rows, 1))
    scale_est = max(
        sx_est if np.isfinite(sx_est) else 1.0,
        sy_est if np.isfinite(sy_est) else 1.0,
        1.0,
    )
    if scale_est < 2.0:
        return None
    factor = scale_est / 1.25
    mid_rows = max(int(np.ceil(src_rows / factor)), 1)
    mid_cols = max(int(np.ceil(src_cols / factor)), 1)
    ry = mid_rows / src_rows
    rx = mid_cols / src_cols
    map_x = (plan.map_x + 0.5) * rx - 0.5
    map_y = (plan.map_y + 0.5) * ry - 0.5
    return mid_rows, mid_cols, map_x, map_y


@dataclasses.dataclass
class HostWarp:
    """The host half of a warp: the source band, read (and pre-reduced) on
    the host, with the sampling its device half runs, and the output's
    georeferencing."""

    band: HostBand
    geotransform: list[float]
    projection: str
    epsg: int


def plan_to_host(reader, target_crs: str, resample_alg: Optional[str] = None,
                 target_size: Optional[int] = None,
                 geolocation_grid: Optional[np.ndarray] = None,
                 staging: Optional[HostStaging] = None) -> HostWarp:
    """Plan the warp of band 1 of an `io.raster.RasterReader` to
    `target_crs` and read its source on the host: the whole band, or for a
    strong reduction the host box reduce to ~1.25x the output resolution
    (`raster.reduce_band`, into `staging`). Touches no device."""
    plan = plan_warp(reader, target_crs, resample_alg, target_size,
                     geolocation_grid)
    map_x, map_y = plan.map_x, plan.map_y
    src_cols = reader.metadata.size_x
    src_rows = reader.metadata.size_y
    two = two_stage_plan(plan, src_cols, src_rows)
    if two is not None:
        # the pre-reduce runs on the host where the native box reducer
        # applies, so only the ~1.25x-output intermediate crosses to the card
        mid_rows, mid_cols, map_x, map_y = two
        band = reduce_band(reader, 1, mid_cols, mid_rows, "average", staging)
        logger.info("Warp two-stage: source %dx%d -> %dx%d before sampling",
                    src_cols, src_rows, mid_cols, mid_rows)
    else:
        band = HostBand(torch.from_numpy(reader.read_band(1)))
    band.warp = DeviceWarp(map_x, map_y, plan.out_rows, plan.out_cols,
                           plan.method)
    projection = geodesy.epsg_to_wkt(plan.dst_epsg) or f"EPSG:{plan.dst_epsg}"
    return HostWarp(band=band, geotransform=plan.geotransform,
                    projection=projection, epsg=plan.dst_epsg)


def warp_to_crs(reader, target_crs: str, device,
                resample_alg: Optional[str] = None,
                target_size: Optional[int] = None,
                geolocation_grid: Optional[np.ndarray] = None,
                shard_devices: int = 0) -> WarpResult:
    """Reproject band 1 of an `io.raster.RasterReader` to
    `target_crs` (EPSG:XXXX) on `device`, the equivalent of the reference's
    gdalwarp invocation (sentinel1.rs:988-1071): the host half
    (`plan_to_host`), then the device half (`raster.band_to_device`), its
    output rows split over `shard_devices` of the caller's devices (0 none,
    -1 all; `parallel.warp`)."""
    device = torch.device(device)
    host = plan_to_host(reader, target_crs, resample_alg, target_size,
                        geolocation_grid, upload_staging(device))
    return WarpResult(data=band_to_device(host.band, device, shard_devices),
                      geotransform=host.geotransform,
                      projection=host.projection, epsg=host.epsg)
