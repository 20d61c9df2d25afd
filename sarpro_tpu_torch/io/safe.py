"""Dual-pol SAFE loading onto the GPU (port of the reader glue of
sarpro_tpu/io/safe.py:459-611 and :637-708).

Metadata and file discovery come from the JAX package's host-only parser.
Without a target CRS, the measurement rasters are read as raw u16 DN (never
cast to f32 on the host, which would double their 800 MB per band at
20000 x 20000) and copied to the device, where the band stage resamples
them. With one, each band is warped on the device (`io/warp.warp_to_crs`):
a strong reduction is box-averaged on the host first, so only the reduced
f32 plane is uploaded.

Band 1 is handed to `band_stage` as soon as it lands on the device: its
kernels are queued, the call returns, and the device works on band 1 while
band 2 is still being read from disk.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from sarpro_tpu.errors import (
    ProcessingError,
    SafeMissingField,
    UnsupportedProduct,
)
from sarpro_tpu.io import geodesy
from sarpro_tpu.io.raster import RasterReader
from sarpro_tpu.io.safe import (
    SafeMetadata,
    TargetCrsArg,
    identify_polarization_files,
    parse_comprehensive_metadata,
)
from sarpro_tpu.io.tiffio import TiffReader

from ..core.fused import _plan_read_dims
from . import warp

logger = logging.getLogger("sarpro")


@dataclasses.dataclass
class DualPolScene:
    """A co-/cross-pol pair on the device, with the product's metadata."""

    metadata: SafeMetadata
    band1: torch.Tensor  # co-pol DN (VV or HH): u16, or f32 when warped
    band2: torch.Tensor  # cross-pol DN (VH or HV)
    is_vvvh: bool
    staged_band1: object = None  # band_stage(band1), queued during the read


def _load_dn(path: Path, metadata: SafeMetadata, device: torch.device,
             target_size: Optional[int]) -> torch.Tensor:
    """Full-resolution DN on the device, u16 as stored (f32 for other
    sample types). Records the raster's geotransform and projection in
    `metadata`, and as its size the read size that `target_size` plans
    (reference: sentinel1.rs:1084-1102)."""
    logger.info("Loading underlying data from: %s", path)
    reader = RasterReader(path)
    try:
        metadata.geotransform = list(reader.metadata.geotransform)
        metadata.projection = reader.metadata.projection
        metadata.crs = reader.metadata.projection
    finally:
        reader.close()
    tiff = TiffReader(path)
    try:
        arr = tiff.read(1)
    finally:
        tiff.close()
    arr = (arr.astype(np.uint16, copy=False) if arr.dtype.kind == "u"
           and arr.dtype.itemsize == 2 else arr.astype(np.float32))
    metadata.lines, metadata.samples, _ = _plan_read_dims(*arr.shape,
                                                          target_size)
    return torch.from_numpy(arr).to(device)


def _load_band(path: Path, metadata: SafeMetadata, device: torch.device,
               target_size: Optional[int], target_crs: Optional[str],
               resample_alg: Optional[str]) -> torch.Tensor:
    """One band onto the device: warped to `target_crs` when it is set
    (reference: sentinel1.rs:914-1071), else the DN as stored."""
    if not target_crs:
        return _load_dn(path, metadata, device, target_size)
    logger.info("Warping to target CRS: %s", target_crs)
    reader = RasterReader(path)
    try:
        # skip-warp guard when already in the target CRS (reference:
        # :959-986): the full-resolution DN, which the band stage resamples
        ds_epsg = reader.metadata.epsg
        dst_epsg = geodesy.parse_epsg_code(target_crs)
        if ds_epsg is not None and ds_epsg == dst_epsg:
            logger.info("Input already in target CRS (%s); skipping warp",
                        target_crs)
            return _load_dn(path, metadata, device, None)
        result = warp.warp_to_crs(
            reader, target_crs, device,
            resample_alg=resample_alg or "bilinear",
            target_size=target_size,
            geolocation_grid=metadata.geolocation_grid)
    finally:
        reader.close()
    metadata.geotransform = list(result.geotransform)
    metadata.projection = result.projection
    metadata.crs = result.projection
    metadata.lines, metadata.samples = result.data.shape
    return result.data


def open_dual_pol(safe_dir, device, target_size: Optional[int] = None,
                  band_stage: Optional[Callable[[torch.Tensor], object]] = None,
                  target_crs=None, resample_alg: Optional[str] = None
                  ) -> DualPolScene:
    """Open a GRD SAFE and load its VV+VH pair (else HH+HV) onto `device`
    (reference: api/mod.rs:133-143 pair preference). `target_crs` is None,
    a `TargetCrsArg` or an EPSG string; `resample_alg` is the warp's filter
    (bilinear when unset)."""
    base = Path(safe_dir)
    if not (base / "annotation").is_dir():
        raise SafeMissingField("annotation directory")
    if not (base / "measurement").is_dir():
        raise SafeMissingField("measurement directory")
    metadata = parse_comprehensive_metadata(base)
    if metadata.product_type.upper() != "GRD":
        raise UnsupportedProduct(metadata.product_type)
    vv, vh, hh, hv = identify_polarization_files(base / "measurement",
                                                 metadata.polarizations)
    if vv is not None and vh is not None:
        p1, p2, is_vvvh = vv, vh, True
    elif hh is not None and hv is not None:
        p1, p2, is_vvvh = hh, hv, False
    else:
        raise ProcessingError(
            "Multiband requires VV+VH or HH+HV; available: "
            f"{metadata.polarizations}")
    # the file API opens multiband products with the "all_pairs" hint,
    # which lists every pair in the metadata (io/safe.py:582-583)
    metadata.polarizations = ["VV", "VH", "HH", "HV"]
    # the effective target CRS, resolved once per product (reference:
    # sentinel1.rs:169-175)
    if isinstance(target_crs, str):
        effective_crs: Optional[str] = target_crs
    elif target_crs is TargetCrsArg.AUTO:
        effective_crs = geodesy.resolve_auto_target_crs(base)
    else:  # None or TargetCrsArg.NONE
        effective_crs = None
    device = torch.device(device)
    dn1 = _load_band(p1, metadata, device, target_size, effective_crs,
                     resample_alg)
    staged = band_stage(dn1) if band_stage is not None else None
    dn2 = _load_band(p2, metadata, device, target_size, effective_crs,
                     resample_alg)
    return DualPolScene(metadata, dn1, dn2, is_vvvh, staged)
