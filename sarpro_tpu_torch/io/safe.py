"""SAFE loading onto the GPU (port of the reader glue of
sarpro_tpu/io/safe.py:459-611 and :637-710).

Metadata and file discovery come from the JAX package's host-only parser.
With a target CRS, each band is warped on the device (`io/warp.warp_to_crs`):
a strong reduction is box-averaged on the host first, so only the reduced
f32 plane is uploaded. Without one, two openers differ in where the
downsample-on-read runs:
  * `open_dual_pol` (the synRGB JPEG): the rasters are read as raw u16 DN
    (never cast to f32 on the host, which would double their 800 MB per
    band at 20000 x 20000) and copied to the device, where the band stage
    resamples them. Band 1 is handed to `band_stage` as soon as it lands on
    the device: its kernels are queued, the call returns, and the device
    works on band 1 while band 2 is still being read from disk;
  * `open_band` and `open_pair` (the reader hints vv/vh/hh/hv and
    all_pairs: single bands, operations, multiband TIFF): with a target
    size each band takes the decimated read (`io/raster`), host box reduce
    or device resample with the reader's filter choice, as the JAX reader
    does; without one, the full-resolution u16 DN.
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
from . import raster, warp

logger = logging.getLogger("sarpro")


@dataclasses.dataclass
class DualPolScene:
    """A co-/cross-pol pair on the device, with the product's metadata."""

    metadata: SafeMetadata
    band1: torch.Tensor  # co-pol (VV or HH): u16 DN, or f32 when warped or
    band2: torch.Tensor  # decimated; cross-pol (VH or HV) likewise
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


def _load_decimated(path: Path, metadata: SafeMetadata, device: torch.device,
                    target_size: int, resample_alg: Optional[str]
                    ) -> torch.Tensor:
    """The decimated read at `target_size` (long side) to an f32 band on the
    device, with the reader's filter: the user's, else average for a 4x or
    stronger reduction and lanczos below (reference: sentinel1.rs:1084-1112)."""
    logger.info("Reading at target size (long side): %d", target_size)
    reader = RasterReader(path)
    try:
        metadata.geotransform = list(reader.metadata.geotransform)
        metadata.projection = reader.metadata.projection
        metadata.crs = reader.metadata.projection
        rows, cols, filt = _plan_read_dims(
            reader.metadata.size_y, reader.metadata.size_x, target_size,
            resample_alg)
        out = raster.read_band_resampled_to_device(reader, 1, cols, rows,
                                                   device, filt)
    finally:
        reader.close()
    metadata.lines, metadata.samples = rows, cols
    return out


def _load_band(path: Path, metadata: SafeMetadata, device: torch.device,
               target_size: Optional[int], target_crs: Optional[str],
               resample_alg: Optional[str], decimate: bool = False
               ) -> torch.Tensor:
    """One band onto the device: warped to `target_crs` when it is set
    (reference: sentinel1.rs:914-1071), else decimated on read when
    `decimate` and a target size are set, else the DN as stored."""
    if not target_crs:
        if decimate and target_size is not None:
            return _load_decimated(path, metadata, device, target_size,
                                   resample_alg)
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


@dataclasses.dataclass
class _Product:
    """A parsed GRD product before any band is loaded."""

    metadata: SafeMetadata
    paths: dict  # "vv" / "vh" / "hh" / "hv" -> measurement TIFF or None
    crs: Optional[str]  # the effective target CRS, None without a warp


def _open_product(safe_dir, target_crs) -> _Product:
    """Check the tree, parse the metadata, refuse non-GRD products, find the
    measurement files and resolve the target CRS once per product
    (reference: sentinel1.rs:169-175)."""
    base = Path(safe_dir)
    if not (base / "annotation").is_dir():
        raise SafeMissingField("annotation directory")
    if not (base / "measurement").is_dir():
        raise SafeMissingField("measurement directory")
    metadata = parse_comprehensive_metadata(base)
    if metadata.product_type.upper() != "GRD":
        raise UnsupportedProduct(metadata.product_type)
    found = identify_polarization_files(base / "measurement",
                                        metadata.polarizations)
    if isinstance(target_crs, str):
        crs: Optional[str] = target_crs
    elif target_crs is TargetCrsArg.AUTO:
        crs = geodesy.resolve_auto_target_crs(base)
    else:  # None or TargetCrsArg.NONE
        crs = None
    return _Product(metadata, dict(zip(("vv", "vh", "hh", "hv"), found)), crs)


def _pair(product: _Product, what: str):
    """VV+VH, else HH+HV (reference: api/mod.rs:133-143): (co-pol path,
    cross-pol path, is_vvvh)."""
    p = product.paths
    if p["vv"] is not None and p["vh"] is not None:
        return p["vv"], p["vh"], True
    if p["hh"] is not None and p["hv"] is not None:
        return p["hh"], p["hv"], False
    avail = ", ".join(k.upper() for k, v in p.items() if v is not None)
    raise ProcessingError(f"{what} requires VV+VH or HH+HV; available: "
                          f"{avail or 'none'}")


def open_band(safe_dir, pol: str, device, target_size: Optional[int] = None,
              target_crs=None, resample_alg: Optional[str] = None):
    """One polarization ("vv", "vh", "hh" or "hv") onto `device`, as the
    JAX reader's single-band hints load it: (metadata, band)."""
    product = _open_product(safe_dir, target_crs)
    product.metadata.polarizations = [pol.upper()]
    path = product.paths[pol]
    if path is None:
        raise SafeMissingField(f"{pol.upper()} measurement file")
    band = _load_band(path, product.metadata, torch.device(device),
                      target_size, product.crs, resample_alg, decimate=True)
    return product.metadata, band


def open_pair(safe_dir, device, what: str, target_size: Optional[int] = None,
              target_crs=None, resample_alg: Optional[str] = None
              ) -> DualPolScene:
    """The preferred co-/cross-pol pair onto `device`, as the JAX reader's
    "all_pairs" hint loads it (metadata lists all four polarizations). Both
    bands are reduced on read, before any operation combines them.
    `what` names the caller in the missing-pair error."""
    product = _open_product(safe_dir, target_crs)
    p1, p2, is_vvvh = _pair(product, what)
    product.metadata.polarizations = ["VV", "VH", "HH", "HV"]
    device = torch.device(device)
    b1, b2 = (_load_band(p, product.metadata, device, target_size,
                         product.crs, resample_alg, decimate=True)
              for p in (p1, p2))
    return DualPolScene(product.metadata, b1, b2, is_vvvh)


def open_dual_pol(safe_dir, device, target_size: Optional[int] = None,
                  band_stage: Optional[Callable[[torch.Tensor], object]] = None,
                  target_crs=None, resample_alg: Optional[str] = None
                  ) -> DualPolScene:
    """Open a GRD SAFE and load its VV+VH pair (else HH+HV) onto `device`
    (reference: api/mod.rs:133-143 pair preference). `target_crs` is None,
    a `TargetCrsArg` or an EPSG string; `resample_alg` is the warp's filter
    (bilinear when unset)."""
    product = _open_product(safe_dir, target_crs)
    p1, p2, is_vvvh = _pair(product, "Multiband")
    # the file API opens multiband products with the "all_pairs" hint,
    # which lists every pair in the metadata (io/safe.py:582-583)
    metadata = product.metadata
    metadata.polarizations = ["VV", "VH", "HH", "HV"]
    device = torch.device(device)
    dn1 = _load_band(p1, metadata, device, target_size, product.crs,
                     resample_alg)
    staged = band_stage(dn1) if band_stage is not None else None
    dn2 = _load_band(p2, metadata, device, target_size, product.crs,
                     resample_alg)
    return DualPolScene(metadata, dn1, dn2, is_vvvh, staged)
