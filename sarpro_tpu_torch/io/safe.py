"""Dual-pol SAFE loading onto the GPU (port of the reader glue of
sarpro_tpu/io/safe.py:459-611 and :675-708).

Metadata and file discovery come from the JAX package's host-only parser;
the measurement rasters are read as raw u16 DN (never cast to f32 on the
host, which would double their 800 MB per band at 20000 x 20000) and
copied to the device, where the band stage resamples them.

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
from sarpro_tpu.io.raster import RasterReader
from sarpro_tpu.io.safe import (
    SafeMetadata,
    identify_polarization_files,
    parse_comprehensive_metadata,
)
from sarpro_tpu.io.tiffio import TiffReader

from ..core.fused import _plan_read_dims

logger = logging.getLogger("sarpro")


@dataclasses.dataclass
class DualPolScene:
    """A co-/cross-pol pair on the device, with the product's metadata."""

    metadata: SafeMetadata
    band1: torch.Tensor  # co-pol DN (VV or HH), u16
    band2: torch.Tensor  # cross-pol DN (VH or HV), u16
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


def open_dual_pol(safe_dir, device, target_size: Optional[int] = None,
                  band_stage: Optional[Callable[[torch.Tensor], object]] = None
                  ) -> DualPolScene:
    """Open a GRD SAFE and load its VV+VH pair (else HH+HV) onto `device`
    (reference: api/mod.rs:133-143 pair preference)."""
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
    device = torch.device(device)
    dn1 = _load_dn(p1, metadata, device, target_size)
    staged = band_stage(dn1) if band_stage is not None else None
    dn2 = _load_dn(p2, metadata, device, target_size)
    return DualPolScene(metadata, dn1, dn2, is_vvvh, staged)
