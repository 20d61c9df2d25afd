"""File-output API of the port (port of sarpro_tpu/api.py:345-357 and
:409-487): a GRD SAFE to a GeoTIFF or JPEG on the GPU.

Fast mode runs every route of the JAX package's fast mode on one device:
single bands (vv, vh, hh, hv), the five polarization operations, multiband
TIFF and the multiband synRGB JPEG, every strategy, u8 or u16 TIFF, with or
without reprojection (`target_crs` none, auto or an EPSG code). Exact mode
(ROADMAP queue 1 #5), full-resolution scenes above
`fast_path.BIG_SCENE_PIXELS` (#6) and sharding over several devices (#7)
raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import logging

import torch

from .core import fast_path, fused, ops
from .io.safe import TargetCrsArg, open_band, open_dual_pol, open_pair
from .params import ProcessingParams
from .types import OutputFormat, ProcessingOperation

logger = logging.getLogger("sarpro")


def _resolve_target_args(params: ProcessingParams):
    """Map target CRS strings none/auto/custom and resample names
    (reference: api/mod.rs:544-557, lanczos default)."""
    t = params.target_crs
    if t is None:
        target_arg = None
    elif t.lower() == "none":
        target_arg = TargetCrsArg.NONE
    elif t.lower() == "auto":
        target_arg = TargetCrsArg.AUTO
    else:
        target_arg = t
    alg = params.resample_alg
    if alg in ("nearest", "bilinear", "cubic", "lanczos"):
        resample = alg
    elif alg is None:
        # unspecified -> reader heuristic (Average for >=4x reductions), the
        # reference CLI semantics (runner.rs:61-67)
        resample = None
    else:  # unknown name -> lanczos (api/mod.rs:556)
        resample = "lanczos"
    return target_arg, resample


def process_safe_to_path(input, output, params: ProcessingParams,
                         fast: bool = False, shard_devices: int = 0,
                         device="cuda") -> None:
    """SAFE -> file, driven by ProcessingParams, computing on `device`."""
    if not fast:
        raise NotImplementedError("exact mode is not ported yet; pass "
                                  "fast=True (ROADMAP queue 1 #5, exact "
                                  "mode)")
    if shard_devices:
        raise NotImplementedError("multi-GPU sharding is not ported yet "
                                  "(ROADMAP queue 1 #7, multi-GPU)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    bit_depth = params.bit_depth.to_bit_depth()
    target_arg, resample = _resolve_target_args(params)
    warping = target_arg not in (None, TargetCrsArg.NONE)
    alg0 = None if warping else resample  # the warp consumed the filter
    size = params.size
    pol = params.polarization
    common = dict(pad=params.pad, strategy=params.autoscale,
                  resample_alg=alg0)
    if pol.kind in ("vv", "vh", "hh", "hv"):
        metadata, band = open_band(input, pol.kind, device, size,
                                   target_crs=target_arg,
                                   resample_alg=resample)
        fast_path.save_single_band_fast(
            band, output, params.format, bit_depth, size, metadata,
            operation=ProcessingOperation.SINGLE_BAND, **common)
        return
    if pol.kind == "op":
        op = pol.op
        scene = open_pair(input, device, f"Operation {op.metadata_label}",
                          size, target_crs=target_arg, resample_alg=resample)
        # the operation combines the bands as loaded: already reduced
        band = ops.OPERATIONS[op.value](scene.band1, scene.band2)
        fast_path.save_single_band_fast(
            band, output, params.format, bit_depth, size, scene.metadata,
            operation=ProcessingOperation.PolarOp(op), **common)
        return
    if params.format is OutputFormat.TIFF:
        scene = open_pair(input, device, "Multiband", size,
                          target_crs=target_arg, resample_alg=resample)
    else:
        def band_stage(dn1):
            if fast_path._is_big_scene(*dn1.shape, size):
                return None  # save_multiband_fast rejects the scene
            return fused.synrgb_band_stage(
                dn1, strategy=params.autoscale, copol=True, target_size=size,
                pad=params.pad, resample_alg=alg0)

        scene = open_dual_pol(input, device, size, band_stage=band_stage,
                              target_crs=target_arg, resample_alg=resample)
    fast_path.save_multiband_fast(
        scene.band1, scene.band2, output, params.format, bit_depth, size,
        scene.metadata,
        operation=(ProcessingOperation.MULTIBAND_VV_VH if scene.is_vvvh
                   else ProcessingOperation.MULTIBAND_HH_HV),
        syn_mode=params.synrgb_mode, staged_b1=scene.staged_band1, **common)
