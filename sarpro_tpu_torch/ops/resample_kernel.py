"""Axis-0 separable resampler: the Hopper kernel (csrc/resample.cu) and its
dispatch.

The plain version is the tap loop `core/resize._resample_axis0`, with the
same coefficients (`core/resize._build_coeffs`). Unlike the TPU kernel this
one takes any shape and any tap count, so it never declines a call.
"""
from __future__ import annotations

import torch

from ..core.resize import _resample_axis0, device_coeffs
from ._cuda import launch, use_kernel


def band_resample_axis0(x: torch.Tensor, in_size: int, out_size: int,
                        filter_name: str) -> torch.Tensor:
    """Resample a 2-D u16 or f32 tensor along axis 0 from in_size to
    out_size rows; (out_size, cols) f32."""
    if x.dim() != 2 or x.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"expected a 2-D uint16 or float32 tensor, got "
                        f"{x.dtype} with shape {tuple(x.shape)}")
    if x.shape[0] != in_size:
        raise ValueError(f"x has {x.shape[0]} rows, expected {in_size}")
    starts, weights = device_coeffs(in_size, out_size, filter_name, x.device)
    return resample_rows(x, starts, weights)


def resample_rows(x: torch.Tensor, starts: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Output rows i of the axis-0 resample of a 2-D u16 or f32 tensor,
    sum_k weights[i, k] * x[clamp(starts[i] + k, 0, rows - 1)]: `starts`
    (n,) int32 and `weights` (n, taps) f32 on x's device, for any n rows of
    a coefficient table (a row shard's slice, its starts rebased to the
    band of source rows it is given). (n, cols) f32."""
    if not use_kernel(x):
        return _resample_axis0(x, starts, weights)
    if not all(t.is_contiguous() for t in (x, starts, weights)):
        raise ValueError("resample_rows needs contiguous inputs")
    rows, cols = x.shape
    out = torch.empty((starts.shape[0], cols), dtype=torch.float32,
                      device=x.device)
    launch("sarpro_resample_axis0", "resample_axis0", x.device,
           x.data_ptr(), int(x.dtype == torch.uint16), rows, cols,
           starts.data_ptr(), weights.data_ptr(), weights.shape[1],
           out.data_ptr(), starts.shape[0])
    return out
