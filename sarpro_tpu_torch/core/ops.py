"""Element-wise dual-polarization operations on linear intensities (port of
sarpro_tpu/core/ops.py; reference: src/core/processing/ops.rs:4-44).

f32 element-wise PyTorch on the bands' device; the JAX package leaves the
same operations to XLA, with no kernel of its own.
"""
from __future__ import annotations

import torch

from .numerics import as_f32

ZERO_GUARD = 1e-10  # |denominator| threshold (reference: ops.rs:16,29,41)


def sum_arrays(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (reference: ops.rs:4)."""
    return as_f32(a) + as_f32(b)


def difference_arrays(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (reference: ops.rs:7)."""
    return as_f32(a) - as_f32(b)


def _guarded_div(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """num / denom, 0 where |denom| <= ZERO_GUARD; the guarded lanes divide
    by 1, so no inf or nan is ever formed."""
    safe = torch.abs(denom) > ZERO_GUARD
    return torch.where(safe, num / torch.where(safe, denom, 1.0), 0.0)


def ratio_arrays(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, 0 where |b| <= 1e-10 (reference: ops.rs:10-19)."""
    return _guarded_div(as_f32(a), as_f32(b))


def normalized_diff_arrays(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) / (a + b), 0 where |a + b| <= 1e-10 (reference:
    ops.rs:22-32)."""
    a = as_f32(a)
    b = as_f32(b)
    return _guarded_div(a - b, a + b)


def log_ratio_arrays(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain ratio: the dB conversion happens downstream. A quirk of the
    reference, kept on purpose (ops.rs:34-44)."""
    return ratio_arrays(a, b)


OPERATIONS = {
    "sum": sum_arrays,
    "diff": difference_arrays,
    "ratio": ratio_arrays,
    "n-diff": normalized_diff_arrays,
    "log-ratio": log_ratio_arrays,
}
