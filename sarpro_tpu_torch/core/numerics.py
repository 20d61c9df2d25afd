"""Rounding helpers matching the reference's Rust numerics (port of
sarpro_tpu/core/numerics.py)."""
from __future__ import annotations

import torch


def round_half_up_nonneg(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5): equals Rust .round() for x >= 0 (the common case)."""
    return torch.floor(x + 0.5)
