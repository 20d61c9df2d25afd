"""Exact mode's dB -> stats -> autoscale -> quantize pipeline (port of
sarpro_tpu/core/pipeline.py).

Reference behaviour (file:line cites on each function): the dB conversion
and validity mask (pipeline.rs:8-40), the two-pass histogram statistics
(autoscale.rs:35-160), the standard and advanced autoscale (:368-448,
:452-659), the CLAHE special path (:571-608, in core/clahe.py), the U8
double normalization (:348-364, :662-704) and the Tamed synRGB band
autoscale (:710-742).

Three device passes, as in the JAX package: dB + mask + count/min/max, the
4096-bin histogram (`ops.histogram`) + midpoint-shifted f32 moments, and
the quantize. Between them the host round trips that make the mode exact:
count, min and max come back (one sync), then the histogram and the two
moment sums (one sync); the host builds `stats.HistogramStats` and the
strategy's `stats.ScaleWindow` in f64, and the window goes back as 0-dim
f32 tensors (so CUDA divides by `range` truly). CLAHE adds two syncs (the
tile histograms out, the CDFs in). Unlike fast mode (core/fused), no range
is clamped on the device: `range` is the host window's, cast to f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import histogram
from ..types import AutoscaleStrategy, BitDepth
from . import stats as stats_mod
from .clahe import _window_tensors, clahe_equalize_db
from .fused import _db_bin_index, _db_mask, _scale_u16_to_u8
from .numerics import as_f32, pow_f32, trunc_sat_u8, trunc_sat_u16
from .stats import HistogramStats, ScaleWindow

NUM_BINS = stats_mod.NUM_BINS


# --------------------------------------------------------------------------
# Pass 1: dB + mask + min/max/count
# --------------------------------------------------------------------------
def _db_mask_minmax(x: torch.Tensor):
    """10*log10(max(v, 1e-10)) and the `db > -50` mask (reference:
    pipeline.rs:8-40), with the count/min/max reductions of stats pass 1
    (reference: autoscale.rs:38-55)."""
    db, mask = _db_mask(x)
    count = mask.sum(dtype=torch.int32)
    mn = torch.where(mask, db, float("inf")).amin()
    mx = torch.where(mask, db, float("-inf")).amax()
    return db, mask, count, mn, mx


# --------------------------------------------------------------------------
# Pass 2: 4096-bin histogram + shifted moments
# --------------------------------------------------------------------------
def _hist_moments(db, mask, mn, mx):
    """Histogram over [min, max] with truncating bin assignment (reference:
    autoscale.rs:102-117) and the midpoint-shifted f32 sums s1 and s2 of the
    valid values, from which the host takes mean and std."""
    hist = histogram(_db_bin_index(db, mask, mn, mx).reshape(-1), NUM_BINS)
    shift = (mn + mx) * 0.5
    d = torch.where(mask, db - shift, 0.0)
    s1 = torch.sum(d, dtype=torch.float32)
    s2 = torch.sum(d * d, dtype=torch.float32)
    return hist, s1, s2


def compute_db_and_stats(x: torch.Tensor):
    """Passes 1 and 2 on the device, HistogramStats on the host (reference:
    pipeline.rs:8-40 + autoscale.rs:35-160): (db, mask, stats)."""
    db, mask, count, mn, mx = _db_mask_minmax(x)
    # one copy back (one sync): count, min and max, exact in f64
    count_f, mn_f, mx_f = torch.stack(
        [count.to(torch.float64), mn.to(torch.float64),
         mx.to(torch.float64)]).tolist()
    count = int(count_f)
    if count == 0:
        return db, mask, HistogramStats.empty()
    if abs(mx_f - mn_f) < np.finfo(np.float64).eps:
        # Degenerate: all valid values equal (reference: autoscale.rs:81-100).
        # mean == the value; std == 0.
        return db, mask, HistogramStats.degenerate(count, mn_f, mn_f, 0.0)
    hist, s1, s2 = _hist_moments(db, mask, mn, mx)
    # one copy back (one sync): the 4096 counts and the two sums
    host = torch.cat([hist.to(torch.float64),
                      torch.stack([s1, s2]).to(torch.float64)]).cpu().numpy()
    hist = host[:NUM_BINS].astype(np.uint64)
    s1, s2 = float(host[NUM_BINS]), float(host[NUM_BINS + 1])
    shift = (mn_f + mx_f) * 0.5
    m1 = s1 / count
    mean = shift + m1
    var = max(s2 / count - m1 * m1, 0.0)
    std = float(np.sqrt(var)) if count > 1 else 0.0
    st = stats_mod.stats_from_histogram(hist, count, mn_f, mx_f, mean, std)
    return db, mask, st


# --------------------------------------------------------------------------
# Pass 3: clip-normalize-gamma-quantize
# --------------------------------------------------------------------------
def _quantize_window(db, mask, low, high, rng, gamma, max_val: float):
    """((clip(v) - low)/range)^gamma * max_val, truncated to u16; invalid
    -> 0 (reference: autoscale.rs:437-447 and :644-656). `low`, `high`,
    `rng` and `gamma` are 0-dim f32 tensors."""
    norm = (torch.clamp(db, low, high) - low) / rng
    # exact when gamma == 1 (pow goes through exp/log)
    powed = torch.where(gamma == 1.0, norm, pow_f32(norm, gamma))
    q = torch.clamp(powed * max_val, 0.0, max_val)
    return trunc_sat_u16(torch.where(mask, q, 0.0))


def scale_u16_to_u8(q: torch.Tensor) -> torch.Tensor:
    """Second min-max normalization used for all U8 outputs (reference:
    autoscale.rs:348-364): f32 arithmetic, round half away."""
    return _scale_u16_to_u8(as_f32(q))


def _apply_window_u16(db, mask, window: ScaleWindow,
                      bit_depth: BitDepth) -> torch.Tensor:
    low, high, rng = _window_tensors(window, db.device)
    gamma = torch.full((), float(np.float32(window.gamma)),
                       dtype=torch.float32, device=db.device)
    return _quantize_window(db, mask, low, high, rng, gamma,
                            float(bit_depth.max_val))


# --------------------------------------------------------------------------
# Public autoscale entry points (device tensors in, device tensors out)
# --------------------------------------------------------------------------
def _zeros(db, dtype):
    return torch.zeros(db.shape, dtype=dtype, device=db.device)


def autoscale_db_image(db, mask, stats: HistogramStats,
                       bit_depth: BitDepth) -> torch.Tensor:
    """Standard autoscale -> uint16 at the bit depth's scale (reference:
    autoscale.rs:368-448)."""
    if stats.valid_count == 0:
        return _zeros(db, torch.uint16)
    window = stats_mod.standard_window(stats)
    return _apply_window_u16(db, mask, window, bit_depth)


def autoscale_db_image_advanced(
    db, mask, stats: HistogramStats, bit_depth: BitDepth,
    strategy: AutoscaleStrategy
) -> torch.Tensor:
    """Advanced autoscale incl. the CLAHE special path (reference:
    autoscale.rs:452-659)."""
    if stats.valid_count == 0:
        return _zeros(db, torch.uint16)
    window = stats_mod.advanced_window(stats, strategy)
    if strategy is AutoscaleStrategy.CLAHE:
        return clahe_equalize_db(db, mask, window, bit_depth)
    return _apply_window_u16(db, mask, window, bit_depth)


def autoscale_db_image_tamed_synrgb_u8(
    db, mask, stats: HistogramStats, is_copol: bool
) -> torch.Tensor:
    """Band-specific Tamed autoscale for synRGB (reference:
    autoscale.rs:710-742)."""
    if stats.valid_count == 0:
        return _zeros(db, torch.uint8)
    window = stats_mod.tamed_synrgb_window(stats, is_copol)
    # inline exact clip-normalize (no gamma)
    low, high, rng = _window_tensors(window, db.device)
    q = torch.clamp((torch.clamp(db, low, high) - low) / rng * 255.0,
                    0.0, 255.0)
    return trunc_sat_u8(torch.where(mask, q, 0.0))


# --------------------------------------------------------------------------
# Pipeline orchestration
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineResult:
    """Outputs of the scalar pipeline (the reference returns (db, mask, u8,
    u16), pipeline.rs:42-67), plus the stats, so that the Tamed synRGB
    recompute reuses them without another device pass."""

    db: torch.Tensor
    mask: torch.Tensor
    stats: HistogramStats
    scaled_u8: Optional[torch.Tensor]  # set for U8 bit depth
    scaled_u16: Optional[torch.Tensor]  # set for U16 bit depth

    @property
    def shape(self):
        return tuple(self.db.shape)


def process_scalar_data_pipeline(
    x: torch.Tensor, bit_depth: BitDepth, strategy: AutoscaleStrategy
) -> PipelineResult:
    """Full scalar pipeline: dB + mask, then the strategy-dispatched
    autoscale (reference: pipeline.rs:42-67 with the U8/U16 wrappers of
    autoscale.rs:662-704)."""
    db, mask, st = compute_db_and_stats(x)
    if strategy is AutoscaleStrategy.STANDARD:
        q = autoscale_db_image(db, mask, st, bit_depth)
    else:
        q = autoscale_db_image_advanced(db, mask, st, bit_depth, strategy)
    if bit_depth is BitDepth.U8:
        return PipelineResult(db, mask, st, scale_u16_to_u8(q), None)
    return PipelineResult(db, mask, st, None, q)
