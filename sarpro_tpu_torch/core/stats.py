"""Histogram statistics and autoscale strategy windows: host-side f64
scalar math (a copy of sarpro_tpu/core/stats.py, kept as it is but for this
docstring; tests/test_torch_host_copies.py holds it equal).

This is the control half of the autoscale family (reference:
src/core/processing/autoscale.rs:7-160 and :368-562). The array passes (dB,
min/max, moments, 4096-bin histogram, quantize) run on the device
(core/pipeline.py); this module turns their small outputs (a 4096-vector and
5 scalars) into clip windows and gammas with the reference's f64
arithmetic, as the reference computes them on the CPU. The chosen (low,
high, gamma) go back to the device as 0-dim f32 tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..types import AutoscaleStrategy

NUM_BINS = 4096


@dataclasses.dataclass
class HistogramStats:
    """Percentile estimates + moments (reference: autoscale.rs:7-24)."""

    valid_count: int
    min_db: float
    max_db: float
    mean_db: float
    std_db: float
    median_db: float
    p01: float
    p02: float
    p05: float
    p10: float
    p25: float
    p75: float
    p90: float
    p95: float
    p98: float
    p99: float

    @classmethod
    def empty(cls) -> "HistogramStats":
        return cls(0, *([0.0] * 15))

    @classmethod
    def degenerate(cls, count: int, v: float, mean: float, std: float) -> "HistogramStats":
        """All valid values equal (reference: autoscale.rs:81-100):
        p01..p25 and median = min, p75..p99 = max (== min)."""
        return cls(
            valid_count=count,
            min_db=v,
            max_db=v,
            mean_db=mean,
            std_db=std,
            median_db=v,
            p01=v, p02=v, p05=v, p10=v, p25=v,
            p75=v, p90=v, p95=v, p98=v, p99=v,
        )


_PERCENTS = {
    "median_db": 0.5,
    "p01": 0.01,
    "p02": 0.02,
    "p05": 0.05,
    "p10": 0.10,
    "p25": 0.25,
    "p75": 0.75,
    "p90": 0.90,
    "p95": 0.95,
    "p98": 0.98,
    "p99": 0.99,
}


def estimate_percentile(
    hist: np.ndarray, count: int, min_db: float, max_db: float, p: float
) -> float:
    """Invert the histogram CDF with intra-bin linear interpolation
    (reference: autoscale.rs:120-140).

    target = floor(p*n) clamped to n-1; walk bins until target < cumsum+h;
    value = bin_start + (target - cumsum)/h * bin_width.
    """
    n = int(count)
    span = max_db - min_db
    target = int(np.floor(p * float(n)))
    if target >= n:
        target = n - 1
    cum = np.cumsum(hist.astype(np.uint64))
    b = int(np.searchsorted(cum, target, side="right"))
    if b >= NUM_BINS:
        return max_db  # fallback (reference: autoscale.rs:139)
    h = int(hist[b])
    cum_before = int(cum[b]) - h
    within = max(target - cum_before, 0)
    frac = (float(within) / float(h)) if h > 0 else 0.0
    bin_width = span / float(NUM_BINS)
    return min_db + float(b) * bin_width + frac * bin_width


def stats_from_histogram(
    hist: np.ndarray,
    count: int,
    min_db: float,
    max_db: float,
    mean_db: float,
    std_db: float,
) -> HistogramStats:
    """Assemble HistogramStats from device-computed reductions.

    The device supplies count/min/max/mean/std and the 4096-bin histogram
    (reference computes these in its two CPU passes, autoscale.rs:35-117);
    percentile inversion happens here in f64.
    """
    if count == 0:
        return HistogramStats.empty()
    if abs(max_db - min_db) < np.finfo(np.float64).eps:
        return HistogramStats.degenerate(count, float(min_db), float(mean_db), float(std_db))
    kw = {
        name: estimate_percentile(hist, count, float(min_db), float(max_db), p)
        for name, p in _PERCENTS.items()
    }
    return HistogramStats(
        valid_count=int(count),
        min_db=float(min_db),
        max_db=float(max_db),
        mean_db=float(mean_db),
        std_db=float(std_db),
        **kw,
    )


def compute_histogram_stats_host(db: np.ndarray, valid: np.ndarray) -> HistogramStats:
    """Pure-NumPy f64 reference path (CPU oracle / tiny images).

    Reproduces reference autoscale.rs:35-160 exactly: pass 1 min/max +
    mean/std over valid pixels; pass 2 fixed 4096-bin histogram over
    [min, max] with truncating bin assignment.
    """
    v = db.astype(np.float64).ravel()[valid.ravel()]
    count = v.size
    if count == 0:
        return HistogramStats.empty()
    min_db = float(v.min())
    max_db = float(v.max())
    mean = float(v.mean())
    m2 = float(np.sum((v - mean) ** 2))
    std = float(np.sqrt(m2 / count)) if count > 1 else 0.0
    if abs(max_db - min_db) < np.finfo(np.float64).eps:
        return HistogramStats.degenerate(count, min_db, mean, std)
    span = max_db - min_db
    t = np.clip((v - min_db) * (1.0 / span), 0.0, 1.0)
    idx = (t * NUM_BINS).astype(np.int64)  # truncation, as Rust `as usize`
    np.minimum(idx, NUM_BINS - 1, out=idx)
    hist = np.bincount(idx, minlength=NUM_BINS).astype(np.uint64)
    return stats_from_histogram(hist, count, min_db, max_db, mean, std)


def _approx_eq(a: float, b: float) -> bool:
    """reference: autoscale.rs:26-29."""
    return abs(a - b) < 1e-9


@dataclasses.dataclass
class ScaleWindow:
    low: float
    high: float
    gamma: float

    @property
    def range(self) -> float:
        return max(self.high - self.low, 1.0)


def standard_window(stats: HistogramStats) -> ScaleWindow:
    """SAR-specific clip heuristics of the *standard* autoscale
    (reference: autoscale.rs:404-429)."""
    dr = stats.max_db - stats.min_db
    iqr = stats.p75 - stats.p25
    if dr < 15.0:
        # Very low contrast — median-based range
        rng = max(20.0, dr * 0.8)
        low, high, gamma = stats.median_db - rng / 2.0, stats.median_db + rng / 2.0, 1.1
    elif iqr < 5.0:
        # Heavy-tailed — IQR-based robust range
        low, high, gamma = stats.p25 - 2.5 * iqr, stats.p75 + 2.5 * iqr, 1.0
    elif dr > 40.0:
        # High dynamic range — adaptive inward clipping + slight gamma compression
        low = max(stats.p02, stats.min_db + 0.02 * dr)
        high = min(stats.p98, stats.max_db - 0.02 * dr)
        gamma = 0.9
    else:
        low, high, gamma = stats.p02, stats.p98, 1.0
    # Ensure valid range (reference: autoscale.rs:427-429)
    low = max(low, stats.min_db)
    high = min(high, stats.max_db)
    return ScaleWindow(low, high, gamma)


def advanced_window(stats: HistogramStats, strategy: AutoscaleStrategy) -> ScaleWindow:
    """Strategy table of the *advanced* autoscale (reference: autoscale.rs:491-564).

    Unlike the standard path, low/high are NOT re-clamped to [min, max]
    afterwards (only Robust clamps internally).
    """
    iqr = stats.p75 - stats.p25
    if strategy is AutoscaleStrategy.ROBUST:
        thr = 2.5 * iqr
        low = max(stats.p25 - thr, stats.p01, stats.min_db)
        high = min(stats.p75 + thr, stats.p99, stats.max_db)
        return ScaleWindow(low, high, 1.0)
    if strategy is AutoscaleStrategy.ADAPTIVE:
        skew = (stats.mean_db - stats.median_db) / max(abs(stats.std_db), 1.0)
        tail = (stats.p99 - stats.p95) / max(stats.p95 - stats.p75, 1.0)
        if abs(skew) > 0.5:
            if skew > 0.0:
                low_pct, high_pct, gamma = 0.02, 0.98, 0.9
            else:
                low_pct, high_pct, gamma = 0.05, 0.95, 1.1
        elif tail > 2.0:
            low_pct, high_pct, gamma = 0.10, 0.90, 0.8
        else:
            low_pct, high_pct, gamma = 0.05, 0.95, 1.0
        # percentile lookup chain (reference: autoscale.rs:521-535)
        if _approx_eq(low_pct, 0.10):
            low = stats.p10
        elif _approx_eq(low_pct, 0.02):
            low = stats.p02
        elif _approx_eq(low_pct, 0.05):
            low = stats.p05
        elif _approx_eq(low_pct, 0.25):
            low = stats.p25
        elif _approx_eq(low_pct, 0.75):
            low = stats.p75
        elif _approx_eq(low_pct, 0.95):
            low = stats.p95
        elif _approx_eq(low_pct, 0.99):
            low = stats.p99
        else:
            low = stats.p05
        if _approx_eq(high_pct, 0.90):
            high = stats.p90
        elif _approx_eq(high_pct, 0.98):
            high = stats.p98
        elif _approx_eq(high_pct, 0.95):
            high = stats.p95
        elif _approx_eq(high_pct, 0.75):
            high = stats.p75
        elif _approx_eq(high_pct, 0.99):
            high = stats.p99
        else:
            high = stats.p95
        return ScaleWindow(low, high, gamma)
    if strategy in (AutoscaleStrategy.EQUALIZED, AutoscaleStrategy.CLAHE):
        return ScaleWindow(stats.p01, stats.p99, 1.0)
    if strategy is AutoscaleStrategy.TAMED:
        return ScaleWindow(stats.p25, stats.p99, 1.0)
    # Standard / Default
    return ScaleWindow(stats.p05, stats.p95, 1.0)


def tamed_synrgb_window(stats: HistogramStats, is_copol: bool) -> ScaleWindow:
    """Band-specific Tamed window for synRGB inputs
    (reference: autoscale.rs:710-729). Co-pol: min(p02,p05)..p99; cross-pol:
    p05..p99; no gamma."""
    if is_copol:
        low = min(stats.p02, stats.p05)
    else:
        low = stats.p05
    return ScaleWindow(low, stats.p99, 1.0)
