"""CLAHE: Contrast Limited Adaptive Histogram Equalization (port of
sarpro_tpu/core/clahe.py).

Reference semantics (autoscale.rs:220-345, call site :571-608): 8x8 tiles,
256 bins, clip limit 2.0 x the average bin count, uniform redistribution of
the excess with a round-robin remainder, normalised CDFs, then a bilinear
blend of the 4 neighbouring tile CDFs at each pixel; invalid pixels -> 0.

The constants are copies of the JAX package's (a test holds them equal).
Two programs use them:
  * fast mode, `core/fused._clahe`: every step on the device, the CDFs in
    f32 from the device's window;
  * exact mode, `clahe_equalize_db` below, the JAX package's host/device
    split: the device window-normalizes with the host's f64 window (cast to
    f32) and counts the tile histograms (`ops.tile_histogram`); the host
    clips, redistributes and accumulates the CDFs in f64
    (`_clip_redistribute_cdf`, a numpy copy held bit-equal to the
    original); the device blends them per pixel (`ops.clahe_lookup`) and
    quantizes. Two host syncs: the tile histograms out, the CDFs back in.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import clahe_lookup, tile_histogram
from ..types import BitDepth
from .numerics import round_half_up_nonneg, trunc_sat_u16
from .stats import ScaleWindow

TILES_X = 8
TILES_Y = 8
CLIP_LIMIT = 2.0
CLAHE_BINS = 256


def _clahe_bins(norm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel CLAHE bin, round(clamp(v, 0, 1) * 255) half away
    (reference: autoscale.rs:262-265); masked pixels carry CLAHE_BINS (the
    kernels' masked convention)."""
    bin_ = round_half_up_nonneg(torch.clamp(norm, 0, 1)
                                * float(np.float32(CLAHE_BINS - 1)))
    bin_ = torch.clamp(bin_, 0, CLAHE_BINS - 1).to(torch.int32)
    return torch.where(mask, bin_, CLAHE_BINS).to(torch.int32)


def _window_tensors(window: ScaleWindow, device):
    """(low, high, range) of the host window as 0-dim f32 device tensors:
    dividing by a tensor keeps PyTorch's CUDA division true (a Python
    scalar divisor becomes a multiply by its rounded reciprocal)."""
    return tuple(torch.full((), float(np.float32(v)), dtype=torch.float32,
                            device=device)
                 for v in (window.low, window.high, window.range))


def _normalize_and_tile_hists(db, mask, window: ScaleWindow, tile_h: int,
                              tile_w: int):
    """Device pass 1: window-normalize (reference: autoscale.rs:581-591),
    bin, and count the per-tile histograms (reference: :258-269). Returns
    (flat int32 bins, flat int32 (64 * 256,) tile histograms)."""
    low, high, rng = _window_tensors(window, db.device)
    norm = torch.where(mask, (torch.clamp(db, low, high) - low) / rng, 0.0)
    bins = _clahe_bins(norm, mask).reshape(-1)
    hists = tile_histogram(bins, db.shape[1], TILES_X, TILES_Y, tile_h,
                           tile_w, n_bins=CLAHE_BINS)
    return bins, hists


def _clip_redistribute_cdf(hists: np.ndarray, rows: int, cols: int,
                           tile_h: int, tile_w: int) -> np.ndarray:
    """Host pass: clip histogram at 2×average, redistribute excess uniformly
    with round-robin remainder, normalize CDF (reference: autoscale.rs:271-303).

    f64 arithmetic with the reference's exact truncating casts.
    Input: (64, 256) int counts. Output: (64, 256) f64 CDFs in [0,1].
    """
    h = hists.reshape(TILES_Y, TILES_X, CLAHE_BINS).astype(np.float64)
    # per-tile pixel extents — ragged edges via min() (reference: :247-256)
    r0 = np.arange(TILES_Y) * tile_h
    r1 = np.minimum(r0 + tile_h, rows)
    c0 = np.arange(TILES_X) * tile_w
    c1 = np.minimum(c0 + tile_w, cols)
    tile_pixels = np.maximum(r1 - r0, 0)[:, None] * np.maximum(c1 - c0, 0)[None, :]
    avg = tile_pixels.astype(np.float64) / CLAHE_BINS
    thr = np.maximum(CLIP_LIMIT * avg, 1.0)[..., None]  # (8,8,1)

    over = h > thr
    excess = np.sum(np.where(over, h - thr, 0.0), axis=-1)  # f64 (8,8)
    h = np.where(over, np.trunc(thr), h)  # `*h = clip_threshold as u32`

    add_per_bin = np.floor(excess / CLAHE_BINS)  # (8,8)
    h = np.trunc(h + add_per_bin[..., None])  # `(*h as f64 + add) as u32`
    remainder = np.floor(excess - add_per_bin * CLAHE_BINS + 0.5)  # .round(), >= 0
    # +1 to bins 0..remainder-1, wrapping (remainder <= 256)
    bin_idx = np.arange(CLAHE_BINS)[None, None, :]
    h = h + (bin_idx < remainder[..., None]).astype(np.float64)

    total = np.maximum(h.sum(axis=-1, keepdims=True), 1.0)
    cdf = np.clip(np.cumsum(h, axis=-1) / total, 0.0, 1.0)
    return cdf.reshape(TILES_Y * TILES_X, CLAHE_BINS)


def _apply_cdfs(bins, mask, cdfs: torch.Tensor, max_val: float, tile_h: int,
                tile_w: int) -> torch.Tensor:
    """Device pass 2: bilinear interpolation between the 4 neighbour-tile
    CDFs at each pixel's bin (reference: autoscale.rs:307-343) and quantize
    (reference: :595-607); uint16 out. `bins` are pass 1's, which are the
    JAX package's pass-2 bins of the same normalized values."""
    rows, cols = mask.shape
    eq = clahe_lookup(bins, cdfs, cols, TILES_X, TILES_Y, tile_h,
                      tile_w).reshape(rows, cols)
    return trunc_sat_u16(torch.where(mask, torch.clamp(eq, 0.0, 1.0)
                                     * float(max_val), 0.0))


def clahe_equalize_db(db, mask, window: ScaleWindow,
                      bit_depth: BitDepth) -> torch.Tensor:
    """Full CLAHE path: normalize -> tile histograms -> (host) CDFs -> apply
    -> uint16 (reference: autoscale.rs:571-607)."""
    rows, cols = db.shape
    if rows == 0 or cols == 0:
        return torch.zeros(db.shape, dtype=torch.uint16, device=db.device)
    tile_h = -(-rows // TILES_Y)  # ceil div (reference: :235-236)
    tile_w = -(-cols // TILES_X)
    bins, hists = _normalize_and_tile_hists(db, mask, window, tile_h, tile_w)
    cdfs = _clip_redistribute_cdf(hists.cpu().numpy(), rows, cols, tile_h,
                                  tile_w)
    cdfs = torch.from_numpy(cdfs.astype(np.float32)).to(db.device)
    return _apply_cdfs(bins, mask, cdfs, bit_depth.max_val, tile_h, tile_w)
