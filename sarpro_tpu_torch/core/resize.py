"""Separable resampling coefficients and the plain axis-0 resampler (port of
the downsample pieces of sarpro_tpu/core/resize.py).

`_build_coeffs` is a copy of the JAX package's numpy builder (that module
imports jax, so it cannot be shared); a test holds the copy bit-equal to the
original. The coefficients follow Pillow's `precompute_coeffs` convolution
bounds and normalization.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .numerics import as_f32, u16_bits


def _lanczos3(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.sinc(x) * np.sinc(x / 3.0)  # np.sinc includes the pi factor
    return np.where(ax < 3.0, s, 0.0)


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution (a=-0.5, the GDAL/Catmull-Rom-style kernel)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, w1, np.where(ax < 2.0, w2, 0.0))


def _box(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


_FILTERS = {
    "lanczos": (_lanczos3, 3.0),
    "lanczos3": (_lanczos3, 3.0),
    "bilinear": (_bilinear, 1.0),
    "cubic": (_cubic, 2.0),
    "average": (_box, 0.5),
    "box": (_box, 0.5),
}


@functools.lru_cache(maxsize=64)
def _build_coeffs(in_size: int, out_size: int, filter_name: str):
    """Per-output-sample first source index and normalized f32 weights,
    ((out,) int32, (out, ksize) f32)."""
    fn, base_support = _FILTERS[filter_name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    if ksize < 128:
        # vectorized form of the per-row loop below: identical f64 values at
        # every tap, and since ksize < numpy's pairwise-summation blocksize
        # (128) the masked row sums add the same taps in the same order
        centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
        xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
        xmax = np.minimum((centers + support + 0.5).astype(np.int64),
                          in_size)
        idx = xmin[:, None] + np.arange(ksize, dtype=np.int64)[None, :]
        valid = idx < xmax[:, None]
        k = fn((idx - centers[:, None] + 0.5) / filterscale)
        k = np.where(valid, k, 0.0)
        ssum = k.sum(axis=1)
        k = np.where((ssum != 0.0)[:, None],
                     k / np.where(ssum == 0.0, 1.0, ssum)[:, None], k)
        return xmin.astype(np.int32), k.astype(np.float32)

    starts = np.zeros(out_size, np.int32)
    weights = np.zeros((out_size, ksize), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        k = fn((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        ssum = k.sum()
        if ssum != 0.0:
            k = k / ssum
        starts[i] = xmin
        weights[i, :n] = k
    return starts, weights.astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_coeffs(in_size: int, out_size: int, filter_name: str,
                  device: torch.device):
    """`_build_coeffs` as tensors on `device`, cached so the second band of
    a scene uploads nothing (an upload after queued work would wait for it)."""
    s, w = _build_coeffs(in_size, out_size, filter_name)
    return (torch.from_numpy(s).to(device, non_blocking=True),
            torch.from_numpy(w).to(device, non_blocking=True))


def _resample_axis0(x: torch.Tensor, starts: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Plain tap loop: out[i] = sum_k w[i, k] * x[clamp(starts[i] + k)], f32,
    taps added in order. The source may be u16 (DN) or f32; whole rows are
    gathered in the source dtype and cast after."""
    rows = x.shape[0]
    src = u16_bits(x)
    out = None
    for j in range(weights.shape[1]):
        idx = torch.clamp(starts.to(torch.int64) + j, 0, rows - 1)
        r = as_f32(src.index_select(0, idx).view(x.dtype))
        term = weights[:, j:j + 1] * r
        out = term if out is None else out + term
    return out

