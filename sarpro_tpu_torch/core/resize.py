"""Resampling and padding (port of sarpro_tpu/core/resize.py).

Reference behaviour (src/core/processing/resize.rs, padding.rs): long-side
target preserving aspect, warn and keep on upscale (:6-30); Lanczos3
separable convolution over the quantized u8/u16 image (:32-89); the
skip-if-already-at-target early return, optional square zero-padding, and
the (scale_x, scale_y, pad_left, pad_top) metadata (:91-236); center
padding into max_dim^2 (padding.rs:5-49).

`_build_coeffs` is a copy of the JAX package's numpy builder (Pillow's
`precompute_coeffs` convolution bounds and normalization); a test holds the
copy bit-equal to the original. Two tap loops apply the coefficients:
  * `_resample_axis0`, the plain version of the resample kernel
    (ops.band_resample_axis0) on the read's downsampling: each tap's
    product rounded, then added;
  * `_resample_axis0_fma`, exact mode's quantized resize: each tap fused
    into the running sum with one rounding, in the order XLA on the CPU
    gives the JAX package's tap loop and dot (`sarpro_tpu/core/resize.py:
    160-173`), so the port is bit-equal to it there.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..types import BitDepth
from .numerics import as_f32, as_u16, round_half_up_nonneg, u16_bits

logger = logging.getLogger("sarpro")


def calculate_resize_dimensions(
    original_cols: int, original_rows: int, target_size: int
) -> tuple[int, int]:
    """Long-side target preserving aspect ratio (reference: resize.rs:6-30)."""
    short_side = min(original_rows, original_cols)
    long_side = max(original_rows, original_cols)
    if target_size > long_side:
        logger.warning(
            "Target size %d is larger than original long side %d. "
            "Keeping original dimensions %dx%d",
            target_size, long_side, original_cols, original_rows,
        )
        return original_cols, original_rows
    scale_factor = target_size / long_side
    new_short_side = int(np.floor(short_side * scale_factor + 0.5))
    if original_cols > original_rows:
        return target_size, new_short_side
    return new_short_side, target_size


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


# the JAX package's tap loop takes at most this many taps; above it, a dot
_TAP_LOOP_MAX = 24


def _resample_axis0_fma(x: torch.Tensor, starts: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The tap loop in the rounding order XLA on the CPU gives the JAX
    package's quantized resize: each tap's f32 product fused into the
    running sum with one rounding (its FMA contraction). Up to
    _TAP_LOOP_MAX taps (its unrolled loop) the first sum is
    fl32(w0*x0 + fl32(w1*x1)); above (its dot) fl32(w1*x1 + fl32(w0*x0)).
    The products of f32 values are exact in f64, where each sum is formed
    before its one rounding to f32. `x` is f32; f32 out."""
    rows, taps = x.shape[0], weights.shape[1]
    first = out = None
    for j in range(taps):
        idx = torch.clamp(starts.to(torch.int64) + j, 0, rows - 1)
        prod = (weights[:, j:j + 1].to(torch.float64)
                * x.index_select(0, idx).to(torch.float64))
        if j == 0:
            first, out = prod, prod.to(torch.float32)
        elif j == 1 and taps <= _TAP_LOOP_MAX:
            out = (first + prod.to(torch.float32).to(torch.float64)).to(
                torch.float32)
        else:
            out = (prod + out.to(torch.float64)).to(torch.float32)
    return out


def _round_clamp(x: torch.Tensor, max_val: float) -> torch.Tensor:
    """Round half up and clamp to [0, max_val], held as f32."""
    return torch.clamp(round_half_up_nonneg(x), 0.0, max_val)


def _resize_quantized(data, original_cols, original_rows, target_cols,
                      target_rows, max_val: float) -> torch.Tensor:
    """Two-pass Lanczos3 with an integer intermediate: Pillow /
    fast_image_resize run the horizontal then the vertical convolution
    through an integer-typed buffer (the reference resizes U8/U16 images,
    resize.rs:39-51), so the columns pass is quantized before the rows
    pass. Returns the values as f32."""
    x = as_f32(data.reshape(original_rows, original_cols))
    dev = x.device
    if original_cols != target_cols:
        s, w = device_coeffs(original_cols, target_cols, "lanczos3", dev)
        x = _round_clamp(_resample_axis0_fma(x.T, s, w).T, max_val)
    if original_rows != target_rows:
        s, w = device_coeffs(original_rows, target_rows, "lanczos3", dev)
        x = _resample_axis0_fma(x, s, w)
    return _round_clamp(x, max_val)


def resize_u8_image(data, original_cols, original_rows, target_cols,
                    target_rows) -> torch.Tensor:
    """Lanczos3 resize of a u8 plane (reference: resize.rs:32-53)."""
    return _resize_quantized(data, original_cols, original_rows, target_cols,
                             target_rows, 255.0).to(torch.uint8)


def resize_u16_image(data, original_cols, original_rows, target_cols,
                     target_rows) -> torch.Tensor:
    """True-u16 Lanczos3 resize, no down-conversion (reference:
    resize.rs:55-89)."""
    return as_u16(_resize_quantized(data, original_cols, original_rows,
                                    target_cols, target_rows, 65535.0))


# --------------------------------------------------------------------------
# Padding (reference: src/core/processing/padding.rs:5-49)
# --------------------------------------------------------------------------
def add_padding_to_square(u8_data, u16_data, cols: int, rows: int,
                          bit_depth: BitDepth):
    """Center the image in a max_dim^2 zero canvas; returns (u8, u16)."""
    max_dim = max(cols, rows)
    pad_cols = (max_dim - cols) // 2
    pad_rows = (max_dim - rows) // 2
    logger.info(
        "Adding padding: cols=%d, rows=%d, pad_cols=%d, pad_rows=%d; final %dx%d",
        cols, rows, pad_cols, pad_rows, max_dim, max_dim,
    )

    def _pad(arr):
        a = u16_bits(arr.reshape(rows, cols))  # uint16 pads as its int16 bits
        out = torch.zeros((max_dim, max_dim), dtype=a.dtype, device=a.device)
        out[pad_rows:pad_rows + rows, pad_cols:pad_cols + cols] = a
        return out.view(arr.dtype)

    if bit_depth is BitDepth.U8:
        return _pad(u8_data), None
    if u16_data is None:
        raise ValueError("U16 data required for U16 bit depth")
    return None, _pad(u16_data)


# --------------------------------------------------------------------------
# Orchestration (reference: resize.rs:91-257)
# --------------------------------------------------------------------------
def resize_image_data_with_meta(
    u8_data,
    u16_data,
    original_cols: int,
    original_rows: int,
    target_size: int | None,
    bit_depth: BitDepth,
    pad: bool,
):
    """Resize + optional pad with geotransform metadata. Returns
    (final_cols, final_rows, u8, u16, scale_x, scale_y, pad_left, pad_top),
    the reference's tuple (resize.rs:99-110). Tensors in and out are 2-D
    (the u8 slot used for U8 depth, the u16 slot for U16), `None` in the
    inactive slot."""

    def _finish(u8, u16, cols, rows, sx, sy):
        if pad:
            p8, p16 = add_padding_to_square(u8, u16, cols, rows, bit_depth)
            final_dim = max(cols, rows)
            return (
                final_dim, final_dim, p8, p16, sx, sy,
                (final_dim - cols) // 2, (final_dim - rows) // 2,
            )
        return cols, rows, u8, u16, sx, sy, 0, 0

    if target_size is not None:
        logger.info("Resizing image to %d (long side)", target_size)
        current_long = max(original_cols, original_rows)
        if current_long == target_size:
            # already at requested long side: skip resize (reference: :115-145)
            return _finish(u8_data, u16_data, original_cols, original_rows, 1.0, 1.0)
        new_cols, new_rows = calculate_resize_dimensions(
            original_cols, original_rows, target_size
        )
        logger.info(
            "Original size: %dx%d, New size: %dx%d",
            original_cols, original_rows, new_cols, new_rows,
        )
        if bit_depth is BitDepth.U8:
            r8 = resize_u8_image(u8_data, original_cols, original_rows, new_cols, new_rows)
            r16 = None
        else:
            if u16_data is None:
                raise ValueError("U16 data required for U16 bit depth")
            r8 = None
            r16 = resize_u16_image(u16_data, original_cols, original_rows, new_cols, new_rows)
        scale_x = new_cols / original_cols
        scale_y = new_rows / original_rows
        return _finish(r8, r16, new_cols, new_rows, scale_x, scale_y)

    return _finish(u8_data, u16_data, original_cols, original_rows, 1.0, 1.0)


def resize_image_data(u8_data, u16_data, original_cols, original_rows,
                      target_size, bit_depth, pad):
    """Tuple-reduced variant (reference: resize.rs:238-257)."""
    c, r, u8v, u16v, _sx, _sy, _pl, _pt = resize_image_data_with_meta(
        u8_data, u16_data, original_cols, original_rows, target_size, bit_depth, pad
    )
    return c, r, u8v, u16v
