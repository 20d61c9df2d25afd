"""The fused synthetic-RGB program on the GPU: DN rasters -> Tamed u8 bands
-> suppressed synRGB -> YCbCr -> quantized JPEG DCT blocks (port of the
slice of sarpro_tpu/core/fused.py that the Tamed synRGB JPEG runs).

Like the JAX program, the band and combine stages never wait for the host:
no `.item()`, no boolean-mask indexing, no `nonzero`. Data-dependent scalars
(percentiles, windows, the water floor) stay 0-dim device tensors, and the
water floor picks its table set on the device. The only device-to-host copy
of the slice is the final coefficient blocks.

Numerics: f32 throughout, the same op sequence as the JAX program. f32 log
and pow differ by an ulp between XLA and PyTorch on a few percent of
values, so a band may differ by 1 on rare pixels where a bin or a trunc
flips.

Not ported yet (each raises NotImplementedError): strategies other than
Tamed, default-mode (non-suppressed) synRGB, the bgr layout, row sharding.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sarpro_tpu.types import AutoscaleStrategy

from ..ops import band_resample_axis0, histogram, synrgb_lookup
from .synthetic_rgb import FLOOR_MAX, FLOOR_MIN, suppressed_table_sets

# sarpro_tpu/core/pipeline.py:32-35 and core/stats.py:24
NUM_BINS = 4096
DB_FLOOR = 1e-10  # magnitude floor (reference: pipeline.rs:19)
DB_VALID_THRESHOLD = -50.0  # validity threshold (reference: pipeline.rs:22)

_PCT_ORDER = ("p01", "p02", "p05", "p10", "p25", "median", "p75", "p90",
              "p95", "p98", "p99")
_PCT_VALUES = np.array([0.01, 0.02, 0.05, 0.10, 0.25, 0.5, 0.75, 0.90,
                        0.95, 0.98, 0.99], np.float32)
_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


@functools.lru_cache(maxsize=8)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """Small constant tables, uploaded once per device."""
    if name == "pct":
        arr = _PCT_VALUES
    elif name == "dct":
        arr = _dct_operator()
    else:
        raise KeyError(name)
    return torch.from_numpy(arr).to(device, non_blocking=True)


def _db_mask(x: torch.Tensor):
    v = torch.clamp_min(x.to(torch.float32), DB_FLOOR)
    db = 10.0 * (torch.log(v) * _INV_LN10)
    return db, db > DB_VALID_THRESHOLD


def _stats(db: torch.Tensor, mask: torch.Tensor):
    """count/min/max + 4096-bin histogram + percentiles, all on the device."""
    count = mask.sum(dtype=torch.int32)
    inf = float("inf")
    mn = torch.where(mask, db, inf).amin()
    mx = torch.where(mask, db, -inf).amax()
    mn = torch.where(count > 0, mn, 0.0)
    mx = torch.where(count > 0, mx, 0.0)
    hist = histogram(_db_bin_index(db, mask, mn, mx).reshape(-1), NUM_BINS)
    return _stats_finalize(hist, count, mn, mx)


def _db_bin_index(db, mask, mn, mx):
    """dB value -> 4096-bin index; masked pixels carry the overflow index."""
    span = mx - mn
    inv = torch.where(span > 0, 1.0 / span, 0.0)
    t = torch.clamp((db - mn) * inv, 0.0, 1.0)
    idx = torch.clamp_max((t * NUM_BINS).to(torch.int32), NUM_BINS - 1)
    return torch.where(mask, idx, NUM_BINS).to(torch.int32)


def _tamed_quantize_u8(db, mask, low, high):
    """Band-specific tamed window straight to u8 (autoscale.rs:710-742)."""
    rng = torch.clamp_min(high - low, 1.0)
    q = torch.clamp(torch.trunc(torch.clamp(
        (torch.clamp(db, low, high) - low) / rng * 255.0, 0, 255)), 0, 255)
    return torch.where(mask, q, 0.0)


def _stats_finalize(hist, count, mn, mx):
    """Histogram -> moments + percentiles (mean/std from bin centres, as the
    JAX program derives them)."""
    device = hist.device
    span = mx - mn
    n = torch.clamp_min(count.to(torch.float32), 1.0)
    hf = hist[:NUM_BINS].to(torch.float32)
    centers = torch.arange(NUM_BINS, dtype=torch.float32, device=device) + 0.5
    bw_m = span / NUM_BINS
    m1 = torch.sum(hf * centers) / n
    m2 = torch.sum(hf * centers * centers) / n
    mean = mn + m1 * bw_m
    var = torch.clamp_min(m2 - m1 * m1, 0.0) * bw_m * bw_m
    std = torch.where(count > 1, torch.sqrt(var), 0.0)

    # percentile inversion (reference: autoscale.rs:120-140, vectorized)
    pct = _const("pct", device)
    cum = torch.cumsum(hist, 0, dtype=torch.int32)
    targets = torch.minimum(torch.floor(pct * n).to(torch.int32), count - 1)
    b = torch.searchsorted(cum, targets, right=True)
    b = torch.clamp_max(b, NUM_BINS - 1)
    h = hist[b]
    cum_before = cum[b] - h
    within = torch.clamp_min(targets - cum_before, 0)
    frac = torch.where(h > 0, within.to(torch.float32) / h.to(torch.float32),
                       0.0)
    bw = span / NUM_BINS
    pcts = mn + (b.to(torch.float32) + frac) * bw
    # degenerate all-equal case: low pcts = min, high = max
    lowhigh = torch.where(pct <= 0.5, mn, mx)
    pcts = torch.where(span <= 0, lowhigh, pcts)

    d = dict(zip(_PCT_ORDER, pcts.unbind()))
    d.update(count=count, min=mn, max=mx, mean=mean, std=std)
    return d


def _resample_dn(x: torch.Tensor, out_rows: int, out_cols: int,
                 filter_name: str) -> torch.Tensor:
    """Downsample-on-read, on the device. The row pass reads the u16 DN
    directly; the column pass runs the same kernel on a transposed copy."""
    in_rows, in_cols = x.shape
    if in_rows != out_rows:
        x = band_resample_axis0(x, in_rows, out_rows, filter_name)
    if in_cols != out_cols:
        x = band_resample_axis0(x.T.contiguous(), in_cols, out_cols,
                                filter_name).T
    return x.to(torch.float32).contiguous()


def _band_u8(dn: torch.Tensor, strategy: AutoscaleStrategy,
             tamed_copol: bool | None) -> torch.Tensor:
    """One band DN -> final u8: the Tamed synRGB band path (save.rs:324-328)."""
    if tamed_copol is None or strategy is not AutoscaleStrategy.TAMED:
        raise NotImplementedError(
            f"autoscale {strategy.value!r} is not ported yet; the port runs "
            "tamed only (ROADMAP queue 1, CLAHE and other strategies)")
    db, mask = _db_mask(dn)
    s = _stats(db, mask)
    # band-specific tamed window (autoscale.rs:710-742)
    low = torch.minimum(s["p02"], s["p05"]) if tamed_copol else s["p05"]
    high = s["p99"]
    return _tamed_quantize_u8(db, mask, low, high).to(torch.uint8)


def _suppressed_floor(hist: torch.Tensor, total_pixels: int) -> torch.Tensor:
    """Combined-histogram water floor (reference: synthetic_rgb.rs:96-110),
    as an int32 device scalar in [3, 40]."""
    target = np.floor(np.float32(total_pixels) * np.float32(0.05)
                      + np.float32(0.5))
    reached = torch.cumsum(hist, 0, dtype=torch.int32).to(torch.float32) >= float(target)
    first = torch.argmax(reached.to(torch.uint8))
    floor_value = torch.where(reached.any(), first, 0)
    return torch.clamp_max(floor_value + FLOOR_MIN, FLOOR_MAX).to(torch.int32)


def _synrgb_suppressed(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Suppressed composition with the data-dependent floor computed on the
    device (reference: synthetic_rgb.rs:88-178)."""
    f1, f2 = b1.reshape(-1), b2.reshape(-1)
    hist = histogram((f1, f2), 256)
    floor_c = _suppressed_floor(hist, b1.numel() + b2.numel())
    rgb = synrgb_lookup(f1, f2, suppressed_table_sets(b1.device),
                        set_index=floor_c - FLOOR_MIN, water_floor=floor_c)
    return rgb.reshape(b1.shape + (3,))


def _pad_square(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    m = max(rows, cols)
    pr = (m - rows) // 2
    pc = (m - cols) // 2
    pad = (pc, m - cols - pc, pr, m - rows - pr)
    if x.dim() == 3:
        pad = (0, 0) + pad
    return F.pad(x, pad)


def _plan_read_dims(in_rows: int, in_cols: int, target_size: int | None,
                    resample_alg: str | None = None):
    """Downsample-on-read sizing + filter choice (sentinel1.rs:1084-1102):
    user-chosen algorithm wins; otherwise Average for >=4x reduction,
    Lanczos for mild downscale."""
    if target_size is None:
        return in_rows, in_cols, None
    long_side = max(in_rows, in_cols)
    scale = min(target_size / long_side, 1.0)
    out_rows = max(int(np.floor(in_rows * scale + 0.5)), 1)
    out_cols = max(int(np.floor(in_cols * scale + 0.5)), 1)
    reduction = max(long_side / target_size, 1.0)
    filt = resample_alg or ("average" if reduction >= 4.0 else "lanczos")
    return out_rows, out_cols, filt


def synrgb_pipeline(vv_dn, vh_dn,
                    strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
                    target_size: int | None = 2048, pad: bool = False,
                    suppressed: bool | None = None,
                    resample_alg: str | None = None,
                    channel_order: str = "rgb"):
    """Dual-pol DN rasters -> synthetic RGB in `channel_order` (the JAX
    program's flagship, run as eager kernels on the tensors' device)."""
    b1 = _synrgb_band(vv_dn, strategy, True, target_size, pad, resample_alg)
    b2 = _synrgb_band(vh_dn, strategy, False, target_size, pad, resample_alg)
    return _synrgb_combine(b1, b2, strategy, suppressed, channel_order)


def _synrgb_band(dn, strategy, copol: bool, target_size, pad: bool,
                 resample_alg=None):
    """One band: resample -> dB/stats/autoscale -> u8 (+ pad)."""
    in_rows, in_cols = dn.shape
    rows, cols, filt = _plan_read_dims(in_rows, in_cols, target_size,
                                       resample_alg)
    x = (_resample_dn(dn, rows, cols, filt) if filt is not None
         else dn.to(torch.float32))
    tamed = strategy is AutoscaleStrategy.TAMED
    b = _band_u8(x, strategy, copol if tamed else None)
    if pad:
        # padding precedes composition (save.rs:332-361): the pad zeros take
        # part in the suppressed mode's combined histogram
        b = _pad_square(b, rows, cols)
    return b


def _dct_operator() -> np.ndarray:
    """The per-block 2-D FDCT as one (64, 64) f32 map in the native encoder's
    transposed layout: out[i*8+j] = sum_{k,l} T[i,k] T[j,l] blk[l,k], with
    the input flattened column-major (index k*8 + l)."""
    u = np.arange(8, dtype=np.float64)
    s = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    t = s[:, None] * np.cos((2.0 * u[None, :] + 1.0) * u[:, None] * np.pi / 16.0)
    return np.einsum("ik,jl->klij", t, t).reshape(64, 64).astype(np.float32)


def jpeg_dct_planes(planes_u8: torch.Tensor) -> torch.Tensor:
    """u8 planes (c, rows, cols) -> quantized q100 JPEG DCT blocks
    (c, ceil(rows/8), ceil(cols/8), 8, 8) int16: level shift, 8x8 FDCT,
    q100 quantize (round half to even, like lrintf), each block transposed
    as the native encoder's fdct8x8 and zigzag table expect."""
    c, rows, cols = planes_u8.shape
    nbh, nbw = -(-rows // 8), -(-cols // 8)
    x = planes_u8.to(torch.float32) - 128.0
    if (nbh * 8, nbw * 8) != (rows, cols):
        # the host encoder edge-replicates partial border blocks
        x = F.pad(x[None], (0, nbw * 8 - cols, 0, nbh * 8 - rows),
                  mode="replicate")[0]
    # (c, nbh, nbw, col k, row l): each block flattened column-major
    v = x.reshape(c, nbh, 8, nbw, 8).permute(0, 1, 3, 4, 2).reshape(
        c, nbh, nbw, 64)
    # the f32 product runs with TF32 off: TF32's 10-bit mantissa would
    # break the +-1 coefficient contract
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = torch.matmul(v, _const("dct", planes_u8.device))
    out = torch.clamp(torch.round(out), -32767.0, 32767.0)
    return out.to(torch.int16).reshape(c, nbh, nbw, 8, 8)


def ycbcr_planes(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Interleaved RGB u8 -> planar full-range JFIF YCbCr u8."""
    r = rgb_u8[..., 0].to(torch.float32)
    g = rgb_u8[..., 1].to(torch.float32)
    b = rgb_u8[..., 2].to(torch.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    planes = torch.stack([y, cb, cr])
    return torch.clamp(torch.round(planes), 0.0, 255.0).to(torch.uint8)


def _synrgb_combine(b1, b2, strategy, suppressed, channel_order: str):
    """Dual-band u8 -> composed synRGB in the writer's channel order."""
    if suppressed is None:
        suppressed = strategy in (AutoscaleStrategy.TAMED,
                                  AutoscaleStrategy.CLAHE)
    if not suppressed:
        raise NotImplementedError(
            "default-mode synRGB is not ported yet (ROADMAP queue 1, "
            "other strategies and default synRGB)")
    out = _synrgb_suppressed(b1, b2)
    if channel_order == "rgb":
        return out
    if channel_order in ("ycbcr", "dct"):
        planes = ycbcr_planes(out)
        return jpeg_dct_planes(planes) if channel_order == "dct" else planes
    raise NotImplementedError(f"channel order {channel_order!r} is not "
                              "ported (rgb, ycbcr, dct)")


# per-stage entry points of the overlapped file path: band 1's stage is
# queued on the device while band 2 is still being read from disk
synrgb_band_stage = _synrgb_band
synrgb_combine_stage = _synrgb_combine
