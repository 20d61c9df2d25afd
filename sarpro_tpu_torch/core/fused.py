"""The fused programs on the GPU (port of sarpro_tpu/core/fused.py): the
synthetic-RGB program, DN rasters -> u8 bands of any strategy -> suppressed
or default synRGB -> YCbCr -> quantized JPEG DCT blocks, and the grayscale
program, one DN raster -> u8 or u16 band (or its JPEG DCT blocks).

Like the JAX program, the band and combine stages never wait for the host:
no `.item()`, no boolean-mask indexing, no `nonzero`. Data-dependent scalars
(percentiles, windows, the water floor, the u16-to-u8 range) stay 0-dim
device tensors, and the water floor picks its table set on the device. The
CLAHE tile geometry comes from the static shape. The only device-to-host
copy of the slice is the final coefficient blocks.

Numerics: f32 throughout, the same op sequence as the JAX program. f32 log
and pow differ by an ulp between XLA and PyTorch on a few percent of
values, and XLA on the CPU contracts the CLAHE blend into FMAs, so a Tamed
band may differ by 1 on rare pixels where a bin or a trunc flips, and a
CLAHE band by up to 4 where a percentile, and so the CLAHE window, moves
by one histogram bin (ROADMAP queue 3). `_quantize`'s f32 `pow` (gamma 0.8,
0.9, 1.1) moves a level by 1 on a few pixels in 1e5; gamma 1 is exact.

Row sharding (the JAX program's `row_axis`) is parallel/sharded.py: it runs
these helpers on each row block and reduces between them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import (
    band_resample_axis0,
    clahe_lookup,
    histogram,
    synrgb_lookup,
    tile_histogram,
)
from ..types import AutoscaleStrategy, BitDepth
from .clahe import CLAHE_BINS, CLIP_LIMIT, TILES_X, TILES_Y, _clahe_bins
from .numerics import as_f32, as_u16, log_f32, pow_f32, round_half_up_nonneg
from .synthetic_rgb import (
    FLOOR_MAX,
    FLOOR_MIN,
    suppressed_table_sets,
)
from .synthetic_rgb import create_synthetic_rgb as _synrgb_default

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
    v = torch.clamp_min(as_f32(x), DB_FLOOR)
    db = 10.0 * (log_f32(v) * _INV_LN10)
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


def _clahe_norm(db, mask, low, high):
    """Masked [0,1] normalization ahead of CLAHE binning."""
    rng = torch.clamp_min(high - low, 1.0)
    return torch.where(mask, (torch.clamp(db, low, high) - low) / rng, 0.0)


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


def _window(s, strategy: AutoscaleStrategy):
    """Strategy windows as scalar arithmetic on 0-dim device tensors
    (reference: autoscale.rs:404-424 standard, :491-562 advanced); returns
    (low, high, gamma)."""
    iqr = s["p75"] - s["p25"]
    one = torch.ones_like(iqr)
    if strategy is AutoscaleStrategy.STANDARD:
        dr = s["max"] - s["min"]
        rng_med = torch.clamp_min(dr * 0.8, 20.0)
        low1, high1, g1 = (s["median"] - rng_med / 2,
                           s["median"] + rng_med / 2, 1.1)
        low2, high2, g2 = s["p25"] - 2.5 * iqr, s["p75"] + 2.5 * iqr, 1.0
        low3 = torch.maximum(s["p02"], s["min"] + 0.02 * dr)
        high3 = torch.minimum(s["p98"], s["max"] - 0.02 * dr)
        g3 = 0.9
        low4, high4, g4 = s["p02"], s["p98"], 1.0
        c1 = dr < 15.0
        c2 = iqr < 5.0
        c3 = dr > 40.0
        low = torch.where(c1, low1, torch.where(c2, low2,
                                                torch.where(c3, low3, low4)))
        high = torch.where(c1, high1, torch.where(c2, high2,
                                                  torch.where(c3, high3, high4)))
        gamma = torch.where(c1, g1 * one, torch.where(
            c2, g2 * one, torch.where(c3, g3 * one, g4 * one)))
        low = torch.maximum(low, s["min"])
        high = torch.minimum(high, s["max"])
        return low, high, gamma
    if strategy is AutoscaleStrategy.ROBUST:
        thr = 2.5 * iqr
        low = torch.maximum(torch.maximum(s["p25"] - thr, s["p01"]), s["min"])
        high = torch.minimum(torch.minimum(s["p75"] + thr, s["p99"]), s["max"])
        return low, high, one
    if strategy is AutoscaleStrategy.ADAPTIVE:
        skew = (s["mean"] - s["median"]) / torch.clamp_min(torch.abs(s["std"]),
                                                           1.0)
        tail = (s["p99"] - s["p95"]) / torch.clamp_min(s["p95"] - s["p75"], 1.0)
        c_skew = torch.abs(skew) > 0.5
        c_pos = skew > 0.0
        c_tail = tail > 2.0
        low = torch.where(
            c_skew, torch.where(c_pos, s["p02"], s["p05"]),
            torch.where(c_tail, s["p10"], s["p05"]))
        high = torch.where(
            c_skew, torch.where(c_pos, s["p98"], s["p95"]),
            torch.where(c_tail, s["p90"], s["p95"]))
        gamma = torch.where(
            c_skew, torch.where(c_pos, 0.9 * one, 1.1 * one),
            torch.where(c_tail, 0.8 * one, one))
        return low, high, gamma
    if strategy in (AutoscaleStrategy.EQUALIZED, AutoscaleStrategy.CLAHE):
        return s["p01"], s["p99"], one
    if strategy is AutoscaleStrategy.TAMED:
        return s["p25"], s["p99"], one
    return s["p05"], s["p95"], one  # default


def _quantize(db, mask, low, high, gamma, max_val: float):
    """Window, gamma and quantize to [0, max_val]; the u16 values are held
    as f32. Gamma 1 skips the `pow`, so that case stays exact."""
    rng = torch.clamp_min(high - low, 1.0)
    norm = (torch.clamp(db, low, high) - low) / rng
    powed = torch.where(gamma == 1.0, norm, pow_f32(norm, gamma))
    q = torch.clamp(torch.trunc(torch.clamp(powed * max_val, 0.0, max_val)),
                    0, 65535)
    return torch.where(mask, q, 0.0)


def _scale_u16_to_u8(q):
    """Min-max stretch of the u16 band values to u8 (the range stays on the
    device)."""
    return _u8_stretch(q, q.amin().to(torch.float32),
                       q.amax().to(torch.float32))


def _u8_stretch(q, mn, mx):
    """u8 codes of u16 values `q` stretched over the band's range [mn, mx]
    (0-dim f32 tensors): the one arithmetic of this program's u16-to-u8
    stretch and of every streamed pass that takes one (core/streamed). The
    scale is a true division: PyTorch's `255.0 / t` multiplies by the
    rounded reciprocal, off by an ulp for a quarter of ranges."""
    scale = torch.where(mx > mn, torch.full_like(mx, 255.0) / (mx - mn), 1.0)
    val = round_half_up_nonneg((q.to(torch.float32) - mn) * scale)
    return torch.clamp(val, 0.0, 255.0).to(torch.uint8)


def _clahe_thresholds(rows: int, cols: int, tile_h: int, tile_w: int,
                      device) -> torch.Tensor:
    """(tiles, 1) f32 clip thresholds, CLIP_LIMIT x each tile's mean bin
    count (at least 1), built on the device from the static tile extents."""
    ty = torch.arange(TILES_Y, device=device)
    tx = torch.arange(TILES_X, device=device)
    th = torch.clamp_min(torch.clamp_max((ty + 1) * tile_h, rows)
                         - ty * tile_h, 0)
    tw = torch.clamp_min(torch.clamp_max((tx + 1) * tile_w, cols)
                         - tx * tile_w, 0)
    tile_pixels = (th[:, None] * tw[None, :]).reshape(-1).to(torch.float32)
    return torch.clamp_min(CLIP_LIMIT * tile_pixels / CLAHE_BINS, 1.0)[:, None]


def _clahe_cdfs(hists, rows_global: int, cols: int, tile_h: int, tile_w: int):
    """Tile histograms (flat int counts) -> clipped, redistributed,
    normalised CDFs (reference: autoscale.rs:268-305), (tiles, bins) f32."""
    h = hists.reshape(TILES_Y * TILES_X, CLAHE_BINS).to(torch.float32)
    thr = _clahe_thresholds(rows_global, cols, tile_h, tile_w, h.device)
    over = h > thr
    excess = torch.sum(torch.where(over, h - thr, 0.0), dim=-1, keepdim=True)
    h = torch.where(over, torch.trunc(thr), h)
    add = torch.floor(excess / CLAHE_BINS)
    h = torch.trunc(h + add)
    rem = torch.floor(excess - add * CLAHE_BINS + 0.5)
    bin_idx = torch.arange(CLAHE_BINS, dtype=torch.float32,
                           device=h.device)[None, :]
    h = h + (bin_idx < rem).to(torch.float32)
    total = torch.clamp_min(torch.sum(h, dim=-1, keepdim=True), 1.0)
    return torch.clamp(torch.cumsum(h, dim=-1) / total, 0.0, 1.0)


def _clahe(db, mask, low, high, max_val: float, rows: int, cols: int):
    """CLAHE on the device: window-normalise, bin, count per tile
    (tile_histogram), clip and redistribute into CDFs, blend the 4
    neighbouring tile CDFs per pixel (clahe_lookup), quantize. Returns the
    u16 band values, held as f32 (PyTorch's uint16 has few kernels)."""
    tile_h = -(-rows // TILES_Y)
    tile_w = -(-cols // TILES_X)
    norm = _clahe_norm(db, mask, low, high)
    bin_flat = _clahe_bins(norm, mask).reshape(-1)
    hists = tile_histogram(bin_flat, cols, TILES_X, TILES_Y, tile_h, tile_w,
                           n_bins=CLAHE_BINS)
    cdfs = _clahe_cdfs(hists, rows, cols, tile_h, tile_w)
    eq = clahe_lookup(bin_flat, cdfs, cols, TILES_X, TILES_Y, tile_h,
                      tile_w).reshape(rows, cols)
    return _clahe_quantize(eq, mask, max_val)


def _clahe_quantize(eq, mask, max_val: float):
    """Blended CDF values -> the u16 band values (as f32), masked pixels 0
    (shared with the streamed passes, core/streamed)."""
    return torch.where(mask, torch.trunc(torch.clamp(eq, 0.0, 1.0) * max_val),
                       0.0)


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
    return as_f32(x).contiguous()


def _autoscale(db, mask, s, strategy: AutoscaleStrategy, max_val: float,
               rows: int, cols: int):
    """The strategy's window, then CLAHE or `_quantize` to [0, max_val]
    (the u16 values, held as f32)."""
    low, high, gamma = _window(s, strategy)
    if strategy is AutoscaleStrategy.CLAHE:
        return _clahe(db, mask, low, high, max_val, rows, cols)
    return _quantize(db, mask, low, high, gamma, max_val)


def _band_u8(dn: torch.Tensor, strategy: AutoscaleStrategy,
             tamed_copol: bool | None) -> torch.Tensor:
    """One band DN -> final u8: the strategy dispatch of pipeline.rs:42-67
    plus the Tamed synRGB band path of save.rs:324-328."""
    db, mask = _db_mask(dn)
    s = _stats(db, mask)
    if tamed_copol is not None and strategy is AutoscaleStrategy.TAMED:
        # band-specific tamed window (autoscale.rs:710-742) straight to u8
        low = torch.minimum(s["p02"], s["p05"]) if tamed_copol else s["p05"]
        high = s["p99"]
        return _tamed_quantize_u8(db, mask, low, high).to(torch.uint8)
    return _scale_u16_to_u8(_autoscale(db, mask, s, strategy, 255.0,
                                       *dn.shape))


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
         else as_f32(dn))
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
    if channel_order not in ("rgb", "bgr", "ycbcr", "dct"):
        raise ValueError(f"unknown channel order {channel_order!r} (rgb, "
                         "bgr, ycbcr, dct)")
    out = (_synrgb_suppressed(b1, b2) if suppressed
           else _synrgb_default(b1, b2))
    return _in_channel_order(out, channel_order)


def _in_channel_order(rgb: torch.Tensor, channel_order: str) -> torch.Tensor:
    """Interleaved RGB u8 -> the writer's channel order: rgb, bgr, planar
    YCbCr, or its quantized JPEG DCT blocks."""
    if channel_order == "bgr":
        return torch.flip(rgb, (-1,))
    if channel_order in ("ycbcr", "dct"):
        planes = ycbcr_planes(rgb)
        return jpeg_dct_planes(planes) if channel_order == "dct" else planes
    return rgb


# per-stage entry points of the overlapped file path: band 1's stage is
# queued on the device while band 2 is still being read from disk
synrgb_band_stage = _synrgb_band
synrgb_combine_stage = _synrgb_combine


def grayscale_pipeline(dn, strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
                       bit_depth: BitDepth = BitDepth.U8,
                       target_size: int | None = None, pad: bool = False,
                       resample_alg: str | None = None,
                       jpeg_dct: bool = False) -> torch.Tensor:
    """One DN raster -> u8 or u16 grayscale band: resample (unless already
    at size), dB, stats, the strategy's window, CLAHE or `_quantize` at the
    bit depth's range, the u16-to-u8 stretch for u8, pad. With `jpeg_dct`
    (u8 only) the band's quantized q100 JPEG DCT blocks (bh, bw, 8, 8)
    int16 come out instead, for the entropy-only host encoder."""
    if jpeg_dct and bit_depth is not BitDepth.U8:
        raise ValueError("the JPEG front end takes u8 bands only")
    rows, cols, filt = _plan_read_dims(*dn.shape, target_size, resample_alg)
    x = (_resample_dn(dn, rows, cols, filt) if filt is not None
         else as_f32(dn))
    db, mask = _db_mask(x)
    s = _stats(db, mask)
    q16 = _autoscale(db, mask, s, strategy, float(bit_depth.max_val), rows,
                     cols)
    out = _scale_u16_to_u8(q16) if bit_depth is BitDepth.U8 else q16
    if pad:
        out = _pad_square(out, rows, cols)
    if jpeg_dct:
        return jpeg_dct_planes(out[None])[0]
    return out if bit_depth is BitDepth.U8 else as_u16(out)
