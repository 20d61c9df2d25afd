"""Sharded programs: scene-batched, row-sharded processing over a `Mesh`
(port of sarpro_tpu/parallel/sharded.py).

Scenes of a (scenes, rows, cols) batch spread over the mesh's scene axis,
in contiguous groups; each scene's rows split over its group's row devices.

Full-resolution configs (no resample, no pad) are the JAX package's
`shard_map` path: every device runs the fused program's steps on its own
row block (core/fused.py helpers and the kernel wrappers), and the JAX
program's collectives become small tensors reduced on the scene's lead
device and copied back to each block's device:

  1. dB, the valid count and the raw min / max (+-inf where a block has no
     valid pixel), summed and folded, then the empty-band rule;
  2. the 4096-bin histogram with the global range, summed, then
     `_stats_finalize` and the strategy's window on the lead;
  3. CLAHE: the tile histograms with each block's global `row_offset`,
     summed, then `_clahe_cdfs` on the lead and the lookup with the same
     offset (no halo: a tile may straddle blocks);
  4. the u16 -> u8 stretch with the folded min / max;
  5. suppressed synRGB: each block's 256-bin histogram of both bands,
     summed, the water floor over the whole scene, the compose per block;
  6. the blocks gathered in order on the lead device.

Every reduction is an integer sum or a min / max, which combine exactly in
any order, and Adaptive's mean and std come from the summed histogram, so
each output equals the unsharded program's bit for bit at any shard count.

Resample and pad configs (a target size, or a square pad): the JAX package
runs these through GSPMD with XLA kernels. Here only the axis-0 resample of
the full DN splits, by blocks of output rows: each block takes its slice of
the resample coefficients and the band of source rows its taps read
(`starts` rebased) on its device, where the resample kernel runs unchanged.
The blocks are gathered on the scene's lead device, and the rest of the
band stage (the column pass, statistics, strategy, pad, compose) runs there
unsharded.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import fused
from ..core.clahe import CLAHE_BINS, TILES_X, TILES_Y, _clahe_bins
from ..core.numerics import as_f32, as_u16
from ..core.resize import _build_coeffs
from ..core.synthetic_rgb import FLOOR_MIN, suppressed_table_sets
from ..core.synthetic_rgb import create_synthetic_rgb as _synrgb_default
from ..ops import clahe_lookup, histogram, synrgb_lookup, tile_histogram
from ..ops.resample_kernel import band_resample_axis0, resample_rows
from ..types import AutoscaleStrategy, BitDepth
from .mesh import Mesh, combine
from .mesh import to_each as _to_each


def _sum(parts, lead):
    return combine(parts, torch.add, lead)


def _scene_devices(n_scenes: int, mesh: Mesh) -> list:
    """Each scene's row devices: scenes in contiguous groups over the scene
    axis, as a P('scene') sharding lays them out."""
    s = mesh.shape["scene"]
    return [mesh.row_devices(i * s // n_scenes) for i in range(n_scenes)]


def _row_blocks(dn, devices) -> list:
    """A scene's rows split into len(devices) equal blocks, each on its
    device."""
    rows = dn.shape[0]
    n = len(devices)
    if rows % n:
        raise ValueError(f"{rows} rows do not split evenly over {n} row "
                         "devices")
    local = rows // n
    return [dn[j * local:(j + 1) * local].to(d)
            for j, d in enumerate(devices)]


# ---------------------------------------------------------------------------
# Full resolution: the fused program's steps on each row block
# ---------------------------------------------------------------------------
def _blocks_stats(xs, devices):
    """Step 1-2: each block's (dB, mask), and the scene's statistics dict
    on the lead device."""
    lead = devices[0]
    inf = float("inf")
    dbm = [fused._db_mask(x) for x in xs]
    count = _sum([m.sum(dtype=torch.int32) for _, m in dbm], lead)
    mn = combine([torch.where(m, db, inf).amin() for db, m in dbm],
               torch.minimum, lead)
    mx = combine([torch.where(m, db, -inf).amax() for db, m in dbm],
               torch.maximum, lead)
    mn = torch.where(count > 0, mn, 0.0)
    mx = torch.where(count > 0, mx, 0.0)
    mns, mxs = _to_each(mn, devices), _to_each(mx, devices)
    hist = _sum([histogram(fused._db_bin_index(db, m, a, b).reshape(-1),
                           fused.NUM_BINS)
                 for (db, m), a, b in zip(dbm, mns, mxs)], lead)
    return dbm, fused._stats_finalize(hist, count, mn, mx)


def _blocks_q16(dbm, s, strategy, max_val: float, cols: int, devices):
    """Step 2-3: each block's u16 band values (as f32) under the scene's
    window: CLAHE with the tile histograms summed, else `_quantize`."""
    lead = devices[0]
    low, high, gamma = fused._window(s, strategy)
    lows, highs = _to_each(low, devices), _to_each(high, devices)
    if strategy is not AutoscaleStrategy.CLAHE:
        gammas = _to_each(gamma, devices)
        return [fused._quantize(db, m, lo, hi, g, max_val)
                for (db, m), lo, hi, g in zip(dbm, lows, highs, gammas)]
    rows_g = sum(m.shape[0] for _, m in dbm)
    tile_h, tile_w = -(-rows_g // TILES_Y), -(-cols // TILES_X)
    offsets = np.cumsum([0] + [m.shape[0] for _, m in dbm])[:-1].tolist()
    bins = [_clahe_bins(fused._clahe_norm(db, m, lo, hi), m).reshape(-1)
            for (db, m), lo, hi in zip(dbm, lows, highs)]
    hists = _sum([tile_histogram(b, cols, TILES_X, TILES_Y, tile_h, tile_w,
                                 row_offset=off, n_bins=CLAHE_BINS)
                  for b, off in zip(bins, offsets)], lead)
    cdfs = fused._clahe_cdfs(hists, rows_g, cols, tile_h, tile_w)
    return [fused._clahe_quantize(
        clahe_lookup(b, c, cols, TILES_X, TILES_Y, tile_h, tile_w,
                     row_offset=off).view(m.shape), m, max_val)
        for b, c, off, (_, m) in zip(bins, _to_each(cdfs, devices), offsets,
                                     dbm)]


def _blocks_u8(qs, devices):
    """Step 4: the u16 -> u8 stretch with the scene's folded range."""
    lead = devices[0]
    mn = combine([q.amin().to(torch.float32) for q in qs], torch.minimum, lead)
    mx = combine([q.amax().to(torch.float32) for q in qs], torch.maximum, lead)
    return [fused._u8_stretch(q, a, b) for q, a, b in
            zip(qs, _to_each(mn, devices), _to_each(mx, devices))]


def _band_blocks(dn, strategy, tamed_copol, bit_depth: BitDepth, devices):
    """One full-resolution band split over `devices`: the u8 blocks (u16
    blocks, uint16, for a u16 band) of `fused._band_u8` /
    `fused.grayscale_pipeline`."""
    xs = [as_f32(x) for x in _row_blocks(dn, devices)]
    dbm, s = _blocks_stats(xs, devices)
    if tamed_copol is not None and strategy is AutoscaleStrategy.TAMED:
        low = torch.minimum(s["p02"], s["p05"]) if tamed_copol else s["p05"]
        return [fused._tamed_quantize_u8(db, m, lo, hi).to(torch.uint8)
                for (db, m), lo, hi in zip(dbm, _to_each(low, devices),
                                           _to_each(s["p99"], devices))]
    qs = _blocks_q16(dbm, s, strategy, float(bit_depth.max_val),
                     dn.shape[1], devices)
    if bit_depth is BitDepth.U16:
        return [as_u16(q) for q in qs]
    return _blocks_u8(qs, devices)


def _synrgb_blocks(b1s, b2s, strategy, suppressed, devices):
    """Step 5: each block's interleaved RGB."""
    if suppressed is None:
        suppressed = strategy in (AutoscaleStrategy.TAMED,
                                  AutoscaleStrategy.CLAHE)
    if not suppressed:
        return [_synrgb_default(a, b) for a, b in zip(b1s, b2s)]
    lead = devices[0]
    hist = _sum([histogram((a.reshape(-1), b.reshape(-1)), 256)
                 for a, b in zip(b1s, b2s)], lead)
    floor_c = fused._suppressed_floor(
        hist, sum(a.numel() + b.numel() for a, b in zip(b1s, b2s)))
    return [synrgb_lookup(a.reshape(-1), b.reshape(-1),
                          suppressed_table_sets(d), set_index=f - FLOOR_MIN,
                          water_floor=f).reshape(a.shape + (3,))
            for a, b, d, f in zip(b1s, b2s, devices,
                                  _to_each(floor_c, devices))]


def _gather(blocks, lead) -> torch.Tensor:
    """Step 6: the blocks in order on the lead device."""
    return torch.cat([b.to(lead) for b in blocks])


# ---------------------------------------------------------------------------
# Resample and pad configs: the axis-0 resample split by output rows
# ---------------------------------------------------------------------------
def _resample_rows_sharded(dn, out_rows: int, filter_name: str, devices):
    """The axis-0 resample of `dn` to `out_rows` (`band_resample_axis0`),
    by blocks of ceil(out_rows / n) output rows, one a device: each gets its
    rows of the coefficient table and the source rows its taps read, its
    starts rebased to them. Gathered on devices[0] (f32)."""
    in_rows = dn.shape[0]
    starts, weights = _build_coeffs(in_rows, out_rows, filter_name)
    taps = weights.shape[1]
    block = -(-out_rows // len(devices))
    parts = []
    for k, dev in enumerate(devices):
        o0, o1 = k * block, min((k + 1) * block, out_rows)
        if o0 >= o1:
            break
        s = starts[o0:o1]
        lo = int(s.min())
        hi = min(int(s.max()) + taps, in_rows)
        band = dn[lo:hi].to(dev)
        st = torch.from_numpy(np.ascontiguousarray(s - lo)).to(dev)
        w = torch.from_numpy(np.ascontiguousarray(weights[o0:o1])).to(dev)
        parts.append(resample_rows(band, st, w))
    return _gather(parts, devices[0])


def _resampled(dn, target_size, resample_alg, devices):
    """`fused._resample_dn` of the read's plan (the DN unchanged where no
    resample is planned), its row pass split over `devices`; on
    devices[0]."""
    lead = devices[0]
    in_rows, in_cols = dn.shape
    rows, cols, filt = fused._plan_read_dims(in_rows, in_cols, target_size,
                                             resample_alg)
    if filt is None:
        return dn.to(lead)
    x = (_resample_rows_sharded(dn, rows, filt, devices)
         if in_rows != rows else dn.to(lead))
    if in_cols != cols:
        x = band_resample_axis0(x.T.contiguous(), in_cols, cols, filt).T
    return as_f32(x).contiguous()


def _full_res(target_size, pad: bool) -> bool:
    return target_size is None and not pad


def _as_batch(batch) -> torch.Tensor:
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if batch.dim() != 3:
        raise ValueError("a batch is (scenes, rows, cols)")
    return batch


def synrgb_batch(vv_batch, vh_batch, mesh: Mesh,
                 strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
                 target_size: Optional[int] = 2048, pad: bool = False,
                 channel_order: str = "rgb",
                 suppressed: Optional[bool] = None,
                 resample_alg: Optional[str] = None) -> torch.Tensor:
    """A batch of dual-pol DN scenes (scenes, rows, cols), tensors on any
    device or arrays, to synthetic RGB across `mesh`, in `channel_order`
    (rgb, bgr, ycbcr, dct): `fused.synrgb_pipeline` of each scene, stacked
    on the mesh's lead device."""
    vv, vh = _as_batch(vv_batch), _as_batch(vh_batch)
    if vv.shape != vh.shape:
        raise ValueError("the two bands of a batch must share one shape")
    out = []
    for i, devices in enumerate(_scene_devices(vv.shape[0], mesh)):
        if _full_res(target_size, pad):
            tamed = strategy is AutoscaleStrategy.TAMED
            b1s = _band_blocks(vv[i], strategy, True if tamed else None,
                               BitDepth.U8, devices)
            b2s = _band_blocks(vh[i], strategy, False if tamed else None,
                               BitDepth.U8, devices)
            rgb = _gather(_synrgb_blocks(b1s, b2s, strategy, suppressed,
                                         devices), devices[0])
            del b1s, b2s
            out.append(fused._in_channel_order(rgb, channel_order))
            continue
        bands = [fused.synrgb_band_stage(
            _resampled(dn[i], target_size, resample_alg, devices), strategy,
            copol, None, pad) for dn, copol in ((vv, True), (vh, False))]
        out.append(fused.synrgb_combine_stage(*bands, strategy, suppressed,
                                              channel_order))
    return torch.stack([o.to(mesh.lead) for o in out])


def grayscale_batch(dn_batch, mesh: Mesh,
                    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
                    bit_depth: BitDepth = BitDepth.U8,
                    target_size: Optional[int] = None, pad: bool = False,
                    resample_alg: Optional[str] = None) -> torch.Tensor:
    """A batch of single-band DN scenes (scenes, rows, cols) to u8 or
    uint16 grayscale across `mesh`: `fused.grayscale_pipeline` of each
    scene, stacked on the mesh's lead device."""
    dn = _as_batch(dn_batch)
    out = []
    for i, devices in enumerate(_scene_devices(dn.shape[0], mesh)):
        if _full_res(target_size, pad):
            out.append(_gather(_band_blocks(dn[i], strategy, None, bit_depth,
                                            devices), devices[0]))
            continue
        out.append(fused.grayscale_pipeline(
            _resampled(dn[i], target_size, resample_alg, devices), strategy,
            bit_depth, None, pad))
    return torch.stack([o.to(mesh.lead) for o in out])

