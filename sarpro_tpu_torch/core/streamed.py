"""Streamed full-resolution scenes (port of sarpro_tpu/core/streamed.py):
the fused programs' semantics, run as chunked passes over row chunks so
that no full-band f32 intermediate is ever held.

Per band, each pass walks the chunks in order, the ragged tail last:

  minmax   dB + mask: valid count, min, max (exact folds)
  stats    4096-bin histogram with the global range; percentiles and the
           histogram moments in `fused._stats_finalize`
  [CLAHE]  tile histograms with the chunk's global `row_offset`, the
           per-pixel CLAHE bins staged in the band's q16 buffer; one CDF
           build (`fused._clahe_cdfs`); the lookup reads the bins back
  apply    window (`fused._quantize`), CLAHE or Tamed values into the q16
           buffer, folding its min and max
  scale    the u16 -> u8 stretch with the global range (`fused._u8_stretch`),
           optionally with the band's 256-bin histogram
  synRGB   the combined histogram's water floor on the host (int64, one
           copy back a scene), then the suppressed or default compose a
           chunk at a time, straight from the two q16 buffers

Every body calls the fused program's own helpers and the same kernels
(histogram, tile_histogram, clahe_lookup, synrgb_lookup), so the output
equals the fused program's bit for bit for every strategy. The JAX package
folds each pass into one XLA program (`lax.fori_loop`), because a dispatch
there cost a round trip; here a Python loop over the chunks queues the same
work. Accumulators and extrema stay 0-dim device tensors and row offsets are
Python ints, so no chunk waits for the host.

The q16 staging buffer holds the u16 values as their int16 bit pattern (2
bytes a pixel; PyTorch's uint16 has few CUDA kernels), written through
`numerics.as_u16` and read through `numerics.as_f32`. Bands above
`_DEVICE_ACC_MAX_PIXELS` accumulate their counts in int64 on the device and
take the host-f64 percentile inversion when the valid count passes int32.

`BIG_SCENE_PIXELS` and `CHUNK_ROWS` are read at call time, so one change
here governs `core/fast_path` and `api`.

Mesh mode (`mesh`, a parallel.mesh.Mesh; sarpro_tpu/core/streamed.py:
729-1035): a band whose rows split evenly over the mesh's row axis runs
the same passes on each row block, on its device, with the block's global
row offset in the CLAHE tile geometry. The raw accumulators are combined on
the lead device before the shared finalize: the counts and histograms
summed, the min / max folded with the +-inf of a block with no valid pixel
kept until the global count is known. The blocks are gathered in order on
the lead, where the compose and the JPEG front end run, so every strategy
equals the unsharded passes bit for bit. Otherwise (uneven rows, a band
past the int32 ceiling) the band runs unsharded with a warning.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops import clahe_lookup, histogram, synrgb_lookup, tile_histogram
from ..parallel.mesh import combine as _combine
from ..types import AutoscaleStrategy, BitDepth
from . import fused
from .clahe import CLAHE_BINS, TILES_X, TILES_Y, _clahe_bins
from .numerics import as_f32, as_u16, u16_bits
from .synthetic_rgb import FLOOR_MAX, FLOOR_MIN, suppressed_table_sets
from .synthetic_rgb import create_synthetic_rgb as _synrgb_default

logger = logging.getLogger("sarpro")

CHUNK_ROWS = 4096
# above this many pixels per band a full-resolution scene takes this module
BIG_SCENE_PIXELS = 192 << 20

# int32 accumulation is exact while every accumulated count is bounded by
# the band's pixel count; past this the int64 / host-finalize branch engages
_DEVICE_ACC_MAX_PIXELS = 2**31 - 1
_INT32_MAX = 2**31 - 1
NUM_BINS = fused.NUM_BINS


def _plan(rows: int, chunk: int):
    """(full-chunk count, tail rows)."""
    return rows // chunk, rows % chunk


def _chunk_starts(rows: int, chunk: int):
    """(first row, rows) of each chunk: the full chunks, then the tail."""
    k, tail = _plan(rows, chunk)
    return [(i * chunk, chunk) for i in range(k)] + (
        [(k * chunk, tail)] if tail else [])


def _chunk_rows(rows: int, cols: int, chunk_rows: int | None) -> int:
    """The chunk height: CHUNK_ROWS unless given, never past the band, and
    under 2^31 pixels (the per-chunk int32 reductions)."""
    chunk = CHUNK_ROWS if chunk_rows is None else chunk_rows
    return max(min(chunk, rows, _INT32_MAX // max(cols, 1)), 1)


def _stage(q: torch.Tensor) -> torch.Tensor:
    """f32-held u16 values -> the q16 buffer's int16 bit pattern."""
    return u16_bits(as_u16(q))


def _unstage(b: torch.Tensor) -> torch.Tensor:
    """The q16 buffer's int16 bit pattern -> the u16 values as f32."""
    return as_f32(b.view(torch.uint16))


# ---------------------------------------------------------------------------
# Per-chunk bodies
# ---------------------------------------------------------------------------
def _minmax_chunk(dn, r0: int, n: int):
    db, mask = fused._db_mask(dn[r0:r0 + n])
    count = mask.sum(dtype=torch.int32)  # a chunk is under 2^31 px
    inf = float("inf")
    return (count, torch.where(mask, db, inf).amin(),
            torch.where(mask, db, -inf).amax())


def _hist_chunk(dn, mn, mx, r0: int, n: int):
    db, mask = fused._db_mask(dn[r0:r0 + n])
    return histogram(fused._db_bin_index(db, mask, mn, mx).reshape(-1),
                     NUM_BINS)


def _tile_hist_chunk(dn, low, high, r0: int, n: int, cols: int,
                     tile_h: int, tile_w: int, base: int = 0):
    """(flat int32 CLAHE bins, tile histograms) of rows [r0, r0 + n) of
    `dn`, a band or the row block of a band that starts at global row
    `base`: the tiles are the global raster's (`row_offset=base + r0`)."""
    db, mask = fused._db_mask(dn[r0:r0 + n])
    bins = _clahe_bins(fused._clahe_norm(db, mask, low, high),
                       mask).reshape(-1)
    return bins, tile_histogram(bins, cols, TILES_X, TILES_Y, tile_h, tile_w,
                                row_offset=base + r0, n_bins=CLAHE_BINS)


def _tile_hist_stage_chunk(buf, dn, low, high, r0: int, n: int, cols: int,
                           tile_h: int, tile_w: int, base: int = 0):
    """The tile-histogram pass that also stages the chunk's CLAHE bins
    (CLAHE_BINS marks a masked pixel) in the q16 buffer, so the apply pass
    reads them back instead of recomputing dB, window and bins."""
    bins, hist = _tile_hist_chunk(dn, low, high, r0, n, cols, tile_h, tile_w,
                                  base)
    buf[r0:r0 + n] = bins.view(n, cols)
    return hist


def _apply_clahe_bins_chunk(buf, max_val: float, cdfs, r0: int, n: int,
                            cols: int, tile_h: int, tile_w: int,
                            base: int = 0):
    """CLAHE apply from the staged bins: reads the chunk's bins from the
    buffer it then overwrites with the q16 values; (min, max) of them."""
    bins = buf[r0:r0 + n].to(torch.int32)
    eq = clahe_lookup(bins.reshape(-1), cdfs, cols, TILES_X, TILES_Y, tile_h,
                      tile_w, row_offset=base + r0).view(n, cols)
    q = fused._clahe_quantize(eq, bins < CLAHE_BINS, max_val)
    buf[r0:r0 + n] = _stage(q)
    return q.amin(), q.amax()


def _apply_clahe_chunk(buf, dn, low, high, max_val: float, cdfs, r0: int,
                       n: int, cols: int, tile_h: int, tile_w: int):
    """CLAHE apply from the DN (the int64 branch, which stages no bins)."""
    db, mask = fused._db_mask(dn[r0:r0 + n])
    bins = _clahe_bins(fused._clahe_norm(db, mask, low, high),
                       mask).reshape(-1)
    eq = clahe_lookup(bins, cdfs, cols, TILES_X, TILES_Y, tile_h, tile_w,
                      row_offset=r0).view(n, cols)
    q = fused._clahe_quantize(eq, mask, max_val)
    buf[r0:r0 + n] = _stage(q)
    return q.amin(), q.amax()


def _apply_window_chunk(buf, dn, low, high, gamma, max_val: float, r0: int,
                        n: int):
    db, mask = fused._db_mask(dn[r0:r0 + n])
    q = fused._quantize(db, mask, low, high, gamma, max_val)
    buf[r0:r0 + n] = _stage(q)
    return q.amin(), q.amax()


def _apply_tamed_chunk(buf, dn, low, high, r0: int, n: int) -> None:
    """Band-specific Tamed window straight to u8 values (autoscale.rs:
    710-742), staged in the q16 buffer."""
    db, mask = fused._db_mask(dn[r0:r0 + n])
    buf[r0:r0 + n] = _stage(fused._tamed_quantize_u8(db, mask, low, high))


def _q16_u8_vals(buf, mn, mx, r0: int, n: int):
    """u8 codes of rows [r0, r0 + n) of a q16 buffer under the band's global
    stretch: `fused._u8_stretch`, the fused program's own arithmetic. For a
    Tamed buffer (u8 values already) callers pass mn = 0, mx = 255: the
    scale is exactly 1 and the map the identity."""
    return fused._u8_stretch(_unstage(buf[r0:r0 + n]), mn, mx)


def _scale_u8_chunk(u8_buf, buf, mn, mx, r0: int, n: int, with_hist: bool):
    """The u16 -> u8 stretch of one chunk; with `with_hist`, the chunk's u8
    histogram too (the suppressed floor's, riding this pass)."""
    u8 = _q16_u8_vals(buf, mn, mx, r0, n)
    u8_buf[r0:r0 + n] = u8
    return histogram(u8.reshape(-1), 256) if with_hist else None


def _u8hist_q16_chunk(buf, mn, mx, r0: int, n: int):
    """The u8 histogram of a chunk's codes, with no u8 buffer written (the
    q16 compose needs only the floor before it composes)."""
    return histogram(_q16_u8_vals(buf, mn, mx, r0, n).reshape(-1), 256)


def _u8_hist_chunk(b, r0: int, n: int):
    return histogram(b[r0:r0 + n].reshape(-1), 256)


def _q16_chunk_codes(q1, q2, mn1, mx1, mn2, mx2, r0: int, n: int):
    """The two bands' u8 codes of a chunk, stretched from their q16
    buffers inside the compose: no u8 plane is written. Padded q16 zeros
    stretch to u8 0, as the padded u8 bands hold."""
    return (_q16_u8_vals(q1, mn1, mx1, r0, n),
            _q16_u8_vals(q2, mn2, mx2, r0, n))


def _compose_chunk(rgb_buf, c1, c2, r0: int, n: int, floor=None) -> None:
    """synRGB of one chunk's u8 codes into rows [r0, r0 + n) of the RGB
    buffer: suppressed with `floor` = (set index, water floor) as int32
    device scalars, else the default mode."""
    if floor is None:
        rgb_buf[r0:r0 + n] = _synrgb_default(c1, c2)
        return
    set_index, water_floor = floor
    rgb = synrgb_lookup(c1.reshape(-1), c2.reshape(-1),
                        suppressed_table_sets(c1.device), set_index=set_index,
                        water_floor=water_floor)
    rgb_buf[r0:r0 + n] = rgb.view(n, c1.shape[1], 3)


def dct_blocks_streamed(img: torch.Tensor,
                        chunk_rows: int | None = None) -> torch.Tensor:
    """The JPEG front end over a composed full-resolution u8 image (RGB
    interleaved (rows, cols, 3), or one gray plane (rows, cols)), a chunk
    of 8-aligned rows at a time: YCbCr, level shift, FDCT, q100 quantize
    (`fused.ycbcr_planes`, `fused.jpeg_dct_planes`). Returns the
    (3 or 1, ceil(rows/8), ceil(cols/8), 8, 8) int16 coefficients in host
    memory (pinned when `img` is on a GPU), for the entropy-only coder.

    Each chunk's blocks are copied to their rows of the host array without
    waiting; once the copies are queued the chunk's device blocks are
    released, and the stream orders their reuse after the copy, so about
    one chunk's blocks are alive at a time. One stream sync at the end."""
    rows, cols = img.shape[:2]
    rgb = img.dim() == 3
    step = max(_chunk_rows(rows, cols, chunk_rows) // 8 * 8, 8)
    out = torch.empty((3 if rgb else 1, -(-rows // 8), -(-cols // 8), 8, 8),
                      dtype=torch.int16, pin_memory=img.is_cuda)
    for r0, n in _chunk_starts(rows, step):
        chunk = img[r0:r0 + n]
        blocks = fused.jpeg_dct_planes(
            fused.ycbcr_planes(chunk) if rgb else chunk[None])
        b0 = r0 // 8
        for c in range(out.shape[0]):  # contiguous rows of each plane
            out[c, b0:b0 + blocks.shape[1]].copy_(blocks[c], non_blocking=True)
        del blocks
    if img.is_cuda:
        torch.cuda.current_stream(img.device).synchronize()
    return out


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------
def _fold_minmax_raw(dn, chunks, acc_dtype):
    """(count, min, max) of the valid dB of `dn`'s chunks, +-inf where none
    is valid (a row block's, combined across blocks before the empty-band
    rule)."""
    count = torch.zeros((), dtype=acc_dtype, device=dn.device)
    mn = torch.full((), float("inf"), device=dn.device)
    mx = torch.full((), float("-inf"), device=dn.device)
    for r0, n in chunks:
        c, a, b = _minmax_chunk(dn, r0, n)
        count, mn, mx = count + c, torch.minimum(mn, a), torch.maximum(mx, b)
    return count, mn, mx


def _empty_band_rule(count, mn, mx):
    """An empty band's range is 0, as the fused program has it."""
    return (count, torch.where(count > 0, mn, 0.0),
            torch.where(count > 0, mx, 0.0))


def _fold_minmax(dn, chunks, acc_dtype):
    """(count, min, max) of the band's valid dB, empty bands normalized to
    a 0 range as the fused program does."""
    return _empty_band_rule(*_fold_minmax_raw(dn, chunks, acc_dtype))


def _fold_hist(dn, mn, mx, chunks, acc_dtype):
    hist = torch.zeros(NUM_BINS, dtype=acc_dtype, device=dn.device)
    for r0, n in chunks:
        hist += _hist_chunk(dn, mn, mx, r0, n)
    return hist


def _band_stats_hostacc(dn, chunks):
    """The statistics of a band above the int32 accumulation ceiling: the
    counts fold in int64 on the device and come back once; past int32
    valid pixels the percentiles invert on the host in f64."""
    count, mn, mx = _fold_minmax(dn, chunks, torch.int64)
    hist = _fold_hist(dn, mn, mx, chunks, torch.int64)
    n = int(count)  # the one copy back of the band's statistics
    if n > _INT32_MAX:
        return _stats_finalize_host(hist.cpu().numpy(), n, float(mn),
                                    float(mx), dn.device)
    return fused._stats_finalize(hist.to(torch.int32),
                                 count.to(torch.int32), mn, mx)


def _stats_finalize_host(hist, count: int, mn: float, mx: float,
                         device=None):
    """Host-f64 mirror of `fused._stats_finalize` for bands whose valid
    count passes int32 (the device finalize's int32 cumsum would wrap);
    moments come from the histogram like the device's. Returns the same
    dict of 0-dim f32 tensors on `device`."""
    span = mx - mn
    n = max(float(count), 1.0)
    centers = np.arange(NUM_BINS, dtype=np.float64) + 0.5
    hf = np.asarray(hist[:NUM_BINS], np.float64)
    bw_m = span / NUM_BINS
    m1 = float(np.sum(hf * centers)) / n
    m2 = float(np.sum(hf * centers * centers)) / n
    mean = mn + m1 * bw_m
    var = max(m2 - m1 * m1, 0.0) * bw_m * bw_m
    std = np.sqrt(var) if count > 1 else 0.0
    cum = np.cumsum(hist)
    pct_values = np.asarray(fused._PCT_VALUES, np.float64)
    targets = np.minimum(np.floor(pct_values * n).astype(np.int64), count - 1)
    b = np.minimum(np.searchsorted(cum, targets, side="right"), NUM_BINS - 1)
    h = hist[b]
    cum_before = cum[b] - h
    within = np.maximum(targets - cum_before, 0)
    frac = np.where(h > 0, within.astype(np.float64) / np.maximum(h, 1), 0.0)
    bw = span / NUM_BINS
    pcts = mn + (b.astype(np.float64) + frac) * bw
    if span <= 0:
        pcts = np.where(pct_values <= 0.5, mn, mx)

    def f32(v):
        return torch.full((), float(np.float32(v)), device=device)

    d = {k: f32(v) for k, v in zip(fused._PCT_ORDER, pcts)}
    # the count saturates at int32, the device dict's dtype (no consumer
    # reads it: the true count was used above)
    d.update(count=torch.full((), min(count, _INT32_MAX), dtype=torch.int32,
                              device=device),
             min=f32(mn), max=f32(mx), mean=f32(mean), std=f32(std))
    return d


# ---------------------------------------------------------------------------
# Band, synRGB and grayscale entry points
# ---------------------------------------------------------------------------
class _Block:
    """A band's row block: its DN on its device, its chunks (local rows),
    its first global row, and its views of the band's output buffers."""

    def __init__(self, dn, device, base: int, rows: int, chunks):
        self.device, self.base, self.rows, self.chunks = (device, base, rows,
                                                          chunks)
        self.dn = dn[base:base + rows].to(device)

    def buffer(self, full: torch.Tensor) -> torch.Tensor:
        """The block's rows of `full`: a view where the block shares its
        device, else a buffer of its own (`gather` copies it back)."""
        if self.device == full.device:
            return full[self.base:self.base + self.rows]
        return torch.empty((self.rows,) + tuple(full.shape[1:]),
                           dtype=full.dtype, device=self.device)

    def gather(self, full: torch.Tensor, part: torch.Tensor) -> None:
        if part.data_ptr() != full[self.base:].data_ptr():
            full[self.base:self.base + self.rows].copy_(part)


def _blocks(dn, mesh, chunk_rows, device_acc: bool):
    """The band's row blocks: one per device of the mesh's row axis where
    the rows split evenly and the band is within the int32 ceiling, else
    the whole band (with the JAX package's warnings)."""
    rows, cols = dn.shape
    if mesh is not None:
        devices = mesh.row_devices()
        n = len(devices)
        if device_acc and n >= 2 and rows % n == 0:
            local = rows // n
            chunks = _chunk_starts(local, _chunk_rows(local, cols,
                                                      chunk_rows))
            return [_Block(dn, d, j * local, local, chunks)
                    for j, d in enumerate(devices)]
        # a 1-device mesh is unsharded execution, not worth a warning
        if not device_acc:
            logger.warning(
                "streamed: band (%dx%d) exceeds the int32 device-"
                "accumulation ceiling (%d px); running unsharded",
                rows, cols, _DEVICE_ACC_MAX_PIXELS)
        elif n >= 2:
            logger.warning(
                "streamed: %d rows don't split evenly over %d 'row' "
                "devices; running unsharded", rows, n)
    chunks = _chunk_starts(rows, _chunk_rows(rows, cols, chunk_rows))
    return [_Block(dn, dn.device, 0, rows, chunks)]


def band_u8_streamed(dn: torch.Tensor, strategy: AutoscaleStrategy,
                     tamed_copol: bool | None = None,
                     bit_depth: BitDepth = BitDepth.U8,
                     chunk_rows: int | None = None,
                     collect_hist: bool = False, mesh=None,
                     emit_q16: bool = False):
    """One full-resolution band DN -> u8 (uint16 for a u16 grayscale band),
    chunked: the semantics of `fused._band_u8` and `fused.grayscale_pipeline`
    at original size. With `collect_hist`, returns (band, the u8 output's
    256-bin device histogram; None for u16).

    With `emit_q16` (the synRGB compose from q16, bands within the int32
    ceiling only) returns (q16 buffer, histogram or None, mn, mx): the
    int16-held q16 values and their stretch range; no u8 plane is written.
    A Tamed band returns its u8-valued buffer with (0, 255), under which
    the stretch is the identity.

    Bands within `_DEVICE_ACC_MAX_PIXELS` fold their counts in int32 on the
    device and never wait for the host; larger ones fold in int64, also on
    the device, and copy their statistics back once (`_band_stats_hostacc`),
    their histograms int64.

    With `mesh`, the passes run on each row block of the mesh's row axis
    (the module's mesh mode); the outputs land on the mesh's lead device."""
    rows, cols = dn.shape
    device_acc = dn.numel() <= _DEVICE_ACC_MAX_PIXELS
    if emit_q16 and not device_acc:
        raise ValueError("emit_q16 needs a band within the int32 "
                         "accumulation ceiling (_DEVICE_ACC_MAX_PIXELS)")
    acc = torch.int32 if device_acc else torch.int64
    blocks = _blocks(dn, mesh, chunk_rows, device_acc)
    dev = blocks[0].device  # the lead: reductions and outputs

    def each(t):
        """A lead-device scalar or table copied to each block's device."""
        return [t.to(b.device) for b in blocks]

    def fold_u8_hist(body, bufs, *scalars):
        """The u8 histogram summed over every block's chunks; `scalars`
        are lead-device scalars handed to `body` on each block's device."""
        per = [each(x) for x in scalars]
        parts = []
        for k, (b, buf) in enumerate(zip(blocks, bufs)):
            h = torch.zeros(256, dtype=acc, device=b.device)
            for r0, n in b.chunks:
                h += body(buf, *(x[k] for x in per), r0, n)
            parts.append(h)
        return _combine(parts, torch.add, dev)

    if device_acc:
        raw = [_fold_minmax_raw(b.dn, b.chunks, acc) for b in blocks]
        count, mn, mx = _empty_band_rule(
            _combine([r[0] for r in raw], torch.add, dev),
            _combine([r[1] for r in raw], torch.minimum, dev),
            _combine([r[2] for r in raw], torch.maximum, dev))
        hist = _combine([_fold_hist(b.dn, a, c, b.chunks, acc) for b, a, c
                         in zip(blocks, each(mn), each(mx))], torch.add, dev)
        s = fused._stats_finalize(hist, count, mn, mx)
    else:
        s = _band_stats_hostacc(dn, blocks[0].chunks)
    buf = torch.empty((rows, cols), dtype=torch.int16, device=dev)
    bufs = [b.buffer(buf) for b in blocks]

    def gather(full, parts):
        for b, part in zip(blocks, parts):
            b.gather(full, part)
        return full

    if tamed_copol is not None and strategy is AutoscaleStrategy.TAMED:
        # band-specific Tamed window straight to u8 values (fused._band_u8)
        low = torch.minimum(s["p02"], s["p05"]) if tamed_copol else s["p05"]
        for b, bb, lo, hi in zip(blocks, bufs, each(low), each(s["p99"])):
            for r0, n in b.chunks:
                _apply_tamed_chunk(bb, b.dn, lo, hi, r0, n)
        if emit_q16:
            q_mn = torch.zeros((), device=dev)
            q_mx = torch.full((), 255.0, device=dev)
            h = (fold_u8_hist(_u8hist_q16_chunk, bufs, q_mn, q_mx)
                 if collect_hist else None)
            return gather(buf, bufs), h, q_mn, q_mx
        u8s = [bb.to(torch.uint8) for bb in bufs]
        h = fold_u8_hist(_u8_hist_chunk, u8s) if collect_hist else None
        u8 = torch.cat([x.to(dev) for x in u8s]) if len(u8s) > 1 else u8s[0]
        return (u8, h) if collect_hist else u8

    low, high, gamma = fused._window(s, strategy)
    max_val = float(bit_depth.max_val)
    extrema = []
    if strategy is AutoscaleStrategy.CLAHE:
        tile_h, tile_w = -(-rows // TILES_Y), -(-cols // TILES_X)
        parts = []
        for b, bb, lo, hi in zip(blocks, bufs, each(low), each(high)):
            hists = torch.zeros(TILES_Y * TILES_X * CLAHE_BINS, dtype=acc,
                                device=b.device)
            for r0, n in b.chunks:
                if device_acc:
                    hists += _tile_hist_stage_chunk(bb, b.dn, lo, hi, r0, n,
                                                    cols, tile_h, tile_w,
                                                    b.base)
                else:
                    hists += _tile_hist_chunk(b.dn, lo, hi, r0, n, cols,
                                              tile_h, tile_w)[1]
            parts.append(hists)
        cdfs = fused._clahe_cdfs(_combine(parts, torch.add, dev), rows, cols,
                                 tile_h, tile_w)
        for b, bb, c, lo, hi in zip(blocks, bufs, each(cdfs), each(low),
                                    each(high)):
            for r0, n in b.chunks:
                extrema.append(
                    _apply_clahe_bins_chunk(bb, max_val, c, r0, n, cols,
                                            tile_h, tile_w, b.base)
                    if device_acc
                    else _apply_clahe_chunk(bb, b.dn, lo, hi, max_val, c, r0,
                                            n, cols, tile_h, tile_w))
    else:
        for b, bb, lo, hi, g in zip(blocks, bufs, each(low), each(high),
                                    each(gamma)):
            for r0, n in b.chunks:
                extrema.append(_apply_window_chunk(bb, b.dn, lo, hi, g,
                                                   max_val, r0, n))
    q_mn = _combine([a for a, _ in extrema], torch.minimum, dev)
    q_mx = _combine([b for _, b in extrema], torch.maximum, dev)

    if emit_q16:
        h = (fold_u8_hist(_u8hist_q16_chunk, bufs, q_mn, q_mx)
             if collect_hist else None)
        return gather(buf, bufs), h, q_mn, q_mx
    if bit_depth is BitDepth.U16:
        out = gather(buf, bufs).view(torch.uint16)
        return (out, None) if collect_hist else out
    u8 = torch.empty((rows, cols), dtype=torch.uint8, device=dev)
    pairs = [(b.buffer(u8), bb) for b, bb in zip(blocks, bufs)]

    def scale(pair, mn_b, mx_b, r0, n):
        return _scale_u8_chunk(*pair, mn_b, mx_b, r0, n, collect_hist)

    if collect_hist:
        h = fold_u8_hist(scale, pairs, q_mn, q_mx)
    else:
        for b, pair, mn_b, mx_b in zip(blocks, pairs, each(q_mn), each(q_mx)):
            for r0, n in b.chunks:
                scale(pair, mn_b, mx_b, r0, n)
    gather(u8, [ub for ub, _ in pairs])
    return (u8, h) if collect_hist else u8


def _suppressed_floor_host(hist: np.ndarray, total_pixels: int) -> int:
    """Combined-histogram water floor with its cushion, int64-exact on the
    host with an f64 target (streamed totals can pass int32; reference:
    synthetic_rgb.rs:96-110)."""
    target = np.floor(np.float64(total_pixels) * 0.05 + 0.5)
    cum = np.cumsum(hist.astype(np.int64))
    reached = cum >= target
    floor_value = int(np.argmax(reached)) if reached.any() else 0
    return min(floor_value + FLOOR_MIN, FLOOR_MAX)


def synrgb_streamed(vv_dn: torch.Tensor, vh_dn: torch.Tensor,
                    strategy: AutoscaleStrategy = AutoscaleStrategy.CLAHE,
                    suppressed: bool | None = None, pad: bool = False,
                    chunk_rows: int | None = None, layout: str = "rgb",
                    mesh=None) -> torch.Tensor:
    """Full-resolution dual-pol DN -> synthetic RGB u8 (rows, cols, 3) on
    the device, chunked: `fused.synrgb_pipeline(target_size=None)`'s
    semantics. `layout="dct"` runs the chunked JPEG front end after the
    compose and returns the host int16 coefficients instead (the fused
    program's channel_order="dct" blocks; `dct_blocks_streamed`).

    Bands within the int32 ceiling stay in their q16 buffers and the
    compose stretches them a chunk at a time; larger ones are stretched to
    u8 planes first. The suppressed mode copies the combined 256-bin
    histogram back once for its floor, which goes back to the card as two
    int32 scalars (set index and water floor). With `mesh`, each band runs
    the mesh mode (`band_u8_streamed`) and the compose runs on the lead."""
    if layout not in ("rgb", "dct"):
        raise ValueError(f"unknown layout {layout!r} (rgb, dct)")
    rows, cols = vv_dn.shape
    tamed = strategy is AutoscaleStrategy.TAMED
    if suppressed is None:
        suppressed = strategy in (AutoscaleStrategy.TAMED,
                                  AutoscaleStrategy.CLAHE)
    q16_mode = max(vv_dn.numel(), vh_dn.numel()) <= _DEVICE_ACC_MAX_PIXELS
    bands = [band_u8_streamed(dn, strategy, copol if tamed else None,
                              chunk_rows=chunk_rows, collect_hist=suppressed,
                              mesh=mesh, emit_q16=q16_mode)
             for dn, copol in ((vv_dn, True), (vh_dn, False))]
    if q16_mode:
        (b1, h1, mn1, mx1), (b2, h2, mn2, mx2) = bands
    else:
        (b1, h1), (b2, h2) = bands if suppressed else ((b, None)
                                                       for b in bands)
    del bands
    dev = b1.device
    hist = (h1.to(torch.int64) + h2.to(torch.int64)).cpu().numpy() \
        if suppressed else None
    if pad:
        m = max(rows, cols)
        if suppressed:
            # pad precedes composition (save.rs:332-361): the pad zeros take
            # part in the combined histogram (q16 zeros stretch to u8 0)
            hist[0] += 2 * (m * m - rows * cols)
        b1 = fused._pad_square(b1, rows, cols)
        b2 = fused._pad_square(b2, rows, cols)
        rows = cols = m
    floor = None
    if suppressed:
        fc = _suppressed_floor_host(hist, 2 * rows * cols)
        floor = (torch.full((), fc - FLOOR_MIN, dtype=torch.int32, device=dev),
                 torch.full((), fc, dtype=torch.int32, device=dev))
    rgb = torch.empty((rows, cols, 3), dtype=torch.uint8, device=dev)
    for r0, n in _chunk_starts(rows, _chunk_rows(rows, cols, chunk_rows)):
        codes = (_q16_chunk_codes(b1, b2, mn1, mx1, mn2, mx2, r0, n)
                 if q16_mode else (b1[r0:r0 + n], b2[r0:r0 + n]))
        _compose_chunk(rgb, *codes, r0, n, floor)
    del b1, b2
    return dct_blocks_streamed(rgb, chunk_rows) if layout == "dct" else rgb


def grayscale_streamed(dn: torch.Tensor,
                       strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
                       bit_depth: BitDepth = BitDepth.U8, pad: bool = False,
                       chunk_rows: int | None = None, jpeg_dct: bool = False,
                       mesh=None) -> torch.Tensor:
    """Full-resolution single-band DN -> u8 or uint16 grayscale on the
    device, chunked: `fused.grayscale_pipeline(target_size=None)`'s
    semantics. With `jpeg_dct` (u8 only) the band's (bh, bw, 8, 8) int16
    JPEG coefficients come back in host memory instead
    (`dct_blocks_streamed`)."""
    if jpeg_dct and bit_depth is not BitDepth.U8:
        raise ValueError("the JPEG front end takes u8 bands only")
    rows, cols = dn.shape
    out = band_u8_streamed(dn, strategy, None, bit_depth, chunk_rows,
                           mesh=mesh)
    if pad:
        # a uint16 band pads through its int16 view
        out = fused._pad_square(u16_bits(out), rows, cols).view(out.dtype)
    if jpeg_dct:
        return dct_blocks_streamed(out, chunk_rows)[0]
    return out
