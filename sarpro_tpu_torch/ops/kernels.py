"""Histogram, CLAHE tile histogram, CLAHE lookup and synthetic-RGB lookup:
Hopper kernels and their plain PyTorch versions.

Each public wrapper checks its inputs, allocates the output, and then
launches its CUDA kernel (csrc/histogram.cu, csrc/tile_histogram.cu,
csrc/clahe_lookup.cu, csrc/synrgb.cu) for tensors on a CUDA device, or runs
the plain version beside it for tensors on the CPU (and under
`force_plain()`). A CUDA launch that fails raises; nothing falls back. The
plain versions are the reference the kernels are checked against on the
card, and what the CPU tests compare with the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ._cuda import launch, use_kernel

# the largest int32 table one block's shared memory holds (227 KB)
MAX_HIST_BINS = 232448 // 4
SYNRGB_SET_BYTES = 256 + 256 + 65536


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------
def _histogram_plain(parts: Sequence[torch.Tensor], num_bins: int):
    out = torch.zeros(num_bins, dtype=torch.int32, device=parts[0].device)
    for p in parts:
        i = p.reshape(-1).to(torch.int64)
        valid = (i >= 0) & (i < num_bins)
        # masked entries count into an extra overflow bin that is sliced off
        counts = torch.bincount(torch.where(valid, i, num_bins),
                                minlength=num_bins + 1)
        out += counts[:num_bins].to(torch.int32)
    return out


def histogram(idx, num_bins: int) -> torch.Tensor:
    """int32 counts of the values of `idx` in [0, num_bins); other values
    (the masked convention: masked pixels carry num_bins) are dropped.

    `idx` is one int32 or uint8 tensor, or a sequence of two of one dtype
    counted together (the combined histogram of two bands, with no
    concatenated copy)."""
    parts = [idx] if isinstance(idx, torch.Tensor) else list(idx)
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"histogram takes one or two tensors, got {len(parts)}")
    dtype, device = parts[0].dtype, parts[0].device
    if dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"histogram indices must be int32 or uint8, not {dtype}")
    if any(p.dtype != dtype or p.device != device for p in parts):
        raise TypeError("histogram inputs must share dtype and device")
    if not 0 < num_bins <= MAX_HIST_BINS:
        raise ValueError(f"num_bins {num_bins} outside 1..{MAX_HIST_BINS}")
    if not use_kernel(parts[0]):
        return _histogram_plain(parts, num_bins)
    if any(not p.is_contiguous() for p in parts):
        raise ValueError("histogram inputs must be contiguous")
    out = torch.zeros(num_bins, dtype=torch.int32, device=device)
    a = parts[0]
    b = parts[1] if len(parts) == 2 else None
    launch("sarpro_histogram", "histogram", device,
           a.data_ptr(), a.numel(),
           None if b is None else b.data_ptr(), 0 if b is None else b.numel(),
           a.element_size(), num_bins, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# CLAHE tile histograms
# ---------------------------------------------------------------------------
def _pixel_rows_cols(n: int, cols: int, row_offset: int, device):
    """Global (row, col) of each flat row-major pixel index, int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i // cols + row_offset, i % cols


def _tile_histogram_plain(bin_flat, cols, tiles_x, tiles_y, tile_h, tile_w,
                          row_offset, n_bins):
    r, c = _pixel_rows_cols(bin_flat.numel(), cols, row_offset,
                            bin_flat.device)
    ty = torch.clamp_max(r // tile_h, tiles_y - 1)
    tx = torch.clamp_max(c // tile_w, tiles_x - 1)
    b = bin_flat.to(torch.int64)
    n_hist = tiles_y * tiles_x * n_bins
    valid = (b >= 0) & (b < n_bins)
    flat = torch.where(valid, (ty * tiles_x + tx) * n_bins + b, n_hist)
    return torch.bincount(flat, minlength=n_hist + 1)[:n_hist].to(torch.int32)


def _check_tiles(bin_flat, cols, tiles_x, tiles_y, tile_h, tile_w,
                 row_offset, name):
    if bin_flat.dtype != torch.int32 or bin_flat.dim() != 1:
        raise TypeError(f"{name}: bins must be a flat int32 tensor")
    if cols <= 0 or bin_flat.numel() % cols:
        raise ValueError(f"{name}: {bin_flat.numel()} pixels are not whole "
                         f"rows of {cols}")
    if min(tiles_x, tiles_y, tile_h, tile_w) <= 0 or row_offset < 0:
        raise ValueError(f"{name}: tile grid and row_offset must be positive")


def tile_histogram(bin_flat, cols: int, tiles_x: int, tiles_y: int,
                   tile_h: int, tile_w: int, row_offset: int = 0,
                   n_bins: int = 256) -> torch.Tensor:
    """Per-tile histograms for CLAHE (reference: autoscale.rs:258-269).

    `bin_flat` is the flat row-major int32 bin array of a (N/cols, cols)
    image; bins outside [0, n_bins) (the masked convention: n_bins) are not
    counted. A pixel's tile is (min((r + row_offset) // tile_h, tiles_y-1),
    min(c // tile_w, tiles_x-1)): `row_offset` places a row chunk or shard in
    the global raster. Returns the flat tile-major (tiles_y*tiles_x*n_bins,)
    int32 counts."""
    _check_tiles(bin_flat, cols, tiles_x, tiles_y, tile_h, tile_w,
                 row_offset, "tile_histogram")
    n_hist = tiles_y * tiles_x * n_bins
    if not 0 < n_hist <= MAX_HIST_BINS:
        raise ValueError(f"{n_hist} tile bins outside 1..{MAX_HIST_BINS}")
    if not use_kernel(bin_flat):
        return _tile_histogram_plain(bin_flat, cols, tiles_x, tiles_y, tile_h,
                                     tile_w, row_offset, n_bins)
    if not bin_flat.is_contiguous():
        raise ValueError("tile_histogram needs a contiguous bin tensor")
    out = torch.zeros(n_hist, dtype=torch.int32, device=bin_flat.device)
    launch("sarpro_tile_histogram", "tile_histogram", bin_flat.device,
           bin_flat.data_ptr(), bin_flat.numel(), cols, tiles_x, tiles_y,
           tile_h, tile_w, row_offset, n_bins, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# CLAHE bilinear CDF lookup
# ---------------------------------------------------------------------------
def _clahe_lookup_plain(bin_idx, cdfs, cols, tiles_x, tiles_y, tile_h,
                        tile_w, row_offset):
    """`_clahe_lookup_xla`'s operations in its order, each rounded to f32
    (XLA on the CPU contracts the blends into FMAs; see the tests). The
    tile sizes divide as device tensors: PyTorch's CUDA division by a
    Python scalar multiplies by its rounded reciprocal instead."""
    dev = bin_idx.device
    r, c = _pixel_rows_cols(bin_idx.numel(), cols, row_offset, dev)
    th = torch.full((), float(tile_h), dtype=torch.float32, device=dev)
    tw = torch.full((), float(tile_w), dtype=torch.float32, device=dev)
    rf = r.to(torch.float32) / th - 0.5
    cf = c.to(torch.float32) / tw - 0.5
    tyf = torch.clamp_min(torch.floor(rf), 0.0)
    txf = torch.clamp_min(torch.floor(cf), 0.0)
    dy = rf - tyf
    dx = cf - txf
    tyi = tyf.to(torch.int64)
    txi = txf.to(torch.int64)
    ty0 = torch.clamp(tyi, 0, tiles_y - 1)
    tx0 = torch.clamp(txi, 0, tiles_x - 1)
    ty1 = torch.clamp(tyi + 1, 0, tiles_y - 1)
    tx1 = torch.clamp(txi + 1, 0, tiles_x - 1)
    n_bins = cdfs.shape[1]
    flat = cdfs.reshape(-1)
    b = bin_idx.to(torch.int64)
    safe_bin = torch.clamp(b, 0, n_bins - 1)
    valid = b < n_bins

    def at(a, t):
        return flat[(a * tiles_x + t) * n_bins + safe_bin]

    top = at(ty0, tx0) * (1 - dx) + at(ty0, tx1) * dx
    bot = at(ty1, tx0) * (1 - dx) + at(ty1, tx1) * dx
    return torch.where(valid, top * (1 - dy) + bot * dy, 0.0)


def clahe_lookup(bin_idx, cdfs, cols: int, tiles_x: int, tiles_y: int,
                 tile_h: int, tile_w: int, row_offset: int = 0) -> torch.Tensor:
    """Bilinear interpolation between the 4 neighbour-tile CDFs at each
    pixel's bin (reference: autoscale.rs:307-343), (N,) f32.

    `bin_idx` is the flat row-major int32 bin array of a (N/cols, cols)
    image; `bin_idx == n_bins` marks a masked pixel, which gives 0 (bins
    are expected in [0, n_bins]). `cdfs` is (tiles_y*tiles_x, n_bins) f32,
    tile-major. `row_offset` places a row chunk or shard in the global
    raster."""
    _check_tiles(bin_idx, cols, tiles_x, tiles_y, tile_h, tile_w,
                 row_offset, "clahe_lookup")
    if (cdfs.dtype != torch.float32 or cdfs.dim() != 2
            or cdfs.shape[0] != tiles_x * tiles_y or cdfs.shape[1] < 1):
        raise ValueError(f"cdfs must be ({tiles_x * tiles_y}, n_bins) f32")
    if cdfs.device != bin_idx.device:
        raise ValueError("clahe_lookup inputs must share one device")
    if not use_kernel(bin_idx):
        return _clahe_lookup_plain(bin_idx, cdfs, cols, tiles_x, tiles_y,
                                   tile_h, tile_w, row_offset)
    if not (bin_idx.is_contiguous() and cdfs.is_contiguous()):
        raise ValueError("clahe_lookup inputs must be contiguous")
    out = torch.empty(bin_idx.numel(), dtype=torch.float32,
                      device=bin_idx.device)
    launch("sarpro_clahe_lookup", "clahe_lookup", bin_idx.device,
           bin_idx.data_ptr(), bin_idx.numel(), cdfs.data_ptr(),
           cdfs.shape[1], cols, tiles_x, tiles_y, tile_h, tile_w,
           row_offset, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# synRGB lookup
# ---------------------------------------------------------------------------
def _synrgb_lookup_plain(b1, b2, tables, set_index=None, water_floor=None):
    i1 = b1.reshape(-1).to(torch.int64)
    i2 = b2.reshape(-1).to(torch.int64)
    if set_index is None:
        t = tables[0]
    else:
        s = set_index.reshape(1).to(torch.int64).clamp(0, tables.shape[0] - 1)
        t = tables.index_select(0, s)[0]
    rgb = torch.stack([t[:256][i1], t[256:512][i2], t[512:][i1 * 256 + i2]],
                      dim=-1)
    if water_floor is not None:
        f = water_floor.reshape(()).to(torch.int64)
        water = (i1 <= f) & (i2 <= f)
        rgb = torch.where(water[:, None], torch.zeros_like(rgb), rgb)
    return rgb


def synrgb_lookup(b1, b2, tables, set_index=None, water_floor=None):
    """(N, 3) u8 `(lut_r[b1], lut_g[b2], lut_b[b1 * 256 + b2])` from flat u8
    bands.

    `tables` is (S, 66048) u8: S table sets, each laid out as
    [lut_r (256) | lut_g (256) | lut_b (65536)]. `set_index` (int32 scalar
    tensor on the bands' device, default set 0) picks the set, so a floor
    computed on the device selects its tables without a host round trip.
    With `water_floor` (int32 scalar tensor), pixels whose bands are both at
    or below it become (0, 0, 0): the suppressed mode's water mask."""
    for name, t in (("b1", b1), ("b2", b2)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise TypeError(f"{name} must be a flat uint8 tensor")
    if b1.shape != b2.shape:
        raise ValueError(f"band shapes differ: {b1.shape} vs {b2.shape}")
    if (tables.dtype != torch.uint8 or tables.dim() != 2
            or tables.shape[1] != SYNRGB_SET_BYTES):
        raise ValueError(f"tables must be (S, {SYNRGB_SET_BYTES}) uint8")
    scalars = [t for t in (set_index, water_floor) if t is not None]
    for t in scalars:
        if t.dtype != torch.int32 or t.numel() != 1:
            raise TypeError("set_index / water_floor must be int32 scalars")
    if any(t.device != b1.device for t in [b2, tables, *scalars]):
        raise ValueError("synrgb_lookup inputs must share one device")
    if not use_kernel(b1):
        return _synrgb_lookup_plain(b1, b2, tables, set_index, water_floor)
    if not all(t.is_contiguous() for t in (b1, b2, tables)):
        raise ValueError("synrgb_lookup inputs must be contiguous")
    out = torch.empty((b1.numel(), 3), dtype=torch.uint8, device=b1.device)
    launch("sarpro_synrgb_lookup", "synrgb_lookup", b1.device,
           b1.data_ptr(), b2.data_ptr(), b1.numel(), tables.data_ptr(),
           tables.shape[0],
           None if set_index is None else set_index.data_ptr(),
           None if water_floor is None else water_floor.data_ptr(),
           out.data_ptr())
    return out
