"""Histogram and synthetic-RGB lookup: Hopper kernels and their plain
PyTorch versions.

Each public wrapper checks its inputs, allocates the output, and then
launches its CUDA kernel (csrc/histogram.cu, csrc/synrgb.cu) for tensors on
a CUDA device, or runs the plain version beside it for tensors on the CPU
(and under `force_plain()`). A CUDA launch that fails raises; nothing falls
back. The plain versions are the reference the kernels are checked against
on the card, and what the CPU tests compare with the JAX package.
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
