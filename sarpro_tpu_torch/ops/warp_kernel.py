"""Inverse-map warp sampler: the Hopper kernel (csrc/warp.cu) and its plain
PyTorch version.

The plain version is `sarpro_tpu/io/warp._warp_sample_block`: the output
rows [row0, row0 + rows) (by default the whole output) of the coarse
inverse-mapping grid bilinearly upsampled to every output pixel, the source is sampled there (near, bilinear, or Keys
cubic with a = -0.5 over 4x4 taps), the taps are renormalised by the weight
sum of the in-bounds ones, and pixels that map outside the source are 0.
Each operation is rounded to f32 in the reference's order; XLA on the CPU
contracts some of them into FMAs, so the two agree to an ulp of the mapped
coordinate (see the tests), and the kernel equals the plain version.

Float to int: XLA saturates and maps NaN to 0, so the reference's `near`
sampler reads source pixel (0, 0) at a NaN grid node. The plain version maps
NaN to 0 and clamps into +-2^30 before the cast (PyTorch's cast of NaN or of
an out-of-range value is undefined); any index that far out is out of bounds
either way, and the clamp keeps `x0 + dx` from wrapping.
"""
from __future__ import annotations

import numpy as np
import torch

from ._cuda import launch, use_kernel

METHODS = {"near": 0, "bilinear": 1, "cubic": 2}
_INT_LIMIT = float(1 << 30)


def grid_scales(gh: int, gw: int, out_rows: int, out_cols: int):
    """Mapping-grid steps per output row and column, rounded to f32 as the
    reference's weak-typed Python float is."""
    return (float(np.float32((gh - 1) / max(out_rows - 1, 1))),
            float(np.float32((gw - 1) / max(out_cols - 1, 1))))


def _to_index(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts in range: NaN -> 0, clamped to +-2^30."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -_INT_LIMIT, _INT_LIMIT).to(torch.int32)


def _keys(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic weight, a = -0.5, in io/warp.py:276-282's order."""
    a = -0.5
    at = torch.abs(t)
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - (5.0 * a) * at2 + (8.0 * a) * at - 4.0 * a
    return torch.where(at < 1.0, w1, torch.where(at < 2.0, w2, 0.0))


def _warp_sample_plain(src, map_x, map_y, out_rows: int, out_cols: int,
                       method: str, row0: int = 0,
                       rows: int | None = None) -> torch.Tensor:
    h, w = src.shape
    gh, gw = map_x.shape
    dev = src.device
    rows = out_rows - row0 if rows is None else rows
    sr, sc = grid_scales(gh, gw, out_rows, out_cols)
    # global row coordinates: integers, exact in f32
    r = (torch.arange(rows, dtype=torch.int64, device=dev) + row0).to(
        torch.float32)
    gr = r[:, None] * sr
    gc = torch.arange(out_cols, dtype=torch.float32, device=dev)[None, :] * sc
    gr0 = torch.clamp(torch.floor(gr), 0, gh - 2).to(torch.int64)
    gc0 = torch.clamp(torch.floor(gc), 0, gw - 2).to(torch.int64)
    fr = gr - gr0
    fc = gc - gc0

    def interp(grid):
        flat = grid.reshape(-1)
        i00 = flat[gr0 * gw + gc0]
        i01 = flat[gr0 * gw + gc0 + 1]
        i10 = flat[(gr0 + 1) * gw + gc0]
        i11 = flat[(gr0 + 1) * gw + gc0 + 1]
        top = i00 * (1 - fc) + i01 * fc
        bot = i10 * (1 - fc) + i11 * fc
        return top * (1 - fr) + bot * fr

    sx = interp(map_x)  # source col
    sy = interp(map_y)  # source row
    flat_src = src.reshape(-1)

    def fetch(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = (torch.clamp(iy, 0, h - 1).to(torch.int64) * w
               + torch.clamp(ix, 0, w - 1))
        return torch.where(valid, flat_src[idx], 0.0), valid

    if method == "near":
        v, _ = fetch(_to_index(torch.floor(sy + 0.5)),
                     _to_index(torch.floor(sx + 0.5)))
        return v

    if method == "bilinear":
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0 = _to_index(x0)
        y0 = _to_index(y0)
        v00, m00 = fetch(y0, x0)
        v01, m01 = fetch(y0, x0 + 1)
        v10, m10 = fetch(y0 + 1, x0)
        v11, m11 = fetch(y0 + 1, x0 + 1)
        w00 = (1 - fx) * (1 - fy)
        w01 = fx * (1 - fy)
        w10 = (1 - fx) * fy
        w11 = fx * fy
        wsum = w00 * m00 + w01 * m01 + w10 * m10 + w11 * m11
        val = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
        return torch.where(wsum > 0, val / torch.clamp_min(wsum, 1e-20), 0.0)

    x0 = _to_index(torch.floor(sx))
    y0 = _to_index(torch.floor(sy))
    fx = sx - x0
    fy = sy - y0
    val = torch.zeros_like(sx)
    wsum = torch.zeros_like(sx)
    for dy in range(-1, 3):
        wy = _keys(fy - dy)
        for dx in range(-1, 3):
            wx = _keys(fx - dx)
            v, m = fetch(y0 + dy, x0 + dx)
            wgt = wx * wy * m
            val = val + v * wgt
            wsum = wsum + wgt
    return torch.where(wsum > 1e-6, val / torch.clamp_min(wsum, 1e-20), 0.0)


def warp_sample(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
                out_rows: int, out_cols: int, method: str, row0: int = 0,
                rows: int | None = None) -> torch.Tensor:
    """Sample the f32 source (H, W) at the inverse mapping: `map_x` and
    `map_y` are the (gh, gw) f32 source column and row of evenly spaced
    output grid nodes spanning (out_rows, out_cols). `method` is near,
    bilinear or cubic. Returns the output's rows [row0, row0 + rows) (by
    default all of them), (rows, out_cols) f32, 0 out of bounds: a row
    shard equals its rows of the whole output bit for bit."""
    if method not in METHODS:
        raise ValueError(f"unknown warp method {method!r}")
    if src.dtype != torch.float32 or src.dim() != 2 or min(src.shape) < 1:
        raise TypeError("warp source must be a non-empty 2-D float32 tensor")
    if (map_x.shape != map_y.shape or map_x.dim() != 2
            or min(map_x.shape) < 2):
        raise ValueError("map_x and map_y must be one (gh, gw) shape, "
                         "gh, gw >= 2")
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise TypeError("mapping grids must be float32")
    if map_x.device != src.device or map_y.device != src.device:
        raise ValueError("warp_sample inputs must share one device")
    if out_rows < 1 or out_cols < 1:
        raise ValueError("output must be at least 1 x 1")
    rows = out_rows - row0 if rows is None else rows
    if row0 < 0 or rows < 1 or row0 + rows > out_rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) are not within the "
                         f"{out_rows} output rows")
    if src.numel() >= 1 << 31:
        raise ValueError("warp source above 2^31 pixels")
    if not use_kernel(src):
        return _warp_sample_plain(src, map_x, map_y, out_rows, out_cols,
                                  method, row0, rows)
    if not all(t.is_contiguous() for t in (src, map_x, map_y)):
        raise ValueError("warp_sample inputs must be contiguous")
    gh, gw = map_x.shape
    sr, sc = grid_scales(gh, gw, out_rows, out_cols)
    out = torch.empty((rows, out_cols), dtype=torch.float32,
                      device=src.device)
    launch("sarpro_warp_sample", "warp_sample", src.device,
           src.data_ptr(), src.shape[0], src.shape[1], map_x.data_ptr(),
           map_y.data_ptr(), gh, gw, sr, sc, METHODS[method],
           out.data_ptr(), row0, rows, out_cols)
    return out


# the branches of the kernel's output tiles, as tile_kinds reports them
TILE_KINDS = ("staged", "outside", "global", "interior")


def tile_kinds(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
               out_rows: int, out_cols: int, method: str, row0: int = 0,
               rows: int | None = None) -> torch.Tensor:
    """Which branch the kernel takes for each output tile of the same call
    (CUDA tensors only; inspection, not counted as a launch), as int32
    indices into TILE_KINDS: the tile's source footprint staged in shared
    memory with each tap tested against the source, no tap in the source,
    every tap from device memory, or staged with every tap inside the
    source (untested). Cubic takes 32 x 32 tiles; near and bilinear gather
    from device memory in 8 x 32 tiles, all "global". Tiles lie at global
    rows: a row shard's are the tile rows that hold its rows."""
    if not (src.is_cuda and map_x.is_cuda and map_y.is_cuda):
        raise ValueError("tile_kinds inspects the CUDA kernel: CUDA tensors "
                         "only")
    if not (map_x.is_contiguous() and map_y.is_contiguous()):
        raise ValueError("mapping grids must be contiguous")
    gh, gw = map_x.shape
    sr, sc = grid_scales(gh, gw, out_rows, out_cols)
    rows = out_rows - row0 if rows is None else rows
    tile_rows = 32 if method == "cubic" else 8
    tiles = (row0 + rows - 1) // tile_rows - row0 // tile_rows + 1
    kinds = torch.empty((tiles, -(-out_cols // 32)), dtype=torch.int32,
                        device=src.device)
    launch("sarpro_warp_tiles", None, src.device, src.shape[0], src.shape[1],
           map_x.data_ptr(), map_y.data_ptr(), gh, gw, sr, sc,
           METHODS[method], kinds.data_ptr(), row0, rows, out_cols)
    return kinds
