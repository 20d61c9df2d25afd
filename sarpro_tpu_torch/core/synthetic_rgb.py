"""Synthetic RGB composition from two u8 SAR bands (port of
sarpro_tpu/core/synthetic_rgb.py).

Reference semantics (synthetic_rgb.rs): the default mode (:10-67), the
maritime-suppressed mode of Tamed and CLAHE (:88-178) and the mode
dispatchers (:72-79, :182-197; every SyntheticRgbMode aliases Default).

`default_luts` and `suppressed_luts` are copies of the JAX package's host
f32 numpy builders (the reference's f32 LUT precomputation,
synthetic_rgb.rs:20-51 and :115-154); a test holds each copy bit-equal to
the original. On the device a table set is one u8 row laid out as
`ops.synrgb_lookup` expects, [lut_r (256) | lut_g (256) | lut_b (65536)]:
the default mode has one set, and the suppressed mode stacks the sets of
every reachable floor (3..40), picked by `set_index`. Fast mode
(core/fused) computes the floor on the device; exact mode
(`create_synthetic_rgb_suppressed` here) computes it on the host from the
combined 256-bin histogram, as the JAX package does, with one host sync.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import histogram, synrgb_lookup
from ..types import AutoscaleStrategy, SyntheticRgbMode

GAMMA_R = np.float32(0.7)
GAMMA_G = np.float32(0.9)
GAMMA_B = np.float32(0.1)
BLUE_SCALE = np.float32(0.24)

GAMMA_R_SUPP = np.float32(1.15)
GAMMA_G_SUPP = np.float32(1.10)
BLUE_SCALE_SUPP = np.float32(0.18)
EPS_SUPP = np.float32(8.0)

# reachable suppressed floors: the p05 floor + 3 cushion, capped at 40
FLOOR_MIN, FLOOR_MAX = 3, 40


def _round_half_away_f32(x: np.ndarray) -> np.ndarray:
    return np.trunc(x + np.copysign(np.float32(0.5), x).astype(np.float32))


@functools.lru_cache(maxsize=1)
def default_luts() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Default-mode LUTs (lut_r (256,), lut_g (256,), lut_b (65536,) flat
    index b1 * 256 + b2), u8: f32 arithmetic, round half away from zero,
    and the band2 == 0 -> blue 0 guard baked into lut_b."""
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    # (vf^g * 255).round().clamp(0,255) as u8: round, then clamp
    lut_r = np.clip(_round_half_away_f32(np.power(v, GAMMA_R) * np.float32(255.0)), 0, 255).astype(np.uint8)
    lut_g = np.clip(_round_half_away_f32(np.power(v, GAMMA_G) * np.float32(255.0)), 0, 255).astype(np.uint8)

    r = lut_r.astype(np.float32)[:, None]  # indexed by b1
    g = lut_g.astype(np.float32)[None, :]  # indexed by b2
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = r / g  # g == 0 -> inf; 0/0 -> nan
        blue_f = np.power(ratio, GAMMA_B) * np.float32(255.0) * BLUE_SCALE
    # (ratio^g * 255 * 0.24).clamp(0,255).round() as u8: clamp, then round
    blue_f = np.nan_to_num(blue_f, nan=0.0, posinf=np.inf)
    blue = _round_half_away_f32(np.clip(blue_f, 0.0, 255.0)).astype(np.uint8)
    blue[:, 0] = 0  # band2 == 0 -> blue = 0 (reference: :38-39)
    return lut_r, lut_g, blue.reshape(-1)


@functools.lru_cache(maxsize=4)
def default_table_set(device: torch.device) -> torch.Tensor:
    """(1, 66048) u8 on `device`: [lut_r | lut_g | lut_b] of
    `default_luts()`."""
    return torch.from_numpy(np.concatenate(default_luts())[None]).to(
        device, non_blocking=True)


def suppressed_luts(floor_with_cushion: int):
    """LUTs for the maritime-suppressed mapping: (lut_r (256,), lut_g
    (256,), lut_b (65536,) flat index b1 * 256 + b2), u8."""
    floor = np.float32(floor_with_cushion)
    denom = np.float32(max(255.0 - float(floor_with_cushion), 1.0))
    v = np.arange(256, dtype=np.float32)
    shifted = (v - floor) / denom
    r_f = _round_half_away_f32(np.power(shifted, GAMMA_R_SUPP, where=shifted > 0, out=np.zeros_like(shifted)) * np.float32(255.0))
    g_f = _round_half_away_f32(np.power(shifted, GAMMA_G_SUPP, where=shifted > 0, out=np.zeros_like(shifted)) * np.float32(255.0))
    lut_r = np.clip(r_f, 0, 255).astype(np.uint8)
    lut_g = np.clip(g_f, 0, 255).astype(np.uint8)
    below = v <= floor  # `(v as u8) <= floor_with_cushion` (reference: :125)
    lut_r[below] = 0
    lut_g[below] = 0

    r = lut_r.astype(np.float32)[:, None]
    g = lut_g.astype(np.float32)[None, :]
    ratio = (r + EPS_SUPP) / (g + EPS_SUPP)
    blue_f = np.power(ratio, GAMMA_B) * np.float32(255.0) * BLUE_SCALE_SUPP
    blue = _round_half_away_f32(np.clip(blue_f, 0.0, 255.0)).astype(np.uint8)
    return lut_r, lut_g, blue.reshape(-1)


@functools.lru_cache(maxsize=1)
def _suppressed_table_sets_np() -> np.ndarray:
    return np.stack([np.concatenate(suppressed_luts(f))
                     for f in range(FLOOR_MIN, FLOOR_MAX + 1)])


@functools.lru_cache(maxsize=4)
def suppressed_table_sets(device: torch.device) -> torch.Tensor:
    """(38, 66048) u8 on `device`: for floor f, row f - 3 holds
    [lut_r | lut_g | lut_b] of `suppressed_luts(f)` (about 2.5 MB)."""
    return torch.from_numpy(_suppressed_table_sets_np()).to(
        device, non_blocking=True)


def create_synthetic_rgb(band1: torch.Tensor,
                         band2: torch.Tensor) -> torch.Tensor:
    """Default synRGB (reference: synthetic_rgb.rs:10-67): the one default
    table set, no set index and no water mask. u8 bands of one shape in,
    (..., 3) u8 out."""
    rgb = synrgb_lookup(band1.reshape(-1), band2.reshape(-1),
                        default_table_set(band1.device))
    return rgb.reshape(band1.shape + (3,))


def _suppressed_floor(band1: torch.Tensor, band2: torch.Tensor) -> int:
    """Combined-histogram p05 floor with cushion, on the host (reference:
    synthetic_rgb.rs:92-113): the two bands' 256-bin histogram (one count
    over both, no concatenated copy), copied back."""
    hist = histogram((band1.reshape(-1), band2.reshape(-1)), 256)
    hist = hist.cpu().numpy().astype(np.uint64)
    total = int(band1.numel() + band2.numel())
    target = int(np.floor(total * 0.05 + 0.5))  # .round() as u32, non-negative
    cum = np.cumsum(hist)
    floor_value = 0
    idx = np.nonzero(cum >= target)[0]
    if idx.size:
        floor_value = int(idx[0])
    return min(floor_value + FLOOR_MIN, FLOOR_MAX)


def create_synthetic_rgb_suppressed(band1: torch.Tensor,
                                    band2: torch.Tensor) -> torch.Tensor:
    """Maritime-suppressed synRGB (reference: synthetic_rgb.rs:88-178): the
    host floor picks the `suppressed_luts(floor)` set, and pixels whose
    bands are both at or below the floor become black."""
    floor_c = _suppressed_floor(band1, band2)
    dev = band1.device
    rgb = synrgb_lookup(
        band1.reshape(-1), band2.reshape(-1), suppressed_table_sets(dev),
        set_index=torch.full((), floor_c - FLOOR_MIN, dtype=torch.int32,
                             device=dev),
        water_floor=torch.full((), floor_c, dtype=torch.int32, device=dev))
    return rgb.reshape(band1.shape + (3,))


def create_synthetic_rgb_by_mode(mode: SyntheticRgbMode, band1,
                                 band2) -> torch.Tensor:
    """All modes currently alias Default (reference: synthetic_rgb.rs:72-79)."""
    return create_synthetic_rgb(band1, band2)


def create_synthetic_rgb_by_mode_and_strategy(
    mode: SyntheticRgbMode, strategy: AutoscaleStrategy, band1, band2
) -> torch.Tensor:
    """Tamed/CLAHE -> suppressed mapping, otherwise default
    (reference: synthetic_rgb.rs:182-197)."""
    if strategy in (AutoscaleStrategy.TAMED, AutoscaleStrategy.CLAHE):
        return create_synthetic_rgb_suppressed(band1, band2)
    return create_synthetic_rgb_by_mode(mode, band1, band2)
