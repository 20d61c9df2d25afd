"""Rounding and cast helpers matching the reference's Rust numerics (port
of sarpro_tpu/core/numerics.py), and the port's one place for uint16
casts."""
from __future__ import annotations

import torch


def round_half_up_nonneg(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5): equals Rust .round() for x >= 0 (the common case)."""
    return torch.floor(x + 0.5)


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` as f32; u16 DN converts through its int16 bit pattern (PyTorch
    builds differ in which casts they dispatch for uint16)."""
    if x.dtype == torch.uint16:
        x = x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.float32)


def u16_bits(x: torch.Tensor) -> torch.Tensor:
    """The int16 view (same bits) of a uint16 tensor, for gathers; other
    dtypes as they are."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x


def as_u16(q: torch.Tensor) -> torch.Tensor:
    """f32-held u16 values -> uint16 through the int16 bit pattern (casts to
    uint16 itself are missing from some PyTorch builds)."""
    return q.to(torch.int32).to(torch.int16).view(torch.uint16)


def trunc_sat_u16(x: torch.Tensor) -> torch.Tensor:
    """Rust `as u16` from float: NaN -> 0, truncate toward zero, saturate to
    [0, 65535]; uint16 out (through `as_u16`)."""
    return as_u16(torch.clamp(torch.trunc(torch.nan_to_num(x, nan=0.0)),
                              0.0, 65535.0))


def trunc_sat_u8(x: torch.Tensor) -> torch.Tensor:
    """Rust `as u8` from float: NaN -> 0, truncate, saturate to [0, 255]."""
    return torch.clamp(torch.trunc(torch.nan_to_num(x, nan=0.0)),
                       0.0, 255.0).to(torch.uint8)


# PyTorch's CPU f32 `log` and `pow` take MKL's or ATen's vector code as the
# host allows (MKL_CBWR, ATEN_CPU_CAPABILITY, the tail of a loop), and these
# differ by up to tens of ulps on some inputs. On the CPU both run in f64 and
# round once to f32, which gives the same bytes on every path; a CUDA tensor
# keeps the f32 op.
def log_f32(v: torch.Tensor) -> torch.Tensor:
    """Natural log of an f32 tensor, independent of the CPU's math path."""
    if v.device.type != "cpu":
        return torch.log(v)
    return torch.log(v.double()).float()


def pow_f32(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """`x ** e` for f32 tensors, independent of the CPU's math path."""
    if x.device.type != "cpu":
        return torch.pow(x, e)
    return torch.pow(x.double(), e.double()).float()
