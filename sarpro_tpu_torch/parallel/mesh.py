"""Device meshes for scene-batch x row-shard processing (port of
sarpro_tpu/parallel/mesh.py).

A `Mesh` is a (scene, row) grid of `torch.device`s: scenes spread over the
scene axis, each scene's rows split over the row axis. One process drives
every device of it: the sharded programs (parallel/sharded.py,
parallel/warp.py, the mesh mode of core/streamed.py) queue each row block's
kernels on its own device and copy the small reductions to the lead device.
A device may appear more than once (`[cuda:0] * 4` splits a scene four ways
on one card).

The devices a caller has are `cuda:0 .. count - 1` for a CUDA caller and
`HOST_DEVICE_COUNT` entries of `cpu` for a CPU caller (the counterpart of
XLA's `--xla_force_host_platform_device_count`; tests set it to 8).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# the devices a CPU caller has: this many entries of `cpu`
HOST_DEVICE_COUNT = 1


class Mesh:
    """A (scene, row) grid of torch devices; `shape` maps the axis names
    to their lengths, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        if not self.devices or any(len(r) != len(self.devices[0]) or not r
                                   for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape = {"scene": len(self.devices),
                      "row": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """The device the reductions and the gathered outputs land on."""
        return self.devices[0][0]

    def row_devices(self, scene_group: int = 0) -> list[torch.device]:
        """The devices of one scene group, in row-block order."""
        return self.devices[scene_group]


def _indexed(d) -> torch.device:
    """`d` as a tensor's `.device` reads: "cuda" is the current card's
    index, so a block on the lead's card is known to share its memory."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def available_devices(device="cuda") -> list[torch.device]:
    """The devices a caller on `device` has: every CUDA device for a CUDA
    caller (RuntimeError without CUDA), `HOST_DEVICE_COUNT` CPUs for a CPU
    caller."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but CUDA is not "
                               "available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")] * HOST_DEVICE_COUNT
    raise ValueError(f"no mesh for device type {kind!r}")


def _factor(n: int) -> tuple[int, int]:
    """Split n devices into (scene, row) — favor scene parallelism, keep the
    row axis a power-of-two divisor for clean histogram reductions."""
    best = (n, 1)
    for rows in (1, 2, 4, 8):
        if n % rows == 0:
            best = (n // rows, rows)
            if rows >= 2 and n // rows >= 2:
                return best
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[tuple[int, int]] = None,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (scene, row) mesh over the first `n_devices` of `devices` (by
    default the devices a caller on `device` has, `available_devices`),
    shaped `shape` or `_factor(n_devices)`. A CUDA device in the mesh
    without CUDA raises RuntimeError."""
    if devices is None:
        devices = available_devices(device)
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but CUDA is not "
                           "available")
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} "
                         "given")
    devices = devices[:n_devices]
    if shape is None:
        shape = _factor(n_devices)
    s, r = shape
    if s * r != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} "
                         "devices")
    return Mesh([devices[i * r:(i + 1) * r] for i in range(s)])


def combine(parts, fn, lead: torch.device) -> torch.Tensor:
    """The row blocks' partial results (a count, an extremum, a histogram)
    folded in order by `fn` (torch.add, torch.minimum, torch.maximum) on
    the lead device."""
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = fn(acc, p.to(lead))
    return acc


def to_each(t: torch.Tensor, devices) -> list:
    """A lead-device scalar or table copied to each block's device."""
    return [t.to(d) for d in devices]
