"""Row-sharded warp sampling (port of sarpro_tpu/parallel/warp.py).

The warp's output rows are independent (the inverse mapping is a pure
gather), so the output splits into blocks of ceil(out_rows / n) rows, one a
device of the mesh's row axis; every device samples its block against a
replica of the source. Replication is the right layout: a reprojection may
read any part of the source from any block (rotation, thin-plate spline),
and the sampled source is the small side, since the two-stage plan
(io/warp.two_stage_plan) reduces a strong shrink to ~1.25x the output
first.

Each block is one `ops.warp_sample` launch with its `row0` and `rows`: the
kernel keeps the whole output's grid scales and global row coordinates, so
a block equals the same rows of the unsharded output bit for bit. The
blocks are gathered in order on the lead device. A failed launch raises;
there is no other sampler to fall back to.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.raster import plan_grids_to_device
from ..ops.warp_kernel import warp_sample
from .mesh import Mesh, available_devices, make_mesh

logger = logging.getLogger("sarpro")


def make_row_mesh(n: int, device="cuda") -> Mesh:
    """A (1, n) mesh over the first `n` devices a caller on `device` has."""
    return make_mesh(n, shape=(1, n), device=device)


def shard_mesh(shard_devices: int, device) -> Mesh | None:
    """The warp's row mesh for a shard request (0 none, -1 every device),
    or None where fewer than 2 devices would take part (the unsharded
    sampler runs, with no warning: the device programs log it)."""
    if not shard_devices:
        return None
    avail = len(available_devices(device))
    n = avail if shard_devices < 0 else min(shard_devices, avail)
    return make_row_mesh(n, device) if n >= 2 else None


def warp_sample_sharded(src, map_x, map_y, out_rows: int, out_cols: int,
                        method: str, mesh: Mesh) -> torch.Tensor | None:
    """The warp sampler's contract (io/warp, ops.warp_sample) over `mesh`'s
    row axis: `src` an f32 (H, W) tensor or array, `map_x` / `map_y` the
    host (gh, gw) grids. Returns the (out_rows, out_cols) f32 output on the
    mesh's lead device, or None for a row axis under 2 devices."""
    devices = mesh.row_devices()
    n = len(devices)
    if n < 2:
        return None
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src, np.float32))
    block = -(-out_rows // n)
    parts = []
    replicas: dict = {}
    for k, dev in enumerate(devices):
        row0 = k * block
        rows = min(block, out_rows - row0)
        if rows <= 0:
            break
        if dev not in replicas:  # one source and grid copy a device
            replicas[dev] = (src.to(dev, torch.float32).contiguous(),
                             *plan_grids_to_device(map_x, map_y, dev))
        parts.append(warp_sample(*replicas[dev], out_rows, out_cols, method,
                                 row0=row0, rows=rows).to(mesh.lead))
    logger.info("Warp: sampler over %d devices", n)
    return torch.cat(parts)
