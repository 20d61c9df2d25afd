"""Per-stage timing and the torch profiler (port of
sarpro_tpu/utils/profiling.py).

The same interface as the JAX module: `StageTimer.stage(...)` and `block`
record the host's wall time until the given values are ready on their
device, `report()` prints the JAX module's table, `trace(logdir)` wraps
`torch.profiler` (a Chrome trace in `logdir`, for TensorBoard or Perfetto)
and `device_memory_stats()` reads the CUDA caching allocator.

A CUDA value is ready when an event recorded on its device's current
stream after the work has completed: the wait is on that event, never on
the whole device. CPU tensors are ready when the call returns.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any

import torch


def _tensors(value: Any):
    """The tensors in a value: a tensor, or tuples, lists and dict values of
    them (the pytrees `jax.block_until_ready` takes)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def _wait(*values) -> None:
    """Wait until the device work behind `values` has run: one event on the
    current stream of each CUDA device they lie on, synchronized."""
    for device in {t.device for v in values for t in _tensors(v)
                   if t.is_cuda}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class StageTimer:
    """Accumulates per-stage timings across a run."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *tensors):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _wait(*tensors)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def block(self, name: str, value: Any) -> Any:
        """Time the completion of a device value under `name`."""
        t0 = time.perf_counter()
        _wait(value)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return value

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<30} {tot * 1000:9.2f} ms  x{n}"
                         f"  ({tot / max(n, 1) * 1000:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """A torch.profiler trace of the block, written as a Chrome trace
    (`*.pt.trace.json`) into `logdir`: host operations, and the kernels and
    copies of the card when `device` is a CUDA device (RuntimeError when
    CUDA is asked for and absent)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def device_memory_stats(device="cuda") -> dict:
    """The caching allocator's memory on `device`: bytes in use, the peak
    since the last `torch.cuda.reset_peak_memory_stats`, and the card's
    total memory. {} for a device without such stats (the CPU, or no
    CUDA), as the JAX function returns where a device has none."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
