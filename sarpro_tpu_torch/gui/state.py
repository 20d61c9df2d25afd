"""GUI state model + background processing worker (port of
sarpro_tpu/gui/state.py).

The worker runs every job on the device it was given (the card unless the
caller asks for the CPU), on a thread of its own for each job: the API
functions queue every kernel and copy of a job on the thread that calls
them, so the HTTP handler threads never touch the device. A failed job is
reported as {"ok": false, "error": ...}, as in the JAX worker; nothing
runs it again elsewhere. `generate_cli_command` names the port's console
script, `sarpro-torch`; `save_preset`, `load_preset` and `system_stats` are
copies (tests/test_torch_host_copies.py).

Mirrors the reference's `SarproGui` state struct (src/gui/models.rs:39-86),
its worker-thread + completion-channel pattern (src/gui/processing.rs:451-549),
preset files (models.rs:208-341), the CLI command generator (models.rs:343-433)
and the system monitor footer (models.rs:436-463).
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from pathlib import Path
from typing import Optional

from .. import api
from ..params import ProcessingParams
from ..utils.logging import get_ring_handler

logger = logging.getLogger("sarpro")


@dataclasses.dataclass
class GuiState:
    """Processing configuration + run status."""

    mode: str = "single"  # single | batch
    input_path: str = ""
    output_path: str = ""
    input_dir: str = ""
    output_dir: str = ""
    params: ProcessingParams = dataclasses.field(default_factory=ProcessingParams)
    prefetch: int = 2
    fast: bool = False
    shard_devices: int = 0
    # run status
    running: bool = False
    last_result: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "input_path": self.input_path,
            "output_path": self.output_path,
            "input_dir": self.input_dir,
            "output_dir": self.output_dir,
            "params": self.params.to_dict(),
            "prefetch": self.prefetch,
            "fast": self.fast,
            "shard_devices": self.shard_devices,
            "running": self.running,
            "last_result": self.last_result,
        }

    def apply(self, d: dict) -> None:
        self.mode = d.get("mode", self.mode)
        self.input_path = d.get("input_path", self.input_path)
        self.output_path = d.get("output_path", self.output_path)
        self.input_dir = d.get("input_dir", self.input_dir)
        self.output_dir = d.get("output_dir", self.output_dir)
        self.prefetch = int(d.get("prefetch", self.prefetch))
        self.fast = bool(d.get("fast", self.fast))
        self.shard_devices = int(d.get("shard_devices", self.shard_devices))
        if "params" in d:
            self.params = ProcessingParams.from_dict(d["params"])


def generate_cli_command(state: GuiState) -> str:
    """Equivalent CLI invocation (reference: models.rs:343-433)."""
    p = state.params
    parts = ["sarpro-torch"]
    if state.mode == "batch":
        parts += ["--input-dir", state.input_dir or "<input-dir>",
                  "--output-dir", state.output_dir or "<output-dir>"]
    else:
        parts += ["-i", state.input_path or "<input.SAFE>",
                  "-o", state.output_path or "<output>"]
    parts += ["-f", p.format.value]
    if p.bit_depth.value != "u8":
        parts += ["--bit-depth", p.bit_depth.value]
    if p.polarization.cli_value != "vv":
        parts += ["--polarization", p.polarization.cli_value]
    parts += ["--autoscale", p.autoscale.value]
    if p.size is not None:
        parts += ["--size", str(p.size)]
    if p.pad:
        parts += ["--pad"]
    if p.target_crs:
        parts += ["--target-crs", p.target_crs]
    if p.resample_alg and p.resample_alg != "lanczos":
        parts += ["--resample-alg", p.resample_alg]
    if p.synrgb_mode.value != "default":
        parts += ["--synrgb-mode", p.synrgb_mode.value]
    if state.mode == "batch" and state.prefetch:
        parts += ["--prefetch", str(state.prefetch)]
    if state.fast:
        parts += ["--fast"]
    if state.shard_devices:
        parts += ["--shard-devices", str(state.shard_devices)]
    return " ".join(parts)


def save_preset(state: GuiState, path) -> None:
    """Preset as commented JSON (.sarpro) — reference: models.rs:208-341."""
    header = (
        "// SARPRO processing preset\n"
        "// Generated by sarproUI (sarpro-tpu)\n"
        f"// {time.strftime('%Y-%m-%d %H:%M:%S')}\n"
    )
    Path(path).write_text(header + state.params.to_json())


def load_preset(state: GuiState, path) -> None:
    state.params = ProcessingParams.from_json(Path(path).read_text())


def system_stats() -> dict:
    """CPU load + RAM footer (reference: models.rs:436-463, sysinfo)."""
    stats = {}
    try:
        load1, _, _ = os.getloadavg()
        stats["load1"] = round(load1, 2)
        stats["cpus"] = os.cpu_count()
    except OSError:
        pass
    try:
        info = {}
        with open("/proc/meminfo") as fh:
            for line in fh:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0])
        stats["mem_total_mb"] = info.get("MemTotal", 0) // 1024
        stats["mem_used_mb"] = (
            info.get("MemTotal", 0) - info.get("MemAvailable", 0)
        ) // 1024
    except (OSError, ValueError):
        pass
    return stats


class Worker:
    """Background processing thread + completion queue
    (reference: src/gui/processing.rs:451-549) on `device`, resolved once:
    RuntimeError when CUDA is asked for and absent."""

    _jobs = itertools.count(1)

    def __init__(self, device="cuda"):
        self.device = api._device(device)
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.ring = get_ring_handler()
        # live batch progress {"done", "total", "current"} — written by the
        # worker thread's progress callback, read by /api/state (atomic dict
        # swap, no lock needed)
        self.progress: Optional[dict] = None

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, state: GuiState) -> bool:
        if self.busy():
            return False
        snapshot = GuiState(
            mode=state.mode,
            input_path=state.input_path,
            output_path=state.output_path,
            input_dir=state.input_dir,
            output_dir=state.output_dir,
            params=ProcessingParams.from_dict(state.params.to_dict()),
            prefetch=state.prefetch,
            fast=state.fast,
            shard_devices=state.shard_devices,
        )
        device = self.device

        def on_progress(done, total, current):
            self.progress = {"done": done, "total": total,
                             "current": current}

        def run():
            t0 = time.perf_counter()
            result = {"ok": True}
            self.progress = None
            try:
                if snapshot.mode == "batch":
                    from ..parallel.batch import process_directory_pipelined

                    if snapshot.prefetch > 0:
                        report = process_directory_pipelined(
                            snapshot.input_dir, snapshot.output_dir,
                            snapshot.params, True, snapshot.prefetch,
                            fast=snapshot.fast, progress=on_progress,
                            shard_devices=snapshot.shard_devices,
                            device=device,
                        )
                    else:
                        report = api.process_directory_to_path(
                            snapshot.input_dir, snapshot.output_dir,
                            snapshot.params, True, fast=snapshot.fast,
                            progress=on_progress,
                            shard_devices=snapshot.shard_devices,
                            device=device,
                        )
                    result["report"] = {
                        "processed": report.processed,
                        "skipped": report.skipped,
                        "errors": report.errors,
                    }
                else:
                    out = snapshot.output_path
                    if not out:
                        ext = snapshot.params.format.extension
                        out = str(Path(snapshot.input_path).with_suffix(f".{ext}"))
                    api.process_safe_to_path(
                        snapshot.input_path, out, snapshot.params,
                        fast=snapshot.fast,
                        shard_devices=snapshot.shard_devices, device=device,
                    )
                    result["output"] = out
            except Exception as e:  # noqa: BLE001 — reported to the UI
                logger.warning("Processing failed: %s", e)
                result = {"ok": False, "error": str(e)}
            result["elapsed_s"] = round(time.perf_counter() - t0, 3)
            self._queue.put(result)

        self._thread = threading.Thread(
            target=run, daemon=True,
            name=f"sarpro-gui-job-{next(self._jobs)}")
        self._thread.start()
        return True

    def poll(self) -> Optional[dict]:
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None
