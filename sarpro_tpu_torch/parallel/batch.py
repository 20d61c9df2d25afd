"""Pipelined batch driver on one GPU (port of sarpro_tpu/parallel/batch.py).

The reference's batch mode is a serial loop (src/cli/runner.rs:294-340,
src/api/mod.rs:484-533); `api.process_directory_to_path` is its port. Here
a pool of loader threads reads the next scenes while the device works on
the current one, and one writer thread entropy-codes and writes while the
device starts the next scene. Unsupported products are skipped, failures
counted, and the batch goes on, as in the reference.

Unlike the JAX driver, whose loaders also run the warp's device programs
(sarpro_tpu/io/safe.py:618-621), the loader threads here run only the host
half of each read (`api._Route.read`: parse, plan the warp, read and
box-reduce into host memory). The calling (consumer) thread runs every
device half, kernel and copy; the writer thread gets host arrays only. The
loaders reduce into pinned buffers that the consumer allocates and recycles
(`_PinnedStaging`); no loader allocates pinned memory.
"""
from __future__ import annotations

import concurrent.futures
import logging
import math
import threading
from pathlib import Path
from typing import Optional

import torch

from ..api import (
    BatchReport,
    _device,
    _route,
    iterate_safe_products,
    scene_skip_reason,
)
from ..core import fast_path
from ..io import raster
from ..io.safe import HostScene, upload_scene
from ..params import ProcessingParams
from ..types import OutputFormat, ProcessingOperation

logger = logging.getLogger("sarpro")


class _PinnedStaging(raster.HostStaging):
    """Host buffers the loaders reduce bands into, pinned on a GPU so the
    consumer's uploads are DMA reads in stream order. The consumer thread
    allocates them (a pinned allocation goes through the CUDA driver and
    takes its locks) and recycles each once the device work queued after
    its upload has run. A loader only takes a free buffer, and reduces into
    pageable memory when none is free or large enough; a load that fails
    gives its buffers back."""

    def __init__(self, device: torch.device, nbytes: int, count: int,
                 most: int):
        self._device, self._nbytes, self._most = device, nbytes, most
        self._free: list = []
        self._lent: dict = {}  # data pointer -> buffer, per band in use
        self._parked: list = []  # (event or None, buffers)
        self._made = 0
        self._lock = threading.Lock()
        self._loads = threading.local()  # the buffers lent to a thread's load
        self._grow(count)

    def _grow(self, count: int) -> None:
        """Allocate up to `count` more buffers (consumer thread)."""
        pinned = self._device.type == "cuda"
        bufs = [torch.empty(self._nbytes, dtype=torch.uint8,
                            pin_memory=pinned)
                for _ in range(min(count, self._most - self._made))]
        self._made += len(bufs)
        with self._lock:
            self._free.extend(bufs)

    def host(self, shape, dtype):
        """A (shape, dtype) CPU tensor (loader threads)."""
        n = math.prod(shape) * dtype.itemsize
        with self._lock:
            buf = next((b for b in self._free if b.numel() >= n), None)
            if buf is not None:
                self._free.remove(buf)
                self._lent[buf.data_ptr()] = buf
        if buf is None:
            return torch.empty(shape, dtype=dtype)
        getattr(self._loads, "lent", []).append(buf)
        return buf[:n].view(dtype).view(shape)

    def begin(self) -> None:
        """A loader starts a scene (loader threads)."""
        self._loads.lent = []

    def abandon(self) -> None:
        """The loader's scene failed before any upload: its buffers are free
        again (loader threads)."""
        with self._lock:
            for buf in self._loads.lent:
                if self._lent.pop(buf.data_ptr(), None) is not None:
                    self._free.append(buf)
        self._loads.lent = []

    def release(self, scene: HostScene) -> None:
        """Park the buffers of `scene`'s bands until the device work queued
        so far has run (consumer thread, after the scene's work)."""
        with self._lock:
            bufs = [self._lent.pop(b.data.data_ptr()) for b in scene.bands
                    if b.data.data_ptr() in self._lent]
        if not bufs:
            return
        event = None
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        with self._lock:
            self._parked.append((event, bufs))

    def reclaim(self, want: int) -> None:
        """Free the parked buffers whose work has run, and allocate more
        while fewer than `want` are free (consumer thread)."""
        with self._lock:
            parked, self._parked = self._parked, []
        keep = []
        for event, bufs in parked:
            if event is None or event.query():
                with self._lock:
                    self._free.extend(bufs)
            else:
                keep.append((event, bufs))
        with self._lock:
            self._parked.extend(keep)
            short = want - len(self._free)
        if short > 0:
            self._grow(short)


class _SceneLoad:
    def __init__(self, path: Path, route=None, scene=None,
                 error: Optional[Exception] = None, skipped: bool = False):
        self.path = path
        self.route = route
        self.scene = scene
        self.error = error
        self.skipped = skipped


def _load_scene(path: Path, params: ProcessingParams, fast: bool,
                device: torch.device, direct_io: bool = True,
                staging: Optional[_PinnedStaging] = None,
                shard_devices: int = 0) -> _SceneLoad:
    """A loader thread's work: the viability check, then the host half of
    the scene's read. Touches no device: a sharded warp runs in the
    route's device half, on the consumer."""
    # batch scans touch each scene once: O_DIRECT keeps the read out of the
    # page cache; set for this loader thread only
    raster.DIRECT_IO.set(bool(direct_io))
    if staging is not None:
        staging.begin()
    try:
        try:
            reason = scene_skip_reason(path, params)
        except Exception:
            reason = "unreadable product metadata"
        if reason is not None:
            logger.warning("Skipping %s: %s", path, reason)
            return _SceneLoad(path, skipped=True)
        route = _route(path, params, fast, device, shard_devices)
        return _SceneLoad(path, route=route, scene=route.read(path, staging))
    except Exception as e:  # noqa: BLE001 — batch isolation boundary
        if staging is not None:
            staging.abandon()
        return _SceneLoad(path, error=e)


def _staging_bytes(size: int) -> int:
    """A staging buffer's size: a reduced plane of a `size` read, or the
    ~1.25x-output source of a warp's host pre-reduce, in f32."""
    return 4 * math.ceil(1.5 * size) ** 2


def process_directory_pipelined(
    input_dir,
    output_dir,
    params: ProcessingParams,
    continue_on_error: bool = True,
    prefetch: int = 2,
    resume: bool = False,
    fast: bool = False,
    device_batch: int = 4,
    progress=None,
    shard_devices: int = 0,
    direct_io: bool = True,
    device="cuda",
):
    """Batch all SAFE subdirectories with `prefetch` scenes loading ahead,
    computing on `device`.

    Loader threads (`max(prefetch, 1)`, `prefetch + 1` loads pending) run
    the host half of each scene's read; this thread runs its device half
    and programs. In fast mode the write goes to one writer thread (at most
    2 waiting), so the device starts scene N+1 while scene N is coded.

    `device_batch > 1` (fast multiband JPEG with a target size) gathers
    scenes of one post-read (rows, cols) and pair into buckets, each run by
    `fast_path.save_multiband_batch_fast` with one host sync. The kernels
    are the per-scene route's, so a bucketed file equals the per-scene one.
    Staged scenes are capped at max(8, 2 * device_batch): past it the
    oldest partial bucket runs per scene; partial buckets at the end of
    input run per scene.

    `direct_io` (default on) reads the loaders' host box reduce by O_DIRECT
    chunks (io/raster.py); a file system that refuses O_DIRECT gets the
    buffered read.

    `shard_devices` (N >= 2, or -1) shards each scene over the caller's
    devices as `api.process_safe_to_path` does: it implies fast mode and
    turns bucketing off (each scene already spans the mesh).

    A failed band-1 stage or bucket dispatch counts as the error of its
    scene (or scenes), as any other failure does; nothing is retried.
    `progress(done, total, current_name)` is called as scenes finish; its
    exceptions are ignored. Returns a BatchReport.
    """
    device = _device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report = BatchReport()
    paths = list(iterate_safe_products(input_dir))
    total_scenes = len(paths)
    current_scene = [None]
    ext = params.format.extension

    def tick(current=None):
        """`progress(done, total, current_name)`; exceptions in the
        observer must not affect the batch."""
        if current is not None:
            current_scene[0] = current
        if progress is not None:
            try:
                progress(report.processed + report.skipped + report.errors,
                         total_scenes, current_scene[0])
            except Exception:  # noqa: BLE001
                pass

    if resume:
        kept = []
        for p in paths:
            if (output_dir / f"{p.name}.{ext}").exists():
                logger.info("Resume: output exists, skipping %s", p)
                report.skipped += 1
                tick()
            else:
                kept.append(p)
        paths = kept
    if not paths:
        return report

    if shard_devices:
        # sharding implies fast mode and spans the mesh with each scene, so
        # the bucketing that spreads scenes over the devices is off
        fast = True
        if device_batch > 1:
            logger.info("shard-devices set: device-batch bucketing disabled "
                        "(each scene already spans the mesh)")
            device_batch = 1
    bucketing = (fast and device_batch > 1
                 and params.polarization.kind == "multiband"
                 and params.format is OutputFormat.JPEG
                 and params.size is not None)
    cap = max(8, 2 * device_batch)
    in_flight = max(prefetch, 1) + 1
    staging = None
    if params.size is not None:  # original-size reads stay pageable
        # two bands a scene, for the pending loads and the one in hand (and
        # the staged buckets, grown to on demand)
        staging = _PinnedStaging(
            device, _staging_bytes(params.size), 2 * in_flight,
            2 * (in_flight + 1 + (cap if bucketing else 0)))
    buckets: dict = {}
    # deferred writes (fast mode), resolved as they finish so the counters
    # stay accurate; at most 2 wait for the writer thread
    write_futs: list = []

    def count_error(path, what, e):
        logger.warning("Error %s %s: %s", what, path, e)
        report.errors += 1
        tick()
        if not continue_on_error:
            raise e

    def drain_writes(block: bool = False):
        while write_futs:
            path, wfut = write_futs[0]
            if not block and not wfut.done():
                return
            write_futs.pop(0)
            try:
                wfut.result()
            except Exception as e:  # noqa: BLE001 — batch isolation boundary
                count_error(path, "writing", e)
            else:
                report.processed += 1
                logger.info("Processed: %s", path)
                tick()

    def record_write(path, wfut):
        if wfut is None:
            report.processed += 1
            logger.info("Processed: %s", path)
            tick()
            return
        write_futs.append((path, wfut))
        drain_writes()
        if len(write_futs) > 2:
            write_futs[0][1].exception()  # wait without raising here
            drain_writes()

    def run_scene(load: _SceneLoad):
        """Device half, programs and copy back of one scene on this
        thread; returns the deferred write's Future (None: written)."""
        out = output_dir / f"{load.path.name}.{ext}"
        try:
            scene = load.route.upload(load.scene)
            return load.route.save(scene, out, write_pool=writer_pool)
        finally:
            if staging is not None:
                staging.release(load.scene)

    def run_and_record(load: _SceneLoad):
        try:
            wfut = run_scene(load)
        except Exception as e:  # noqa: BLE001 — batch isolation boundary
            count_error(load.path, "processing", e)
            return
        record_write(load.path, wfut)

    def flush_bucket(key, per_scene: bool):
        items = buckets.pop(key, [])
        if per_scene or len(items) == 1:
            for load in items:
                run_and_record(load)
            return
        route = items[0].route
        op = (ProcessingOperation.MULTIBAND_VV_VH if key[1]
              else ProcessingOperation.MULTIBAND_HH_HV)

        # the bucket's scenes spread over the caller's devices
        devices = fast_path.bucket_devices(len(items), device)

        def scenes():  # each scene uploaded as its stages are queued
            for load, dev in zip(items, devices):
                s = upload_scene(load.scene, dev)
                yield (s.band1, s.band2,
                       output_dir / f"{load.path.name}.{ext}",
                       s.metadata)

        try:
            futs = fast_path.save_multiband_batch_fast(
                scenes(), params.size, params.pad, params.autoscale, op,
                params.synrgb_mode, resample_alg=route.alg0,
                write_pool=writer_pool)
        except Exception as e:  # noqa: BLE001 — the bucket's scenes fail
            logger.warning("device-batched bucket of %d scenes failed: %s",
                           len(items), e)
            for load in items:
                count_error(load.path, "processing", e)
            return
        finally:
            if staging is not None:
                for load in items:
                    staging.release(load.scene)
        for load, wfut in zip(items, futs):
            record_write(load.path, wfut)

    def stage(load: _SceneLoad):
        """Add a loaded scene to its bucket; run the bucket when full, or
        the oldest partial bucket past the staging cap."""
        key = (load.scene.bands[0].shape, bool(load.scene.is_vvvh))
        buckets.setdefault(key, []).append(load)
        if len(buckets[key]) >= device_batch:
            flush_bucket(key, per_scene=False)
            return
        # mixed shapes never fill their buckets: bound the staged scenes so
        # memory stays bounded and the device is not starved until the end
        while sum(len(v) for v in buckets.values()) > cap:
            victim = next((k for k in buckets if k != key), key)
            flush_bucket(victim, per_scene=True)

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(prefetch, 1),
            thread_name_prefix="sarpro-loader") as pool, \
         concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sarpro-writer") as writer_pool:
        pending: list = []
        it = iter(paths)

        def refill():
            if staging is not None:
                staging.reclaim(2)
            while len(pending) < in_flight:
                try:
                    p = next(it)
                except StopIteration:
                    return
                pending.append(pool.submit(_load_scene, p, params, fast,
                                           device, direct_io, staging,
                                           shard_devices))

        refill()
        while pending:
            fut = pending.pop(0)
            try:
                load = fut.result()
            except Exception as e:  # noqa: BLE001 — loader thread crashed
                logger.warning("Scene loader failed: %s", e)
                report.errors += 1
                tick()
                refill()
                if not continue_on_error:
                    raise
                continue
            refill()
            if load.skipped:
                report.skipped += 1
                tick()
                continue
            if load.error is not None:
                count_error(load.path, "loading", load.error)
                continue
            tick(load.path.name)
            if bucketing:
                stage(load)
            else:
                run_and_record(load)
        # end of input: partial buckets run per scene
        for key in list(buckets):
            flush_bucket(key, per_scene=True)
        drain_writes(block=True)
    return report
