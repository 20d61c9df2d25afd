"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

The kernels are CUDA C++ for Hopper (sm_90a) with a plain C interface.
At first use each source compiles with its own nvcc, all at once, and the
objects link into one shared library under `build/sarpro_tpu_torch/` (below
the checkout root) that ctypes loads. The library's file name carries a
hash of the sources, their headers (*.cuh) and the flags, so an edited
source rebuilds and an unchanged one loads at once.

Launch counts live here: each wrapper adds one to its count where it
launches its kernel, and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sarpro_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "sarpro_histogram": [_P, _L, _P, _L, _I, _I, _P, _P],
    "sarpro_resample_axis0": [_P, _I, _L, _L, _P, _P, _I, _P, _L, _P],
    "sarpro_synrgb_lookup": [_P, _P, _L, _P, _L, _P, _P, _P, _P],
    "sarpro_tile_histogram": [_P, _L, _I, _I, _I, _I, _I, _L, _I, _P, _P],
    "sarpro_clahe_lookup": [_P, _L, _P, _I, _I, _I, _I, _I, _I, _L, _P, _P],
    "sarpro_warp_sample": [_P, _I, _I, _P, _P, _I, _I, _F, _F, _I, _P, _I,
                           _I, _I, _P],
    "sarpro_warp_tiles": [_I, _I, _P, _P, _I, _I, _F, _F, _I, _P, _I, _I, _I,
                          _P],
}

LAUNCHES = {"histogram": 0, "resample_axis0": 0, "synrgb_lookup": 0,
            "tile_histogram": 0, "clahe_lookup": 0, "warp_sample": 0}

_LIB: ctypes.CDLL | None = None
# (seconds, nvcc's stderr) of the build this process ran; None when the
# library was already built
BUILD_INFO: tuple[float, str] | None = None
# force_plain() holds for the thread that entered it: a comparison run on
# one thread never sends the launches of a job on another thread (the GUI's
# worker) to the plain versions
_PLAIN = threading.local()


class force_plain:
    """Context manager (test and comparison use): route every wrapper
    called on this thread to its plain PyTorch version, CUDA tensors
    included."""

    def __enter__(self):
        self._prev = plain_forced()
        _PLAIN.on = True
        return self

    def __exit__(self, *exc):
        _PLAIN.on = self._prev
        return False


def plain_forced() -> bool:
    """True inside force_plain() on the calling thread."""
    return getattr(_PLAIN, "on", False)


def use_kernel(t: torch.Tensor) -> bool:
    """True when `t` lies on a CUDA device and the plain versions are not
    forced on this thread: the wrapper then launches its kernel (or
    raises)."""
    return t.is_cuda and not plain_forced()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _build(sources: list[Path], so: Path) -> str:
    """One nvcc per source, all started together, then one link into `so`;
    returns nvcc's stderr (ptxas's register and shared-memory report)."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    # nvcc tells an object from a source by its suffix: keep ".o" last
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    tmp = so.with_name(f"{so.name}.{tag}")
    try:
        logs = []
        for src, p in zip(sources, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{err}")
            logs.append(err)
        res = subprocess.run([nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never loads a part
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in [*objs, tmp]:
            f.unlink(missing_ok=True)
    return "".join(logs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if needed."""
    global _LIB, BUILD_INFO
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the headers too
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libsarpro_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(sources, so)
        BUILD_INFO = (time.perf_counter() - t0, log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def launch(name: str, counter: str | None, device: torch.device,
           *args) -> None:
    """Call kernel entry `name` on `device`'s current stream (appended as the
    last argument), raise on a refused launch, and count it under `counter`
    (None: an inspection entry, not counted)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    if counter is not None:
        LAUNCHES[counter] += 1
