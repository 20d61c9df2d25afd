"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

The kernels are CUDA C++ for Hopper (sm_90a) with a plain C interface.
They compile with nvcc into one shared library that ctypes loads, at first
use, into `build/sarpro_tpu_torch/` under the checkout root. The library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

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
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sarpro_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sarpro_histogram": [_P, _L, _P, _L, _I, _I, _P, _P],
    "sarpro_resample_axis0": [_P, _I, _L, _L, _P, _P, _I, _P, _L, _P],
    "sarpro_synrgb_lookup": [_P, _P, _L, _P, _L, _P, _P, _P, _P],
}

LAUNCHES = {"histogram": 0, "resample_axis0": 0, "synrgb_lookup": 0}

_LIB: ctypes.CDLL | None = None
# (seconds, nvcc's stderr) of the build this process ran; None when the
# library was already built
BUILD_INFO: tuple[float, str] | None = None
_FORCE_PLAIN = False


class force_plain:
    """Context manager (test and comparison use): route every wrapper to its
    plain PyTorch version, CUDA tensors included."""

    def __enter__(self):
        global _FORCE_PLAIN
        self._prev = _FORCE_PLAIN
        _FORCE_PLAIN = True
        return self

    def __exit__(self, *exc):
        global _FORCE_PLAIN
        _FORCE_PLAIN = self._prev
        return False


def use_kernel(t: torch.Tensor) -> bool:
    """True when `t` lies on a CUDA device and the plain versions are not
    forced: the wrapper then launches its kernel (or raises)."""
    return t.is_cuda and not _FORCE_PLAIN


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


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if needed."""
    global _LIB, BUILD_INFO
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libsarpro_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never loads a part
        BUILD_INFO = (time.perf_counter() - t0, res.stderr)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def launch(name: str, counter: str, device: torch.device, *args) -> None:
    """Call kernel entry `name` on `device`'s current stream (appended as the
    last argument), raise on a refused launch, and count it."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[counter] += 1
