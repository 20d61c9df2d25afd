"""The port's CPU dB and gamma do not hang on the host's math library.

PyTorch's CPU `log` and `pow` in f32 take other code under `MKL_CBWR` and
`ATEN_CPU_CAPABILITY` (MKL's and ATen's vector paths), and differ there by up
to tens of ulps on some inputs. The port takes both in f64 on the CPU and
rounds once to f32 (`core/numerics.log_f32` / `pow_f32`), so each child
below, one per setting, gives the same bytes for `fused._db_mask` and the
gamma's `pow_f32`, over the whole input and over a slice at an odd offset.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, sys
import numpy as np
import torch
from sarpro_tpu_torch.core import fused
from sarpro_tpu_torch.core.numerics import pow_f32

rng = np.random.default_rng(25)
dn = rng.gamma(1.5, 90.0, size=(96, 131)).astype(np.float32) + 0.5
dn[::7, ::5] = 0.0
dn[5, :40] = rng.uniform(1e-3, 1.0, 40)
x = torch.from_numpy(dn)
norm = torch.from_numpy(rng.uniform(0.0, 1.0, dn.shape).astype(np.float32))
out = []
for gamma in (0.6, 1.1, 2.2):
    e = torch.tensor(gamma, dtype=torch.float32)
    whole = pow_f32(norm, e)
    part = pow_f32(norm.reshape(-1)[33:].clone(), e)
    if not torch.equal(part, whole.reshape(-1)[33:]):
        sys.exit("pow at an odd offset differs from the whole")
    out.append(whole)
db, mask = fused._db_mask(x)
out += [db, mask]
part, _ = fused._db_mask(x.reshape(-1)[17:].clone())
if not torch.equal(part, db.reshape(-1)[17:]):
    sys.exit("dB at an odd offset differs from the whole")
h = hashlib.sha256()
for t in out:
    h.update(t.contiguous().numpy().tobytes())
print(h.hexdigest())
"""


def _settings():
    """(name, extra environment) for each setting the host can run."""
    out = [("MKL_CBWR unset", {}),
           ("MKL_CBWR=COMPATIBLE", {"MKL_CBWR": "COMPATIBLE"}),
           ("MKL_CBWR=AVX2", {"MKL_CBWR": "AVX2"}),
           ("ATEN_CPU_CAPABILITY=default", {"ATEN_CPU_CAPABILITY": "default"})]
    cap = torch.backends.cpu.get_cpu_capability()
    for level in ("AVX2", "AVX512"):
        if cap in ("AVX2", "AVX512") and (level == "AVX2" or cap == "AVX512"):
            out.append((f"ATEN_CPU_CAPABILITY={level.lower()}",
                        {"ATEN_CPU_CAPABILITY": level.lower()}))
    return out


def test_db_and_pow_bytes_do_not_hang_on_the_math_library():
    base = {k: v for k, v in os.environ.items()
            if k not in ("MKL_CBWR", "ATEN_CPU_CAPABILITY")}
    base["PYTHONPATH"] = ROOT + os.pathsep + base.get("PYTHONPATH", "")
    base["OMP_NUM_THREADS"] = "2"
    procs = []
    for name, extra in _settings():
        procs.append((name, subprocess.Popen(
            [sys.executable, "-c", CHILD], env={**base, **extra}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    digests = {}
    for name, p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"{name}: {err[-2000:]}"
        digests[name] = out.strip()
    assert len(set(digests.values())) == 1, "\n".join(
        f"{name}: {d}" for name, d in digests.items())
