#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sarpro_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. environment: a CUDA device is required; prints the card's name and
     power limit, the torch and CUDA versions; TF32 off;
  2. build: the native JPEG entropy coder (native/build.py) if absent, and
     the Hopper kernels (sarpro_tpu_torch/csrc) from source;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the slice gives it, with CUDA-event timings of both;
  4. slice: a 20000 x 20000 dual-pol SAFE (tests/fixtures.make_safe, random
     DN from a seed) through the port's CLI to a 2048 Tamed synRGB JPEG,
     twice with cubic resampling and once with the default filter; the warm
     run's kernel launch counts must all be positive; the JPEG's first MCUs
     are entropy-decoded and must equal the device's coefficient blocks;
  5. the device stages once more on the resident DN, with host syncs made
     errors, and under force_plain(); the bands must agree within 1.
Then one JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIDE = 20000  # 400 MP per band, the reference's published scene size
SIZE = 2048
RESAMPLE_TOL = dict(rtol=2e-6, atol=2e-2)
KERNELS = {
    "histogram": ("sarpro_tpu_torch/csrc/histogram.cu",
                  "sarpro_tpu/ops/kernels.py:107"),
    "resample_axis0": ("sarpro_tpu_torch/csrc/resample.cu",
                       "sarpro_tpu/ops/resample_kernel.py:87"),
    "synrgb_lookup": ("sarpro_tpu_torch/csrc/synrgb.cu",
                      "sarpro_tpu/ops/kernels.py:635"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_environment():
    if not (ROOT / "sarpro_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: the sarpro_tpu_torch package is not "
                         "beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def phase_build():
    if not (ROOT / "sarpro_tpu" / "_native" / "tiffcodec.so").exists():
        t0 = time.perf_counter()
        subprocess.run([sys.executable, str(ROOT / "native" / "build.py")],
                       check=True, capture_output=True, timeout=600)
        log(f"build: native codec {time.perf_counter() - t0:.1f} s")
    sys.path.insert(0, str(ROOT))
    from sarpro_tpu_torch.io.writers import jpeg
    from sarpro_tpu_torch.ops import _cuda

    if not jpeg._native.available():
        raise RuntimeError("native codec failed to load after its build")
    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: kernels {time.perf_counter() - t0:.1f} s")
    if _cuda.BUILD_INFO is not None:
        for line in _cuda.BUILD_INFO[1].splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernels(results):
    import torch

    from sarpro_tpu_torch.core import resize, synthetic_rgb
    from sarpro_tpu_torch.ops import kernels, resample_kernel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def record(name, err, ms, plain_ms):
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # histogram: the 4096-bin dB stats of a 2048^2 band (crowded bins, 2%
    # masked) and the 256-bin water floor over both u8 bands
    n = SIZE * SIZE
    idx = (torch.randn(n, device=dev, generator=g) * 300 + 2048).clamp(
        0, 4095).to(torch.int32)
    idx[torch.rand(n, device=dev, generator=g) < 0.02] = 4096
    got = kernels.histogram(idx, 4096)
    want = kernels._histogram_plain([idx], 4096)
    err = (got - want).abs().max().item()
    ms = median_ms(lambda: kernels.histogram(idx, 4096))
    pms = median_ms(lambda: kernels._histogram_plain([idx], 4096))
    log(f"histogram 4096 bins over {n}: max|err| {err}, kernel {ms:.4f} ms,"
        f" plain {pms:.4f} ms")
    record("histogram", err, ms, pms)
    u1 = torch.randint(0, 256, (n,), device=dev, generator=g,
                       dtype=torch.int32).to(torch.uint8)
    u2 = torch.randint(0, 256, (n,), device=dev, generator=g,
                       dtype=torch.int32).to(torch.uint8)
    got = kernels.histogram((u1, u2), 256)
    want = kernels._histogram_plain([u1, u2], 256)
    err = (got - want).abs().max().item()
    ms2 = median_ms(lambda: kernels.histogram((u1, u2), 256))
    pms2 = median_ms(lambda: kernels._histogram_plain([u1, u2], 256))
    log(f"histogram 256 bins over 2x{n}: max|err| {err}, kernel {ms2:.4f} "
        f"ms, plain {pms2:.4f} ms")
    record("histogram", err, None, None)

    # synrgb: every (b1, b2) pair for every floor 3..40, then a 2048^2 pair
    tables = synthetic_rgb.suppressed_table_sets(dev)
    a = torch.arange(256, device=dev, dtype=torch.int32)
    p1 = a.repeat_interleave(256).to(torch.uint8)
    p2 = a.repeat(256).to(torch.uint8)
    worst = 0
    for f in range(synthetic_rgb.FLOOR_MIN, synthetic_rgb.FLOOR_MAX + 1):
        fl = torch.tensor(f, dtype=torch.int32, device=dev)
        si = fl - synthetic_rgb.FLOOR_MIN
        for water in (None, fl):
            got = kernels.synrgb_lookup(p1, p2, tables, si, water)
            want = kernels._synrgb_lookup_plain(p1, p2, tables, si, water)
            worst = max(worst, (got.int() - want.int()).abs().max().item())
    fl = torch.tensor(7, dtype=torch.int32, device=dev)
    si = fl - synthetic_rgb.FLOOR_MIN
    got = kernels.synrgb_lookup(u1, u2, tables, si, fl)
    want = kernels._synrgb_lookup_plain(u1, u2, tables, si, fl)
    worst = max(worst, (got.int() - want.int()).abs().max().item())
    ms = median_ms(lambda: kernels.synrgb_lookup(u1, u2, tables, si, fl))
    pms = median_ms(
        lambda: kernels._synrgb_lookup_plain(u1, u2, tables, si, fl))
    log(f"synrgb_lookup 65536 pairs x 38 floors x water on/off + {n} px: "
        f"max|err| {worst}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
    record("synrgb_lookup", worst, ms, pms)

    # resample: the u16 20000^2 row pass for each filter, then the f32
    # transposed column pass
    x16 = torch.randint(0, 65536, (SIDE, SIDE), device=dev, generator=g,
                        dtype=torch.int32).to(torch.int16).view(torch.uint16)
    for filt in ("cubic", "average", "lanczos"):
        got = resample_kernel.band_resample_axis0(x16, SIDE, SIZE, filt)
        s, w = resize.device_coeffs(SIDE, SIZE, filt, dev)
        want = resize._resample_axis0(x16, s, w)
        _check_close(got, want, f"resample {filt}")
        err = (got - want).abs().max().item()
        ms = median_ms(lambda: resample_kernel.band_resample_axis0(
            x16, SIDE, SIZE, filt), reps=5)
        pms = median_ms(lambda: resize._resample_axis0(x16, s, w), reps=3)
        log(f"resample u16 {SIDE}^2 -> {SIZE} rows, {filt} ({w.shape[1]} "
            f"taps): max|err| {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms")
        if filt == "cubic":  # the slice's filter: the reported time
            record("resample_axis0", err, ms, pms)
        else:
            record("resample_axis0", err, None, None)
    del x16
    xt = got.T.contiguous()  # the cubic row pass, transposed: (20000, 2048)
    got = resample_kernel.band_resample_axis0(xt, SIDE, SIZE, "cubic")
    s, w = resize.device_coeffs(SIDE, SIZE, "cubic", dev)
    want = resize._resample_axis0(xt, s, w)
    _check_close(got, want, "resample f32 column pass")
    err = (got - want).abs().max().item()
    ms = median_ms(lambda: resample_kernel.band_resample_axis0(
        xt, SIDE, SIZE, "cubic"))
    pms = median_ms(lambda: resize._resample_axis0(xt, s, w), reps=5)
    log(f"resample f32 ({SIDE}, {SIZE}) -> {SIZE} rows, cubic: max|err| "
        f"{err:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
    record("resample_axis0", err, None, None)
    torch.cuda.synchronize()


def _check_close(got, want, what):
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    torch.testing.assert_close(got, want, **RESAMPLE_TOL)


def _zigzag():
    """zigzag k -> (row, col) of the JPEG scan order."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return order


def phase_slice(work: Path):
    import torch

    from sarpro_tpu_torch import cli, ops

    t0 = time.perf_counter()
    # the scene is written by a child process, whose ~7 GB of numpy
    # temporaries are returned when it exits
    subprocess.run(
        [sys.executable, "-c",
         "import pathlib, sys; sys.path[:0] = [sys.argv[1], "
         "sys.argv[1] + '/tests']; import fixtures; "
         "fixtures.make_safe(pathlib.Path(sys.argv[2]), "
         f"shape=({SIDE}, {SIDE}))", str(ROOT), str(work)],
        check=True)
    safe = next(work.glob("*.SAFE"))
    log(f"slice: wrote {safe.name} ({SIDE}x{SIDE} u16 VV+VH) in "
        f"{time.perf_counter() - t0:.1f} s")
    out = work / "out.jpg"
    argv = ["-i", str(safe), "-o", str(out), "-f", "jpeg", "--polarization",
            "multiband", "--autoscale", "tamed", "--size", str(SIZE),
            "--pad", "--fast"]
    walls = {}
    for label, extra in (("cold cubic", ["--resample-alg", "cubic"]),
                         ("warm cubic", ["--resample-alg", "cubic"]),
                         ("warm average", [])):
        if label == "warm cubic":
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.run(argv + extra) != 0:
            raise RuntimeError(f"cli.run failed ({label})")
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if label == "warm cubic":
            counts = ops.launch_counts()
            blob = out.read_bytes()
        log(f"slice: {label} wall {walls[label] * 1e3:.1f} ms")
    log(f"slice: launches in the warm cubic run {counts}")
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")
    if blob[:2] != b"\xff\xd8" or blob[-2:] != b"\xff\xd9":
        raise AssertionError("output is not a JPEG (SOI/EOI)")
    for ext in (".jgw", ".json", ".prj"):
        if not out.with_suffix(ext).exists():
            raise AssertionError(f"missing sidecar {ext}")
    return safe, blob, counts, walls


def _breakdown(scene, kw):
    """Device time of each stage (CUDA events), then the host's share: the
    coefficient copy back and the entropy coding."""
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io.writers import jpeg

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    b1 = fused.synrgb_band_stage(scene.band1, copol=True, **kw)
    ev[1].record()
    b2 = fused.synrgb_band_stage(scene.band2, copol=False, **kw)
    ev[2].record()
    dct = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "dct")
    ev[3].record()
    ev[3].synchronize()
    t0 = time.perf_counter()
    co = dct.cpu().numpy()
    t1 = time.perf_counter()
    n = SIZE + (-SIZE) % 8
    blob = jpeg._native.jpeg_encode_coeffs444(co[0], co[1], co[2], n, n)
    t2 = time.perf_counter()
    log(f"breakdown: device band1 {ev[0].elapsed_time(ev[1]):.3f} ms, band2 "
        f"{ev[1].elapsed_time(ev[2]):.3f} ms, combine+dct "
        f"{ev[2].elapsed_time(ev[3]):.3f} ms; host copy-back "
        f"{(t1 - t0) * 1e3:.2f} ms, entropy coding {(t2 - t1) * 1e3:.2f} ms "
        f"({len(blob)} bytes)")


def phase_resident(safe: Path, blob: bytes):
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from oracle import decode_baseline_jpeg_coeffs

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io.safe import open_dual_pol
    from sarpro_tpu_torch.ops import force_plain

    t0 = time.perf_counter()
    scene = open_dual_pol(safe, "cuda", SIZE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = scene.band1.cpu().numpy()
    t2 = time.perf_counter()
    torch.from_numpy(host).to(scene.band1.device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"breakdown: read + upload of both bands {(t1 - t0) * 1e3:.1f} ms, "
        f"of which one band's upload from pageable memory "
        f"{(t3 - t2) * 1e3:.1f} ms (host clock)")
    del host
    kw = dict(strategy=fused.AutoscaleStrategy.TAMED, target_size=SIZE, pad=True,
              resample_alg="cubic")

    def stages():
        b1 = fused.synrgb_band_stage(scene.band1, copol=True, **kw)
        b2 = fused.synrgb_band_stage(scene.band2, copol=False, **kw)
        rgb = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "rgb")
        dct = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "dct")
        return b1, b2, rgb, dct

    stages()
    torch.cuda.synchronize()
    _breakdown(scene, kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.set_sync_debug_mode("error")  # any host sync raises
    try:
        start.record()
        k = stages()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    log(f"resident: band x2 + combine x2 on the device {start.elapsed_time(end):.3f} ms "
        "(no host sync)")
    with force_plain():
        p = stages()
    torch.cuda.synchronize()
    for name, a, b in (("band1", k[0], p[0]), ("band2", k[1], p[1])):
        if a.shape != (SIZE, SIZE) or a.dtype != torch.uint8:
            raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)}")
        d = (a.int() - b.int()).abs()
        share = (d > 0).float().mean().item()
        log(f"resident: {name} kernels vs plain max|diff| {d.max().item()}, "
            f"share differing {share:.3g}")
        if d.max().item() > 1:
            raise AssertionError(f"{name} differs from plain by > 1")
    same = (k[0] == p[0]) & (k[1] == p[1])
    if not torch.equal(k[2][same], p[2][same]):
        raise AssertionError("rgb differs where both bands agree")
    # the file holds the device's coefficients: decode the first MCUs
    n_mcus = 256
    blocks, ncomp = decode_baseline_jpeg_coeffs(blob, n_mcus)
    dct = k[3].cpu().numpy().reshape(3, -1, 8, 8)
    zz = _zigzag()
    for m in range(n_mcus):
        for c in range(3):
            want = [int(dct[c, m][col, row]) for row, col in zz]
            if blocks[m * 3 + c] != want:
                raise AssertionError(f"JPEG block {m}/{c} != device block")
    log(f"resident: first {n_mcus} MCUs of the JPEG decode to the device's "
        "coefficient blocks")


def main() -> int:
    smi = phase_environment()
    phase_build()
    results = {}
    phase_kernels(results)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        safe, blob, counts, walls = phase_slice(work)
        phase_resident(safe, blob)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    import torch

    log(f"slice: warm wall {walls['warm cubic'] * 1e3:.1f} ms (cubic), "
        f"{walls['warm average'] * 1e3:.1f} ms (average) on {smi}")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
