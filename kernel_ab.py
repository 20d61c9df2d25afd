#!/usr/bin/env python3
"""Device times of the port in two checkouts side by side, on one GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [--rounds N]

OTHER_CHECKOUT is another checkout of this repository, for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists. Each round runs OTHER, this checkout, this checkout, OTHER (N rounds,
default 1), each in a child process that imports that checkout's
sarpro_tpu_torch, builds its kernels, and measures on the card, with the
same inputs made on the device from seed 0:
  * the resample kernel at the slice's shapes: u16 20000^2 -> 2048 rows
    (cubic, lanczos, average) and the f32 (20000, 2048) column pass;
  * the warp kernel, f32 2380^2 -> 2048^2 on a rotated 66^2 grid with NaN
    nodes (cubic, bilinear, near);
  * the device stages of two routes: no warp (Tamed band stages of two
    u16 20000^2 bands with the cubic filter, then the combine) and auto-UTM
    (two cubic warps of 2380^2 bands to 2048^2, the CLAHE band stages, the
    combine), each stage and the whole route;
  * the CLAHE kernels (tile_histogram, clahe_lookup) on SAR-like bins at
    2048^2 and 10000^2, and the grayscale CLAHE program of the 100 MP route
    (fused.grayscale_pipeline, u8) on a resident 10000^2 u16 band;
  * the histogram (4096 bins over 2048^2 and 10000^2 int32 dB indices, 256
    bins over a uniform and a SAR-like pair of 2048^2 u8 bands) and the
    synRGB lookup (2048^2, the suppressed set with the water mask and the
    default set), beside the combine stages above.
Every time is chip_smoke.device_ms's: one CUDA event pair around 20 calls
(5 for the grayscale program) queued behind a spin kernel, over their
count, so the host's launch gaps between the stages' many small kernels are
not counted.
Prints each child's numbers, then one JSON line of all runs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: Path) -> dict:
    """The numbers of one checkout (run in a child process)."""
    sys.path.insert(0, str(tree))
    import torch

    cs = _chip_smoke()
    from sarpro_tpu_torch.core import fused, synthetic_rgb
    from sarpro_tpu_torch.core.numerics import as_u16
    from sarpro_tpu_torch.io import warp
    from sarpro_tpu_torch.ops import _cuda, kernels, resample_kernel, warp_kernel

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    side, size, mid = cs.SIDE, cs.SIZE, cs.MID
    res = {}
    dn = [as_u16(torch.randint(0, 65536, (side, side), device=dev,
                               generator=g, dtype=torch.int32))
          for _ in range(2)]
    for filt in ("cubic", "lanczos", "average"):
        res[f"resample u16 {filt}"] = cs.device_ms(
            lambda: resample_kernel.band_resample_axis0(dn[0], side, size,
                                                        filt))
    xt = resample_kernel.band_resample_axis0(dn[0], side, size,
                                             "cubic").T.contiguous()
    res["resample f32 column pass"] = cs.device_ms(
        lambda: resample_kernel.band_resample_axis0(xt, side, size, "cubic"))
    del xt
    srcs = [torch.exp(torch.randn((mid, mid), device=dev, generator=g) * 1.1
                      + 5.0) for _ in range(2)]
    mx, my = cs.warp_grid(mid, size)
    mx[3, 5] = mx[40, 60] = float("nan")
    my[10, 10] = float("nan")
    gx, gy = warp.plan_grids_to_device(mx, my, dev)
    for method in ("cubic", "bilinear", "near"):
        res[f"warp {method}"] = cs.device_ms(
            lambda: warp_kernel.warp_sample(srcs[0], gx, gy, size, size,
                                            method))

    def route(label, load, strategy, resample_alg):
        kw = dict(strategy=strategy, target_size=size, pad=True,
                  resample_alg=resample_alg)

        def band_stages(b1, b2):
            return (fused.synrgb_band_stage(b1, copol=True, **kw),
                    fused.synrgb_band_stage(b2, copol=False, **kw))

        def combine(s1, s2):
            return fused.synrgb_combine_stage(s1, s2, strategy, None, "dct")

        b1, b2 = load()
        s1, s2 = band_stages(b1, b2)
        res[f"{label}: load"] = cs.device_ms(load)
        res[f"{label}: band stages"] = cs.device_ms(lambda: band_stages(b1,
                                                                       b2))
        res[f"{label}: combine"] = cs.device_ms(lambda: combine(s1, s2))
        res[f"{label}: all"] = cs.device_ms(
            lambda: combine(*band_stages(*load())))

    route("no-warp tamed cubic", lambda: dn, fused.AutoscaleStrategy.TAMED,
          "cubic")
    route("auto-UTM clahe", lambda: [
        warp_kernel.warp_sample(s, gx, gy, size, size, "cubic")
        for s in srcs], fused.AutoscaleStrategy.CLAHE, None)
    del dn, srcs

    for side in (size, cs.EW_SIDE):
        tile = -(-side // 8)
        bins = cs._clahe_bins(dev, g, side * side)
        grid = (side, 8, 8, tile, tile)
        cdfs = fused._clahe_cdfs(kernels.tile_histogram(bins, *grid), side,
                                 side, tile, tile)
        res[f"tile_histogram {side}^2"] = cs.device_ms(
            lambda: kernels.tile_histogram(bins, *grid))
        res[f"clahe_lookup {side}^2"] = cs.device_ms(
            lambda: kernels.clahe_lookup(bins, cdfs, *grid))
        del bins
    ew = cs.EW_SIDE
    band = as_u16(torch.exp(torch.randn((ew, ew), device=dev, generator=g)
                            * 1.1 + 5.0).clamp(0, 65535))
    res[f"grayscale CLAHE program {ew}^2"] = cs.device_ms(
        lambda: fused.grayscale_pipeline(
            band, strategy=fused.AutoscaleStrategy.CLAHE,
            bit_depth=fused.BitDepth.U8), reps=5)
    del band

    for side in (size, ew):
        idx = cs._db_bins(dev, g, side * side)
        res[f"histogram 4096 bins {side}^2"] = cs.device_ms(
            lambda: kernels.histogram(idx, 4096))
        del idx
    n = size * size
    u = [torch.randint(0, 256, (n,), device=dev, generator=g,
                       dtype=torch.int32).to(torch.uint8) for _ in range(2)]
    s = [cs._sar_u8(dev, g, n, 2.8), cs._sar_u8(dev, g, n, 2.3)]
    res[f"histogram 256 bins 2 x {size}^2 u8"] = cs.device_ms(
        lambda: kernels.histogram(u, 256))
    res[f"histogram 256 bins 2 x {size}^2 u8 SAR-like"] = cs.device_ms(
        lambda: kernels.histogram(s, 256))
    fl = torch.tensor(7, dtype=torch.int32, device=dev)
    si = fl - synthetic_rgb.FLOOR_MIN
    sup = synthetic_rgb.suppressed_table_sets(dev)
    dflt = synthetic_rgb.default_table_set(dev)
    res[f"synrgb_lookup {size}^2 suppressed"] = cs.device_ms(
        lambda: kernels.synrgb_lookup(u[0], u[1], sup, si, fl))
    res[f"synrgb_lookup {size}^2 default"] = cs.device_ms(
        lambda: kernels.synrgb_lookup(u[0], u[1], dflt))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve())))
        return 0
    other = args.other.resolve()
    if not (other / "sarpro_tpu_torch").is_dir():
        raise SystemExit(f"kernel_ab: no sarpro_tpu_torch in {other}")
    runs = []
    for _ in range(args.rounds):
        for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                            ("other", other)):
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(other),
                 "--measure", str(tree)],
                check=True, capture_output=True, text=True).stdout
            res = json.loads(out.strip().splitlines()[-1])
            runs.append({"tree": label, **res})
            print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in res.items()),
                  flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
