#!/usr/bin/env python3
"""JPEG 2000 or AVIF decode times of the port in two checkouts side by
side.

    python3 decode_ab.py OTHER_CHECKOUT [--format jpeg2000|avif]
                         [--rounds N] [--reps R]

OTHER_CHECKOUT is another checkout of this repository, for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists. Each round runs OTHER, this checkout, this checkout, OTHER (N rounds,
default 1), each in a child process that imports that checkout's
sarpro_tpu_torch (which builds that checkout's decoder library) and
decodes the same files, made with this checkout's chip_smoke helpers as
its JPEG 2000 phase makes them (`--format jpeg2000`, the default):
  * the spliced 84.9 MP u16 JP2s, the default coding and the styled one;
  * the 4096^2 sYCC 4:2:0 JP2 and the 4096^2 JP2 of 20-bit amplitude;
or six of this checkout's 9216^2 AVIF bands of its avif phase (`--format
avif`: unfiltered, filtered, "LA", grain, 12-bit "LA", superres).
Each decode is io.jpeg2000.read (io.avif.read(...).load()) of the file's
bytes, timed on the host clock, the median of R (default 3) after one
untimed decode; a file that checkout refuses is reported as refused. The
decoder runs on the host: no GPU is needed, though the host's CPUs set the
times. Prints each child's
numbers with the SHA-256 of its arrays, then one JSON line of all runs.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def files(fmt: str) -> dict:
    """The JP2s or AVIF files to decode, by name."""
    cs = _chip_smoke()
    if fmt == "avif":
        return {label: path.read_bytes() for label, path in (
            ("band 84.9 MP", cs.AVIF_BAND),
            ("filtered band", cs.AVIF_FILTERED_BAND),
            ("LA band", cs.AVIF_LA_BAND),
            ("grain band", cs.AVIF_GRAIN_BAND),
            ("12-bit LA band", cs.AVIF_DEPTH_BAND),
            ("superres band", cs.AVIF_SUPERRES_BAND))}
    out = {}
    for name, fname, tiles, bands, bits, enumcs in (
            ("u16 band 84.9 MP", cs.J2K_BAND, cs.J2K_BAND_TILES, 1, 16, 17),
            ("u16 styled band 84.9 MP", cs.J2K_STYLED, cs.J2K_BAND_TILES, 1,
             16, 17),
            ("sycc 4:2:0 9/7 16.8 MP", cs.J2K_SYCC, cs.J2K_SUB_TILES, 3, 8,
             18),
            ("20-bit band 16.8 MP", cs.J2K_DEEP, cs.J2K_SUB_TILES, 1, 20,
             17)):
        code = cs.j2k_splice((cs.J2K_DIR / fname).read_bytes(), tiles, tiles)
        w, h = struct.unpack_from(">II", code, 8)
        out[name] = cs.jp2_wrap(code, w, h, bands, bits, enumcs)
    return out


def measure(tree: Path, fmt: str, reps: int) -> dict:
    """The decode times of one checkout (run in a child process)."""
    blobs = files(fmt)
    sys.path.insert(0, str(tree))
    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.io import avif, jpeg2000

    def decode(blob):
        if fmt == "avif":
            return avif.read(blob).load().array
        return jpeg2000.read(blob).array

    res = {"threads": _native._threads()}
    for name, blob in blobs.items():
        try:
            arr = decode(blob)
        except Exception as e:  # noqa: BLE001 - a refusal is a result here
            res[name] = {"refused": str(e)[:200]}
            continue
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            decode(blob)
            walls.append((time.perf_counter() - t0) * 1e3)
        res[name] = {"ms": statistics.median(walls), "walls": walls,
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout")
    ap.add_argument("--format", choices=("jpeg2000", "avif"),
                    default="jpeg2000")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve(), args.format,
                                 args.reps)))
        return 0
    other = args.other.resolve()
    if not (other / "sarpro_tpu_torch").is_dir():
        raise SystemExit(f"decode_ab: no sarpro_tpu_torch in {other}")
    runs = []
    for _ in range(args.rounds):
        for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                            ("other", other)):
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(other),
                 "--format", args.format, "--reps", str(args.reps),
                 "--measure", str(tree)],
                check=True, capture_output=True, text=True).stdout
            res = json.loads(out.strip().splitlines()[-1])
            runs.append({"tree": label, **res})
            print(f"{label} ({res['threads']} threads): " + ", ".join(
                f"{k} refused" if "refused" in v else
                f"{k} {v['ms']:.1f} ms (sha256 {v['sha256'][:16]})"
                for k, v in res.items() if k != "threads"), flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
