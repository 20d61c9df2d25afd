"""Command line of the port: the JAX package's flags, run on the GPU (port
of sarpro_tpu/cli.py:127-189). Without `--fast` it runs exact mode, the
reference's semantics with host-f64 statistics; `--fast` runs the fused
device programs.

    python -m sarpro_tpu_torch.cli -i X.SAFE -o out.tiff  # u8 VV CLAHE
    python -m sarpro_tpu_torch.cli -i X.SAFE -o out.jpg -f jpeg \\
        --polarization multiband --autoscale clahe --size 2048 --pad \\
        --target-crs auto --resample-alg cubic [--fast]
    python -m sarpro_tpu_torch.cli --input-dir D --output-dir O [--prefetch N]

Batch mode (`--input-dir`, or `--batch`) processes every product of a
directory: one after the other (`--prefetch 0`, the default), or pipelined
with N scenes loading ahead (`parallel/batch.py`), and prints the
processed, skipped and error counts.

`build_parser`, `_parse_size` and `_params_from_args` are copies of the JAX
package's (tests/test_torch_host_copies.py holds the parsed params equal),
`--version` included.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from . import __version__
from .errors import MissingArgument, SarproError, ZeroSize
from .params import ProcessingParams
from .types import (
    AutoscaleStrategy,
    BitDepthArg,
    InputFormat,
    OutputFormat,
    Polarization,
    SyntheticRgbMode,
)

logger = logging.getLogger("sarpro")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sarpro", description="SARPRO CLI (TPU-native)", add_help=True
    )
    p.add_argument("--version", action="version", version=f"sarpro {__version__}")
    p.add_argument("-i", "--input", type=Path,
                   help="Input SAFE directory (single file mode)")
    p.add_argument("--input-dir", type=Path,
                   help="Input directory containing SAFE subdirectories (batch mode)")
    p.add_argument("-o", "--output", type=Path,
                   help="Output filename (single file mode)")
    p.add_argument("--output-dir", type=Path,
                   help="Output directory for batch processing (batch mode)")
    p.add_argument("-f", "--format", choices=["tiff", "jpeg"], default="tiff",
                   help="Output format (tiff or jpeg)")
    p.add_argument("--input-format", choices=["safe"], default="safe",
                   help="Input format (only SAFE supported currently)")
    p.add_argument("--bit-depth", choices=["u8", "u16"], default="u8",
                   help="Output bit depth (8 or 16)")
    p.add_argument("--polarization", choices=Polarization.cli_choices(),
                   default="vv", help="Polarization mode")
    p.add_argument("--autoscale",
                   choices=[s.value for s in AutoscaleStrategy], default="clahe",
                   help="Autoscaling strategy")
    p.add_argument("--size", default="original",
                   help='Image size: 512/1024/2048, any positive integer, or "original"')
    p.add_argument("--log", action="store_true", help="Enable logging")
    p.add_argument("--batch", action="store_true",
                   help="Batch mode: continue past unsupported products")
    p.add_argument("--pad", action="store_true",
                   help="Zero-pad to square (centered)")
    p.add_argument("--target-crs",
                   help="Target CRS: any EPSG code (e.g. EPSG:4326, "
                        "EPSG:32633), a raw '+proj=...' string, 'auto', "
                        "or 'none'")
    p.add_argument("--resample-alg",
                   help="Resampling algorithm (nearest, bilinear, cubic, lanczos)")
    p.add_argument("--synrgb-mode", choices=[m.value for m in SyntheticRgbMode],
                   default="default",
                   help="Synthetic RGB mode (jpeg+multiband only)")
    p.add_argument("--prefetch", type=int, default=0, metavar="N",
                   help="Batch mode: load N scenes ahead while the device "
                        "processes (0 = serial, reference-parity)")
    p.add_argument("--device-batch", type=int, default=4, metavar="K",
                   help="Batch+fast mode: stack K same-shape multiband-JPEG "
                        "scenes into one vmapped device dispatch (1 = "
                        "per-scene). On TPU, bucketed scenes may differ "
                        "from per-scene output by <=1 u8 step (both within "
                        "the fast-mode contract)")
    p.add_argument("--fast", action="store_true",
                   help="Fused single-program pipeline (benchmark path): one "
                        "device dispatch per band; autoscale windows within "
                        "1 histogram bin of exact mode")
    p.add_argument("--shard-devices", type=int, default=0, metavar="N",
                   help="Shard one scene's compute across N local devices "
                        "(rows split over a mesh, stats via ICI "
                        "collectives); -1 = all devices; implies --fast")
    p.add_argument("--resume", action="store_true",
                   help="Batch mode: skip products whose output already exists")
    p.add_argument("--no-direct-io", action="store_true",
                   help="Pipelined batch mode: use buffered (page-cache) "
                        "reads in the loader threads instead of the default "
                        "O_DIRECT chunked DMA (use when scenes are re-read "
                        "and should stay cached)")
    return p


def _parse_size(size: str):
    """reference: src/cli/runner.rs:43-55."""
    if size == "original":
        return None
    try:
        parsed = int(size)
    except ValueError:
        raise SarproError(f"Invalid size: {size}")
    if parsed == 0:
        raise ZeroSize(parsed)
    if parsed < 0:
        raise SarproError(f"Invalid size: {size}")
    return parsed


def _params_from_args(args) -> ProcessingParams:
    return ProcessingParams(
        format=OutputFormat.TIFF if args.format == "tiff" else OutputFormat.JPEG,
        input_format=InputFormat.SAFE,
        bit_depth=BitDepthArg.U8 if args.bit_depth == "u8" else BitDepthArg.U16,
        polarization=Polarization.from_cli(args.polarization),
        autoscale=AutoscaleStrategy(args.autoscale),
        synrgb_mode=SyntheticRgbMode(args.synrgb_mode),
        size=_parse_size(args.size),
        pad=args.pad,
        target_crs=args.target_crs,
        resample_alg=args.resample_alg,
    )



def run(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    if args.log:
        logging.basicConfig(
            level=logging.DEBUG,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
    from . import api

    batch_mode = args.batch or args.input_dir is not None
    try:
        params = _params_from_args(args)
        if batch_mode:
            if args.input_dir is None:
                raise MissingArgument("--input-dir")
            if args.output_dir is None:
                raise MissingArgument("--output-dir")
            args.output_dir.mkdir(parents=True, exist_ok=True)
            logger.info("Starting batch processing from directory: %s",
                        args.input_dir)
            if args.prefetch > 0:
                from .parallel.batch import process_directory_pipelined

                report = process_directory_pipelined(
                    args.input_dir, args.output_dir, params,
                    continue_on_error=True, prefetch=args.prefetch,
                    resume=args.resume, fast=args.fast,
                    device_batch=args.device_batch,
                    shard_devices=args.shard_devices,
                    direct_io=not args.no_direct_io, device=device,
                )
            else:
                report = api.process_directory_to_path(
                    args.input_dir, args.output_dir, params,
                    continue_on_error=True, fast=args.fast,
                    resume=args.resume, shard_devices=args.shard_devices,
                    device=device,
                )
            logger.info("Batch processing complete!")
            logger.info("Processed: %d", report.processed)
            logger.info("Skipped: %d", report.skipped)
            logger.info("Errors: %d", report.errors)
            print(f"Processed: {report.processed}\n"
                  f"Skipped: {report.skipped}\nErrors: {report.errors}")
            return 0
        if args.input is None:
            raise MissingArgument("--input")
        if args.output is None:
            raise MissingArgument("--output")
        t0 = time.perf_counter()
        api.process_safe_to_path(args.input, args.output, params,
                                 fast=args.fast,
                                 shard_devices=args.shard_devices,
                                 device=device)
        logger.info("Successfully processed: %s -> %s (%.3f s)",
                    args.input, args.output, time.perf_counter() - t0)
    except SarproError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def main():  # console entry point
    sys.exit(run())


if __name__ == "__main__":
    main()
