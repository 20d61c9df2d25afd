"""Command line of the port: the JAX package's flags, run on the GPU (port
of sarpro_tpu/cli.py:127-189).

    python -m sarpro_tpu_torch.cli -i X.SAFE -o out.jpg -f jpeg \\
        --polarization multiband --autoscale clahe --size 2048 --pad \\
        --target-crs auto --resample-alg cubic --fast
    python -m sarpro_tpu_torch.cli -i X.SAFE -o out.tiff --fast  # u8 VV CLAHE
"""
from __future__ import annotations

import logging
import sys
import time

from sarpro_tpu.cli import _params_from_args, build_parser
from sarpro_tpu.errors import MissingArgument, SarproError

logger = logging.getLogger("sarpro")


def run(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    if args.log:
        logging.basicConfig(
            level=logging.DEBUG,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
    from . import api

    try:
        params = _params_from_args(args)
        if args.batch or args.input_dir is not None:
            raise NotImplementedError("batch mode is not ported yet "
                                      "(ROADMAP queue 1 #8, batch)")
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
