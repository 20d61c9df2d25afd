"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (port of sarpro_tpu/ops).

  * histogram: shared-memory atomics (csrc/histogram.cu);
  * tile_histogram: the CLAHE per-tile counts, a block's strip of rows and
    segment of columns (at most 2 x 2 tiles) counted with shared-memory
    atomics (csrc/tile_histogram.cu);
  * clahe_lookup: the CLAHE bilinear CDF blend, a block's row and column
    terms computed once and the four CDF values of each bin packed into one
    shared-memory entry (csrc/clahe_lookup.cu);
  * band_resample_axis0: a group of output rows' source rows staged once
    in shared memory as f32, the tap loop read from there
    (csrc/resample.cu);
  * synrgb_lookup: tables staged in shared memory, set chosen on the device
    (csrc/synrgb.cu);
  * warp_sample: the inverse-map warp sampler; cubic stages each output
    tile's source footprint in shared memory (csrc/warp.cu).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; `force_plain()` routes CUDA tensors to the plain versions
too, for comparisons.
"""
from ._cuda import force_plain, launch_counts, reset_launch_counts  # noqa: F401
from .kernels import (  # noqa: F401
    clahe_lookup,
    histogram,
    synrgb_lookup,
    tile_histogram,
)
from .resample_kernel import band_resample_axis0  # noqa: F401
from .warp_kernel import warp_sample  # noqa: F401
