"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (port of sarpro_tpu/ops).

  * histogram: shared-memory atomics (csrc/histogram.cu);
  * band_resample_axis0: coalesced tap loop over u16/f32 rows
    (csrc/resample.cu);
  * synrgb_lookup: tables staged in shared memory, set chosen on the device
    (csrc/synrgb.cu).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; `force_plain()` routes CUDA tensors to the plain versions
too, for comparisons.
"""
from ._cuda import force_plain, launch_counts, reset_launch_counts  # noqa: F401
from .kernels import histogram, synrgb_lookup  # noqa: F401
from .resample_kernel import band_resample_axis0  # noqa: F401
