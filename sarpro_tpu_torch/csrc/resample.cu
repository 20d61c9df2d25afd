// Separable resample along axis 0 for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (sarpro_tpu/ops/resample_kernel.py,
// reached through `_banded_call` / `band_resample_axis0`). That kernel DMAs
// 16-row-aligned source bands into VMEM and applies an (8, B) x (B, cols)
// weight matmul, so it refuses shapes whose band does not fit its tiling and
// leaves ragged columns and tail rows to the tap loop.
//
// Computes out[i, c] = sum_k w[i, k] * x[clamp(starts[i] + k), c] in f32,
// with the coefficients of core/resize._build_coeffs, the same function as
// the tap loop core/resize._resample_axis0.
//
// What bounds it: device-memory bandwidth. The source (800 MB for a
// 20000 x 20000 u16 band) must be read once; each output row reads `taps`
// source rows, and neighbouring output rows share most of them.
//
// Design: one thread per output column, threads of a warp on neighbouring
// columns, so every source-row read and every output write is coalesced.
// Each thread walks the taps in order and adds them as the tap loop does
// (round the product, then round the sum: __fmul_rn / __fadd_rn, no FMA
// contraction), so the kernel agrees with the plain PyTorch tap loop on the
// same inputs. Blocks are ordered column-chunk fastest, so the blocks in
// flight at once cover a few neighbouring output rows and their shared
// source rows stay in L2. u16 and f32 sources are read directly, with no
// cast copy. Any shape and any tap count is accepted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void resample_axis0_kernel(const T* __restrict__ x, long long rows,
                                      long long cols,
                                      const int* __restrict__ starts,
                                      const float* __restrict__ w, int taps,
                                      float* __restrict__ out,
                                      long long out_rows) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  for (long long i = blockIdx.y; i < out_rows; i += gridDim.y) {
    const long long s = starts[i];
    const float* wi = w + i * taps;
    float acc = 0.0f;
    for (int k = 0; k < taps; ++k) {
      long long r = s + k;
      r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
      const float term = __fmul_rn(wi[k], (float)x[r * cols + c]);
      acc = k == 0 ? term : __fadd_rn(acc, term);
    }
    out[i * cols + c] = acc;
  }
}

template <typename T>
int launch(const void* x, long long rows, long long cols, const int* starts,
           const float* w, int taps, float* out, long long out_rows,
           cudaStream_t stream) {
  const long long gx = (cols + kThreads - 1) / kThreads;
  const long long gy = out_rows < 65535 ? out_rows : 65535;
  if (gx < 1 || gy < 1) return 0;
  dim3 grid((unsigned)gx, (unsigned)gy);
  resample_axis0_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, cols, starts, w, taps, out, out_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, cols) row-major, u16 (is_u16 = 1) or f32 (is_u16 = 0);
// starts: (out_rows,) int32; w: (out_rows, taps) f32; out: (out_rows, cols)
// f32. Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_resample_axis0(const void* x, int is_u16, long long rows,
                                     long long cols, const int* starts,
                                     const float* w, int taps, float* out,
                                     long long out_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16)
    return launch<uint16_t>(x, rows, cols, starts, w, taps, out, out_rows, s);
  return launch<float>(x, rows, cols, starts, w, taps, out, out_rows, s);
}
