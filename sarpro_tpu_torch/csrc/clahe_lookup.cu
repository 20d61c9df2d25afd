// CLAHE bilinear CDF lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel `_clahe_kernel` (sarpro_tpu/ops/kernels.py,
// reached through `clahe_lookup`). The TPU gathers slowly from small tables,
// so that kernel selects CDF entries with a one-hot matmul over bf16 hi/lo
// planes of the CDFs (about 1e-5 from the f32 values) and blends the tiles
// in a factored form. Hopper gathers cheaply, so this kernel reads the f32
// CDFs directly and computes the function of `_clahe_lookup_xla`:
//   rf = r / tile_h - 0.5, cf = c / tile_w - 0.5 (r with row_offset),
//   floors clamped at 0, tile indices clamped to the grid,
//   top = a*(1-dx) + b*dx, bot likewise, out = top*(1-dy) + bot*dy,
// with a..d the CDFs of the 4 neighbouring tiles at min(bin, n_bins-1), and
// 0 for a masked pixel (bin >= n_bins).
//
// What bounds it: device-memory traffic, 4 bytes in and 4 out per pixel;
// the four gathers hit a 64 KB table that stays in L1 and L2.
//
// Design: one thread per pixel in a grid-stride loop; the table is read
// through the read-only cache (__ldg). Every operation is an explicitly
// rounded intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn) in the
// plain PyTorch version's order, so nvcc contracts nothing into an FMA and
// the kernel equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void clahe_lookup_kernel(const int* __restrict__ bins, long long n,
                                    const float* __restrict__ cdfs,
                                    int n_bins, int cols, int tiles_x,
                                    int tiles_y, int tile_h, int tile_w,
                                    long long row_offset,
                                    float* __restrict__ out) {
  const float fth = (float)tile_h;
  const float ftw = (float)tile_w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int b = bins[i];
    if (b >= n_bins) {
      out[i] = 0.0f;
      continue;
    }
    const long long r0 = i / cols;
    const long long c = i - r0 * cols;
    const float rf = __fsub_rn(__fdiv_rn((float)(r0 + row_offset), fth), 0.5f);
    const float cf = __fsub_rn(__fdiv_rn((float)c, ftw), 0.5f);
    const float tyf = fmaxf(floorf(rf), 0.0f);
    const float txf = fmaxf(floorf(cf), 0.0f);
    const float dy = __fsub_rn(rf, tyf);
    const float dx = __fsub_rn(cf, txf);
    const int tyi = __float2int_rz(tyf);
    const int txi = __float2int_rz(txf);
    const int ty0 = clampi(tyi, 0, tiles_y - 1);
    const int tx0 = clampi(txi, 0, tiles_x - 1);
    const int ty1 = clampi(tyi + 1, 0, tiles_y - 1);
    const int tx1 = clampi(txi + 1, 0, tiles_x - 1);
    const int sb = b < 0 ? 0 : b;
    const float a00 = __ldg(cdfs + (ty0 * tiles_x + tx0) * n_bins + sb);
    const float a01 = __ldg(cdfs + (ty0 * tiles_x + tx1) * n_bins + sb);
    const float a10 = __ldg(cdfs + (ty1 * tiles_x + tx0) * n_bins + sb);
    const float a11 = __ldg(cdfs + (ty1 * tiles_x + tx1) * n_bins + sb);
    const float omdx = __fsub_rn(1.0f, dx);
    const float top = __fadd_rn(__fmul_rn(a00, omdx), __fmul_rn(a01, dx));
    const float bot = __fadd_rn(__fmul_rn(a10, omdx), __fmul_rn(a11, dx));
    out[i] = __fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, dy)),
                       __fmul_rn(bot, dy));
  }
}

}  // namespace

// bins: (n,) int32, row-major rows of `cols`; cdfs: (tiles_y * tiles_x,
// n_bins) f32, tile-major; out: (n,) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_clahe_lookup(const int* bins, long long n,
                                   const float* cdfs, int n_bins, int cols,
                                   int tiles_x, int tiles_y, int tile_h,
                                   int tile_w, long long row_offset,
                                   float* out, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  clahe_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      bins, n, cdfs, n_bins, cols, tiles_x, tiles_y, tile_h, tile_w,
      row_offset, out);
  return (int)cudaGetLastError();
}
