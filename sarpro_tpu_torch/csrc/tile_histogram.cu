// CLAHE per-tile histograms for Hopper (sm_90a).
//
// Replaces the TPU kernel `_tile_hist_kernel` (sarpro_tpu/ops/kernels.py,
// reached through `tile_histogram`). The TPU has no fast scatter-add, so
// that kernel counts with one-hot (tile, bin_hi) x bin_lo matmuls on the MXU
// over 8192-pixel lane blocks, banded to two tile rows. Hopper has fast
// shared-memory atomics, so this kernel counts directly.
//
// Computes, for every pixel i of a row-major (n / cols, cols) bin image, with
// r = i / cols + row_offset and c = i % cols:
//   out[(min(r / tile_h, tiles_y-1) * tiles_x + min(c / tile_w, tiles_x-1))
//       * n_bins + bin[i]] += 1
// for bin[i] in [0, n_bins); other bins (n_bins = masked) are not counted.
// The result is exact (integer adds commute).
//
// What bounds it: reading the 4-byte bins once from device memory, and
// contention on the shared-memory atomics of the bins SAR data crowds into.
//
// Design: each block owns a contiguous run of pixels and keeps the whole
// (tiles x bins) int32 table in dynamic shared memory (64 KB for 8 x 8 x
// 256, above the 48 KB default, hence cudaFuncSetAttribute). Its run covers
// only a few raster rows, so it touches only the tile rows [ty_lo, ty_hi]
// of those rows: it zeroes, fills and merges just that band, with one global
// atomicAdd per non-zero entry. Threads stride through the run so reads are
// coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int tile_row(long long row, int tile_h,
                                        int tiles_y) {
  const long long ty = row / tile_h;
  return ty < tiles_y - 1 ? (int)ty : tiles_y - 1;
}

__global__ void tile_hist_kernel(const int* __restrict__ bins, long long n,
                                 int cols, int tiles_x, int tiles_y,
                                 int tile_h, int tile_w, long long row_offset,
                                 int n_bins, long long per_block,
                                 int* __restrict__ out) {
  extern __shared__ int sh[];
  const long long start = (long long)blockIdx.x * per_block;
  if (start >= n) return;
  const long long end = start + per_block < n ? start + per_block : n;
  const int ty_lo = tile_row(start / cols + row_offset, tile_h, tiles_y);
  const int ty_hi = tile_row((end - 1) / cols + row_offset, tile_h, tiles_y);
  const int row_entries = tiles_x * n_bins;
  const int lo = ty_lo * row_entries;
  const int hi = (ty_hi + 1) * row_entries;
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) sh[k] = 0;
  __syncthreads();
  const unsigned nb = (unsigned)n_bins;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const unsigned b = (unsigned)bins[i];  // negative bins wrap past nb
    if (b >= nb) continue;
    const long long r = i / cols;
    const int c = (int)(i - r * cols);
    const int ty = tile_row(r + row_offset, tile_h, tiles_y);
    const int tx0 = c / tile_w;
    const int tx = tx0 < tiles_x - 1 ? tx0 : tiles_x - 1;
    atomicAdd(&sh[(ty * tiles_x + tx) * n_bins + (int)b], 1);
  }
  __syncthreads();
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const int v = sh[k];
    if (v) atomicAdd(&out[k], v);
  }
}

}  // namespace

// bins: (n,) int32, row-major rows of `cols`; out: (tiles_y * tiles_x *
// n_bins,) int32, zeroed by the caller, which also checks that the table
// fits in shared memory and that row_offset >= 0.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_tile_histogram(const int* bins, long long n, int cols,
                                     int tiles_x, int tiles_y, int tile_h,
                                     int tile_w, long long row_offset,
                                     int n_bins, int* out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)tiles_x * tiles_y * n_bins * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_hist_kernel,
                                                kThreads, smem);
  // one wave of resident blocks, each run at least a few thousand pixels:
  // longer runs spread the zeroing and merging of a band over more counts
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long per_block = (n + blocks - 1) / blocks;
  if (per_block < 4 * kThreads) per_block = 4 * kThreads;
  blocks = (n + per_block - 1) / per_block;
  tile_hist_kernel<<<(unsigned)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      bins, n, cols, tiles_x, tiles_y, tile_h, tile_w, row_offset, n_bins,
      per_block, out);
  return (int)cudaGetLastError();
}
