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
// What bounds it: reading the 4-byte bins once from device memory (400 MB,
// 0.12 ms at 3.35 TB/s for a 10000 x 10000 band). The first design (one
// thread a pixel over a flat index) spent more issue time than that: two
// 64-bit divisions a pixel to find its row and tile row, a 4-byte load, and
// an atomic into a 64 KB table of all 64 tiles that held 3 blocks an SM.
//
// Design: a block owns a segment of at most tile_w columns (a multiple of 4
// wide, so rows of a 4-aligned image start on 16 bytes) and a strip of at
// most tile_h rows, so its pixels fall in at most 2 x 2 tiles. It finds the
// column and row where the tile changes once; a pixel then takes its tile
// with two compares, no division. The strip is read as 16-byte vectors with
// kUnroll loads in flight a thread (strip_walk.cuh, which also handles rows
// that do not start on 16 bytes: ragged widths, an offset base pointer). The
// 2 x 2-tile table (4 KB at 256 bins) is kept once per pair of warps, so the
// atomics of the bins SAR data crowds into contend less; a cap of 40
// registers lets 6 blocks of 256 threads share an SM (on the card, 4 blocks
// at 57 registers with 4 loads a thread were slower). A vector whose 4
// pixels share a tile and bin (a flat or all-water band) adds them with one
// atomic; a warp-wide vote for one atomic a warp was slower on the card, on
// SAR-like bins and on a band of one bin alike. At the end the copies are
// summed and each non-zero entry goes out with one global atomicAdd. Blocks
// are sized so that one wave of them covers the image.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "strip_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;  // blocks an SM, for the register cap
constexpr int kUnroll = 2;     // 16-byte loads in flight a thread
constexpr int kCopies = kThreads / 64;  // one table per pair of warps
constexpr int kCopyBytes = 16 * 1024;   // the most the copies may take
constexpr int kMinPixels = 8192;        // the least a block counts

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tile_hist_kernel(const int* __restrict__ bins, int rows, int cols,
                     int tiles_x, int tiles_y, int tile_h, int tile_w,
                     long long row_offset, int n_bins, int seg_w, int n_seg,
                     int strip_h, int win_x, int win_y, int copies,
                     int* __restrict__ out) {
  extern __shared__ int sh[];
  const int seg = (int)(blockIdx.x % (unsigned)n_seg);
  const int r0 = (int)(blockIdx.x / (unsigned)n_seg) * strip_h;
  const int r1 = min(r0 + strip_h, rows);
  const int c0 = seg * seg_w;
  const int w = min(seg_w, cols - c0);
  // the block's tiles: columns [tx_lo, tx_lo + 1], rows [ty_lo, ty_lo + 1]
  const int tx_lo = min(c0 / tile_w, tiles_x - 1);
  const int tx_hi = min((c0 + w - 1) / tile_w, tiles_x - 1);
  const long long g0 = r0 + row_offset, g1 = r1 - 1 + row_offset;
  const int ty_lo = (int)min(g0 / tile_h, (long long)tiles_y - 1);
  const int ty_hi = (int)min(g1 / tile_h, (long long)tiles_y - 1);
  // segment column and strip row where the second tile starts
  const int col_b = tx_hi > tx_lo ? (tx_lo + 1) * tile_w - c0 : INT_MAX;
  const int row_b =
      ty_hi > ty_lo ? (int)((ty_lo + 1) * (long long)tile_h - row_offset)
                    : INT_MAX;
  const int table = win_x * win_y * n_bins;
  for (int k = threadIdx.x; k < copies * table; k += kThreads) sh[k] = 0;
  __syncthreads();

  int* tab = sh + ((threadIdx.x >> 5) % copies) * table;
  const unsigned nb = (unsigned)n_bins;
  const int row_step = win_x * n_bins;
  const strip_walk::Strip s(bins, cols, c0, w, r0, r1);
  strip_walk::walk<kUnroll>(s, [&](int row, long long, int col, int4 v) {
    const int base = row >= row_b ? row_step : 0;
    const int b[4] = {v.x, v.y, v.z, v.w};
    int key[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // negative bins wrap past nb; a column outside [0, w) too
      ok[j] = (unsigned)(col + j) < (unsigned)w && (unsigned)b[j] < nb;
      key[j] = base + (col + j >= col_b ? n_bins : 0) + b[j];
    }
    // a vector of one key (a flat or all-water band): one atomic
    if (ok[0] && ok[1] && ok[2] && ok[3] && key[0] == key[1] &&
        key[0] == key[2] && key[0] == key[3]) {
      atomicAdd(&tab[key[0]], 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) atomicAdd(&tab[key[j]], 1);
    }
  });
  __syncthreads();

  for (int k = threadIdx.x; k < table; k += kThreads) {
    int c = 0;
    for (int t = 0; t < copies; ++t) c += sh[t * table + k];
    if (!c) continue;
    const int wy = k / row_step;
    const int wx = (k - wy * row_step) / n_bins;
    const int bin = k - wy * row_step - wx * n_bins;
    atomicAdd(&out[((ty_lo + wy) * tiles_x + tx_lo + wx) * n_bins + bin], c);
  }
}

}  // namespace

// bins: (n,) int32, row-major rows of `cols`, at any 4-byte alignment; out:
// (tiles_y * tiles_x * n_bins,) int32, zeroed by the caller, which also
// checks that the table fits in shared memory and that row_offset >= 0.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_tile_histogram(const int* bins, long long n, int cols,
                                     int tiles_x, int tiles_y, int tile_h,
                                     int tile_w, long long row_offset,
                                     int n_bins, int* out, void* stream) {
  if (n <= 0) return 0;
  const int rows = (int)(n / cols);
  // segments: at most tile_w wide, a multiple of 4 where tile_w allows,
  // the width spread evenly over as few as cover the row
  int seg_w = tile_w;
  if (tile_w >= 4) {
    const int most = tile_w & ~3;
    const int n_seg = (cols + most - 1) / most;
    seg_w = (((cols + n_seg - 1) / n_seg) + 3) & ~3;
  }
  const int n_seg = (cols + seg_w - 1) / seg_w;
  const int win_x = tiles_x < 2 ? tiles_x : 2;
  const int win_y = tiles_y < 2 ? tiles_y : 2;
  const int table = win_x * win_y * n_bins;
  int copies = kCopyBytes / (table * (int)sizeof(int));
  copies = copies < 1 ? 1 : (copies > kCopies ? kCopies : copies);
  const size_t smem = (size_t)copies * table * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_hist_kernel,
                                                kThreads, smem);
  // strips: one wave of resident blocks, each at least kMinPixels (the
  // zeroing and merging of its tables spread over enough counts), at most
  // tile_h rows
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long strips = wave / n_seg;
  if (strips < 1) strips = 1;
  long long strip_h = (rows + strips - 1) / strips;
  const long long least = (kMinPixels + seg_w - 1) / seg_w;
  if (strip_h < least) strip_h = least;
  if (strip_h > tile_h) strip_h = tile_h;
  if (strip_h > rows) strip_h = rows;
  const long long blocks = (long long)n_seg * ((rows + strip_h - 1) / strip_h);
  tile_hist_kernel<<<(unsigned)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      bins, rows, cols, tiles_x, tiles_y, tile_h, tile_w, row_offset, n_bins,
      seg_w, n_seg, (int)strip_h, win_x, win_y, copies, out);
  return (int)cudaGetLastError();
}
