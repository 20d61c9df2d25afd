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
// with a..d the CDFs of the 4 neighbouring tiles at min(bin, n_bins-1)
// (negative bins at 0), and 0 for a masked pixel (bin >= n_bins).
//
// What bounds it: device-memory traffic, 4 bytes in and 4 out per pixel
// (800 MB, 0.24 ms at 3.35 TB/s for a 10000 x 10000 band). The first design
// (one thread a pixel over a flat index) spent more issue time than that: a
// 64-bit division, two IEEE divisions, floors and clamps for every pixel,
// though they depend only on its row or its column, four gathers through L1
// and 4-byte loads and stores.
//
// Design: a block owns a segment of columns (at most kSegCols, and at most
// a tile wide down to kNarrowSeg) and a strip of at most tile_h rows. It
// computes the column terms (dx, tx0) of its segment and the row terms (dy,
// 1 - dy, ty0, ty1) of its strip once into shared memory. A strip shorter
// than a tile meets at most 2 values of ty0, a segment at most
// (width - 1) / tile_w + 2 values of tx0, and t1 = min(t0 + 1, last) always;
// so the block packs, for each (ty0, tx0) it meets and each bin, the four
// CDF values a pixel blends into one float4 (16 KB for 2 x 2 at 256 bins):
// a pixel then reads its column term (8 bytes) and one packed entry (16
// bytes) from shared memory, instead of four scattered 4-byte gathers that
// conflict in the banks. The strip is read as 16-byte vectors, kUnroll loads
// in flight a thread, and written as 16-byte vectors (strip_walk.cuh; a
// vector that straddles a row's or segment's edge, or an output whose
// alignment differs from the input's, is stored element by element). The
// column terms are stored by column residue mod 4, so a warp's lanes read
// neighbouring words. Where the packed CDFs would not fit (many bins) or
// coordinates reach 2^23 (where the bounds on ty0 and tx0 may fail), the
// four CDF values are read from device memory instead, with the same
// arithmetic. Every operation is an explicitly rounded intrinsic
// (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn) in the plain PyTorch
// version's order, so nvcc contracts nothing into an FMA and the kernel
// equals the plain version bit for bit.
//
// On the card the 100 MP lookup stays above a device copy of the same bytes
// whatever its shared-memory work: with the packed entries and column terms
// replaced by constants it is no faster. Two blocks of 256 threads an SM at
// up to 128 registers (96 used) beat four at 64 and three at 80; a second
// set of loads issued before the first is used, 8 loads a thread (which
// spill), streaming cache hints, 2048-column segments, and (with the blend
// taken out) rows interleaved across blocks were each no faster.
#include <cuda_runtime.h>
#include <stdint.h>

#include "strip_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;        // blocks an SM, for the register cap
constexpr int kUnroll = 4;           // 16-byte loads in flight a thread
constexpr int kSegCols = 1024;       // the widest segment
constexpr int kNarrowSeg = 256;      // the narrowest, where tiles are narrow
constexpr int kMaxStrip = 256;       // the tallest strip
constexpr int kMinPixels = 16384;    // the least a block blends
constexpr int kMaxSmem = 96 * 1024;  // the most a block's tables may take
constexpr int kExact = 1 << 23;      // coordinates where rf and cf are exact

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the plain version's steps for one coordinate: fraction d past the tile
// centre below it, and the tiles t0, t1 on either side
__device__ __forceinline__ void tile_terms(float pos, float size, int tiles,
                                           float* d, int* t0, int* t1) {
  const float f = __fsub_rn(__fdiv_rn(pos, size), 0.5f);
  const float tf = fmaxf(floorf(f), 0.0f);
  *d = __fsub_rn(f, tf);
  const int ti = __float2int_rz(tf);
  *t0 = clampi(ti, 0, tiles - 1);
  *t1 = clampi(ti + 1, 0, tiles - 1);
}

// Shared memory: [packed CDFs: float4 an entry][row terms: float4 a row]
// [column terms: float2 a column]. kPacked: entry (yp, xp, bin) holds the
// CDFs at `bin` of tiles (ty0, tx0), (ty0, tx1), (ty1, tx0), (ty1, tx1) for
// the strip's yp-th ty0 and the segment's xp-th tx0 (t1 = min(t0 + 1, last)
// wherever t0 comes from a floor at or above 0); a row term is (dy, 1 - dy,
// its entry offset, -), a column term (dx, its entry offset). Otherwise the
// terms hold the offsets of ty0, ty1 and tx0 in the CDFs in device memory.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    clahe_lookup_kernel(const int* __restrict__ bins,
                        const float* __restrict__ cdfs, int n_bins, int rows,
                        int cols, int tiles_x, int tiles_y, int tile_h,
                        int tile_w, long long row_offset, int seg_w, int n_seg,
                        int strip_h, int nx, int ny, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int packed = kPacked ? ny * nx * n_bins : 0;
  float4* s_pack = reinterpret_cast<float4*>(smem);
  float4* s_row = s_pack + packed;
  float2* s_col = reinterpret_cast<float2*>(s_row + strip_h);

  const int seg = (int)(blockIdx.x % (unsigned)n_seg);
  const int r0 = (int)(blockIdx.x / (unsigned)n_seg) * strip_h;
  const int r1 = min(r0 + strip_h, rows);
  const int c0 = seg * seg_w;
  const int w = min(seg_w, cols - c0);
  const float fth = (float)tile_h, ftw = (float)tile_w;
  const int tile_row = tiles_x * n_bins;

  // the first ty0 of the strip and tx0 of the segment, and (kPacked) the
  // entries from there
  int y_base = 0, x_base = 0;
  if (kPacked) {
    float d;
    int t1;
    tile_terms((float)(r0 + row_offset), fth, tiles_y, &d, &y_base, &t1);
    tile_terms((float)c0, ftw, tiles_x, &d, &x_base, &t1);
#pragma unroll 4
    for (int k = threadIdx.x; k < packed; k += kThreads) {
      const int yp = k / (nx * n_bins);
      const int xp = (k - yp * nx * n_bins) / n_bins;
      const int bin = k - (yp * nx + xp) * n_bins;
      const int ty0 = min(y_base + yp, tiles_y - 1);
      const int tx0 = min(x_base + xp, tiles_x - 1);
      const float* y0 = cdfs + ty0 * tile_row + bin;
      const float* y1 = cdfs + min(ty0 + 1, tiles_y - 1) * tile_row + bin;
      const int x0 = tx0 * n_bins, x1 = min(tx0 + 1, tiles_x - 1) * n_bins;
      s_pack[k] = make_float4(__ldg(y0 + x0), __ldg(y0 + x1), __ldg(y1 + x0),
                              __ldg(y1 + x1));
    }
  }
  for (int k = threadIdx.x; k < r1 - r0; k += kThreads) {
    float dy;
    int t0, t1;
    tile_terms((float)(r0 + k + row_offset), fth, tiles_y, &dy, &t0, &t1);
    const int o0 = kPacked ? (t0 - y_base) * nx * n_bins : t0 * tile_row;
    s_row[k] = make_float4(dy, __fsub_rn(1.0f, dy), __int_as_float(o0),
                           __int_as_float(t1 * tile_row));
  }
  // column k's term at (k % 4) * q + k / 4: a warp's lanes read element j
  // of neighbouring vectors, columns 4 apart, from neighbouring words
  const int q = seg_w >> 2;
  for (int k = threadIdx.x; k < w; k += kThreads) {
    float dx;
    int t0, t1;
    tile_terms((float)(c0 + k), ftw, tiles_x, &dx, &t0, &t1);
    s_col[(k & 3) * q + (k >> 2)] =
        make_float2(dx, __int_as_float((t0 - x_base) * n_bins));
  }
  __syncthreads();

  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const strip_walk::Strip s(bins, cols, c0, w, r0, r1);
  const bool out_vectors = (int)((op & 15) >> 2) == s.m;
  const int x_last = (tiles_x - 1) * n_bins;
  strip_walk::walk<kUnroll>(s, [&](int row, long long i0, int col, int4 v) {
    const float4 rt = s_row[row - r0];
    const int y0 = __float_as_int(rt.z), y1 = __float_as_int(rt.w);
    const int b[4] = {v.x, v.y, v.z, v.w};
    float o[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = (unsigned)(col + j) < (unsigned)w;
      const int c = clampi(col + j, 0, w - 1);
      const float2 ct = s_col[(c & 3) * q + (c >> 2)];
      const float dx = ct.x;
      const int x0 = __float_as_int(ct.y);
      const int sb = clampi(b[j], 0, n_bins - 1);
      float4 a;
      if (kPacked) {
        a = s_pack[y0 + x0 + sb];
      } else {
        const int x1 = x0 < x_last ? x0 + n_bins : x0;
        a = make_float4(
            __ldg(cdfs + y0 + x0 + sb), __ldg(cdfs + y0 + x1 + sb),
            __ldg(cdfs + y1 + x0 + sb), __ldg(cdfs + y1 + x1 + sb));
      }
      const float omdx = __fsub_rn(1.0f, dx);
      const float top = __fadd_rn(__fmul_rn(a.x, omdx), __fmul_rn(a.y, dx));
      const float bot = __fadd_rn(__fmul_rn(a.z, omdx), __fmul_rn(a.w, dx));
      o[j] = b[j] >= n_bins
                 ? 0.0f
                 : __fadd_rn(__fmul_rn(top, rt.y), __fmul_rn(bot, rt.x));
    }
    if (out_vectors && ok[0] && ok[1] && ok[2] && ok[3]) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) out[i0 + j] = o[j];
    }
  });
}

}  // namespace

// bins: (n,) int32, row-major rows of `cols`, at any 4-byte alignment; cdfs:
// (tiles_y * tiles_x, n_bins) f32, tile-major; out: (n,) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_clahe_lookup(const int* bins, long long n,
                                   const float* cdfs, int n_bins, int cols,
                                   int tiles_x, int tiles_y, int tile_h,
                                   int tile_w, long long row_offset,
                                   float* out, void* stream) {
  if (n <= 0) return 0;
  const int rows = (int)(n / cols);
  // segments: at most kSegCols wide, and no wider than a tile (so that they
  // meet at most 2 tile columns) down to kNarrowSeg; a multiple of 4, the
  // width spread evenly over as few as cover the row
  int widest = tile_w & ~3;
  widest = widest < kNarrowSeg ? kNarrowSeg : (widest > kSegCols ? kSegCols
                                                                  : widest);
  const int n_seg0 = (cols + widest - 1) / widest;
  const int seg_w = (((cols + n_seg0 - 1) / n_seg0) + 3) & ~3;
  const int n_seg = (cols + seg_w - 1) / seg_w;
  int tallest = tile_h < kMaxStrip ? tile_h : kMaxStrip;
  if (tallest > rows) tallest = rows;
  // a strip of at most tile_h rows moves rf by less than 1, so it meets at
  // most 2 values of ty0; a segment of w columns at most (w - 1) / tile_w + 2
  // values of tx0 (both while rf and cf are exact below 2^23)
  const int ny = tiles_y < 2 ? tiles_y : 2;
  int nx = (seg_w - 1) / tile_w + 2;
  if (nx > tiles_x) nx = tiles_x;
  const size_t terms =
      (size_t)tallest * sizeof(float4) + (size_t)seg_w * sizeof(float2);
  const size_t pack = (size_t)ny * nx * n_bins * sizeof(float4);
  const bool packed = pack + terms <= (size_t)kMaxSmem &&
                      rows + row_offset < kExact && cols < kExact;
  const size_t smem = (packed ? pack : 0) + terms;
  auto kernel =
      packed ? clahe_lookup_kernel<true> : clahe_lookup_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  // strips: one wave of resident blocks, each at least kMinPixels (its
  // terms and packed CDFs spread over enough pixels), at most `tallest`
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long strips = wave / n_seg;
  if (strips < 1) strips = 1;
  long long strip_h = (rows + strips - 1) / strips;
  const long long least = (kMinPixels + seg_w - 1) / seg_w;
  if (strip_h < least) strip_h = least;
  if (strip_h > tallest) strip_h = tallest;
  const long long blocks = (long long)n_seg * ((rows + strip_h - 1) / strip_h);
  kernel<<<(unsigned)blocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      bins, cdfs, n_bins, rows, cols, tiles_x, tiles_y, tile_h, tile_w,
      row_offset, seg_w, n_seg, (int)strip_h, nx, ny, out);
  return (int)cudaGetLastError();
}
