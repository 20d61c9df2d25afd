// Inverse-map warp sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel `_warp_tile_kernel` (sarpro_tpu/ops/warp_kernel.py,
// reached through `warp_sample_tiled` and `tiled_flat_call`). The TPU
// gathers slowly, so that kernel DMAs an aligned (48, 384) source window per
// (16, 128) output tile, refits the mapping per tile, and samples separably
// with one-hot weight matmuls; it matches the XLA sampler only to a mean
// abs error below 1e-3. This kernel computes the function of
// `sarpro_tpu/io/warp._warp_sample_block` for each output pixel (r, c) of
// the rows [row0, row0 + rows) of the (out_rows, out_cols) output (the whole
// output, or one row shard of it):
//   gr = r * scale_r, gc = c * scale_c (scales rounded to f32 on the host),
//   cell = clamp(floor(g), 0, g_n - 2), f = g - cell,
//   (sx, sy) = bilinear blend of the 4 grid nodes around the pixel,
// then samples the source at (sy, sx): near (floor(s + 0.5)), bilinear, or
// Keys cubic (a = -0.5) over 4x4 taps, with the weights renormalised by the
// sum over in-bounds taps (> 0 for bilinear, > 1e-6 for cubic) and 0 where
// no tap is in bounds.
//
// Float -> int uses __float2int_rd (saturating, NaN -> 0, as XLA converts),
// then clamps into +-2^30 like the plain version, so a NaN grid node reads
// source pixel (0, 0) under `near`, as the reference does, and x0 + dx
// never overflows.
//
// What bounds it: at the slice's shape (a 2380^2 f32 host-reduced band to
// 2048^2) the bytes are 22.7 MB of source read and 16.8 MB written, 0.012
// ms at 3.35 TB/s. A cubic pixel also costs some 230 instructions (two grid
// blends, 8 Keys weights, 16 taps of two products and two sums, an IEEE
// division), about 30 M warp instructions for the band: instruction issue,
// not memory, bounds cubic, near 0.04 ms on 132 SMs.
//
// Design. Near and bilinear (1 and 4 taps) keep one thread a pixel in
// 32 x 8 tiles and gather through the read-only cache: staging costs them
// more than it saves (measured). Cubic takes 32 x 32 output tiles, 4 pixels
// a thread:
//   * each thread maps its pixels (the column half of the blend once, the
//     blends along the columns kept while its rows stay in one grid cell)
//     and the block reduces the union of their in-bounds taps: the tile's
//     exact source footprint (about 50 x 50 at the slice's shape);
//   * a footprint of up to kStage pixels is staged into shared memory with
//     coalesced loads, 4 in flight a thread, and the taps read from there;
//     a larger one (strong shrinks, NaN or far-out nodes, whose pixels read
//     taps at 0 or +-2^30) reads every tap through the read-only cache, in
//     the same kernel with the same arithmetic;
//   * a pixel computes its 4 x and 4 y Keys weights once (the one-thread-a-
//     pixel design evaluated 20) and skips out-of-bounds taps: their weight
//     times the zero they read adds a signed zero to sums that are never -0,
//     so the sums stay the plain version's bit for bit. The in-bounds test
//     stays on the source coordinates;
//   * where every tap of the tile is inside the source (its "interior"),
//     the taps go untested and each Keys weight takes its known branch
//     (cubic_interior): the same values, fewer instructions.
// Every f32 operation is an explicitly rounded intrinsic in the plain
// PyTorch version's order, so nvcc contracts nothing into an FMA and the
// kernel equals the plain version bit for bit.
//
// A row shard (row0, rows) keeps the whole output's grid scales and its
// tiles: they stay placed by global row (tile t covers global rows
// [t * tile rows, (t + 1) * tile rows)), and only the rows outside the shard
// are left out of a tile at its edges. A pixel's arithmetic is the same in
// every branch, so each shard equals its rows of the whole output bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // output tile side
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 8192;  // source pixels a tile may stage (32 KB)
constexpr int kIndexLimit = 1 << 30;
// tile kinds, as sarpro_warp_tiles reports them
constexpr int kStaged = 0;    // footprint in shared memory, taps tested
constexpr int kOutside = 1;   // no tap of the tile in the source
constexpr int kGlobal = 2;    // taps from device memory
constexpr int kInterior = 3;  // footprint in shared memory, all taps inside

__device__ __forceinline__ int to_index(float x) {
  const int i = __float2int_rd(x);  // floor; saturates; NaN -> 0
  return i < -kIndexLimit ? -kIndexLimit : (i > kIndexLimit ? kIndexLimit : i);
}

__device__ __forceinline__ float blend(float a, float b, float f) {
  // a * (1 - f) + b * f, each step rounded
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// Keys cubic, a = -0.5, in io/warp.py:276-282's order: the inner branch
// w1 = 1.5 at^3 - 2.5 at^2 + 1 (at < 1) and the outer one
// w2 = a at^3 - 5a at^2 + 8a at - 4a (1 <= at < 2)
__device__ __forceinline__ float keys_inner(float at) {
  const float at2 = __fmul_rn(at, at);
  const float at3 = __fmul_rn(at2, at);
  return __fadd_rn(__fsub_rn(__fmul_rn(1.5f, at3), __fmul_rn(2.5f, at2)),
                   1.0f);
}

__device__ __forceinline__ float keys_outer(float at) {
  const float at2 = __fmul_rn(at, at);
  const float at3 = __fmul_rn(at2, at);
  return __fsub_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, at3), __fmul_rn(-2.5f, at2)),
                __fmul_rn(-4.0f, at)),
      -2.0f);
}

__device__ __forceinline__ float keys(float t) {
  const float at = fabsf(t);
  if (at < 1.0f) return keys_inner(at);
  if (at < 2.0f) return keys_outer(at);
  return 0.0f;
}

struct Grid {
  const float* map_x;
  const float* map_y;
  int gh, gw;
  float scale_r, scale_c;
};

// source column sx and row sy of output pixel (r, c)
__device__ __forceinline__ void map_pixel(const Grid& g, int r, int c,
                                          float& sx, float& sy) {
  const float gr = __fmul_rn((float)r, g.scale_r);
  const float gc = __fmul_rn((float)c, g.scale_c);
  const int gr0 = (int)fminf(fmaxf(floorf(gr), 0.0f), (float)(g.gh - 2));
  const int gc0 = (int)fminf(fmaxf(floorf(gc), 0.0f), (float)(g.gw - 2));
  const float fr = __fsub_rn(gr, (float)gr0);
  const float fc = __fsub_rn(gc, (float)gc0);
  const long long k00 = (long long)gr0 * g.gw + gc0;
  const long long k10 = k00 + g.gw;
  const float* mx = g.map_x;
  const float* my = g.map_y;
  sx = blend(blend(__ldg(mx + k00), __ldg(mx + k00 + 1), fc),
             blend(__ldg(mx + k10), __ldg(mx + k10 + 1), fc), fr);
  sy = blend(blend(__ldg(my + k00), __ldg(my + k00 + 1), fc),
             blend(__ldg(my + k10), __ldg(my + k10 + 1), fc), fr);
}

struct GlobalFetch {
  const float* p;
  int w;
  __device__ __forceinline__ float operator()(int iy, int ix) const {
    return __ldg(p + (long long)iy * w + ix);
  }
};

struct StageFetch {
  const float* s;
  int x0, y0, fw;
  __device__ __forceinline__ float operator()(int iy, int ix) const {
    return s[(iy - y0) * fw + (ix - x0)];
  }
};

// source taps [first, first + kCount) along each axis of a pixel at (sy,
// sx): floor(s + 0.5) for near, floor(s) - kLo onwards otherwise
template <int kMethod>
struct Taps {
  static constexpr int kLo = kMethod == 2 ? 1 : 0;
  static constexpr int kCount = kMethod == 0 ? 1 : (kMethod == 1 ? 2 : 4);
  __device__ __forceinline__ static int first(float s) {
    return kMethod == 0 ? to_index(__fadd_rn(s, 0.5f))
                        : to_index(floorf(s)) - kLo;
  }
};

// Cubic stages its footprint (16 taps a pixel); near and bilinear gather
// from device memory, where 1 and 4 taps do not repay the staging.
template <int kMethod>
struct Plan {
  static constexpr bool kStages = kMethod == 2;
  static constexpr int kTileRows = kStages ? kTile : kThreadsY;
  static constexpr int kPixels = kTileRows / kThreadsY;  // a thread's
};

template <int kMethod, class F>
__device__ __forceinline__ float sample(const F& f, int h, int w, float sx,
                                        float sy) {
  if (kMethod == 0) {  // near
    const int iy = to_index(__fadd_rn(sy, 0.5f));
    const int ix = to_index(__fadd_rn(sx, 0.5f));
    return iy >= 0 && iy < h && ix >= 0 && ix < w ? f(iy, ix) : 0.0f;
  }
  if (kMethod == 1) {  // bilinear
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    const float fx = __fsub_rn(sx, x0f);
    const float fy = __fsub_rn(sy, y0f);
    const int x0 = to_index(x0f);
    const int y0 = to_index(y0f);
    const bool vx0 = x0 >= 0 && x0 < w, vx1 = x0 + 1 >= 0 && x0 + 1 < w;
    const bool vy0 = y0 >= 0 && y0 < h, vy1 = y0 + 1 >= 0 && y0 + 1 < h;
    const bool m00 = vy0 && vx0, m01 = vy0 && vx1;
    const bool m10 = vy1 && vx0, m11 = vy1 && vx1;
    const float v00 = m00 ? f(y0, x0) : 0.0f;
    const float v01 = m01 ? f(y0, x0 + 1) : 0.0f;
    const float v10 = m10 ? f(y0 + 1, x0) : 0.0f;
    const float v11 = m11 ? f(y0 + 1, x0 + 1) : 0.0f;
    const float omfx = __fsub_rn(1.0f, fx);
    const float omfy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(omfx, omfy);
    const float w01 = __fmul_rn(fx, omfy);
    const float w10 = __fmul_rn(omfx, fy);
    const float w11 = __fmul_rn(fx, fy);
    float wsum = __fmul_rn(w00, m00 ? 1.0f : 0.0f);
    wsum = __fadd_rn(wsum, __fmul_rn(w01, m01 ? 1.0f : 0.0f));
    wsum = __fadd_rn(wsum, __fmul_rn(w10, m10 ? 1.0f : 0.0f));
    wsum = __fadd_rn(wsum, __fmul_rn(w11, m11 ? 1.0f : 0.0f));
    float val = __fmul_rn(v00, w00);
    val = __fadd_rn(val, __fmul_rn(v01, w01));
    val = __fadd_rn(val, __fmul_rn(v10, w10));
    val = __fadd_rn(val, __fmul_rn(v11, w11));
    return wsum > 0.0f ? __fdiv_rn(val, fmaxf(wsum, 1e-20f)) : 0.0f;
  }
  // cubic
  const int x0 = to_index(floorf(sx));
  const int y0 = to_index(floorf(sy));
  const float fx = __fsub_rn(sx, (float)x0);
  const float fy = __fsub_rn(sy, (float)y0);
  float wx[4], wy[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    wx[d] = keys(__fsub_rn(fx, (float)(d - 1)));
    wy[d] = keys(__fsub_rn(fy, (float)(d - 1)));
  }
  float val = 0.0f;
  float wsum = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const int iy = y0 + dy - 1;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      const int ix = x0 + dx - 1;
      // an out-of-bounds tap would add (w * 0) * 0 and w * 0, signed
      // zeros, to sums that are never -0: skipping it changes no bit
      if (ix < 0 || ix >= w) continue;
      const float wgt = __fmul_rn(wx[dx], wy[dy]);
      val = __fadd_rn(val, __fmul_rn(f(iy, ix), wgt));
      wsum = __fadd_rn(wsum, wgt);
    }
  }
  return wsum > 1e-6f ? __fdiv_rn(val, fmaxf(wsum, 1e-20f)) : 0.0f;
}

// Cubic for a pixel whose 16 taps are all inside the source (so its
// coordinates are finite and f = s - floor(s) lies in [0, 1)), from the
// staged footprint at (sx0, sy0) of width fw. keys() then takes a known
// branch for each tap: |f + 1| in [1, 2] and |f - 2| in (1, 2] the outer
// one, |f| in [0, 1) the inner one, |f - 1| in (0, 1] the inner one; at
// 1 and 2, where the branch would switch, both forms give +0. No tap is
// tested: the weights and sums are the checked form's bit for bit.
__device__ __forceinline__ float cubic_interior(const float* stage, int sx0,
                                                int sy0, int fw, float sx,
                                                float sy) {
  const int x0 = to_index(floorf(sx));
  const int y0 = to_index(floorf(sy));
  const float fx = __fsub_rn(sx, (float)x0);
  const float fy = __fsub_rn(sy, (float)y0);
  const float wx[4] = {keys_outer(fabsf(__fsub_rn(fx, -1.0f))),
                       keys_inner(fabsf(fx)),
                       keys_inner(fabsf(__fsub_rn(fx, 1.0f))),
                       keys_outer(fabsf(__fsub_rn(fx, 2.0f)))};
  const float wy[4] = {keys_outer(fabsf(__fsub_rn(fy, -1.0f))),
                       keys_inner(fabsf(fy)),
                       keys_inner(fabsf(__fsub_rn(fy, 1.0f))),
                       keys_outer(fabsf(__fsub_rn(fy, 2.0f)))};
  const float* p = stage + (y0 - 1 - sy0) * fw + (x0 - 1 - sx0);
  float val = 0.0f;
  float wsum = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      const float wgt = __fmul_rn(wx[dx], wy[dy]);
      val = __fadd_rn(val, __fmul_rn(p[dy * fw + dx], wgt));
      wsum = __fadd_rn(wsum, wgt);
    }
  }
  return wsum > 1e-6f ? __fdiv_rn(val, fmaxf(wsum, 1e-20f)) : 0.0f;
}

struct Stage {
  int kind;
  int x0, y0, fw, fh;  // the staged source rectangle
};

// Each thread maps its pixels of the tile at (r0, c0), those of global rows
// [rlo, rhi), into (sx, sy); the union of their in-bounds taps is the
// footprint, and `st` gets the tile's kind (all threads take part).
template <int kMethod>
__device__ void tile_plan(const Grid& g, int h, int w, int rlo, int rhi,
                          int out_cols, int r0, int c0,
                          float (&sx)[Plan<kMethod>::kPixels],
                          float (&sy)[Plan<kMethod>::kPixels], Stage& st,
                          int* red) {
  constexpr int n = Taps<kMethod>::kCount;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int c = c0 + threadIdx.x;
  int xlo = 0x7FFFFFFF, xhi = -1, ylo = 0x7FFFFFFF, yhi = -1;
  int interior = 1;
  // map_pixel, with the column half computed once and the blends along the
  // columns kept while the pixels stay in one row of grid cells
  const float gc = __fmul_rn((float)c, g.scale_c);
  const int gc0 = (int)fminf(fmaxf(floorf(gc), 0.0f), (float)(g.gw - 2));
  const float fc = __fsub_rn(gc, (float)gc0);
  int cell_row = -1;
  float x_top = 0.0f, x_bot = 0.0f, y_top = 0.0f, y_bot = 0.0f;
#pragma unroll
  for (int k = 0; k < Plan<kMethod>::kPixels; ++k) {
    const int r = r0 + threadIdx.y + k * kThreadsY;
    if (r < rlo || r >= rhi || c >= out_cols) continue;
    const float gr = __fmul_rn((float)r, g.scale_r);
    const int gr0 = (int)fminf(fmaxf(floorf(gr), 0.0f), (float)(g.gh - 2));
    if (gr0 != cell_row) {
      const long long k00 = (long long)gr0 * g.gw + gc0;
      const long long k10 = k00 + g.gw;
      x_top = blend(__ldg(g.map_x + k00), __ldg(g.map_x + k00 + 1), fc);
      x_bot = blend(__ldg(g.map_x + k10), __ldg(g.map_x + k10 + 1), fc);
      y_top = blend(__ldg(g.map_y + k00), __ldg(g.map_y + k00 + 1), fc);
      y_bot = blend(__ldg(g.map_y + k10), __ldg(g.map_y + k10 + 1), fc);
      cell_row = gr0;
    }
    const float fr = __fsub_rn(gr, (float)gr0);
    sx[k] = blend(x_top, x_bot, fr);
    sy[k] = blend(y_top, y_bot, fr);
    const int ax = Taps<kMethod>::first(sx[k]);
    const int ay = Taps<kMethod>::first(sy[k]);
    const int bx = ax + n - 1, by = ay + n - 1;
    interior &= ax >= 0 && bx < w && ay >= 0 && by < h;
    const int cx0 = max(ax, 0), cx1 = min(bx, w - 1);
    const int cy0 = max(ay, 0), cy1 = min(by, h - 1);
    if (cx0 <= cx1 && cy0 <= cy1) {  // some tap in bounds
      xlo = min(xlo, cx0);
      xhi = max(xhi, cx1);
      ylo = min(ylo, cy0);
      yhi = max(yhi, cy1);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    xlo = min(xlo, __shfl_xor_sync(0xFFFFFFFFu, xlo, off));
    xhi = max(xhi, __shfl_xor_sync(0xFFFFFFFFu, xhi, off));
    ylo = min(ylo, __shfl_xor_sync(0xFFFFFFFFu, ylo, off));
    yhi = max(yhi, __shfl_xor_sync(0xFFFFFFFFu, yhi, off));
  }
  interior = __all_sync(0xFFFFFFFFu, interior);
  if ((tid & 31) == 0) {
    int* r = red + (tid >> 5) * 5;
    r[0] = xlo;
    r[1] = xhi;
    r[2] = ylo;
    r[3] = yhi;
    r[4] = interior;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k) {
      xlo = min(xlo, red[k * 5]);
      xhi = max(xhi, red[k * 5 + 1]);
      ylo = min(ylo, red[k * 5 + 2]);
      yhi = max(yhi, red[k * 5 + 3]);
      interior &= red[k * 5 + 4];
    }
    Stage s{kOutside, 0, 0, 0, 0};
    if (xlo <= xhi) {
      const long long area = (long long)(xhi - xlo + 1) * (yhi - ylo + 1);
      s = Stage{area > kStage ? kGlobal : (interior ? kInterior : kStaged),
                xlo, ylo, xhi - xlo + 1, yhi - ylo + 1};
    }
    st = s;
  }
  __syncthreads();
}

template <int kMethod>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ src, int h, int w, Grid g,
            float* __restrict__ out, int row0, int rows, int out_cols) {
  using P = Plan<kMethod>;
  // tiles at global rows; the shard's rows are [row0, row0 + rows)
  const int r0 = (row0 / P::kTileRows + (int)blockIdx.y) * P::kTileRows;
  const int rhi = row0 + rows;
  const int c = blockIdx.x * kThreadsX + threadIdx.x;
  const GlobalFetch gf{src, w};
  if (!P::kStages) {  // one pixel a thread, taps from device memory
    const int r = r0 + threadIdx.y;
    if (r < row0 || r >= rhi || c >= out_cols) return;
    float sx, sy;
    map_pixel(g, r, c, sx, sy);
    out[(long long)(r - row0) * out_cols + c] =
        sample<kMethod>(gf, h, w, sx, sy);
    return;
  }
  __shared__ __align__(16) float stage[P::kStages ? kStage : 1];
  __shared__ Stage st;
  __shared__ int red[kWarps * 5];
  float sx[P::kPixels], sy[P::kPixels];
  tile_plan<kMethod>(g, h, w, row0, rhi, out_cols, r0,
                     blockIdx.x * kThreadsX, sx, sy, st, red);
  const Stage t = st;
  if (t.kind == kStaged || t.kind == kInterior) {
    // rows of the footprint a warp at a time, 4 loads in flight a thread
    for (int rb = threadIdx.y; rb < t.fh; rb += 4 * kThreadsY) {
      for (int col = threadIdx.x; col < t.fw; col += kThreadsX) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = rb + u * kThreadsY;
          if (row < t.fh)
            v[u] = __ldg(src + (long long)(t.y0 + row) * w + t.x0 + col);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = rb + u * kThreadsY;
          if (row < t.fh) stage[row * t.fw + col] = v[u];
        }
      }
    }
    __syncthreads();
  }
  if (c >= out_cols) return;
  const StageFetch sf{stage, t.x0, t.y0, t.fw};
#pragma unroll
  for (int k = 0; k < P::kPixels; ++k) {
    const int r = r0 + threadIdx.y + k * kThreadsY;
    if (r < row0) continue;
    if (r >= rhi) break;
    float v;
    if (t.kind == kGlobal)
      v = sample<kMethod>(gf, h, w, sx[k], sy[k]);
    else if (kMethod == 2 && t.kind == kInterior)
      v = cubic_interior(stage, t.x0, t.y0, t.fw, sx[k], sy[k]);
    else  // every in-bounds tap of the pixel lies in the footprint
      v = sample<kMethod>(sf, h, w, sx[k], sy[k]);
    out[(long long)(r - row0) * out_cols + c] = v;
  }
}

template <int kMethod>
__global__ void __launch_bounds__(kThreads)
warp_tiles_kernel(int h, int w, Grid g, int row0, int rows, int out_cols,
                  int* __restrict__ kinds) {
  using P = Plan<kMethod>;
  __shared__ Stage st;
  __shared__ int red[kWarps * 5];
  const long long tile = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (!P::kStages) {
    if (threadIdx.x == 0 && threadIdx.y == 0) kinds[tile] = kGlobal;
    return;
  }
  float sx[P::kPixels], sy[P::kPixels];
  tile_plan<kMethod>(g, h, w, row0, row0 + rows, out_cols,
                     (row0 / P::kTileRows + (int)blockIdx.y) * P::kTileRows,
                     blockIdx.x * kThreadsX, sx, sy, st, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) kinds[tile] = st.kind;
}

template <int kMethod>
int launch(const float* src, int h, int w, const Grid& g, float* out,
           int* kinds, int row0, int rows, int out_cols,
           cudaStream_t stream) {
  constexpr int tr = Plan<kMethod>::kTileRows;
  // the global tile rows that hold [row0, row0 + rows)
  const int tiles = (row0 + rows - 1) / tr - row0 / tr + 1;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((out_cols + kThreadsX - 1) / kThreadsX, tiles);
  if (kinds != nullptr)
    warp_tiles_kernel<kMethod><<<grid, block, 0, stream>>>(
        h, w, g, row0, rows, out_cols, kinds);
  else
    warp_kernel<kMethod><<<grid, block, 0, stream>>>(src, h, w, g, out, row0,
                                                     rows, out_cols);
  return (int)cudaGetLastError();
}

int dispatch(const float* src, int h, int w, const float* map_x,
             const float* map_y, int gh, int gw, float scale_r, float scale_c,
             int method, float* out, int* kinds, int row0, int rows,
             int out_cols, void* stream) {
  if (row0 < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || out_cols <= 0) return 0;
  const Grid g{map_x, map_y, gh, gw, scale_r, scale_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case 0:
      return launch<0>(src, h, w, g, out, kinds, row0, rows, out_cols, s);
    case 1:
      return launch<1>(src, h, w, g, out, kinds, row0, rows, out_cols, s);
    case 2:
      return launch<2>(src, h, w, g, out, kinds, row0, rows, out_cols, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// src: (h, w) f32; map_x, map_y: (gh, gw) f32 source column and row of the
// grid nodes; scale_r = (gh - 1) / max(out_rows - 1, 1) and scale_c likewise,
// rounded to f32, of the whole (out_rows, out_cols) output; method 0 = near,
// 1 = bilinear, 2 = cubic; out: (rows, out_cols) f32, the output's rows
// [row0, row0 + rows). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int sarpro_warp_sample(const float* src, int h, int w,
                                  const float* map_x, const float* map_y,
                                  int gh, int gw, float scale_r,
                                  float scale_c, int method, float* out,
                                  int row0, int rows, int out_cols,
                                  void* stream) {
  return dispatch(src, h, w, map_x, map_y, gh, gw, scale_r, scale_c, method,
                  out, nullptr, row0, rows, out_cols, stream);
}

// The branch sarpro_warp_sample takes for each output tile of the same
// arguments (0 staged with tested taps, 1 outside the source, 2 device
// memory, 3 staged interior), into kinds: (the global tile rows that hold
// [row0, row0 + rows), ceil(out_cols / 32)) int32, tile rows 32 for cubic
// and 8 for near and bilinear (whose tiles are all 2). Inspection only: it
// samples nothing.
extern "C" int sarpro_warp_tiles(int h, int w, const float* map_x,
                                 const float* map_y, int gh, int gw,
                                 float scale_r, float scale_c, int method,
                                 int* kinds, int row0, int rows,
                                 int out_cols, void* stream) {
  return dispatch(nullptr, h, w, map_x, map_y, gh, gw, scale_r, scale_c,
                  method, nullptr, kinds, row0, rows, out_cols, stream);
}
