// Inverse-map warp sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel `_warp_tile_kernel` (sarpro_tpu/ops/warp_kernel.py,
// reached through `warp_sample_tiled` and `tiled_flat_call`). The TPU
// gathers slowly, so that kernel DMAs an aligned (48, 384) source window per
// (16, 128) output tile, refits the mapping per tile, and samples separably
// with one-hot weight matmuls; it matches the XLA sampler only to a mean
// abs error below 1e-3. Hopper gathers cheaply, so this kernel computes the
// function of `sarpro_tpu/io/warp._warp_sample_block` (whole output, row0 =
// 0) for each output pixel (r, c):
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
// What bounds it: the gathers, 1, 4 or 16 per output pixel, from a source
// of ~26 MB at the slice's shape (a ~2560^2 f32 host-reduced band) that
// fits the 50 MB L2; the output write is 4 bytes per pixel.
//
// Design: one thread per output pixel, a warp along a row so the mapping
// grid reads and the output writes coalesce and neighbouring threads gather
// neighbouring source pixels; the source and grids are read through the
// read-only cache (__ldg). Every f32 operation is an explicitly rounded
// intrinsic in the plain PyTorch version's order, so nvcc contracts nothing
// into an FMA and the kernel equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kIndexLimit = 1 << 30;

__device__ __forceinline__ int to_index(float x) {
  const int i = __float2int_rd(x);  // floor; saturates; NaN -> 0
  return i < -kIndexLimit ? -kIndexLimit : (i > kIndexLimit ? kIndexLimit : i);
}

__device__ __forceinline__ float blend(float a, float b, float f) {
  // a * (1 - f) + b * f, each step rounded
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float keys(float t) {
  // Keys cubic, a = -0.5, in io/warp.py:276-282's order:
  // w1 = 1.5 at^3 - 2.5 at^2 + 1, w2 = a at^3 - 5a at^2 + 8a at - 4a
  const float at = fabsf(t);
  const float at2 = __fmul_rn(at, at);
  const float at3 = __fmul_rn(at2, at);
  if (at < 1.0f)
    return __fadd_rn(__fsub_rn(__fmul_rn(1.5f, at3), __fmul_rn(2.5f, at2)),
                     1.0f);
  if (at < 2.0f)
    return __fsub_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, at3), __fmul_rn(-2.5f, at2)),
                  __fmul_rn(-4.0f, at)),
        -2.0f);
  return 0.0f;
}

struct Source {
  const float* p;
  int h, w;
  // the value at (iy, ix), 0 outside; `valid` says whether it was inside
  __device__ __forceinline__ float at(int iy, int ix, bool& valid) const {
    valid = iy >= 0 && iy < h && ix >= 0 && ix < w;
    return valid ? __ldg(p + (long long)iy * w + ix) : 0.0f;
  }
};

template <int kMethod>
__global__ void warp_kernel(Source src, const float* __restrict__ map_x,
                            const float* __restrict__ map_y, int gh, int gw,
                            float scale_r, float scale_c,
                            float* __restrict__ out, int out_rows,
                            int out_cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= out_cols || r >= out_rows) return;
  // mapping-grid coordinates of the output pixel (the grid spans the output)
  const float gr = __fmul_rn((float)r, scale_r);
  const float gc = __fmul_rn((float)c, scale_c);
  const int gr0 = (int)fminf(fmaxf(floorf(gr), 0.0f), (float)(gh - 2));
  const int gc0 = (int)fminf(fmaxf(floorf(gc), 0.0f), (float)(gw - 2));
  const float fr = __fsub_rn(gr, (float)gr0);
  const float fc = __fsub_rn(gc, (float)gc0);
  const long long k00 = (long long)gr0 * gw + gc0;
  const long long k10 = k00 + gw;
  const float sx = blend(blend(__ldg(map_x + k00), __ldg(map_x + k00 + 1), fc),
                         blend(__ldg(map_x + k10), __ldg(map_x + k10 + 1), fc),
                         fr);
  const float sy = blend(blend(__ldg(map_y + k00), __ldg(map_y + k00 + 1), fc),
                         blend(__ldg(map_y + k10), __ldg(map_y + k10 + 1), fc),
                         fr);
  float result;
  bool m;
  if (kMethod == 0) {  // near
    result = src.at(to_index(__fadd_rn(sy, 0.5f)),
                    to_index(__fadd_rn(sx, 0.5f)), m);
  } else if (kMethod == 1) {  // bilinear
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    const float fx = __fsub_rn(sx, x0f);
    const float fy = __fsub_rn(sy, y0f);
    const int x0 = to_index(x0f);
    const int y0 = to_index(y0f);
    bool m00, m01, m10, m11;
    const float v00 = src.at(y0, x0, m00);
    const float v01 = src.at(y0, x0 + 1, m01);
    const float v10 = src.at(y0 + 1, x0, m10);
    const float v11 = src.at(y0 + 1, x0 + 1, m11);
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
    result = wsum > 0.0f ? __fdiv_rn(val, fmaxf(wsum, 1e-20f)) : 0.0f;
  } else {  // cubic
    const int x0 = to_index(floorf(sx));
    const int y0 = to_index(floorf(sy));
    const float fx = __fsub_rn(sx, (float)x0);
    const float fy = __fsub_rn(sy, (float)y0);
    float val = 0.0f;
    float wsum = 0.0f;
#pragma unroll
    for (int dy = -1; dy < 3; ++dy) {
      const float wy = keys(__fsub_rn(fy, (float)dy));
#pragma unroll
      for (int dx = -1; dx < 3; ++dx) {
        const float wx = keys(__fsub_rn(fx, (float)dx));
        const float v = src.at(y0 + dy, x0 + dx, m);
        const float wgt = __fmul_rn(__fmul_rn(wx, wy), m ? 1.0f : 0.0f);
        val = __fadd_rn(val, __fmul_rn(v, wgt));
        wsum = __fadd_rn(wsum, wgt);
      }
    }
    result = wsum > 1e-6f ? __fdiv_rn(val, fmaxf(wsum, 1e-20f)) : 0.0f;
  }
  out[(long long)r * out_cols + c] = result;
}

template <int kMethod>
int launch(const float* src, int h, int w, const float* map_x,
           const float* map_y, int gh, int gw, float scale_r, float scale_c,
           float* out, int out_rows, int out_cols, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((out_cols + kBlockX - 1) / kBlockX,
                  (out_rows + kBlockY - 1) / kBlockY);
  warp_kernel<kMethod><<<grid, block, 0, stream>>>(
      Source{src, h, w}, map_x, map_y, gh, gw, scale_r, scale_c, out,
      out_rows, out_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// src: (h, w) f32; map_x, map_y: (gh, gw) f32 source column and row of the
// grid nodes; scale_r = (gh - 1) / max(out_rows - 1, 1) and scale_c likewise,
// rounded to f32; method 0 = near, 1 = bilinear, 2 = cubic; out: (out_rows,
// out_cols) f32. Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_warp_sample(const float* src, int h, int w,
                                  const float* map_x, const float* map_y,
                                  int gh, int gw, float scale_r,
                                  float scale_c, int method, float* out,
                                  int out_rows, int out_cols, void* stream) {
  if (out_rows <= 0 || out_cols <= 0) return 0;
  if (out_rows > 65535 * kBlockY) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case 0:
      return launch<0>(src, h, w, map_x, map_y, gh, gw, scale_r, scale_c,
                       out, out_rows, out_cols, s);
    case 1:
      return launch<1>(src, h, w, map_x, map_y, gh, gw, scale_r, scale_c,
                       out, out_rows, out_cols, s);
    case 2:
      return launch<2>(src, h, w, map_x, map_y, gh, gw, scale_r, scale_c,
                       out, out_rows, out_cols, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
