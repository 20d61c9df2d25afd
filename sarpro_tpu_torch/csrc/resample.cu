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
// the tap loop core/resize._resample_axis0: each product rounded, then each
// sum, taps in order (__fmul_rn / __fadd_rn, no FMA contraction).
//
// What bounds it: device-memory bandwidth. The source (800 MB for a
// 20000 x 20000 u16 band) has to be read once and the output (164 MB at
// 2048 rows) written once: 0.29 ms at 3.35 TB/s. Each output row reads
// `taps` source rows (41 for cubic at 20000 -> 2048), so a kernel that
// fetches every tap from memory (this file's first design) moves the source
// about taps / stride = 4.2 times through L2 with one 2-byte load a tap.
//
// Design: a block of 128 threads owns a strip of kCols = 32 columns and a
// group of R = 16 consecutive output rows. It stages the source rows that
// group needs, min(starts) .. max(starts) + taps - 1 (clamped as the tap
// loop clamps), once into shared memory as f32: 16-byte loads, up to 8 in
// flight a thread, the u16 -> f32 conversion done there (exact, by the 2^23
// mantissa trick) so the tap loop does none. The group's weights and starts
// are staged too. Each thread then computes one output row of 4 neighbouring
// columns from shared memory (one 16-byte shared load and one weight a tap,
// for 4 products). The source crosses to the SM (R * stride + taps) /
// (R * stride) = 1.26 times at the slice's shape; blocks are ordered
// strip-fastest, so the blocks in flight read whole source rows and the rows
// that two neighbouring groups share are still in L2 for the second. About
// 27 KB of shared memory and 72 registers a block let 7 blocks share an SM,
// and it is their overlap of one block's loads with another's tap loop that
// sets the speed: groups of 32 rows (fewer blocks an SM), a thread computing
// two rows from one load (less shared-memory traffic, more registers), a
// cap of 64 registers (spills), and an L2 prefetch of a block's next group
// were each slower or no faster on the card.
//
// Any shape is taken by the same kernel: a ragged last strip, rows that are
// not 16-byte aligned (element loads instead of vectors), in_rows < taps
// (the clamp at staging), upsampling and the f32 column pass. Where a
// group's rows do not fit the shared memory (an extreme reduction, taps in
// the thousands), R shrinks, and below one row that block reads its taps
// from device memory instead, with the same arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 32;                             // columns per block
constexpr int kQuad = 4;                              // columns per thread
constexpr int kLanesPerRow = kCols / kQuad;           // 8 threads per row
constexpr int kRowsAtOnce = kThreads / kLanesPerRow;  // 16 output rows
constexpr int kBatch = 8;        // 16-byte staging loads in flight a thread
constexpr int kMaxSmem = 227 * 1024;

// u16 -> f32, exact: 2^23 + u has u in its mantissa
__device__ __forceinline__ float u16_to_f32(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.0f);
}

__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return (float)__ldg(p);
}
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

// 16 bytes of source -> f32 in shared memory
__device__ __forceinline__ void store_vec(float* s, uint4 v, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[2 * j] = u16_to_f32(w[j] & 0xFFFFu);
    s[2 * j + 1] = u16_to_f32(w[j] >> 16);
  }
}
__device__ __forceinline__ void store_vec(float* s, uint4 v, float) {
  *reinterpret_cast<float4*>(s) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                  __uint_as_float(v.z), __uint_as_float(v.w));
}

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// 4 neighbouring columns of an output row: each product rounded, then each
// sum, taps in order
struct Quad {
  float a0, a1, a2, a3;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void first_tap(Quad& q, float w, float4 v) {
  q.a0 = __fmul_rn(w, v.x);
  q.a1 = __fmul_rn(w, v.y);
  q.a2 = __fmul_rn(w, v.z);
  q.a3 = __fmul_rn(w, v.w);
}

__device__ __forceinline__ void add_tap(Quad& q, float w, float4 v) {
  q.a0 = __fadd_rn(q.a0, __fmul_rn(w, v.x));
  q.a1 = __fadd_rn(q.a1, __fmul_rn(w, v.y));
  q.a2 = __fadd_rn(q.a2, __fmul_rn(w, v.z));
  q.a3 = __fadd_rn(q.a3, __fmul_rn(w, v.w));
}

// one output row from its first staged source row xr and its weights wr
__device__ __forceinline__ void tap_row(const float* xr, const float* wr,
                                        int taps, Quad& q) {
  first_tap(q, wr[0], ld4(xr));
#pragma unroll 4
  for (int k = 1; k < taps; ++k) add_tap(q, wr[k], ld4(xr + k * kCols));
}

__device__ __forceinline__ void store_quad(float* row, long long c,
                                           long long cols, bool full,
                                           const Quad& q) {
  if (full && (cols & 3) == 0) {
    *reinterpret_cast<float4*>(row + c) = make_float4(q.a0, q.a1, q.a2, q.a3);
  } else {
    const float a[4] = {q.a0, q.a1, q.a2, q.a3};
#pragma unroll
    for (int j = 0; j < kQuad; ++j)
      if (c + j < cols) row[c + j] = a[j];
  }
}

// Shared memory: xs (cap rows x kCols f32), then ws (R x wstride f32), then
// ss (R int). `cap` is the most source rows a group may stage; a block whose
// group needs more takes the device-memory tap loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_axis0_kernel(const T* __restrict__ x, long long rows, long long cols,
                      const int* __restrict__ starts,
                      const float* __restrict__ w, int taps,
                      float* __restrict__ out, long long out_rows, int R,
                      int wstride, int cap, int vec_ok) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + (long long)cap * kCols;
  int* ss = reinterpret_cast<int*>(ws + R * wstride);
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kCols;
  const bool full = c0 + kCols <= cols;
  const long long groups = (out_rows + R - 1) / R;
  const int q = tid % kLanesPerRow;
  const long long c = c0 + q * kQuad;  // this thread's first column

  for (long long g = blockIdx.y; g < groups; g += gridDim.y) {
    const long long i0 = g * R;
    const int nrow = (int)(out_rows - i0 < R ? out_rows - i0 : R);
    __syncthreads();  // the previous group is done with the shared memory
    for (int k = tid; k < nrow; k += kThreads) ss[k] = starts[i0 + k];
    for (int k = tid; k < nrow * taps; k += kThreads)
      ws[(k / taps) * wstride + k % taps] = w[i0 * taps + k];
    __syncthreads();
    int lo = ss[0], hi = ss[0];
    for (int k = 1; k < nrow; ++k) {
      lo = min(lo, ss[k]);
      hi = max(hi, ss[k]);
    }
    const long long span = (long long)hi - lo + taps;

    if (span <= cap) {
      // stage source rows lo .. lo + span - 1 (clamped), columns c0 ..
      if (full && vec_ok) {
        constexpr int kPer = 16 / (int)sizeof(T);  // elements a vector
        constexpr int kVecs = kCols / kPer;        // vectors a row
        const int n = (int)span * kVecs;
        for (int b = tid; b < n; b += kThreads * kBatch) {
          uint4 v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int idx = b + u * kThreads;
            if (idx < n) {
              const long long r = clamp_row(lo + idx / kVecs, rows);
              v[u] = __ldg(reinterpret_cast<const uint4*>(x + r * cols + c0) +
                           idx % kVecs);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int idx = b + u * kThreads;
            if (idx < n)
              store_vec(xs + (idx / kVecs) * kCols + (idx % kVecs) * kPer,
                        v[u], T());
          }
        }
      } else {
        const int n = (int)span * kCols;
        for (int idx = tid; idx < n; idx += kThreads) {
          const long long r = clamp_row(lo + idx / kCols, rows);
          const long long cc = c0 + idx % kCols;
          xs[idx] = cc < cols ? load_f32(x + r * cols + cc) : 0.0f;
        }
      }
      __syncthreads();
      for (int r = tid / kLanesPerRow; r < nrow; r += kRowsAtOnce) {
        Quad qa;
        tap_row(xs + (ss[r] - lo) * kCols + q * kQuad, ws + r * wstride, taps,
                qa);
        store_quad(out + (i0 + r) * cols, c, cols, full, qa);
      }
    } else {
      // too many rows to stage: every tap from device memory
      for (int r = tid / kLanesPerRow; r < nrow; r += kRowsAtOnce) {
        const float* wr = ws + r * wstride;
        for (int j = 0; j < kQuad; ++j) {
          if (c + j >= cols) break;
          float acc = 0.0f;
          for (int k = 0; k < taps; ++k) {
            const long long sr = clamp_row((long long)ss[r] + k, rows);
            const float term = __fmul_rn(wr[k], load_f32(x + sr * cols + c + j));
            acc = k == 0 ? term : __fadd_rn(acc, term);
          }
          out[(i0 + r) * cols + c + j] = acc;
        }
      }
    }
  }
}

size_t smem_bytes(int cap, int R, int wstride) {
  return ((size_t)cap * kCols + (size_t)R * wstride + R) * sizeof(float);
}

template <typename T>
int launch(const void* x, long long rows, long long cols, const int* starts,
           const float* w, int taps, float* out, long long out_rows,
           cudaStream_t stream) {
  if (cols < 1 || out_rows < 1 || taps < 1) return 0;
  const int wstride = taps | 1;  // odd: a warp's 4 weight rows miss banks
  // the rows a group of R outputs spans: starts move by rows / out_rows a
  // row (a bound on the coefficient builder's rounding: +2); a block whose
  // group spans more takes the tap loop from device memory
  const double step = (double)rows / (double)out_rows;
  int R = kRowsAtOnce, cap = 0;
  for (; R >= 1; R /= 2) {
    const double c = (double)(R - 1) * step + 2.0 + taps;
    if (smem_bytes((int)c, R, wstride) <= (size_t)kMaxSmem) {
      cap = (int)c;
      break;
    }
  }
  if (R < 1) R = 1;  // cap 0: every block reads its taps from memory
  const size_t bytes = smem_bytes(cap, R, wstride);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_axis0_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (out_rows + R - 1) / R;
  const long long gx = (cols + kCols - 1) / kCols;
  if (gx > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)(groups < 65535 ? groups : 65535));
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     ((cols * (long long)sizeof(T)) % 16 == 0);
  resample_axis0_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), rows, cols, starts, w, taps, out, out_rows, R,
      wstride, cap, vec_ok);
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
