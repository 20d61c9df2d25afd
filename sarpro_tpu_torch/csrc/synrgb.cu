// Synthetic-RGB table lookup for Hopper (sm_90a).
//
// Replaces the TPU kernels `_synrgb_formula_kernel` (sarpro_tpu/ops/
// kernels.py, reached through `synrgb_lookup_formula`) and `_synrgb_kernel`
// (through `synrgb_lookup`). Both compute one function:
//   rgb = (lut_r[b1], lut_g[b2], lut_b[b1 * 256 + b2]).
// The TPU gathers slowly from small tables, so it selects table entries
// with one-hot matmuls, and its formula variant rebuilds the 64 KB blue
// table from ln-tables, exp and a list of corrections. Hopper gathers from
// shared memory cheaply, so this kernel indexes the tables directly.
//
// What bounds it: device-memory traffic, 2 bytes in and 3 bytes out a pixel
// (21 MB, 6.3 us at 3.35 TB/s, at 2048^2), and the three gathers a pixel
// from shared memory. The first design took two 1-byte loads and three
// 1-byte stores a pixel and staged the whole 66 KB table set into each of
// about 400 blocks.
//
// Design: a thread takes 16 pixels at a time, one 16-byte load from each
// band. Its 48 output bytes go through a 1.5 KB buffer a warp in shared
// memory, so that each of the warp's three 16-byte stores writes 512
// contiguous bytes (stored straight from registers, the three stores of a
// warp each touched every 128-byte line of the warp's span, and took as
// long as the gathers). Groups of 16 pixels follow the output (a fresh
// allocation, so 16-byte aligned); a band whose base lies off 16 bytes (a
// view) is read as two aligned vectors shifted into place, and the last
// n % 16 pixels are done one by one. The table set is staged once a block
// into shared memory, in blocks of 512 threads, two an SM, each thread
// taking a group a round (on the card, 256- and 1024-thread blocks were
// slower; gathering the blue table through L1 from device memory instead
// was slower on uniform bands and faster only on crowded ones). Its blue
// table is stored with each row's 16-byte chunks permuted by
// the row (chunk c of row r at c ^ (r & 15)): its 256-byte rows would
// otherwise put every row's entry for one b2 in the same bank, and SAR
// bands, whose b1 vary while b2 crowds into a few values, would gather
// from a few banks. The set is chosen by an index read from device memory,
// so the data-dependent water floor of the suppressed mode selects its
// tables with no host round trip. The suppressed mode's water mask (pixels
// with both bands at or below the floor become black) is fused in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSetBytes = 256 + 256 + 65536;
constexpr int kWarpBytes = 32 * 48;  // a warp's output buffer
constexpr int kSmem = kSetBytes + kThreads / 32 * kWarpBytes;
static_assert(kSetBytes % 16 == 0, "tables must copy as uint4");

// 16 bytes of a band from pixel i (a multiple of 16) on; m = the band's
// base offset past 16 bytes (base: the band's pointer rounded down). Where
// m > 0 the second aligned vector holds pixel i + 16 - m <= i + 15, a byte
// of the band, so it lies on a mapped page.
__device__ __forceinline__ uint4 load16(const uint4* __restrict__ base,
                                        int m, long long i) {
  const uint4 a = __ldg(base + (i >> 4));
  if (m == 0) return a;
  const uint4 b = __ldg(base + (i >> 4) + 1);
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = m >> 2, s = (m & 3) * 8;
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned lo = w[k], hi = w[k + 1];
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      lo = q == t ? w[k + t] : lo;
      hi = q == t ? w[k + t + 1] : hi;
    }
    o[k] = __funnelshift_r(lo, hi, s);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// r | g << 8 | b << 16 of one pixel from the staged set
__device__ __forceinline__ unsigned rgb(const uint8_t* set, unsigned v1,
                                        unsigned v2, int floor_v) {
  if ((int)v1 <= floor_v && (int)v2 <= floor_v) return 0u;
  const unsigned blue =
      set[512 + (v1 << 8) + ((((v2 >> 4) ^ v1) & 15) << 4) + (v2 & 15)];
  return set[v1] | ((unsigned)set[256 + v2] << 8) | (blue << 16);
}

__global__ void __launch_bounds__(kThreads)
    synrgb_kernel(const uint8_t* __restrict__ b1,
                  const uint8_t* __restrict__ b2, long long n,
                  const uint8_t* __restrict__ tables, long long n_sets,
                  const int* __restrict__ set_index,
                  const int* __restrict__ water_floor,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sh[];
  const long long groups = n >> 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int m1 = (int)(reinterpret_cast<uintptr_t>(b1) & 15);
  const int m2 = (int)(reinterpret_cast<uintptr_t>(b2) & 15);
  const uint4* base1 = reinterpret_cast<const uint4*>(b1 - m1);
  const uint4* base2 = reinterpret_cast<const uint4*>(b2 - m2);
  // the first group's bands are loaded before the tables are staged
  uint4 v1 = make_uint4(0, 0, 0, 0), v2 = v1;
  if (gi < groups) {
    v1 = load16(base1, m1, gi << 4);
    v2 = load16(base2, m2, gi << 4);
  }
  long long set = set_index ? (long long)set_index[0] : 0;
  set = set < 0 ? 0 : (set >= n_sets ? n_sets - 1 : set);
  const uint4* src = reinterpret_cast<const uint4*>(tables + set * kSetBytes);
  uint4* dst = reinterpret_cast<uint4*>(sh);
  for (int k = threadIdx.x; k < kSetBytes / 16; k += kThreads) {
    // chunk c of blue row r (k = 32 + 16 r + c) goes to c ^ (r & 15)
    const int r = (k - 32) >> 4;
    dst[k < 32 ? k : 32 + (r << 4) + ((k ^ r) & 15)] = __ldg(src + k);
  }
  __syncthreads();
  const int floor_v = water_floor ? water_floor[0] : -1;
  uint4* buf = reinterpret_cast<uint4*>(sh + kSetBytes) +
               (threadIdx.x >> 5) * (kWarpBytes / 16);

  // gi - lane, the warp's first group, is the same for the whole warp
  for (long long wg = gi - lane; wg < groups; wg += stride) {
    if (gi < groups) {
      const unsigned x1[4] = {v1.x, v1.y, v1.z, v1.w};
      const unsigned x2[4] = {v2.x, v2.y, v2.z, v2.w};
      unsigned o[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) o[k] = 0;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const unsigned c = rgb(sh, (x1[p >> 2] >> (8 * (p & 3))) & 0xFFu,
                               (x2[p >> 2] >> (8 * (p & 3))) & 0xFFu,
                               floor_v);
        const int w = (3 * p) >> 2, s = ((3 * p) & 3) * 8;
        o[w] |= c << s;
        if (s > 8) o[w + 1] |= c >> (32 - s);
      }
      buf[3 * lane] = make_uint4(o[0], o[1], o[2], o[3]);
      buf[3 * lane + 1] = make_uint4(o[4], o[5], o[6], o[7]);
      buf[3 * lane + 2] = make_uint4(o[8], o[9], o[10], o[11]);
    }
    __syncwarp();
    const long long chunks = 3 * (groups - wg < 32 ? groups - wg : 32);
    uint4* o16 = reinterpret_cast<uint4*>(out + wg * 48);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (lane + 32 * k < chunks) o16[lane + 32 * k] = buf[lane + 32 * k];
    __syncwarp();
    gi += stride;
    if (gi < groups) {
      v1 = load16(base1, m1, gi << 4);
      v2 = load16(base2, m2, gi << 4);
    }
  }
  // the last n % 16 pixels, one by one
  if (blockIdx.x == 0) {
    const long long i = (groups << 4) + threadIdx.x;
    if (i < n) {
      const unsigned c = rgb(sh, b1[i], b2[i], floor_v);
      out[3 * i] = (uint8_t)c;
      out[3 * i + 1] = (uint8_t)(c >> 8);
      out[3 * i + 2] = (uint8_t)(c >> 16);
    }
  }
}

}  // namespace

// b1, b2: (n,) u8 at any alignment; tables: (n_sets, 66048) u8, each set
// laid out as [lut_r (256) | lut_g (256) | lut_b (65536, index b1 * 256 +
// b2)]; set_index: device int32 selecting the set (null = set 0);
// water_floor: device int32 floor of the water mask (null = no mask); out:
// (n, 3) u8, 16-byte aligned (a fresh allocation). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int sarpro_synrgb_lookup(const uint8_t* b1, const uint8_t* b2,
                                    long long n, const uint8_t* tables,
                                    long long n_sets, const int* set_index,
                                    const int* water_floor, uint8_t* out,
                                    void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = cudaFuncSetAttribute(
      synrgb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, synrgb_kernel,
                                                kThreads, kSmem);
  long long blocks = ((n >> 4) + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  synrgb_kernel<<<(unsigned)blocks, kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      b1, b2, n, tables, n_sets, set_index, water_floor, out);
  return (int)cudaGetLastError();
}
