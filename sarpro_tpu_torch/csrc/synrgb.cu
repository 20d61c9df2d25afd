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
// What bounds it: device-memory traffic, 2 bytes in and 3 bytes out per
// pixel, plus staging one 66 KB table set into each block's shared memory.
//
// Design: one thread per pixel in a grid-stride loop; the table set
// (256 + 256 + 65536 bytes, above the 48 KB static limit, hence
// cudaFuncSetAttribute) is copied into dynamic shared memory with 16-byte
// loads. The set is chosen by an index read from device memory, so the
// data-dependent water floor of the suppressed mode selects its tables with
// no host round trip. The suppressed mode's water mask (pixels with both
// bands at or below the floor become black) is fused in. Output is (N, 3)
// u8, interleaved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSetBytes = 256 + 256 + 65536;
static_assert(kSetBytes % 16 == 0, "table set must copy as uint4");

__global__ void synrgb_kernel(const uint8_t* __restrict__ b1,
                              const uint8_t* __restrict__ b2, long long n,
                              const uint8_t* __restrict__ tables,
                              long long n_sets,
                              const int* __restrict__ set_index,
                              const int* __restrict__ water_floor,
                              uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sh[];
  long long set = set_index ? (long long)set_index[0] : 0;
  set = set < 0 ? 0 : (set >= n_sets ? n_sets - 1 : set);
  const uint4* src = reinterpret_cast<const uint4*>(tables + set * kSetBytes);
  uint4* dst = reinterpret_cast<uint4*>(sh);
  for (int i = threadIdx.x; i < kSetBytes / 16; i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  const int floor_v = water_floor ? water_floor[0] : -1;
  const uint8_t* lut_r = sh;
  const uint8_t* lut_g = sh + 256;
  const uint8_t* lut_b = sh + 512;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int v1 = b1[i];
    const int v2 = b2[i];
    uint8_t r = lut_r[v1];
    uint8_t g = lut_g[v2];
    uint8_t b = lut_b[(v1 << 8) | v2];
    if (v1 <= floor_v && v2 <= floor_v) r = g = b = 0;
    out[3 * i] = r;
    out[3 * i + 1] = g;
    out[3 * i + 2] = b;
  }
}

}  // namespace

// b1, b2: (n,) u8; tables: (n_sets, 66048) u8, each set laid out as
// [lut_r (256) | lut_g (256) | lut_b (65536, index b1 * 256 + b2)];
// set_index: device int32 selecting the set (null = set 0); water_floor:
// device int32 floor of the water mask (null = no mask); out: (n, 3) u8.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_synrgb_lookup(const uint8_t* b1, const uint8_t* b2,
                                    long long n, const uint8_t* tables,
                                    long long n_sets, const int* set_index,
                                    const int* water_floor, uint8_t* out,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      synrgb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSetBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, synrgb_kernel,
                                                kThreads, kSetBytes);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) return 0;
  synrgb_kernel<<<(unsigned)blocks, kThreads, kSetBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      b1, b2, n, tables, n_sets, set_index, water_floor, out);
  return (int)cudaGetLastError();
}
