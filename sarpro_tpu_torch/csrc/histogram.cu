// Integer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (sarpro_tpu/ops/kernels.py, reached
// through `_histogram_pallas` / `histogram`). The TPU has no fast
// scatter-add, so that kernel counts with a one-hot (hi, lo) matmul on the
// MXU and needs num_bins % 128 == 0 and a chunked grid. Hopper has fast
// shared-memory atomics, so this kernel counts directly.
//
// Computes out[v] += 1 for every value v of one or two streams (int32 or u8)
// with 0 <= v < num_bins; other values (the masked convention: masked pixels
// carry num_bins; negative int32 wraps past num_bins as unsigned) are dropped.
// The result is exact (integer adds commute).
//
// What bounds it: reading the streams once from device memory (16.8 MB, 5 us
// at 3.35 TB/s, for a 2048^2 int32 band; 400 MB, 0.12 ms, at 10000^2). The
// first design spent more than that elsewhere: 4- and 1-byte loads in a
// grid-stride loop, one table shared by the sixteen warps of a 512-thread
// block (the bins SAR data crowds into contended across the block), and a
// grid of one resident wave whose every block zeroed and merged all 4096
// bins, about as many shared stores and global atomics as there were pixels
// to count at 2048^2.
//
// Design: each stream is read as 16-byte vectors (4 int32 or 16 u8 a load,
// kUnroll loads in flight a thread), from its first 16-byte boundary on; the
// elements before it and the ragged end are counted one by one by the first
// block, so the two streams may differ in length and in alignment. A block
// of 1024 threads keeps one table per kWarpsPerCopy warps while the copies
// fit in kCopyBytes (16 copies of 1 KB at 256 bins), fewer where they do
// not, down to one (16 KB at 4096 bins, 227 KB at MAX_HIST_BINS). A vector
// whose values are all one bin (a flat or all-water band) adds them with one
// atomic. At the end the copies are summed and each non-zero bin goes out
// with one global atomicAdd. The grid gives each block kPerEntry elements
// for every table entry it zeroes and merges (at least kMinElems), and at
// most one wave of resident blocks: 128 blocks for 4096 bins over a 2048^2
// band, a full wave at 100 MP.
//
// On the card, the 256-bin count of two u8 bands is bound by the shared
// atomics (16 a load): without them it takes half the time, and tables
// split further between the lanes of a warp (fewer bank conflicts) were
// slower. 256- and 512-thread blocks were slower on every case.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarpsPerCopy = 2;     // one table per pair of warps
constexpr int kCopyBytes = 16 * 1024;  // the most the copies may take
constexpr int kUnroll = 2;           // 16-byte loads in flight a thread
constexpr int kPerEntry = 8;         // elements a block counts per entry
constexpr long long kMinElems = 16384;  // the least a block counts

__device__ __forceinline__ void count1(int* tab, unsigned v, unsigned nb) {
  if (v < nb) atomicAdd(&tab[v], 1);
}

// 4 int32 values
__device__ __forceinline__ void count_vec(int* tab, uint4 v, unsigned nb,
                                          const int32_t*) {
  if (v.x < nb && v.x == v.y && v.x == v.z && v.x == v.w) {
    atomicAdd(&tab[v.x], 4);
    return;
  }
  count1(tab, v.x, nb);
  count1(tab, v.y, nb);
  count1(tab, v.z, nb);
  count1(tab, v.w, nb);
}

// 16 u8 values
__device__ __forceinline__ void count_vec(int* tab, uint4 v, unsigned nb,
                                          const uint8_t*) {
  const unsigned b0 = v.x & 0xFFu, rep = b0 * 0x01010101u;
  if (b0 < nb && v.x == rep && v.y == rep && v.z == rep && v.w == rep) {
    atomicAdd(&tab[b0], 16);
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) count1(tab, (w[k] >> (8 * j)) & 0xFFu, nb);
}

// Counts the n elements of p into tab (one stream, any alignment).
template <typename T>
__device__ __forceinline__ void count_stream(const T* __restrict__ p,
                                             long long n, int* tab,
                                             unsigned nb) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  long long head = (long long)(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const long long nv = (n - head) / kVec;
  const long long tail = head + nv * kVec;
  if (blockIdx.x == 0) {
    for (long long i = threadIdx.x; i < head; i += kThreads)
      count1(tab, (unsigned)p[i], nb);
    for (long long i = tail + threadIdx.x; i < n; i += kThreads)
      count1(tab, (unsigned)p[i], nb);
  }
  const uint4* vp = reinterpret_cast<const uint4*>(p + head);
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vp + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count_vec(tab, v[u], nb, p);
  }
  for (; i < nv; i += stride) count_vec(tab, __ldg(vp + i), nb, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const T* __restrict__ a, long long n_a,
                const T* __restrict__ b, long long n_b, int num_bins,
                int copies, int* __restrict__ out) {
  extern __shared__ int sh[];
  for (int k = threadIdx.x; k < copies * num_bins; k += kThreads) sh[k] = 0;
  __syncthreads();
  int* tab = sh + ((threadIdx.x >> 5) % copies) * num_bins;
  const unsigned nb = (unsigned)num_bins;
  count_stream(a, n_a, tab, nb);
  if (n_b > 0) count_stream(b, n_b, tab, nb);
  __syncthreads();
  for (int k = threadIdx.x; k < num_bins; k += kThreads) {
    int c = 0;
    for (int t = 0; t < copies; ++t) c += sh[t * num_bins + k];
    if (c) atomicAdd(&out[k], c);
  }
}

template <typename T>
int launch(const void* a, long long n_a, const void* b, long long n_b,
           int num_bins, int* out, cudaStream_t stream) {
  int copies = kCopyBytes / (num_bins * (int)sizeof(int));
  const int most = kThreads / 32 / kWarpsPerCopy;
  copies = copies < 1 ? 1 : (copies > most ? most : copies);
  const size_t smem = (size_t)copies * num_bins * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel<T>,
                                                kThreads, smem);
  long long per_block = (long long)kPerEntry * copies * num_bins;
  if (per_block < kMinElems) per_block = kMinElems;
  long long blocks = (n_a + n_b + per_block - 1) / per_block;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  hist_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), n_a, static_cast<const T*>(b), n_b, num_bins,
      copies, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Counts of `a` (n_a elements) and `b` (n_b elements, may be 0) in
// [0, num_bins), added into `out` (num_bins int32, zeroed by the caller,
// which also checks that one table fits in shared memory). The streams may
// start at any element. elem_bytes selects the element type: 4 = int32,
// 1 = uint8. Returns the CUDA error code of the launch (0 on success).
extern "C" int sarpro_histogram(const void* a, long long n_a, const void* b,
                                long long n_b, int elem_bytes, int num_bins,
                                int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<int32_t>(a, n_a, b, n_b, num_bins, out, s);
  if (elem_bytes == 1)
    return launch<uint8_t>(a, n_a, b, n_b, num_bins, out, s);
  return (int)cudaErrorInvalidValue;
}
