// Integer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (sarpro_tpu/ops/kernels.py, reached
// through `_histogram_pallas` / `histogram`). The TPU has no fast
// scatter-add, so that kernel counts with a one-hot (hi, lo) matmul on the
// MXU and needs num_bins % 128 == 0 and a chunked grid. Hopper has fast
// shared-memory atomics, so this kernel counts directly.
//
// What bounds it: reading the index stream once from device memory (4 bytes
// per element for int32 indices, 1 for u8 bands) and, on SAR data whose
// values crowd into few bins, contention on the shared-memory atomics of
// those bins.
//
// Design: a grid-stride loop over the elements; each block keeps a private
// int32 histogram in dynamic shared memory (4096 bins = 16 KB) filled with
// shared atomics, then merges it into the global output with one atomicAdd
// per non-zero bin. Indices outside [0, num_bins) are dropped (the masked
// convention of the JAX package: masked pixels carry num_bins). Two input
// streams may be counted in one launch, so the combined histogram of two
// bands needs no concatenated copy. Any num_bins whose table fits in shared
// memory is accepted; the caller zeroes `out` and checks the size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void hist_kernel(const T* __restrict__ a, long long n_a,
                            const T* __restrict__ b, long long n_b,
                            int num_bins, int* __restrict__ out) {
  extern __shared__ int sh[];
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nb = (unsigned)num_bins;
  for (long long i = first; i < n_a; i += stride) {
    const unsigned v = (unsigned)a[i];  // negative int32 wraps past nb
    if (v < nb) atomicAdd(&sh[v], 1);
  }
  for (long long i = first; i < n_b; i += stride) {
    const unsigned v = (unsigned)b[i];
    if (v < nb) atomicAdd(&sh[v], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) {
    const int c = sh[i];
    if (c) atomicAdd(&out[i], c);
  }
}

template <typename T>
int launch(const void* a, long long n_a, const void* b, long long n_b,
           int num_bins, int* out, cudaStream_t stream) {
  const size_t smem = (size_t)num_bins * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel<T>,
                                                kThreads, smem);
  const long long n = n_a > n_b ? n_a : n_b;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  hist_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), n_a, static_cast<const T*>(b), n_b, num_bins,
      out);
  return (int)cudaGetLastError();
}

}  // namespace

// Counts of `a` (n_a elements) and `b` (n_b elements, may be 0) in
// [0, num_bins), added into `out` (num_bins int32, zeroed by the caller).
// elem_bytes selects the element type: 4 = int32, 1 = uint8.
// Returns the CUDA error code of the launch (0 on success).
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
