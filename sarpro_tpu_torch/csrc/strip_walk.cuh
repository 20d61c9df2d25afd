// The 2-D walk of a row-major int32 image shared by the CLAHE kernels
// (tile_histogram.cu, clahe_lookup.cu).
//
// A block owns the columns [c0, c0 + w) of the rows [r0, r1) and reads them
// as 16-byte vectors aligned in device memory, whatever `cols` and the base
// pointer's alignment: row r's pixels span the vectors from
// (r * cols + c0 + m) / 4 on (m: the base pointer's offset past 16 bytes, in
// elements), `nv` of them. A vector may straddle the segment's edge or the
// row's; its element j lies at column `col + j` of the segment, and the
// caller uses only the elements with 0 <= col + j < w. The load never faults:
// a 16-byte-aligned vector holding one element of the image lies on that
// element's page. So every pixel of the block is visited exactly once, in the
// row it belongs to.
//
// The (row, vector) pairs are numbered row-major and the threads stride
// through them, a step carried incrementally (no division in the loop), with
// U vectors loaded before any is used so that several loads are in flight a
// thread.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace strip_walk {

struct Strip {
  const int4* base;  // the image's base pointer rounded down to 16 bytes
  int m;             // elements from `base` to the image's first
  int cols, c0, w, r0, r1;
  int nv;            // vectors a row of the segment spans (at most)

  __device__ Strip(const int* img, int cols_, int c0_, int w_, int r0_,
                   int r1_)
      : cols(cols_), c0(c0_), w(w_), r0(r0_), r1(r1_) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(img);
    base = reinterpret_cast<const int4*>(p & ~uintptr_t(15));
    m = (int)((p & 15) >> 2);
    // every row starts on a vector when cols, c0 and m are multiples of 4;
    // otherwise a row's w elements may start at any of a vector's 4 places
    nv = ((cols | c0 | m) & 3) == 0 ? (w + 3) >> 2 : ((w + 2) >> 2) + 1;
  }
};

// Calls f(row, i0, col, v) for each (row, vector) pair of `s` this thread
// takes: v holds the image's flat elements i0 .. i0 + 3, element j at
// column col + j of the segment (i0 and col may lie outside the image or
// the segment: use only 0 <= col + j < s.w).
template <int U, class F>
__device__ __forceinline__ void walk(const Strip& s, F&& f) {
  const int nt = blockDim.x;
  const int dq = nt / s.nv, dr = nt % s.nv;
  int row = s.r0 + (int)threadIdx.x / s.nv;
  int vi = (int)threadIdx.x % s.nv;
  while (row < s.r1) {
    int rr[U], col[U];
    long long i0[U];
    bool any[U];
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rowflat = (long long)row * s.cols;
      i0[u] = ((((rowflat + s.c0 + s.m) >> 2) + vi) << 2) - s.m;
      col[u] = (int)(i0[u] - rowflat) - s.c0;  // -3 <= col
      // a row whose elements start early in their first vector spans one
      // vector fewer than nv, and that last one may lie past the image
      any[u] = row < s.r1 && col[u] < s.w;
      rr[u] = row;
      vi += dr;
      row += dq;
      if (vi >= s.nv) {
        vi -= s.nv;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (any[u]) v[u] = __ldg(s.base + ((i0[u] + s.m) >> 2));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (any[u]) f(rr[u], i0[u], col[u], v[u]);
  }
}

}  // namespace strip_walk
