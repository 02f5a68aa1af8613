// The one-pass row designs of the norm kernels, whose rows live in
// registers:
// - "row_block" (rms_norm_fwd.cu, rms_norm_bwd.cu): a block of kThreads
//   threads holds one row of D elements, NV 16-byte vectors a thread
//   (vector tid + j * kThreads), and reduces it across the block;
// - "row_warp" (layer_norm_bwd.cu): a warp holds one row, NV vectors a
//   lane (vector lane + j * 32), and reduces it with shuffles alone.
// Either reads its row from device memory once and writes its output row
// once. A persistent grid walks the rows (the grid is chosen by the
// wrapper from the shapes and the SM count, so a launch reads nothing
// back and can be captured in a CUDA graph); each block or warp issues the
// loads of its next row (a block: into registers; a warp: its next rows,
// into shared memory by cp.async) before it reduces the current one, so
// the bytes of several rows are in flight. The row's weight is loaded
// once. A weight's
// gradient is one fp32 partial row a block, and partial_sum_kernel sums
// the partials in a fixed order (no atomics: every launch gives the same
// bits).
#pragma once

#include <cstdint>

#include "numeric.cuh"

namespace paddle_attn {

namespace rowblk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest row: NV <= kMaxNv vectors a thread
constexpr int kMaxNv = 2;

// The NV vectors first, first + kStride, ... of a row of nv 16-byte
// vectors, zero past nv (read through the non-coherent path: the kernels
// write no input); a null row gives zeros (the walk's end).
template <int NV, int kStride>
__device__ __forceinline__ void load_vectors(const void* row, int nv,
                                             int first, uint4 (&v)[NV]) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = first + j * kStride;
    v[j] = p && i < nv ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// This thread's NV vectors of a row held by the block.
template <int NV>
__device__ __forceinline__ void load_row(const void* row, int nv,
                                         uint4 (&v)[NV]) {
  load_vectors<NV, kThreads>(row, nv, threadIdx.x, v);
}

// This lane's NV vectors of a row held by its warp.
template <int NV>
__device__ __forceinline__ void load_warp_row(const void* row, int nv,
                                              uint4 (&v)[NV]) {
  load_vectors<NV, 32>(row, nv, threadIdx.x & 31, v);
}

// Block-wide sum of one float a thread, in a fixed order (each warp's
// shuffle tree, then the warps in order): the same bits in every thread
// and on every launch. slots: 2 * kWarps shared floats; alternate `parity`
// from one call to the next, so one barrier a call suffices (a thread
// writes a slot pair again only after every thread passed the next call's
// barrier, that is, after it read this call's sums).
__device__ __forceinline__ float block_sum(float v, float* slots,
                                           int parity) {
  v = warp_sum(v);
  float* s = slots + parity * kWarps;
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s[w];
  return t;
}

// The weight gradients from the P partials [P, D]: column col summed over
// the partials in a fixed order (warp w takes partials w, w + kSumWarps,
// ... in order, then the kSumWarps warps' sums in order), rounded once to
// T. A block takes 32 columns.
template <typename T, int kSumWarps>
__global__ void __launch_bounds__(kSumWarps * 32)
    partial_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                       int P, int D) {
  __shared__ float sums[kSumWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int p = warp; p < P; p += kSumWarps)
      acc += part[(size_t)p * D + col];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += sums[w][lane];
    out[col] = from_f<T>(t);
  }
}

}  // namespace rowblk

}  // namespace paddle_attn
