// The "row_block" design of the RMSNorm kernels (rms_norm_fwd.cu,
// rms_norm_bwd.cu): a block of kThreads threads holds one row of D
// elements in registers, NV 16-byte vectors a thread (vector tid + j *
// kThreads), reads it from device memory once, reduces it across the block
// and writes its output row once. A persistent grid of blocks walks the
// rows with a stride of gridDim.x (the grid is chosen by the wrapper from
// the shapes and the SM count, so a launch reads nothing back and can be
// captured in a CUDA graph); each block issues the loads of its next row
// before it reduces the current one, so the bytes of two rows are in
// flight. The row's weight is loaded once a block.
#pragma once

#include <cstdint>

#include "numeric.cuh"

namespace paddle_attn {

namespace rowblk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest row: NV <= kMaxNv vectors a thread
constexpr int kMaxNv = 2;

// This thread's NV vectors of a row of nv 16-byte vectors, zero past nv
// (read through the non-coherent path: the kernels write no input); a
// null row gives zeros (the walk's end).
template <int NV>
__device__ __forceinline__ void load_row(const void* row, int nv,
                                         uint4 (&v)[NV]) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = p && i < nv ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
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

}  // namespace rowblk

}  // namespace paddle_attn
