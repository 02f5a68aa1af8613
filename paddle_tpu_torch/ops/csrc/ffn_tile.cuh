// Device-side pieces shared by the fused FFN kernels (fused_ffn_fwd.cu,
// fused_ffn_bwd_dx.cu, fused_ffn_bwd_dw.cu): the two activations and their
// derivatives in fp32, rounding through the stored dtype, and the staging
// of a tile of a row-major matrix into shared memory as fp32 (the fp32
// kernels, on the CUDA cores), straight or transposed. The bf16 / fp16
// kernels load through TMA (tma_tile.cuh) and multiply on wgmma
// (wgmma_tile.cuh).
//
// Activation codes: 0 = GPT-2's tanh gelu, 1 = exact (erf) gelu, the
// `_ACTS` of paddle_tpu/ops/pallas/fused_ffn.py; the derivatives are its
// `_dgelu`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numeric.cuh"

namespace paddle_ffn {

using paddle_attn::from_f;
using paddle_attn::to_f;

constexpr int kThreads = 256;  // 8 warps: ty = warp (row group), tx = lane
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// The tanh gelu as 0.5 x (1 + tanh(u)) = x / (1 + exp(-2 u)): one
// exponential and one division, no cancellation, about a tenth of tanhf's
// instructions (with tanhf the forward's epilogue cost about as much as
// its products). For u below about -44 the exponential overflows and the
// value is -0, what 0.5 x (1 + tanh(u)) rounds to there.
__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == 0)
    return __fdividef(
        x, 1.f + __expf(-2.f * kSqrt2OverPi * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + erff(x * kInvSqrt2));
}

__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == 0) {
    const float th = tanhf(kSqrt2OverPi * (x + 0.044715f * x * x * x));
    return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * kSqrt2OverPi *
                                   (1.f + 3.f * 0.044715f * x * x);
  }
  return 0.5f * (1.f + erff(x * kInvSqrt2)) +
         x * expf(-0.5f * x * x) * kInvSqrt2Pi;
}

// act(x) into t and act'(x) into a, the same arithmetic as act_fwd and
// act_grad with the one transcendental (tanh, or erf) shared.
__device__ __forceinline__ void act_fwd_grad(float x, int act, float& t,
                                             float& a) {
  if (act == 0) {
    const float th = tanhf(kSqrt2OverPi * (x + 0.044715f * x * x * x));
    t = 0.5f * x * (1.f + th);
    a = 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * kSqrt2OverPi *
                                (1.f + 3.f * 0.044715f * x * x);
    return;
  }
  const float e = erff(x * kInvSqrt2);
  t = 0.5f * x * (1.f + e);
  a = 0.5f * (1.f + e) + x * expf(-0.5f * x * x) * kInvSqrt2Pi;
}

// v rounded to T and back: the TPU kernels' `.astype(x.dtype)` before a
// product.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Block-wide: dst[r * dld + c] = src[(r0 + r) * ld + c0 + c] as fp32 for
// r < rows, c < cols; rows at or past n_valid are zero. Consecutive threads
// walk c, so the global reads are contiguous.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int dld,
                                      const T* __restrict__ src, size_t ld,
                                      int r0, int n_valid, int c0, int rows,
                                      int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * dld + c] =
        r < n_valid ? to_f(src[(size_t)(r0 + r) * ld + c0 + c]) : 0.f;
  }
}

// Block-wide, transposed: dst[c * dld + r] = src[(r0 + r) * ld + c0 + c]
// for r < rows, c < cols. Consecutive threads walk c (contiguous global
// reads) and write a column of dst, so dld is odd: the writes of a warp
// then fall in distinct banks.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, int dld,
                                        const T* __restrict__ src, size_t ld,
                                        int r0, int c0, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[c * dld + r] = to_f(src[(size_t)(r0 + r) * ld + c0 + c]);
  }
}

// Raise a kernel's dynamic shared memory limit to smem when it is above
// what `set` records (48 KB needs no call), once per instantiation: the
// caller keeps `set` in a function-local static, so a launch under
// CUDA-graph capture makes no such call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& set) {
  if (smem <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

}  // namespace paddle_ffn
