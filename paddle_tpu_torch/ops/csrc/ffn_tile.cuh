// Device-side pieces shared by the fused FFN kernels (fused_ffn_fwd.cu,
// fused_ffn_bwd_dx.cu, fused_ffn_bwd_dw.cu): the two activations and their
// derivatives in fp32, rounding through the stored dtype, the staging of a
// tile of a row-major matrix into shared memory as fp32 (the fp32 kernels,
// on the CUDA cores), straight or transposed, and its copy in the stored
// 16-bit dtype (the bf16 / fp16 forward, whose products run on the tensor
// cores through nvcuda::wmma; the backward's tensor-core kernels load
// through TMA, tma_tile.cuh, and multiply on wgmma, wgmma_tile.cuh).
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

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == 0)
    return 0.5f * x *
           (1.f + tanhf(kSqrt2OverPi * (x + 0.044715f * x * x * x)));
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

// Block-wide: dst[r * dld + c] = src[(r0 + r) * ld + c0 + c] for r < rows,
// c < cols, in the stored 16-bit dtype; rows at or past n_valid are zero.
// With vec (cols, c0, ld and dld multiples of 8, src and dst 16-byte
// aligned) each thread issues asynchronous 16-byte copies (cp.async), all
// in flight together, which copy_wait() completes: call it after the
// block's copies and before the barrier that publishes them.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int dld,
                                          const T* __restrict__ src,
                                          size_t ld, int r0, int n_valid,
                                          int c0, int rows, int cols,
                                          int vec) {
  static_assert(sizeof(T) == 2, "16-bit tiles");
  if (vec) {
    const int per_row = cols / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * 8;
      const bool valid = r < n_valid;
      // a row past n_valid reads nothing (source size 0 fills zeros)
      const T* from = src + (valid ? (size_t)(r0 + r) * ld + c0 + c : 0);
      const unsigned to =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dld + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(to), "l"(from), "r"(valid ? 16 : 0));
    }
    return;
  }
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * dld + c] = r < n_valid ? src[(size_t)(r0 + r) * ld + c0 + c]
                                   : zero;
  }
}

// Wait for this thread's copy_tile copies (none outstanding: no wait).
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Whether copy_tile may move 16 bytes at a time from these pointers (the
// row lengths are multiples of 128 elements).
inline int vec16(const void* a, const void* b, const void* c,
                 const void* d = nullptr) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d);
  return any % 16 == 0;
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
