// RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_rms_fwd (_rms_fwd_kernel,
// pallas_call :200): rows of x scaled by the reciprocal root of their mean
// square, with the weight fused,
//   rstd = rsqrt(sum(x^2) / D + eps)
//   y = x * rstd * gamma                     (fp32, rounded once to T)
//
//   x, y     [N, D]   fp32, bf16 or fp16; any N (the TPU pads N to 8)
//   gamma    [D]      x's dtype
//   rstd     [N]      fp32, what the backward kernel reads
//
// What bounds it on the card: bytes (x read, y written, three flops an
// element). Design: one warp per row, eight rows per block, each lane
// moving 16 bytes a load (neighbouring lanes on neighbouring vectors)
// when D and the pointers allow it, else one element a load; the sum of
// squares in fp32 by warp shuffles, then the row is read again (from
// L1/L2) for the output. CUDA C++ rather than Triton: the port's only
// build path is nvcc into a plain-C library (ops/_build.py), and the
// LayerNorm kernels these mirror are CUDA.
#include "numeric.cuh"
#include "vec.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 8;

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   T* __restrict__ y, float* __restrict__ rstd, int N, int D,
                   float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  T* yr = y + (size_t)row * D;
  const int nv = D / V;
  float ss = 0.f;
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) {
    float a[V];
    load_vec<T, V>(xr + i * V, a);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(a[j], a[j], ss);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) {
    float a[V], g[V];
    load_vec<T, V>(xr + i * V, a);
    load_vec<T, V>(gamma + i * V, g);
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = a[j] * r * g[j];
    store_vec<T, V>(yr + i * V, a);
  }
  if (lane == 0) rstd[row] = r;
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* y, void* rstd,
                   int N, int D, float eps, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rstd);
  constexpr int V = kVecBytes / sizeof(T);
  if (vec_ok<T>(D, x, gamma, y)) {
    rms_fwd_kernel<T, V><<<blocks, kWarps * 32, 0, stream>>>(xp, gp, yp, rp,
                                                             N, D, eps);
  } else {
    rms_fwd_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(xp, gp, yp, rp,
                                                             N, D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0
// on success); the caller has validated shapes, devices and layout.
extern "C" int paddle_rms_norm_fwd(const void* x, const void* gamma, void* y,
                                   void* rstd, int N, int D, float eps,
                                   int dtype, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, y, rstd, N, D, eps, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, y, rstd, N, D, eps, s);
    case 2:
      return (int)launch<__half>(x, gamma, y, rstd, N, D, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
