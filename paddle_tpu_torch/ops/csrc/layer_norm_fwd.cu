// LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd (_ln_fwd_kernel,
// pallas_call :91): rows of x normalised over the last dim with fp32
// statistics and the affine fused,
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D,  rstd = rsqrt(var + eps)
//   y = (x - mean) * rstd * gamma + beta         (fp32, rounded once to T)
// two passes for the variance, as the TPU kernel takes them.
//
//   x, y        [N, D]   fp32, bf16 or fp16; any N (the TPU pads N to 8)
//   gamma, beta [D]      x's dtype
//   mean, rstd  [N]      fp32, what the backward kernel reads
//
// What bounds it on the card: bytes (x read, y written, a few flops each).
// Design: one warp per row, eight rows per block, neighbouring lanes on
// neighbouring elements; the row is read three times (sum, squared
// deviations, output), the second and third from L1/L2, so device memory
// sees it once.
#include "numeric.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int N,
                  int D, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  T* yr = y + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(xr[d]);
  const float mu = warp_sum(s) / (float)D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_f(xr[d]) - mu;
    ss = fmaf(c, c, ss);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
  for (int d = lane; d < D; d += 32)
    yr[d] = from_f<T>((to_f(xr[d]) - mu) * r * to_f(gamma[d]) +
                      to_f(beta[d]));
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, void* mean, void* rstd, int N, int D, float eps,
                   cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  ln_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), N, D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0
// on success); the caller has validated shapes, devices and layout.
extern "C" int paddle_layer_norm_fwd(const void* x, const void* gamma,
                                     const void* beta, void* y, void* mean,
                                     void* rstd, int N, int D, float eps,
                                     int dtype, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, N, D,
                                        eps, s);
    case 2:
      return (int)launch<__half>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
