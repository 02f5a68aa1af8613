// RMSNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_rms_vjp_bwd
// (_rms_bwd_kernel, pallas_call :230): from x, gamma, the forward's fp32
// rstd, and dy,
//   xhat = x * rstd,  w = dy * gamma
//   dx = (w - xhat * mean_D(w * xhat)) * rstd            (rounded to T)
// and per block of kRows rows the partial sum over its rows of dy * xhat
// (dgamma), in fp32. The caller sums the partials, as the TPU's wrapper
// sums its per-block partials in XLA: the result does not depend on
// scheduling (no atomics).
//
//   x, dy, dx   [N, D]                 fp32, bf16 or fp16; any N
//   gamma       [D]                    x's dtype
//   rstd        [N]                    fp32
//   dg          [ceil(N / kRows), D]   fp32 partials
//
// What bounds it on the card: bytes (x and dy read, dx written; the
// partials are N / kRows times smaller). Design: layer_norm_bwd.cu's
// scheme with 16-byte vectors (when D and the pointers allow them): a
// block owns kRows = 32 rows; first one warp per row (four rows a warp),
// two passes over the row (the sum, then dx, the second from L1/L2);
// then the block's threads split the row's vectors and sum each column
// over the block's rows, reading x and dy again from L2. CUDA C++ for
// the reasons rms_norm_fwd.cu gives.
#include "numeric.cuh"
#include "vec.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 8;
constexpr int kRows = 32;  // rows per block, one dgamma partial each

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dg, int N, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, N - r0);
  const int nv = D / V;
  const float inv_d = 1.f / (float)D;
  for (int rr = warp; rr < nr; rr += kWarps) {
    const size_t off = (size_t)(r0 + rr) * D;
    const float r = rstd[r0 + rr];
    float c = 0.f;
#pragma unroll 4
    for (int i = lane; i < nv; i += 32) {
      float a[V], g[V], d[V];
      load_vec<T, V>(x + off + i * V, a);
      load_vec<T, V>(dy + off + i * V, d);
      load_vec<T, V>(gamma + i * V, g);
#pragma unroll
      for (int j = 0; j < V; ++j) c = fmaf(d[j] * g[j], a[j] * r, c);
    }
    c = warp_sum(c) * inv_d;
#pragma unroll 4
    for (int i = lane; i < nv; i += 32) {
      float a[V], g[V], d[V];
      load_vec<T, V>(x + off + i * V, a);
      load_vec<T, V>(dy + off + i * V, d);
      load_vec<T, V>(gamma + i * V, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = a[j] * r;
        a[j] = (d[j] * g[j] - xhat * c) * r;
      }
      store_vec<T, V>(dx + off + i * V, a);
    }
  }
  for (int i = threadIdx.x; i < nv; i += kWarps * 32) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < nr; ++rr) {
      const size_t off = (size_t)(r0 + rr) * D + i * V;
      const float r = rstd[r0 + rr];
      float a[V], d[V];
      load_vec<T, V>(x + off, a);
      load_vec<T, V>(dy + off, d);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(d[j], a[j] * r, acc[j]);
    }
    float* out = dg + (size_t)blockIdx.x * D + i * V;
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = acc[j];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* rstd,
                   const void* dy, void* dx, void* dg, int N, int D,
                   cudaStream_t stream) {
  const int blocks = (N + kRows - 1) / kRows;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const float* rp = static_cast<const float*>(rstd);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* dgp = static_cast<float*>(dg);
  constexpr int V = kVecBytes / sizeof(T);
  if (vec_ok<T>(D, x, gamma, dy, dx)) {
    rms_bwd_kernel<T, V><<<blocks, kWarps * 32, 0, stream>>>(
        xp, gp, rp, dyp, dxp, dgp, N, D);
  } else {
    rms_bwd_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(
        xp, gp, rp, dyp, dxp, dgp, N, D);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. dg holds ceil(N / 32) x
// D floats (kRows; ops/layer_norm.py's ROWS_PER_PARTIAL). Returns a
// cudaError_t (0 on success); the caller has validated shapes, devices and
// layout.
extern "C" int paddle_rms_norm_bwd(const void* x, const void* gamma,
                                   const void* rstd, const void* dy, void* dx,
                                   void* dg, int N, int D, int dtype,
                                   void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, rstd, dy, dx, dg, N, D, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, rstd, dy, dx, dg, N, D, s);
    case 2:
      return (int)launch<__half>(x, gamma, rstd, dy, dx, dg, N, D, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
