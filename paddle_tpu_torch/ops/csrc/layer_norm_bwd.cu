// LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_vjp_bwd
// (_ln_bwd_kernel, pallas_call :129): from x, gamma, the forward's fp32
// mean and rstd, and dy,
//   xhat = (x - mean) * rstd,  w = dy * gamma
//   dx = (w - mean_D(w) - xhat * mean_D(w * xhat)) * rstd    (rounded to T)
// and per block of kRows rows the partial sums over its rows of dy * xhat
// (dgamma) and dy (dbeta), in fp32. The caller sums the partials, as the
// TPU's wrapper sums its per-block partials in XLA: the result does not
// depend on scheduling (no atomics).
//
//   x, dy, dx   [N, D]        fp32, bf16 or fp16; any N
//   gamma       [D]           x's dtype
//   mean, rstd  [N]           fp32
//   dg, db      [ceil(N / kRows), D]  fp32 partials
//
// What bounds it on the card: bytes (x and dy read, dx written; the
// partials are N / kRows times smaller). Design: a block owns kRows = 32
// rows; first one warp per row (four rows a warp) for dx, neighbouring
// lanes on neighbouring elements; then the block's threads split the
// columns and sum each over the block's rows, reading x and dy again from
// L1/L2.
#include "numeric.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 8;
constexpr int kRows = 32;  // rows per block, one dgamma/dbeta partial each

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ dg,
                  float* __restrict__ db, int N, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, N - r0);
  const float inv_d = 1.f / (float)D;
  for (int rr = warp; rr < nr; rr += kWarps) {
    const size_t off = (size_t)(r0 + rr) * D;
    const float mu = mean[r0 + rr], r = rstd[r0 + rr];
    float c1 = 0.f, c2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float w = to_f(dy[off + d]) * to_f(gamma[d]);
      c1 += w;
      c2 = fmaf(w, (to_f(x[off + d]) - mu) * r, c2);
    }
    c1 = warp_sum(c1) * inv_d;
    c2 = warp_sum(c2) * inv_d;
    for (int d = lane; d < D; d += 32) {
      const float w = to_f(dy[off + d]) * to_f(gamma[d]);
      const float xhat = (to_f(x[off + d]) - mu) * r;
      dx[off + d] = from_f<T>((w - c1 - xhat * c2) * r);
    }
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int rr = 0; rr < nr; ++rr) {
      const size_t off = (size_t)(r0 + rr) * D + d;
      const float g_ = to_f(dy[off]);
      g = fmaf(g_, (to_f(x[off]) - mean[r0 + rr]) * rstd[r0 + rr], g);
      b += g_;
    }
    dg[(size_t)blockIdx.x * D + d] = g;
    db[(size_t)blockIdx.x * D + d] = b;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* mean,
                   const void* rstd, const void* dy, void* dx, void* dg,
                   void* db, int N, int D, cudaStream_t stream) {
  const int blocks = (N + kRows - 1) / kRows;
  ln_bwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg), static_cast<float*>(db), N, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. dg and db hold
// ceil(N / 32) x D floats (kRows; ops/layer_norm.py's ROWS_PER_PARTIAL).
// Returns a cudaError_t (0 on success); the caller has validated shapes,
// devices and layout.
extern "C" int paddle_layer_norm_bwd(const void* x, const void* gamma,
                                     const void* mean, const void* rstd,
                                     const void* dy, void* dx, void* dg,
                                     void* db, int N, int D, int dtype,
                                     void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, mean, rstd, dy, dx, dg, db, N, D,
                                s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dg, db,
                                        N, D, s);
    case 2:
      return (int)launch<__half>(x, gamma, mean, rstd, dy, dx, dg, db, N, D,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
