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
// element). Two designs; the wrapper picks one (ops/layer_norm.py's
// rms_norm_path) and passes it as `path` with the grid's block count; the
// entry runs that design or fails:
// - path 1, "row_block" (D a whole number of 16-byte vectors, at most
//   kMaxNv a thread, and 16-byte aligned pointers): row_block.cuh's
//   design. A block of 256 threads holds a row in registers (D 4096 bf16:
//   two vectors a thread), so x is read once and y written once; the sum
//   of squares is one block reduction; gamma is loaded once a block; a
//   persistent grid of `blocks` walks the rows, each block loading its
//   next row before it reduces the current one.
// - path 0, "per_warp" (every other shape): one warp per row, eight rows
//   per block, each lane moving 16 bytes a load (neighbouring lanes on
//   neighbouring vectors) when D and the pointers allow it, else one
//   element a load; the sum of squares in fp32 by warp shuffles, then the
//   row is read again (from L1/L2) for the output, gamma reloaded a row.
// CUDA C++ rather than Triton: the port's only build path is nvcc into a
// plain-C library (ops/_build.py), and the LayerNorm kernels these mirror
// are CUDA.
#include "numeric.cuh"
#include "row_block.cuh"
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

// The row-block design: block b normalises rows b, b + gridDim.x, ...
// (gridDim.x <= N), each row's NV vectors a thread in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(rowblk::kThreads, 4)
    rms_fwd_row_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       T* __restrict__ y, float* __restrict__ rstd, int N,
                       int D, float eps) {
  constexpr int V = kVecBytes / sizeof(T);
  __shared__ float slots[2 * rowblk::kWarps];
  const int nv = D / V;
  uint4 g[NV], xc[NV];
  rowblk::load_row<NV>(gamma, nv, g);
  int row = blockIdx.x;
  rowblk::load_row<NV>(x + (size_t)row * D, nv, xc);
  for (int parity = 0; row < N; row += gridDim.x, parity ^= 1) {
    // the next row's loads go out before this row's reduction
    const int next = row + gridDim.x;
    uint4 xn[NV];
    rowblk::load_row<NV>(next < N ? x + (size_t)next * D : nullptr, nv, xn);
    float a[NV][V];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack_vec<T, V>(xc[j], a[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(a[j][e], a[j][e], ss);
    }
    const float r =
        rsqrtf(rowblk::block_sum(ss, slots, parity) / (float)D + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x + j * rowblk::kThreads;
      if (i < nv) {
        float gf[V];
        unpack_vec<T, V>(g[j], gf);
#pragma unroll
        for (int e = 0; e < V; ++e) a[j][e] = a[j][e] * r * gf[e];
        yr[i] = pack_vec<T, V>(a[j]);
      }
    }
    if (threadIdx.x == 0) rstd[row] = r;
#pragma unroll
    for (int j = 0; j < NV; ++j) xc[j] = xn[j];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* y, void* rstd,
                   int N, int D, float eps, int path, int blocks,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rstd);
  constexpr int V = kVecBytes / sizeof(T);
  if (path == 1) {
    const int nv = D / V;
    if (D % V || nv > rowblk::kMaxNv * rowblk::kThreads || blocks < 1 ||
        blocks > N)
      return cudaErrorInvalidValue;
    if (!vec_ok<T>(D, x, gamma, y)) return cudaErrorMisalignedAddress;
    if (nv <= rowblk::kThreads)
      rms_fwd_row_kernel<T, 1><<<blocks, rowblk::kThreads, 0, stream>>>(
          xp, gp, yp, rp, N, D, eps);
    else
      rms_fwd_row_kernel<T, 2><<<blocks, rowblk::kThreads, 0, stream>>>(
          xp, gp, yp, rp, N, D, eps);
    return cudaGetLastError();
  }
  if (path != 0 || blocks != (N + kWarps - 1) / kWarps)
    return cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 1 = row_block (D a
// multiple of the 16-byte vector, at most 2 * 256 vectors; 1 <= blocks <=
// N; x, gamma and y 16-byte aligned, else cudaErrorMisalignedAddress), 0 =
// per_warp (blocks = ceil(N / 8)); any other pairing returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_rms_norm_fwd(const void* x, const void* gamma, void* y,
                                   void* rstd, int N, int D, float eps,
                                   int dtype, int path, int blocks,
                                   void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, y, rstd, N, D, eps, path, blocks,
                                s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, y, rstd, N, D, eps, path,
                                        blocks, s);
    case 2:
      return (int)launch<__half>(x, gamma, y, rstd, N, D, eps, path, blocks,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
