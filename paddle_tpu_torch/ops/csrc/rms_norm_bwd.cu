// RMSNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_rms_vjp_bwd
// (_rms_bwd_kernel, pallas_call :230): from x, gamma, the forward's fp32
// rstd, and dy,
//   xhat = x * rstd,  w = dy * gamma
//   dx = (w - xhat * mean_D(w * xhat)) * rstd            (rounded to T)
//   dgamma = sum over the rows of dy * xhat               (fp32, then T)
// dgamma is summed without atomics: each block of the main kernel writes
// its fp32 partial row, and a second kernel of the same call sums the
// partials in a fixed order and rounds to T, as the TPU's wrapper sums its
// per-block partials in XLA, so the result does not depend on scheduling.
//
//   x, dy, dx   [N, D]        fp32, bf16 or fp16; any N
//   gamma, dg   [D]           x's dtype
//   rstd        [N]           fp32
//   part        [blocks, D]   fp32 partials, one a block of the main kernel
//
// What bounds it on the card: bytes (x and dy read, dx written; the
// partials are D floats a block). Two designs; the wrapper picks one
// (ops/layer_norm.py's rms_norm_path) and passes it as `path` with the
// main kernel's block count (rms_bwd_partials: which rows each partial
// covers); the entry runs that design or fails:
// - path 1, "row_block" (D a whole number of 16-byte vectors, at most
//   kMaxNv a thread, and 16-byte aligned pointers): row_block.cuh's
//   design. A block of 256 threads holds a row of x and of dy in registers
//   (D 4096 bf16: two vectors each a thread), so each is read once and dx
//   written once; mean_D(w * xhat) is one block reduction; gamma is loaded
//   once a block; a persistent grid of `blocks` walks the rows with that
//   stride, each block loading its next row before it reduces the current
//   one. Each thread owns a fixed slice of columns and accumulates dy *
//   xhat for every row its block walks in fp32 registers, so dgamma needs
//   no pass of its own; the block writes its partial once at the end.
// - path 0, "per_warp" (every other shape): layer_norm_bwd.cu's scheme
//   with 16-byte vectors (when D and the pointers allow them): a block
//   owns kRows = 32 rows; first one warp per row (four rows a warp), two
//   passes over the row (the sum, then dx, the second from L1/L2); then
//   the block's threads split the row's vectors and sum each column over
//   the block's rows, reading x and dy again from L2.
// CUDA C++ for the reasons rms_norm_fwd.cu gives.
#include "numeric.cuh"
#include "row_block.cuh"
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

// The row-block design: block b takes rows b, b + gridDim.x, ...
// (gridDim.x <= N), each row's NV vectors of x and dy a thread in
// registers, and writes its dgamma partial, part[b], at the end.
template <typename T, int NV>
__global__ void __launch_bounds__(rowblk::kThreads, 2)
    rms_bwd_row_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, int N, int D) {
  constexpr int V = kVecBytes / sizeof(T);
  __shared__ float slots[2 * rowblk::kWarps];
  const int nv = D / V;
  const float inv_d = 1.f / (float)D;
  uint4 g[NV], xc[NV], dc[NV];
  rowblk::load_row<NV>(gamma, nv, g);
  int row = blockIdx.x;
  rowblk::load_row<NV>(x + (size_t)row * D, nv, xc);
  rowblk::load_row<NV>(dy + (size_t)row * D, nv, dc);
  float rc = __ldg(rstd + row);
  float acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  for (int parity = 0; row < N; row += gridDim.x, parity ^= 1) {
    // the next row's loads go out before this row's reduction
    const int next = row + gridDim.x;
    const bool more = next < N;
    uint4 xn[NV], dn[NV];
    rowblk::load_row<NV>(more ? x + (size_t)next * D : nullptr, nv, xn);
    rowblk::load_row<NV>(more ? dy + (size_t)next * D : nullptr, nv, dn);
    const float rn = more ? __ldg(rstd + next) : 0.f;
    float a[NV][V], d[NV][V];
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float gf[V];
      unpack_vec<T, V>(xc[j], a[j]);
      unpack_vec<T, V>(dc[j], d[j]);
      unpack_vec<T, V>(g[j], gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a[j][e] *= rc;  // xhat
        c = fmaf(d[j][e] * gf[e], a[j][e], c);
      }
    }
    c = rowblk::block_sum(c, slots, parity) * inv_d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x + j * rowblk::kThreads;
      if (i < nv) {
        float gf[V], o[V];
        unpack_vec<T, V>(g[j], gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = (d[j][e] * gf[e] - a[j][e] * c) * rc;
          acc[j][e] = fmaf(d[j][e], a[j][e], acc[j][e]);
        }
        dxr[i] = pack_vec<T, V>(o);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xc[j] = xn[j];
      dc[j] = dn[j];
    }
    rc = rn;
  }
  float* out = part + (size_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * rowblk::kThreads;
    if (i < nv) {
      float4* o = reinterpret_cast<float4*>(out + i * V);
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        o[k] = make_float4(acc[j][4 * k], acc[j][4 * k + 1],
                           acc[j][4 * k + 2], acc[j][4 * k + 3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* rstd,
                   const void* dy, void* dx, void* part, void* dg, int N,
                   int D, int path, int blocks, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const float* rp = static_cast<const float*>(rstd);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  constexpr int V = kVecBytes / sizeof(T);
  if (path == 1) {
    const int nv = D / V;
    if (D % V || nv > rowblk::kMaxNv * rowblk::kThreads || blocks < 1 ||
        blocks > N)
      return cudaErrorInvalidValue;
    if (!vec_ok<T>(D, x, gamma, dy, dx, part))
      return cudaErrorMisalignedAddress;
    if (nv <= rowblk::kThreads)
      rms_bwd_row_kernel<T, 1><<<blocks, rowblk::kThreads, 0, stream>>>(
          xp, gp, rp, dyp, dxp, pp, N, D);
    else
      rms_bwd_row_kernel<T, 2><<<blocks, rowblk::kThreads, 0, stream>>>(
          xp, gp, rp, dyp, dxp, pp, N, D);
  } else if (path == 0 && blocks == (N + kRows - 1) / kRows) {
    if (vec_ok<T>(D, x, gamma, dy, dx)) {
      rms_bwd_kernel<T, V><<<blocks, kWarps * 32, 0, stream>>>(
          xp, gp, rp, dyp, dxp, pp, N, D);
    } else {
      rms_bwd_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(
          xp, gp, rp, dyp, dxp, pp, N, D);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowblk::partial_sum_kernel<T, kWarps>
      <<<(D + 31) / 32, kWarps * 32, 0, stream>>>(pp, static_cast<T*>(dg),
                                                  blocks, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 1 = row_block (D a
// multiple of the 16-byte vector, at most 2 * 256 vectors; 1 <= blocks <=
// N; x, gamma, dy, dx and part 16-byte aligned, else
// cudaErrorMisalignedAddress), 0 = per_warp (blocks = ceil(N / 32):
// kRows, ops/layer_norm.py's ROWS_PER_PARTIAL); any other pairing returns
// cudaErrorInvalidValue. part holds blocks x D floats, dg D values of T.
// Returns a cudaError_t (0 on success); the caller has validated shapes,
// devices and layout.
extern "C" int paddle_rms_norm_bwd(const void* x, const void* gamma,
                                   const void* rstd, const void* dy, void* dx,
                                   void* part, void* dg, int N, int D,
                                   int dtype, int path, int blocks,
                                   void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, rstd, dy, dx, part, dg, N, D, path,
                                blocks, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, rstd, dy, dx, part, dg, N,
                                        D, path, blocks, s);
    case 2:
      return (int)launch<__half>(x, gamma, rstd, dy, dx, part, dg, N, D,
                                 path, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
