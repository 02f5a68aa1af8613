// LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_vjp_bwd
// (_ln_bwd_kernel, pallas_call :129): from x, gamma, the forward's fp32
// mean and rstd, and dy,
//   xhat = (x - mean) * rstd,  w = dy * gamma
//   dx = (w - mean_D(w) - xhat * mean_D(w * xhat)) * rstd    (rounded to T)
//   dgamma = sum over the rows of dy * xhat, dbeta = sum of dy
//                                                        (fp32, then T)
// dgamma and dbeta are summed without atomics: each block of the main
// kernel writes its fp32 partial pair, and a second kernel of the same
// call sums the partials in a fixed order and rounds to T, as the TPU's
// wrapper sums its per-block partials in XLA, so the result does not
// depend on scheduling.
//
//   x, dy, dx   [N, D]          fp32, bf16 or fp16; any N
//   gamma       [D]             x's dtype
//   mean, rstd  [N]             fp32
//   part        [blocks, 2 D]   fp32 partials, one pair a block of the main
//                               kernel: dgamma's D columns, then dbeta's
//   dgb         [2, D]          x's dtype: dgamma, then dbeta
//
// What bounds it on the card: bytes (x and dy read, dx written; the
// partials are 2 D floats a block). Two designs; the wrapper picks one
// (ops/layer_norm.py's layer_norm_path) and passes it as `path` with the
// main kernel's block count (layer_norm_blocks; which rows each partial
// covers: ln_bwd_partials); the entry runs that design or fails:
// - path 1, "row_warp" (D a whole number of 16-byte vectors, at most
//   kMaxLaneNv a lane, and 16-byte aligned pointers): row_block.cuh's
//   warp-held row. A warp reduces a row of x and of dy held in its
//   registers, lane l vectors l, l + 32, ... (GPT-2's D 768 in bf16: three
//   each), so each is read once and dx written once; mean_D(w) and
//   mean_D(w * xhat) are two warp shuffle trees, no barrier; gamma stays in
//   registers, loaded once a warp. A persistent grid of `blocks` blocks of
//   kWarps warps walks the rows: warp w of block b takes rows b * kWarps +
//   w, then that plus blocks * kWarps, and so on, with its next kStages - 1
//   rows in flight into a ring in shared memory (cp.async: no registers
//   held while they fly). A lane owns the same columns in every row it
//   takes, so dgamma and dbeta accumulate in fp32 registers with no pass
//   of their own; at the end the block's warps add theirs through shared
//   memory in warp order and the block writes one partial pair. One
//   256-thread block an SM (the fastest grid at [8192, 768] bf16,
//   profile_rms_norm --norm layer) keeps the partials small at short rows
//   and leaves each thread the registers for four vectors a lane.
// - path 0, "per_warp" (every other shape): a block owns kRows = 32 rows;
//   first one warp per row (four rows a warp) for dx, neighbouring lanes
//   on neighbouring elements, two passes over the row; then the block's
//   threads split the columns and sum each over the block's rows, reading
//   x and dy again from L1/L2.
#include "numeric.cuh"
#include "row_block.cuh"
#include "vec.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace paddle_attn;

// warps a block of either design (the row-warp design's one 256-thread
// block an SM leaves a thread up to 255 registers: the row of x and of dy
// it reduces, gamma and the fp32 dgamma and dbeta accumulators, with no
// spill)
constexpr int kWarps = 8;
constexpr int kRows = 32;  // rows per block, one dgamma/dbeta partial each
// the row-warp design: vectors a lane at most, and rows a warp has in its
// shared-memory ring
constexpr int kMaxLaneNv = 4;
constexpr int kStages = 3;
static_assert(kWarps * kStages * (2 * kMaxLaneNv * 32 + 16) * 16 <=
                  227 * 1024,
              "the row-warp design's rings fit a block's shared memory");
// the partials' sum: warps a block (each takes every kSumWarps-th partial)
constexpr int kSumWarps = 32;

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
    dg[(size_t)blockIdx.x * 2 * D + d] = g;
    db[(size_t)blockIdx.x * 2 * D + d] = b;
  }
}

// The row-warp design: warp w of block b takes rows b * kWarps + w, then
// that plus gridDim.x * kWarps, ... (gridDim.x * kWarps < N + kWarps, so
// every block has a row). Each warp streams its rows through a
// ring of kStages stages in shared memory by cp.async (a lane copies the
// vectors it will read, and its own copy of the row's mean and rstd, so
// no lane waits on another), kStages - 1 rows in flight while it reduces
// one; the row it reduces sits in registers, NV vectors of x and of dy a
// lane. At the end the block writes its partial pair, part[b], through
// the same shared memory: kWarps * D floats, one quantity of every warp's
// partial at a time.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32, 1)
    ln_bwd_row_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ part, int N, int D) {
  constexpr int V = kVecBytes / sizeof(T);
  // a stage: x's then dy's [NV][32] vectors, then [2][32] floats (mean
  // and rstd, one a lane)
  constexpr int kStageVecs = 2 * NV * 32 + 16;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  const int nv = D / V;
  const float inv_d = 1.f / (float)D;
  uint4* ring = smem + (size_t)warp * kStages * kStageVecs;
  const uint32_t ring_s = wg::smem_u32(ring);
  // row r's copies into stage s; none past the last row
  auto issue = [&](int r, int s) {
    if (r < N) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
      const uint4* dr = reinterpret_cast<const uint4*>(dy + (size_t)r * D);
      const uint32_t st = ring_s + s * kStageVecs * 16 + lane * 16;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = lane + j * 32;
        const bool ok = i < nv;
        wg::cp_async16(st + j * 512, xr + (ok ? i : 0), ok);
        wg::cp_async16(st + (NV + j) * 512, dr + (ok ? i : 0), ok);
      }
      const uint32_t sf = ring_s + (s * kStageVecs + 2 * NV * 32) * 16;
      wg::cp_async4(sf + lane * 4, mean + r, true);
      wg::cp_async4(sf + (32 + lane) * 4, rstd + r, true);
    }
    wg::cp_async_commit();
  };
  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(row + s * stride, s);
  uint4 g[NV];
  rowblk::load_warp_row<NV>(gamma, nv, g);
  float ag[NV][V], ab[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ag[j][e] = ab[j][e] = 0.f;
  for (int s = 0; row < N; row += stride) {
    // the stage read last time takes the row kStages - 1 ahead
    issue(row + (kStages - 1) * stride, s == 0 ? kStages - 1 : s - 1);
    wg::cp_async_wait<kStages - 1>();
    const uint4* st = ring + s * kStageVecs;
    uint4 xc[NV], dc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xc[j] = st[j * 32 + lane];
      dc[j] = st[(NV + j) * 32 + lane];
    }
    const float* sf = reinterpret_cast<const float*>(st + 2 * NV * 32);
    const float mc = sf[lane], rc = sf[32 + lane];
    // vectors past the row are zero: w = 0 there adds nothing
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float a[V], d[V], gf[V];
      unpack_vec<T, V>(xc[j], a);
      unpack_vec<T, V>(dc[j], d);
      unpack_vec<T, V>(g[j], gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float w = d[e] * gf[e];
        c1 += w;
        c2 = fmaf(w, (a[e] - mc) * rc, c2);
      }
    }
    c1 = warp_sum(c1) * inv_d;
    c2 = warp_sum(c2) * inv_d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + j * 32;
      if (i < nv) {
        float a[V], d[V], gf[V];
        unpack_vec<T, V>(xc[j], a);
        unpack_vec<T, V>(dc[j], d);
        unpack_vec<T, V>(g[j], gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (a[e] - mc) * rc;
          a[e] = (d[e] * gf[e] - c1 - xhat * c2) * rc;
          ag[j][e] = fmaf(d[e], xhat, ag[j][e]);
          ab[j][e] += d[e];
        }
        dxr[i] = pack_vec<T, V>(a);
      }
    }
    s = s == kStages - 1 ? 0 : s + 1;
  }
  // the block's partial pair, each quantity's warps added in warp order,
  // through the ring's shared memory once every copy has landed
  wg::cp_async_wait<0>();
  __syncthreads();
  float4* slab = reinterpret_cast<float4*>(smem);
  const int d4 = D / 4;
  float4* out = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * 2 * D);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + j * 32;
      if (i < nv) {
        float4* s = slab + (size_t)warp * d4 + i * (V / 4);
#pragma unroll
        for (int k = 0; k < V / 4; ++k)
          s[k] = q == 0 ? make_float4(ag[j][4 * k], ag[j][4 * k + 1],
                                      ag[j][4 * k + 2], ag[j][4 * k + 3])
                        : make_float4(ab[j][4 * k], ab[j][4 * k + 1],
                                      ab[j][4 * k + 2], ab[j][4 * k + 3]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d4; c += kWarps * 32) {
      float4 t = slab[c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 u = slab[(size_t)w * d4 + c];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      out[q * d4 + c] = t;
    }
    __syncthreads();
  }
}

template <typename T, int NV>
cudaError_t launch_row(const T* x, const T* gamma, const float* mean,
                       const float* rstd, const T* dy, T* dx, float* part,
                       int N, int D, int blocks, cudaStream_t stream) {
  // the rings (the partials' kWarps * D floats fit in them: D <= NV * 32 *
  // V)
  const int smem = kWarps * kStages * (2 * NV * 32 + 16) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_row_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_row_kernel<T, NV><<<blocks, kWarps * 32, smem, stream>>>(
      x, gamma, mean, rstd, dy, dx, part, N, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* mean,
                   const void* rstd, const void* dy, void* dx, void* part,
                   void* dgb, int N, int D, int path, int blocks,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  constexpr int V = kVecBytes / sizeof(T);
  cudaError_t err;
  if (path == 1) {
    const int lane_nv = (D / V + 31) / 32;
    if (D % V || lane_nv > kMaxLaneNv || blocks < 1 ||
        blocks > (N + kWarps - 1) / kWarps)
      return cudaErrorInvalidValue;
    if (!vec_ok<T>(D, x, gamma, dy, dx, part))
      return cudaErrorMisalignedAddress;
    switch (lane_nv) {
      case 1:
        err = launch_row<T, 1>(xp, gp, mp, rp, dyp, dxp, pp, N, D, blocks,
                               stream);
        break;
      case 2:
        err = launch_row<T, 2>(xp, gp, mp, rp, dyp, dxp, pp, N, D, blocks,
                               stream);
        break;
      case 3:
        err = launch_row<T, 3>(xp, gp, mp, rp, dyp, dxp, pp, N, D, blocks,
                               stream);
        break;
      default:
        err = launch_row<T, 4>(xp, gp, mp, rp, dyp, dxp, pp, N, D, blocks,
                               stream);
        break;
    }
  } else if (path == 0 && blocks == (N + kRows - 1) / kRows) {
    ln_bwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        xp, gp, mp, rp, dyp, dxp, pp, pp + D, N, D);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  rowblk::partial_sum_kernel<T, kSumWarps>
      <<<(2 * D + 31) / 32, kSumWarps * 32, 0, stream>>>(
          pp, static_cast<T*>(dgb), blocks, 2 * D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 1 = row_warp (D a
// multiple of the 16-byte vector, at most 32 * kMaxLaneNv vectors; 1 <=
// blocks <= ceil(N / kWarps); x, gamma, dy, dx and part 16-byte aligned,
// else cudaErrorMisalignedAddress), 0 = per_warp (blocks = ceil(N / 32):
// kRows, ops/layer_norm.py's ROWS_PER_PARTIAL); any other pairing returns
// cudaErrorInvalidValue. part holds
// blocks x 2 D floats, dgb 2 D values of T (dgamma, then dbeta). Returns a
// cudaError_t (0 on success); the caller has validated shapes, devices and
// layout.
extern "C" int paddle_layer_norm_bwd(const void* x, const void* gamma,
                                     const void* mean, const void* rstd,
                                     const void* dy, void* dx, void* part,
                                     void* dgb, int N, int D, int dtype,
                                     int path, int blocks, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, gamma, mean, rstd, dy, dx, part, dgb, N,
                                D, path, blocks, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx, part,
                                        dgb, N, D, path, blocks, s);
    case 2:
      return (int)launch<__half>(x, gamma, mean, rstd, dy, dx, part, dgb, N,
                                 D, path, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
