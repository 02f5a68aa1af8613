// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::decode_attention_paged
// (_paged_kernel + _online_softmax_block): the new queries of each row
// attend, block-causally, to the row's KV prefix, which lives in one shared
// block pool and is resolved through a per-row block table.
//
//   q      [B, H, Sq, D]             (Sq <= 128, D <= 256)
//   pool   [L, 2, NB, Hk, Bt, D]     same dtype as q (fp32, bf16 or fp16)
//   tables [B, nblk] int32           unmapped entries hold the sentinel NB
//   lens   [B] int32                 query row r attends positions <= lens+r
//   out    [B, H, Sq, D]             q's dtype
//
// Semantics kept from the TPU kernel: an unmapped table entry reads block
// min(entry, NB - 1); KV blocks past the last attendable position are never
// read; scores and the softmax state are fp32, and p is rounded to the
// value dtype before the PV product; a row whose softmax sum is 0 returns 0.
//
// What bounds it on the card: bytes. A decode step reads the row's whole
// valid KV prefix once per KV head and does 4*D flops per position and
// query row, far below the H100's ~295 flop/byte ridge; at the serving
// shape (B 8, H 12, 1025 positions, D 64, bf16) the 25 MB of K and V take
// 7.5 us at 3.35 TB/s.
//
// Two designs; the wrapper picks one (ops/decode_attention.py's
// paged_path) and passes it as `path`; the entry runs that design or fails:
// - path 1, "split_kv" (bf16 and fp16, D a multiple of 8): split_decode.cuh.
//   The KV length is split over S blocks per (row, KV head), S from the
//   shapes and the SM count (the wrapper's paged_splits), each block
//   holding the GQA group's query rows, staging K/V tiles in the stored
//   dtype with 16-byte cp.async copies through a ring of 2-3 stages and
//   multiplying on mma.sync; a second kernel merges the S partials of each
//   row from the fp32 workspace `work` in split order.
// - path 0, "per_head" (fp32, or D not a multiple of 8): the first design,
//   one thread block per (row, head), K/V staged through shared memory 32
//   positions at a time as fp32 (row stride D + 1, so the per-lane dot
//   products hit distinct banks), four warps each owning up to four query
//   rows with an fp32 online softmax in registers.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "split_decode.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
constexpr int kTile = 32;  // KV positions staged per pass, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL: head-dim elements each lane accumulates (D <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                 const int* __restrict__ tables, const int* __restrict__ lens,
                 T* __restrict__ out, int H, int Sq, int D, int NB, int Hk,
                 int Bt, int nblk, int layer, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;               // [kTile][D + 1]
  float* vs = ks + kTile * ld;    // [kTile][D + 1]
  float* qs = vs + kTile * ld;    // [kRowsPerPass][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tk = Bt < kTile ? Bt : kTile;

  const size_t plane = (size_t)NB * Hk * Bt * D;  // K plane -> V plane
  const T* k_base = pool + (size_t)layer * 2 * plane;
  const T* v_base = k_base + plane;
  const T* q_bh = q + ((size_t)b * H + h) * Sq * D;
  T* o_bh = out + ((size_t)b * H + h) * Sq * D;
  const int* tbl = tables + (size_t)b * nblk;

  for (int r0 = 0; r0 < Sq; r0 += kRowsPerPass) {
    const int nrows = min(kRowsPerPass, Sq - r0);
    __syncthreads();  // the previous pass is done with qs
    for (int i = threadIdx.x; i < nrows * D; i += blockDim.x)
      qs[i] = to_f(q_bh[(size_t)r0 * D + i]);

    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      m[rr] = kNegInf;
      l[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
    }

    // the last position any row of this pass attends; the table covers
    // nblk * Bt positions and nothing past them is ever read
    const int last_pos = min(len + r0 + nrows - 1, nblk * Bt - 1);
    for (int c0 = 0; c0 <= last_pos; c0 += tk) {
      const int blk = min(tbl[c0 / Bt], NB - 1);
      const size_t off = (((size_t)blk * Hk + hk) * Bt + (c0 % Bt)) * D;
      __syncthreads();  // everyone is done with the previous tile
      for (int i = threadIdx.x; i < tk * D; i += blockDim.x) {
        const int c = i / D;
        const int d = i - c * D;
        ks[c * ld + d] = to_f(k_base[off + i]);
        vs[c * ld + d] = to_f(v_base[off + i]);
      }
      __syncthreads();

#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        if (r < nrows) {  // uniform across the warp
          const int pos = c0 + lane;
          const bool valid = lane < tk && pos <= len + r0 + r;
          float s = kNegInf;
          if (valid) {
            const float* qr = qs + r * D;
            const float* kr = ks + lane * ld;
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
            s = dot * scale;
          }
          const float m_new = fmaxf(m[rr], warp_max(s));
          const float alpha = expf(m[rr] - m_new);
          const float p = valid ? expf(s - m_new) : 0.f;
          l[rr] = l[rr] * alpha + warp_sum(p);
          m[rr] = m_new;
          const float pv = to_f(from_f<T>(p));
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
          for (int c = 0; c < tk; ++c) {
            const float pc = __shfl_sync(0xffffffffu, pv, c);
            const float* vr = vs + c * ld;
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              const int d = lane + 32 * i;
              if (d < D) acc[rr][i] = fmaf(pc, vr[d], acc[rr][i]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r < nrows) {
        const float denom = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D)
            o_bh[(size_t)(r0 + r) * D + d] = from_f<T>(acc[rr][i] / denom);
        }
      }
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* pool, const void* tables,
                   const void* lens, void* out, int B, int H, int Sq, int D,
                   int NB, int Hk, int Bt, int nblk, int layer, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kTile * (D + 1) + kRowsPerPass * D) * sizeof(float);
  auto kernel = paged_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), H, Sq, D, NB, Hk, Bt, nblk, layer, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* pool, const void* tables,
                     const void* lens, void* out, int B, int H, int Sq, int D,
                     int NB, int Hk, int Bt, int nblk, int layer, float scale,
                     cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, pool, tables, lens, out, B, H, Sq, D, NB, Hk, Bt,
                        nblk, layer, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, pool, tables, lens, out, B, H, Sq, D, NB, Hk, Bt,
                        nblk, layer, scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, pool, tables, lens, out, B, H, Sq, D, NB, Hk, Bt,
                        nblk, layer, scale, stream);
  return launch<T, 8>(q, pool, tables, lens, out, B, H, Sq, D, NB, Hk, Bt,
                      nblk, layer, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 1 = split_kv (bf16
// or fp16, D a multiple of 8; splits S >= 1 ranges of cb table blocks each,
// S = ceil(nblk / cb); work: fp32 [S * B * H * Sq * (D + 2)] when S > 1, q,
// pool and out 16-byte aligned), 0 = per_head (splits 1; work unused); any
// other pairing returns cudaErrorInvalidValue. Returns a cudaError_t (0 on
// success); the caller has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_paged(
    const void* q, const void* pool, const void* tables, const void* lens,
    void* out, void* work, int B, int H, int Sq, int D, int NB, int Hk,
    int Bt, int nblk, int layer, int splits, int cb, float scale, int dtype,
    int path, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > 128 || D < 1 || D > 256 || Hk < 1 ||
      H % Hk || NB < 1 || Bt < 1 || (Bt > kTile && Bt % kTile) || nblk < 1 ||
      splits < 1 || splits > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {  // ranges of cb whole table blocks
    if (cb < 1 || (nblk + cb - 1) / cb != splits)
      return (int)cudaErrorInvalidValue;
    return paddle_attn::split::run<false>(
        q, paddle_attn::split::layer_planes(pool, nullptr, layer, NB, Hk, Bt,
                                            D, 2),
        tables, lens, out, work, B, H, Sq, D, NB, Hk, Bt, nblk, splits,
        cb * Bt, scale, dtype, s);
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, pool, tables, lens, out, B, H, Sq, D, NB,
                                  Hk, Bt, nblk, layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, pool, tables, lens, out, B, H,
                                          Sq, D, NB, Hk, Bt, nblk, layer,
                                          scale, s);
    case 2:
      return (int)launch_d<__half>(q, pool, tables, lens, out, B, H, Sq, D,
                                   NB, Hk, Bt, nblk, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
