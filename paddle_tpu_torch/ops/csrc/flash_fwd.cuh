// The FA-2 forward shared by the flash attention forward
// (flash_attention_fwd.cu) and the ring attention chunk forward
// (ring_chunk_attention_fwd.cu): o and the row log-sum-exp of q against
// k/v under a diagonal mask.
//
//   q   [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k,v [B, Hk, Sk, D]    q's dtype; Hk divides H, head h reads h / (H/Hk)
//   o   [B, H, Sq, D]     q's dtype
//   lse [B, H, Sq]        fp32
//
// Row i attends key j iff j <= i + offset. With kRing the offset is the
// argument diag, the ring step's, which may mask every key of a row or of
// the whole launch; otherwise diag is the flash kernels' causal flag and
// the offset Sk - Sq (the bottom-right diagonal), or no mask when it is
// 0. The flash instantiations keep the flag rather than take the offset
// as an argument: with the offset an argument, the dQ kernel at D = 64
// took 152 registers, one block an SM instead of two, and ran 43% slower
// (the backward headers follow the same rule). Key tiles wholly above the
// diagonal are skipped; scores, m and l are fp32; p is rounded to v's
// dtype before the PV product; o = acc / l with l == 0 read as 1, and lse
// = m + log(l) with the same guard, so a row that attends nothing returns
// o = 0 and lse = -1e30 (its m never leaves -1e30). With kDrop the p that
// enter the PV product are multiplied by keep / (1 - p) and l stays the
// sum of the raw p (dropout.cuh).
//
// Design: one thread block per (b, h, 64-row q tile); K/V tiles of 32
// keys staged as fp32 in shared memory with 16-byte loads issued in
// batches; eight warps, each owning eight query rows whose dot products
// share every key read and whose fp32 online softmax lives in registers
// (attention_tile.cuh); the products run on the fp32 cores, so fp32 inputs
// never go through TF32.
#pragma once

#include "attention_tile.cuh"

namespace paddle_attn {

namespace flash_fwd {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // 64 query rows per block

template <typename T, int DPL, bool kDrop, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int H, int Hk, int Sq, int Sk, int D,
           int diag, float scale, DropParams drop, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                 // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;      // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;      // [kQTile][Dp]
  float* ps = qs + kQTile * Dp;     // [kQTile][kTile]

  const int n_qt = (Sq + kQTile - 1) / kQTile;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kQTile;
  const int nrows = min(kQTile, Sq - q0);
  const bool causal = kRing || diag;
  const int offset = kRing ? diag : Sk - Sq;

  const T* q_t = q + (((size_t)b * H + h) * Sq + q0) * D;
  const T* k_bh = k + ((size_t)b * Hk + hk) * Sk * D;
  const T* v_bh = v + ((size_t)b * Hk + hk) * Sk * D;
  stage_rows(qs, q_t, nrows, kQTile, D, Dp, Dp);

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    // the last key this row attends; -1 for rows past Sq (and below -1
    // for a row the offset masks whole)
    limit[rr] = row < Sq ? (causal ? min(row + offset, Sk - 1) : Sk - 1)
                         : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // tiles past the tile's last attended key are skipped
  const int last = causal ? min(q0 + nrows - 1 + offset, Sk - 1) : Sk - 1;
  for (int c0 = 0; c0 <= last; c0 += kTile) {
    const int n = min(kTile, Sk - c0);
    __syncthreads();  // everyone is done with the previous tile
    stage_kv(ks, vs, k_bh + (size_t)c0 * D, v_bh + (size_t)c0 * D, n, D, Dp,
             ld, vec);
    __syncthreads();
    tile_update<T, kRowsPerWarp, DPL, false, kDrop>(
        qs + warp * kRowsPerWarp * Dp, ks, vs,
        ps + warp * kRowsPerWarp * kTile, D, Dp, c0, n, limit, scale, m, l,
        acc, nullptr, nullptr, &drop, (uint32_t)bh,
        q0 + warp * kRowsPerWarp);
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= Sq) continue;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    const size_t r_idx = ((size_t)b * H + h) * Sq + row;
    T* o_r = o + r_idx * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o_r[d] = from_f<T>(acc[rr][i] / denom);
    }
    if (lane == 0) lse[r_idx] = m[rr] + logf(denom);
  }
}

template <typename T, int DPL, bool kDrop, bool kRing>
cudaError_t launch_dpl(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                       int diag, float scale, DropParams drop,
                       cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem =
      (size_t)(2 * kTile * (Dp + 1) + kQTile * Dp + kQTile * kTile) *
      sizeof(float);
  auto fn = kernel<T, DPL, kDrop, kRing>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)B * H * ((Sq + kQTile - 1) / kQTile);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hk, Sq, Sk, D, diag, scale, drop, vec_ok<T>(D, k, v));
  return cudaGetLastError();
}

// The instantiation for D: DPL = D / 32 rounded up to a power of two.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                   int diag, float scale, DropParams drop,
                   cudaStream_t stream) {
#define PADDLE_FLASH_FWD_LAUNCH(DPL)                                         \
  launch_dpl<T, DPL, kDrop, kRing>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D, diag, \
                                   scale, drop, stream)
  if (D <= 32) return PADDLE_FLASH_FWD_LAUNCH(1);
  if (D <= 64) return PADDLE_FLASH_FWD_LAUNCH(2);
  if (D <= 128) return PADDLE_FLASH_FWD_LAUNCH(4);
  return PADDLE_FLASH_FWD_LAUNCH(8);
#undef PADDLE_FLASH_FWD_LAUNCH
}

}  // namespace flash_fwd

}  // namespace paddle_attn
