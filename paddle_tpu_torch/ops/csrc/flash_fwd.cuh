// The FA-2 forward shared by the flash attention forward
// (flash_attention_fwd.cu, replacing paddle_tpu/ops/pallas/
// flash_attention.py:222) and the ring attention chunk forward
// (ring_chunk_attention_fwd.cu, replacing ring_chunk_attention.py:240):
// o and the row log-sum-exp of q against k/v under a diagonal mask.
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
// What bounds it on the card: operations, 4 * D per attended (row, key)
// pair: at LLaMA-2-7B's [1, 32, 4096, 128] causal 137 GFLOP, 0.139 ms at
// the 989 TFLOP/s bf16 peak, against 134 MB of q, k, v and o (0.040 ms at
// 3.35 TB/s); at GPT-2's training [8, 12, 1024, 64] bytes, narrowly (12.9
// GFLOP, 0.013 ms, against 50.7 MB, 0.015 ms).
//
// Two designs, chosen by (dtype, D) alone at launch:
// - bf16 and fp16 at D 64 and 128 (every main path's shape): the
//   tensor-core kernel (flash_fwd_tc below): one warpgroup a block owns 64
//   query rows, K/V tiles of 64 keys stay 16-bit and double-buffered with
//   cp.async, S = Q K^T and O += P V run on wgmma (wgmma_tile.cuh) with P
//   rounded from the score accumulator into the A registers, and the
//   online softmax runs in base 2 in the accumulator's registers. Masks
//   apply only on tiles that cross the diagonal or the end of K. Dropout
//   draws each Philox call once: the four lanes holding a call's four
//   rows swap words by shuffles (dropout.cuh's keep_rows).
// - fp32, and any other D <= 256: the fp32-core kernel (flash_fwd::kernel):
//   one block per (b, h, 64-row q tile); K/V tiles of 32 keys staged as
//   fp32 in shared memory with 16-byte loads issued in batches; eight
//   warps of eight query rows whose fp32 online softmax lives in
//   registers (attention_tile.cuh); fp32 inputs never go through TF32.
#pragma once

#include "attention_tile.cuh"
#include "wgmma_tile.cuh"

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

// The fp32-core instantiation for D: DPL = D / 32 rounded up to a power of
// two.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch_fp32_cores(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Hk,
                              int Sq, int Sk, int D, int diag, float scale,
                              DropParams drop, cudaStream_t stream) {
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

// The tensor-core forward (bf16 / fp16 at D = 64 and 128): one warpgroup
// a block owns 64 query rows of one head; Q stays in shared memory, K/V
// tiles of 64 keys are double-buffered with cp.async (the next tile loads
// while the current one's products run); S = Q K^T and O += P V run on
// wgmma (P from registers), the online softmax in the accumulator's
// registers, in base 2 (scores times scale * log2(e)); lse is converted
// back to the natural log.
namespace flash_fwd_tc {

constexpr int kM = 64;  // query rows a block
constexpr int kN = 64;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int smem_bytes() {
  return (kM + 4 * kN) * D * 2 + 1024;  // Q, two stages of K and V, align
}

template <typename T, int D, bool kDrop, bool kRing>
__global__ void __launch_bounds__(wg::kThreads)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int H, int Hk, int Sq, int Sk, int diag,
           float scale, DropParams drop) {
  constexpr int kTileBytes = kN * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv0 = qs + kM * D * 2;  // stage s: K at kv0 + 2 s tile

  const int n_qt = (Sq + kM - 1) / kM;
  // the heaviest q tiles (the most keys under a causal mask) start first
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = qt * kM;
  const int nrows = min(kM, Sq - q0);
  const bool causal = kRing || diag;
  const int offset = kRing ? diag : Sk - Sq;
  const T* k_bh = k + ((size_t)b * Hk + hk) * Sk * D;
  const T* v_bh = v + ((size_t)b * Hk + hk) * Sk * D;

  // the thread's rows q0 + r_lo and q0 + r_lo + 8, and the last key each
  // attends (rows past Sq are computed and never stored)
  const int r_lo = 16 * warp + (lane >> 2);
  int limit[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    limit[i] = causal ? min(q0 + r_lo + 8 * i + offset, Sk - 1) : Sk - 1;
  const int last = causal ? min(q0 + nrows - 1 + offset, Sk - 1) : Sk - 1;
  const int n_tiles = last < 0 ? 0 : last / kN + 1;

  wg::load_tile<kM, D>(qs, q + ((size_t)bh * Sq + q0) * D, nrows, tid);
  if (n_tiles > 0) {
    wg::load_tile<kN, D>(kv0, k_bh, min(kN, Sk), tid);
    wg::load_tile<kN, D>(kv0 + kTileBytes, v_bh, min(kN, Sk), tid);
  }
  wg::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kN;
    const uint32_t ks = kv0 + (t & 1) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      const uint32_t kn = kv0 + ((t + 1) & 1) * 2 * kTileBytes;
      const int n = min(kN, Sk - c0 - kN);
      wg::load_tile<kN, D>(kn, k_bh + (size_t)(c0 + kN) * D, n, tid);
      wg::load_tile<kN, D>(kn + kTileBytes, v_bh + (size_t)(c0 + kN) * D, n,
                           tid);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile (and Q) landed
    __syncthreads();

    float s[32] = {};
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<T>(s, wg::desc_k<kM>(qs, kk), wg::desc_k<kN>(ks, kk),
                    kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // masks only on tiles that cross the diagonal or the end of K
    const bool masked =
        c0 + kN > Sk || (causal && c0 + kN - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * (lane & 3) + c;
          float& x = s[4 * j + 2 * i + c];
          x = masked && col > limit[i] ? kNegInf : x * scale2;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t kept = 0xfu;
      if constexpr (kDrop)
        kept = keep_rows(drop, (uint32_t)bh, q0, c0 + 8 * j, warp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          // a masked score is kNegInf: its p is 0 even while the row's
          // max is still kNegInf (exp2(0) would be 1)
          const float p = x == kNegInf ? 0.f : exp2f(x - m[i]);
          l[i] += p;
          x = kDrop ? ((kept >> (2 * i + c)) & 1u ? p * drop.inv_keep : 0.f)
                    : p;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[4 * j + r] *= alpha[r >> 1];
    }
    uint32_t pa[4][4];
    wg::to_frags<T>(s, pa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wg::mma_rs<T, D / 2>(acc, pa[kk], wg::desc_mn<kN>(vs, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // the stage is free for the tile after next
  }
  wg::cp_async_wait<0>();

  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    denom[i] = l[i] == 0.f ? 1.f : l[i];
    const int row = q0 + r_lo + 8 * i;
    if ((lane & 3) == 0 && row < Sq)
      lse[(size_t)bh * Sq + row] =
          l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
  }
  wg::store_rows<T, D / 2>(o + ((size_t)bh * Sq + q0) * D, D, nrows, acc,
                           denom, tid);
}

template <typename T, int D, bool kDrop, bool kRing>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Hk, int Sq, int Sk,
                     int diag, float scale, DropParams drop,
                     cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (!wg::aligned16(q, k, v)) return cudaErrorMisalignedAddress;
  auto fn = kernel<T, D, kDrop, kRing>;
  // set on every launch: a function-local static would be one object
  // across every library that includes this header
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + kM - 1) / kM);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, wg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hk, Sq, Sk, diag, scale, drop);
  return cudaGetLastError();
}

}  // namespace flash_fwd_tc

namespace flash_fwd {

// The forward in the design the wrapper chose from (dtype, D)
// (ops/flash_attention.py's kernel_path, the one statement of the rule):
// tc, the tensor-core kernel, which exists for bf16 and fp16 at D 64 and
// 128 and fails with cudaErrorInvalidValue elsewhere; else the fp32-core
// kernel. Nothing here picks a design in the caller's place.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                   int diag, float scale, DropParams drop, bool tc,
                   cudaStream_t stream) {
  if (!tc)
    return launch_fp32_cores<T, kDrop, kRing>(q, k, v, o, lse, B, H, Hk, Sq,
                                              Sk, D, diag, scale, drop, stream);
  if constexpr (wg::tc_type<T>()) {
    if (D == 64)
      return flash_fwd_tc::launch_d<T, 64, kDrop, kRing>(
          q, k, v, o, lse, B, H, Hk, Sq, Sk, diag, scale, drop, stream);
    if (D == 128)
      return flash_fwd_tc::launch_d<T, 128, kDrop, kRing>(
          q, k, v, o, lse, B, H, Hk, Sq, Sk, diag, scale, drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace flash_fwd

}  // namespace paddle_attn
