// The flash backward's dQ half, shared by the flash attention backward
// (flash_attention_bwd_dq.cu, replacing paddle_tpu/ops/pallas/
// flash_attention.py:589 and the dQ of :470) and the ring attention chunk
// backward (ring_chunk_attention_bwd_dq.cu, replacing
// ring_chunk_attention.py:321). Per query row i:
//   p_ij  = exp(scale * q_i . k_j - lse_i)           (masked: 0)
//   dp_ij = (dO_i . v_j) * keep_ij / (1 - p)          (kDrop; else 1)
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i  = sum_j ds_ij k_j
// with ds rounded to k's dtype before the product and fp32 sums.
//
//   q, dout [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k, v    [B, Hk, Sk, D]    q's dtype; head h reads h / (H/Hk)
//   lse     [B, H, Sq]        fp32, the forward's (row guard -1e30)
//   delta   [B, H, Sq]        fp32: rowsum(dO * O), less dlse in the ring
//   dq      [B, H, Sq, D]     q's dtype
//
// Row i sees key j iff j <= i + offset, the forward's diagonal (kRing and
// diag as in flash_fwd.cuh: the ring step's offset, or the causal flag
// with the offset Sk - Sq); key tiles
// past a q tile's last seen key are skipped, a row that sees no key gets
// ds = 0, so dq = 0, and a masked element never evaluates its exp (with
// lse = -1e30 it would be inf, and inf * 0 NaN). The keep bits are
// regenerated from dropout.cuh's hash, equal to the forward's.
//
// What bounds it on the card: operations, 6 * D per attended pair (S, dP
// and dQ): at LLaMA-2-7B's [1, 32, 4096, 128] causal 206 GFLOP, 0.2085 ms
// at the bf16 peak.
//
// Both designs: one block per (b, h, 64-row q tile) walks the key tiles
// up to its last seen key, the dQ sums in registers. By (dtype, D):
// - bf16 and fp16 at D 64 and 128: the tensor-core kernel
//   (flash_bwd_dq_tc below): one warpgroup, Q and dO resident in shared
//   memory, K/V tiles of 64 keys double-buffered with cp.async; S = Q K^T
//   and dP = dO V^T on wgmma, dS in the accumulator's registers, then dQ
//   += dS K on wgmma with dS as the register A operand and K read
//   MN-major. Dropout as the forward's (keep_rows).
// - fp32 and other D: the fp32-core kernel (flash_bwd_dq::kernel): eight
//   warps of eight rows; K/V tiles of 32 keys staged as fp32
//   (attention_tile.cuh's stage_kv); a lane owns one key of the tile for
//   the scores and dP, then D / 32 output dims for the ds K product.
#pragma once

#include "attention_tile.cuh"
#include "wgmma_tile.cuh"

namespace paddle_attn {

namespace flash_bwd_dq {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // 64 query rows per block

template <typename T, int DPL, bool kDrop, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int H, int Hk, int Sq, int Sk, int D,
           int diag, float scale, DropParams drop, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                 // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;      // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;      // [kQTile][Dp]
  float* dos = qs + kQTile * Dp;    // [kQTile][Dp]
  float* ds_s = dos + kQTile * Dp;  // [kQTile][kTile]

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
  const int row0 = q0 + warp * kRowsPerWarp;

  const size_t q_off = ((size_t)bh * Sq + q0) * D;
  const T* k_bh = k + ((size_t)b * Hk + hk) * Sk * D;
  const T* v_bh = v + ((size_t)b * Hk + hk) * Sk * D;
  stage_rows(qs, q + q_off, nrows, kQTile, D, Dp, Dp);
  stage_rows(dos, dout + q_off, nrows, kQTile, D, Dp, Dp);

  int limit[kRowsPerWarp];
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
    // the last key this row sees; -1 for rows past Sq (and below -1 for a
    // row the offset masks whole)
    limit[rr] = row < Sq ? (causal ? min(row + offset, Sk - 1) : Sk - 1)
                         : -1;
    lse_r[rr] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    delta_r[rr] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  float* ds_w = ds_s + warp * kRowsPerWarp * kTile;
  const float* qs_w = qs + warp * kRowsPerWarp * Dp;
  const float* dos_w = dos + warp * kRowsPerWarp * Dp;
  // tiles past the block's last seen key are skipped
  const int last = causal ? min(q0 + nrows - 1 + offset, Sk - 1) : Sk - 1;
  for (int c0 = 0; c0 <= last; c0 += kTile) {
    const int n = min(kTile, Sk - c0);
    __syncthreads();  // everyone is done with the previous tile
    stage_kv(ks, vs, k_bh + (size_t)c0 * D, v_bh + (size_t)c0 * D, n, D, Dp,
             ld, vec);
    __syncthreads();
    // s = q . k and dp = dO . v for key c0 + lane, the warp's eight rows
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = dp[rr] = 0.f;
    const float* kr = ks + lane * ld;
    const float* vr = vs + lane * ld;
    for (int d = 0; d < Dp; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
      const float v0 = vr[d], v1 = vr[d + 1], v2 = vr[d + 2], v3 = vr[d + 3];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qs_w + rr * Dp + d);
        const float4 ov =
            *reinterpret_cast<const float4*>(dos_w + rr * Dp + d);
        s[rr] = fmaf(qv.w, k3, fmaf(qv.z, k2, fmaf(qv.y, k1,
                                                   fmaf(qv.x, k0, s[rr]))));
        dp[rr] = fmaf(ov.w, v3, fmaf(ov.z, v2, fmaf(ov.y, v1,
                                                    fmaf(ov.x, v0, dp[rr]))));
      }
    }
    uint4 bits[kDrop ? kRowsPerWarp / 4 : 1];
    if constexpr (kDrop) {
#pragma unroll
      for (int j = 0; j < kRowsPerWarp / 4; ++j)
        bits[j] = drop_bits(drop, (uint32_t)bh, (row0 >> 2) + j, c0 + lane);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool valid = lane < n && c0 + lane <= limit[rr];
      float ds = 0.f;
      if (valid) {
        const float p = expf(s[rr] * scale - lse_r[rr]);
        float dpv = dp[rr];
        if constexpr (kDrop)
          dpv = word(bits[rr >> 2], rr & 3) >= drop.thresh
                    ? dpv * drop.inv_keep
                    : 0.f;
        ds = p * (dpv - delta_r[rr]) * scale;
      }
      ds_w[rr * kTile + lane] = to_f(from_f<T>(ds));
    }
    __syncwarp();
    // dq += ds K: a lane owns output dims lane + 32 i
    for (int c = 0; c < n; c += 4) {
      float kv[4][DPL];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          kv[j][i] = d < D ? ks[(c + j) * ld + d] : 0.f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (limit[rr] < c0) continue;  // uniform across the warp
        const float4 d4 =
            *reinterpret_cast<const float4*>(ds_w + rr * kTile + c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[rr][i];
          a = fmaf(d4.x, kv[0][i], a);
          a = fmaf(d4.y, kv[1][i], a);
          a = fmaf(d4.z, kv[2][i], a);
          a = fmaf(d4.w, kv[3][i], a);
          acc[rr][i] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
    if (row >= Sq) continue;
    T* dq_r = dq + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq_r[d] = from_f<T>(acc[rr][i]);
    }
  }
}

template <typename T, int DPL, bool kDrop, bool kRing>
cudaError_t launch_dpl(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int H, int Hk,
                       int Sq, int Sk, int D, int diag, float scale,
                       DropParams drop, cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem =
      (size_t)(2 * kTile * (Dp + 1) + 2 * kQTile * Dp + kQTile * kTile) *
      sizeof(float);
  auto fn = kernel<T, DPL, kDrop, kRing>;
  // set on every launch, as the forward does: a function-local static
  // here would be one object across every library that includes this
  // header (GCC makes a template's statics process-wide unique), and a
  // second library's kernel would launch without the attribute
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)B * H * ((Sq + kQTile - 1) / kQTile);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Hk, Sq, Sk, D, diag, scale, drop,
      vec_ok<T>(D, k, v));
  return cudaGetLastError();
}

// The fp32-core instantiation for D: DPL = D / 32 rounded up to a power of
// two.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch_fp32_cores(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Hk, int Sq, int Sk, int D, int diag,
                              float scale, DropParams drop,
                              cudaStream_t stream) {
#define PADDLE_DQ_LAUNCH(DPL)                                             \
  launch_dpl<T, DPL, kDrop, kRing>(q, k, v, dout, lse, delta, dq, B, H, Hk, \
                                   Sq, Sk, D, diag, scale, drop, stream)
  if (D <= 32) return PADDLE_DQ_LAUNCH(1);
  if (D <= 64) return PADDLE_DQ_LAUNCH(2);
  if (D <= 128) return PADDLE_DQ_LAUNCH(4);
  return PADDLE_DQ_LAUNCH(8);
#undef PADDLE_DQ_LAUNCH
}

}  // namespace flash_bwd_dq

// The tensor-core dQ (bf16 / fp16 at D = 64 and 128): one warpgroup a
// block owns 64 query rows of one head, Q and dO resident in shared
// memory; K/V tiles of 64 keys double-buffered with cp.async; S = Q K^T
// and dP = dO V^T on wgmma from shared memory, P from lse in base 2, dS
// in the accumulator's registers, dQ += dS K on wgmma with dS as the
// register A operand and K read MN-major.
namespace flash_bwd_dq_tc {

constexpr int kM = 64;  // query rows a block
constexpr int kN = 64;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  return (2 * kM + 4 * kN) * D * 2 + 1024;  // Q, dO, two stages of K and V
}

template <typename T, int D, bool kDrop, bool kRing>
__global__ void __launch_bounds__(wg::kThreads)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int H, int Hk, int Sq, int Sk, int diag,
           float scale, DropParams drop) {
  constexpr int kTileBytes = kN * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + kM * D * 2;
  const uint32_t kv0 = dos + kM * D * 2;  // stage s: K at kv0 + 2 s tile

  const int n_qt = (Sq + kM - 1) / kM;
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

  const int r_lo = 16 * warp + (lane >> 2);
  int limit[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    // -1 for rows past Sq: every key masked
    limit[i] = row >= Sq ? -1
                         : causal ? min(row + offset, Sk - 1) : Sk - 1;
    lse2[i] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    dl[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  const int last = causal ? min(q0 + nrows - 1 + offset, Sk - 1) : Sk - 1;
  const int n_tiles = last < 0 ? 0 : last / kN + 1;

  const size_t q_off = ((size_t)bh * Sq + q0) * D;
  wg::load_tile<kM, D>(qs, q + q_off, nrows, tid);
  wg::load_tile<kM, D>(dos, dout + q_off, nrows, tid);
  if (n_tiles > 0) {
    wg::load_tile<kN, D>(kv0, k_bh, min(kN, Sk), tid);
    wg::load_tile<kN, D>(kv0 + kTileBytes, v_bh, min(kN, Sk), tid);
  }
  wg::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kN;
    const uint32_t ks = kv0 + (t & 1) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    if (t + 1 < n_tiles) {
      const uint32_t kn = kv0 + ((t + 1) & 1) * 2 * kTileBytes;
      const int n = min(kN, Sk - c0 - kN);
      wg::load_tile<kN, D>(kn, k_bh + (size_t)(c0 + kN) * D, n, tid);
      wg::load_tile<kN, D>(kn + kTileBytes, v_bh + (size_t)(c0 + kN) * D, n,
                           tid);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    __syncthreads();

    float s[32] = {}, dp[32] = {};
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<T>(s, wg::desc_k<kM>(qs, kk), wg::desc_k<kN>(ks, kk),
                    kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<T>(dp, wg::desc_k<kM>(dos, kk), wg::desc_k<kN>(vs, kk),
                    kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    const bool masked = c0 + kN > Sk || q0 + kM > Sq ||
                        (causal && c0 + kN - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t kept = 0xfu;
      if constexpr (kDrop)
        kept = keep_rows(drop, (uint32_t)bh, q0, c0 + 8 * j, warp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          const int col = c0 + 8 * j + 2 * (lane & 3) + c;
          // a masked element never takes exp2(s - lse): at lse = -1e30
          // it would be inf
          const float p =
              masked && col > limit[i] ? 0.f : exp2f(s[r] * scale2 - lse2[i]);
          float dpv = dp[r];
          if constexpr (kDrop)
            dpv = (kept >> (2 * i + c)) & 1u ? dpv * drop.inv_keep : 0.f;
          s[r] = p * (dpv - dl[i]) * scale;
        }
      }
    }
    uint32_t da[4][4];
    wg::to_frags<T>(s, da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wg::mma_rs<T, D / 2>(acc, da[kk], wg::desc_mn<kN>(ks, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    __syncthreads();
  }
  wg::cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  wg::store_rows<T, D / 2>(dq + q_off, D, nrows, acc, one, tid);
}

template <typename T, int D, bool kDrop, bool kRing>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int B, int H, int Hk, int Sq, int Sk,
                     int diag, float scale, DropParams drop,
                     cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (!wg::aligned16(q, k, v, dout)) return cudaErrorMisalignedAddress;
  auto fn = kernel<T, D, kDrop, kRing>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + kM - 1) / kM);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, wg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Hk, Sq, Sk, diag, scale, drop);
  return cudaGetLastError();
}

}  // namespace flash_bwd_dq_tc

namespace flash_bwd_dq {

// The dQ kernel in the design the wrapper chose from (dtype, D)
// (ops/flash_attention.py's kernel_path, the one statement of the rule):
// tc, the tensor-core kernel, which exists for bf16 and fp16 at D 64 and
// 128 and fails with cudaErrorInvalidValue elsewhere; else the fp32-core
// kernel. Nothing here picks a design in the caller's place.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Hk, int Sq, int Sk, int D,
                   int diag, float scale, DropParams drop, bool tc,
                   cudaStream_t stream) {
  if (!tc)
    return launch_fp32_cores<T, kDrop, kRing>(q, k, v, dout, lse, delta, dq, B,
                                              H, Hk, Sq, Sk, D, diag, scale,
                                              drop, stream);
  if constexpr (wg::tc_type<T>()) {
    if (D == 64)
      return flash_bwd_dq_tc::launch_d<T, 64, kDrop, kRing>(
          q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Sk, diag, scale, drop,
          stream);
    if (D == 128)
      return flash_bwd_dq_tc::launch_d<T, 128, kDrop, kRing>(
          q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Sk, diag, scale, drop,
          stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace flash_bwd_dq

}  // namespace paddle_attn
