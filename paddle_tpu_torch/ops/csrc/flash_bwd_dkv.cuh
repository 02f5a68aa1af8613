// The flash backward's dK/dV half, shared by the flash attention backward
// (flash_attention_bwd_dkv.cu, replacing paddle_tpu/ops/pallas/
// flash_attention.py:555 and the dK/dV of :470) and the ring attention
// chunk backward (ring_chunk_attention_bwd_dkv.cu, replacing
// ring_chunk_attention.py:299). Per key j:
//   p_ij  = exp(scale * q_i . k_j - lse_i)           (masked: 0)
//   m_ij  = keep_ij / (1 - p)                         (kDrop; else 1)
//   dv_j  = sum_i (p_ij m_ij) dO_i
//   ds_ij = p_ij * ((dO_i . v_j) m_ij - delta_i) * scale
//   dk_j  = sum_i ds_ij q_i
// with p m rounded to dO's dtype and ds to q's before the products, fp32
// sums, and the sum over the query heads of a GQA group taken in the
// block before the one cast to k's dtype.
//
//   q, dout [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k, v    [B, Hk, Sk, D]    q's dtype; Hk divides H
//   lse     [B, H, Sq]        fp32, the forward's (row guard -1e30)
//   delta   [B, H, Sq]        fp32: rowsum(dO * O), less dlse in the ring
//   dk, dv  [B, Hk, Sk, D]    k's dtype
//
// Row i sees key j iff j <= i + offset, the forward's diagonal (kRing and
// diag as in flash_fwd.cuh: the ring step's offset, or the causal flag
// with the offset Sk - Sq); q tiles
// wholly above a key tile are skipped, a key no row sees gets dk = dv = 0,
// and a masked element never evaluates its exp: a row that saw nothing
// has lse = -1e30, where exp(s - lse) would be inf and inf * 0 NaN. The
// keep bits are regenerated from dropout.cuh's hash of (seed, b, h,
// q_pos, k_pos), equal to the forward's.
//
// What bounds it on the card: operations, 8 * D per attended pair (S^T,
// dP^T, dV and dK): at LLaMA-2-7B's [1, 32, 4096, 128] causal 275 GFLOP,
// 0.278 ms at the bf16 peak.
//
// Both designs own a block's dK/dV rows, so no atomics: one block per (b,
// kv head, key tile) walks the heads of the GQA group and their q tiles,
// recomputing P from lse, with the dK/dV sums in registers for the whole
// walk. By (dtype, D):
// - bf16 and fp16 at D 64 and 128: the tensor-core kernel
//   (flash_bwd_dkv_tc below): one warpgroup owns 64 keys, K and V in
//   shared memory, q tiles of 64 rows (Q, dO, lse, delta) double-buffered
//   with cp.async; S^T = K Q^T and dP^T = V dO^T on wgmma, P^T and dS^T
//   in the accumulator's registers, then dV += (P m)^T dO and dK += dS^T Q
//   on wgmma with the register A operand and dO, Q read MN-major (the
//   transposed B operand). Dropout: lanes l and l ^ 1 share two Philox
//   calls and swap halves (dropout.cuh's keep_cols).
// - fp32 and other D: the fp32-core kernel (flash_bwd_dkv::kernel): eight
//   warps of KPW keys whose K/V rows sit in shared memory as fp32, q tiles
//   of 32 rows (one per lane) staged as fp32 (attention_tile.cuh's
//   stage_kv); a lane owns one query row for the scores and dP, then D /
//   32 output dims of the dV and dK sums.
#pragma once

#include "attention_tile.cuh"
#include "wgmma_tile.cuh"

namespace paddle_attn {

namespace flash_bwd_dkv {

constexpr int kWarps = 8;
constexpr int kQRows = kTile;  // query rows per staged tile, one per lane

template <typename T, int DPL, int KPW, bool kDrop, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Hk, int Sq,
           int Sk, int D, int diag, float scale, DropParams drop,
           int vec) {
  constexpr int kKTile = kWarps * KPW;  // keys per block
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* kb = smem;                   // [kKTile][Dp]
  float* vb = kb + kKTile * Dp;       // [kKTile][Dp]
  float* qs = vb + kKTile * Dp;       // [kQRows][Dp + 1]
  float* dos = qs + kQRows * ld;      // [kQRows][Dp + 1]
  float* lse_s = dos + kQRows * ld;   // [kQRows]
  float* dl_s = lse_s + kQRows;       // [kQRows]
  float* pd_s = dl_s + kQRows;        // [kKTile][kQRows]
  float* ds_s = pd_s + kKTile * kQRows;  // [kKTile][kQRows]

  const int n_kt = (Sk + kKTile - 1) / kKTile;
  const int kt = blockIdx.x % n_kt;
  const int bhk = blockIdx.x / n_kt;
  const int b = bhk / Hk;
  const int hk = bhk % Hk;
  const int group = H / Hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = kt * kKTile;
  const int nk = min(kKTile, Sk - k0);
  const bool causal = kRing || diag;
  const int offset = kRing ? diag : Sk - Sq;
  const int key0 = k0 + warp * KPW;  // the warp's first key

  const size_t kv_off = ((size_t)bhk * Sk + k0) * D;
  stage_rows(kb, k + kv_off, nk, kKTile, D, Dp, Dp);
  stage_rows(vb, v + kv_off, nk, kKTile, D, Dp, Dp);

  float acc_k[KPW][DPL], acc_v[KPW][DPL];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_k[kk][i] = acc_v[kk][i] = 0.f;
  }

  const float* kb_w = kb + warp * KPW * Dp;
  const float* vb_w = vb + warp * KPW * Dp;
  float* pd_w = pd_s + warp * KPW * kQRows;
  float* ds_w = ds_s + warp * KPW * kQRows;
  // the first row that sees the tile's first key
  const int first = causal ? max(0, k0 - offset) : 0;
  for (int g = 0; g < group; ++g) {
    const int bh = b * H + hk * group + g;
    const T* q_bh = q + (size_t)bh * Sq * D;
    const T* do_bh = dout + (size_t)bh * Sq * D;
    for (int r0 = first / kQRows * kQRows; r0 < Sq; r0 += kQRows) {
      const int nr = min(kQRows, Sq - r0);
      __syncthreads();  // everyone is done with the previous q tile
      stage_kv(qs, dos, q_bh + (size_t)r0 * D, do_bh + (size_t)r0 * D, nr, D,
               Dp, ld, vec);
      if (threadIdx.x < kQRows) {
        const int r = threadIdx.x;
        lse_s[r] = r < nr ? lse[(size_t)bh * Sq + r0 + r] : 0.f;
        dl_s[r] = r < nr ? delta[(size_t)bh * Sq + r0 + r] : 0.f;
      }
      __syncthreads();
      // s = q . k and dp = dO . v for row r0 + lane, the warp's keys
      float s[KPW], dp[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) s[kk] = dp[kk] = 0.f;
      const float* qr = qs + lane * ld;
      const float* dr = dos + lane * ld;
      for (int d = 0; d < Dp; d += 4) {
        const float q0 = qr[d], q1 = qr[d + 1], q2 = qr[d + 2], q3 = qr[d + 3];
        const float o0 = dr[d], o1 = dr[d + 1], o2 = dr[d + 2], o3 = dr[d + 3];
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kb_w + kk * Dp + d);
          const float4 vv =
              *reinterpret_cast<const float4*>(vb_w + kk * Dp + d);
          s[kk] = fmaf(q3, kv.w, fmaf(q2, kv.z, fmaf(q1, kv.y,
                                                     fmaf(q0, kv.x, s[kk]))));
          dp[kk] = fmaf(o3, vv.w, fmaf(o2, vv.z, fmaf(o1, vv.y,
                                                      fmaf(o0, vv.x, dp[kk]))));
        }
      }
      const int row = r0 + lane;
      const float lse_r = lse_s[lane];
      const float dl = dl_s[lane];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        const int key = key0 + kk;
        const bool valid = lane < nr && key < Sk &&
                           (!causal || key <= row + offset);
        float pd = 0.f, ds = 0.f;
        if (valid) {
          const float p = expf(s[kk] * scale - lse_r);
          float dpv = dp[kk];
          pd = p;
          if constexpr (kDrop) {
            const bool kept = keep(drop, (uint32_t)bh, row, key);
            pd = kept ? p * drop.inv_keep : 0.f;
            dpv = kept ? dpv * drop.inv_keep : 0.f;
          }
          ds = p * (dpv - dl) * scale;
        }
        pd_w[kk * kQRows + lane] = to_f(from_f<T>(pd));
        ds_w[kk * kQRows + lane] = to_f(from_f<T>(ds));
      }
      __syncwarp();
      // dv += (P m)^T dO and dk += dS^T Q: a lane owns dims lane + 32 i
      for (int r = 0; r < nr; r += 4) {
        float ov[4][DPL], qv[4][DPL];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            ov[j][i] = d < D ? dos[(r + j) * ld + d] : 0.f;
            qv[j][i] = d < D ? qs[(r + j) * ld + d] : 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pd_w + kk * kQRows + r);
          const float4 d4 =
              *reinterpret_cast<const float4*>(ds_w + kk * kQRows + r);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            float av = acc_v[kk][i], ak = acc_k[kk][i];
            av = fmaf(p4.x, ov[0][i], av);
            av = fmaf(p4.y, ov[1][i], av);
            av = fmaf(p4.z, ov[2][i], av);
            av = fmaf(p4.w, ov[3][i], av);
            ak = fmaf(d4.x, qv[0][i], ak);
            ak = fmaf(d4.y, qv[1][i], ak);
            ak = fmaf(d4.z, qv[2][i], ak);
            ak = fmaf(d4.w, qv[3][i], ak);
            acc_v[kk][i] = av;
            acc_k[kk][i] = ak;
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int key = key0 + kk;
    if (key >= Sk) continue;
    const size_t off = ((size_t)bhk * Sk + key) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[off + d] = from_f<T>(acc_k[kk][i]);
        dv[off + d] = from_f<T>(acc_v[kk][i]);
      }
    }
  }
}

template <typename T, int DPL, int KPW, bool kDrop, bool kRing>
cudaError_t launch_kpw(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Hk, int Sq, int Sk, int D, int diag, float scale,
                       DropParams drop, cudaStream_t stream) {
  constexpr int kKTile = kWarps * KPW;
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kKTile * Dp + 2 * kQRows * (Dp + 1) +
                               2 * kQRows + 2 * kKTile * kQRows) *
                      sizeof(float);
  auto fn = kernel<T, DPL, KPW, kDrop, kRing>;
  // set on every launch, as the forward does: a function-local static
  // here would be one object across every library that includes this
  // header (GCC makes a template's statics process-wide unique), and a
  // second library's kernel would launch without the attribute
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)B * Hk * ((Sk + kKTile - 1) / kKTile);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hk, Sq, Sk, D, diag,
      scale, drop, vec_ok<T>(D, q, dout));
  return cudaGetLastError();
}

// The fp32-core instantiation for D: fewer keys per warp at wider heads,
// so the dK/dV sums stay in registers.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch_fp32_cores(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Hk, int Sq, int Sk, int D, int diag,
                              float scale, DropParams drop,
                              cudaStream_t stream) {
#define PADDLE_DKV_LAUNCH(DPL, KPW)                                        \
  launch_kpw<T, DPL, KPW, kDrop, kRing>(q, k, v, dout, lse, delta, dk, dv, \
                                        B, H, Hk, Sq, Sk, D, diag, scale,  \
                                        drop, stream)
  if (D <= 32) return PADDLE_DKV_LAUNCH(1, 8);
  if (D <= 64) return PADDLE_DKV_LAUNCH(2, 8);
  if (D <= 128) return PADDLE_DKV_LAUNCH(4, 4);
  return PADDLE_DKV_LAUNCH(8, 2);
#undef PADDLE_DKV_LAUNCH
}

}  // namespace flash_bwd_dkv

// The tensor-core dK/dV (bf16 / fp16 at D = 64 and 128): one warpgroup a
// block owns 64 keys of one kv head, its K and V in shared memory and its
// dK and dV sums in registers for the whole walk over the heads of the
// GQA group and their q tiles of 64 rows, which are double-buffered with
// cp.async (Q, dO, lse and delta). Per q tile: S^T = K Q^T and dP^T =
// V dO^T on wgmma from shared memory, P^T from lse in base 2 and dS^T in
// the accumulator's registers, then dV += (P m)^T dO and dK += dS^T Q on
// wgmma with the register A operand and dO, Q read MN-major.
namespace flash_bwd_dkv_tc {

constexpr int kN = 64;  // keys a block
constexpr int kM = 64;  // query rows a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  // K, V; two stages of Q and dO; two stages of lse and delta; alignment
  return (2 * kN + 4 * kM) * D * 2 + 2 * 2 * kM * 4 + 1024;
}

template <typename T, int D, bool kDrop, bool kRing>
__global__ void __launch_bounds__(wg::kThreads)
    kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Hk, int Sq,
           int Sk, int diag, float scale, DropParams drop) {
  constexpr int kTileBytes = kM * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;
  const uint32_t vs = ks + kN * D * 2;
  const uint32_t qd0 = vs + kN * D * 2;  // stage s: Q, dO at qd0 + 2 s tile
  const uint32_t rows0 = qd0 + 4 * kTileBytes;  // stage s: lse, delta
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (rows0 - raw));

  const int n_kt = (Sk + kN - 1) / kN;
  const int kt = blockIdx.x % n_kt;
  const int bhk = blockIdx.x / n_kt;
  const int b = bhk / Hk;
  const int hk = bhk % Hk;
  const int group = H / Hk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = kt * kN;
  const int nk = min(kN, Sk - k0);
  const bool causal = kRing || diag;
  const int offset = kRing ? diag : Sk - Sq;
  const int kr_lo = 16 * warp + (lane >> 2);  // keys k0 + kr_lo (+ 8)

  // q tiles from the one holding the first row that sees key k0
  const int first = causal ? max(0, k0 - offset) : 0;
  const int n_qt = (Sq + kM - 1) / kM;
  const int qt_first = first / kM;
  const int per_head = first >= Sq ? 0 : n_qt - qt_first;
  const int n_it = group * per_head;

  const size_t kv_off = ((size_t)bhk * Sk + k0) * D;
  wg::load_tile<kN, D>(ks, k + kv_off, nk, tid);
  wg::load_tile<kN, D>(vs, v + kv_off, nk, tid);
  // iteration it: head hk * group + it / per_head, q tile qt_first +
  // it % per_head, into stage it & 1
  auto load_q = [&](int it) {
    const int st = it & 1;
    const int bh = b * H + hk * group + it / per_head;
    const int r0 = (qt_first + it % per_head) * kM;
    const int nr = min(kM, Sq - r0);
    const size_t off = ((size_t)bh * Sq + r0) * D;
    const uint32_t qst = qd0 + st * 2 * kTileBytes;
    wg::load_tile<kM, D>(qst, q + off, nr, tid);
    wg::load_tile<kM, D>(qst + kTileBytes, dout + off, nr, tid);
    const uint32_t rst = rows0 + st * 2 * kM * 4;
    wg::load_row_values<kM>(rst, lse + (size_t)bh * Sq + r0, nr, tid);
    wg::load_row_values<kM>(rst + kM * 4, delta + (size_t)bh * Sq + r0, nr,
                            tid);
  };
  if (n_it > 0) load_q(0);
  wg::cp_async_commit();

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int bh = b * H + hk * group + it / per_head;
    const int r0 = (qt_first + it % per_head) * kM;
    const uint32_t qst = qd0 + st * 2 * kTileBytes;
    const uint32_t dost = qst + kTileBytes;
    const float* lse_s = rows_s + st * 2 * kM;
    const float* dl_s = lse_s + kM;
    if (it + 1 < n_it) load_q(it + 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    __syncthreads();

    float s[32] = {}, dp[32] = {};
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<T>(s, wg::desc_k<kN>(ks, kk), wg::desc_k<kM>(qst, kk),
                    kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<T>(dp, wg::desc_k<kN>(vs, kk), wg::desc_k<kM>(dost, kk),
                    kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    const bool masked = k0 + kN > Sk || r0 + kM > Sq ||
                        (causal && k0 + kN - 1 > r0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cq = 8 * j + 2 * (lane & 3);  // the tile's query column
      uint32_t kept = 0xfu;
      if constexpr (kDrop)
        kept = keep_cols(drop, (uint32_t)bh, r0 + 8 * j, k0 + kr_lo, lane);
      const float2 lv = *reinterpret_cast<const float2*>(lse_s + cq);
      const float2 dv2 = *reinterpret_cast<const float2*>(dl_s + cq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          const int key = k0 + kr_lo + 8 * i;
          const int row = r0 + cq + c;
          const bool valid = !masked || (key < Sk && row < Sq &&
                                         (!causal || key <= row + offset));
          // a masked element never takes exp2(s - lse): at lse = -1e30
          // it would be inf
          const float p =
              valid ? exp2f(s[r] * scale2 - (c ? lv.y : lv.x) * kLog2e)
                    : 0.f;
          float dpv = dp[r], pd = p;
          if constexpr (kDrop) {
            const bool kd = (kept >> (2 * i + c)) & 1u;
            pd = kd ? p * drop.inv_keep : 0.f;
            dpv = kd ? dpv * drop.inv_keep : 0.f;
          }
          s[r] = pd;
          dp[r] = p * (dpv - (c ? dv2.y : dv2.x)) * scale;
        }
      }
    }
    uint32_t pa[4][4], da[4][4];
    wg::to_frags<T>(s, pa);
    wg::to_frags<T>(dp, da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wg::mma_rs<T, D / 2>(acc_v, pa[kk], wg::desc_mn<kM>(dost, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wg::mma_rs<T, D / 2>(acc_k, da[kk], wg::desc_mn<kM>(qst, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc_v);
    wg::fence_regs(acc_k);
    __syncthreads();  // the stage is free for the tile after next
  }
  wg::cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  wg::store_rows<T, D / 2>(dk + kv_off, D, nk, acc_k, one, tid);
  wg::store_rows<T, D / 2>(dv + kv_off, D, nk, acc_v, one, tid);
}

template <typename T, int D, bool kDrop, bool kRing>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int H, int Hk, int Sq,
                     int Sk, int diag, float scale, DropParams drop,
                     cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (!wg::aligned16(q, k, v, dout)) return cudaErrorMisalignedAddress;
  auto fn = kernel<T, D, kDrop, kRing>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * Hk * ((Sk + kN - 1) / kN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, wg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hk, Sq, Sk, diag, scale,
      drop);
  return cudaGetLastError();
}

}  // namespace flash_bwd_dkv_tc

namespace flash_bwd_dkv {

// The dK/dV kernel in the design the wrapper chose from (dtype, D)
// (ops/flash_attention.py's kernel_path, the one statement of the rule):
// tc, the tensor-core kernel, which exists for bf16 and fp16 at D 64 and
// 128 and fails with cudaErrorInvalidValue elsewhere; else the fp32-core
// kernel. Nothing here picks a design in the caller's place.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Hk, int Sq, int Sk,
                   int D, int diag, float scale, DropParams drop, bool tc,
                   cudaStream_t stream) {
  if (!tc)
    return launch_fp32_cores<T, kDrop, kRing>(q, k, v, dout, lse, delta, dk, dv,
                                              B, H, Hk, Sq, Sk, D, diag, scale,
                                              drop, stream);
  if constexpr (wg::tc_type<T>()) {
    if (D == 64)
      return flash_bwd_dkv_tc::launch_d<T, 64, kDrop, kRing>(
          q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq, Sk, diag, scale,
          drop, stream);
    if (D == 128)
      return flash_bwd_dkv_tc::launch_d<T, 128, kDrop, kRing>(
          q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq, Sk, diag, scale,
          drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace flash_bwd_dkv

}  // namespace paddle_attn
