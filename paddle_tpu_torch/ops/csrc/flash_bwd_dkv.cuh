// The flash backward's dK/dV half, shared by the flash attention backward
// (flash_attention_bwd_dkv.cu) and the ring attention chunk backward
// (ring_chunk_attention_bwd_dkv.cu). Per key j:
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
// Design: one block per (b, kv head, tile of 8 * KPW keys), so it owns its
// dK/dV rows and needs no atomics: eight warps of KPW keys whose K/V rows
// sit in shared memory as fp32; it walks the heads of the GQA group and,
// for each, the q tiles of 32 rows (one per lane) staged as fp32
// (attention_tile.cuh's stage_kv), recomputing P from lse; a lane owns one
// query row for the scores and dP, then D / 32 output dims for the dV and
// dK sums, which live in registers for the whole walk.
#pragma once

#include "attention_tile.cuh"

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

// The instantiation for D: fewer keys per warp at wider heads, so the
// dK/dV sums stay in registers.
template <typename T, bool kDrop, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Hk, int Sq, int Sk,
                   int D, int diag, float scale, DropParams drop,
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

}  // namespace paddle_attn
