// Device-side pieces shared by the flat paged attention, the int8 paged
// attentions, the flash attention kernels and the dense-ring (stacked)
// kernels: staging of a K/V tile into shared memory, one warp's
// online-softmax update of R query rows against one staged tile, and the
// walk of those updates over a contiguous row (dtype conversion and warp
// reductions come from numeric.cuh, attention dropout from dropout.cuh).
//
// Layout of the shared-memory operands a kernel hands to tile_update:
//   qs  [R][Dp]        the warp's query rows in fp32, zero past D
//   ks  [kTile][Dp+1]  the tile's keys in fp32 (odd row stride: each lane's
//   vs  [kTile][Dp+1]  dot product reads its own bank), zero past D and n
//   ps  [R][kTile]     the warp's p scratch
// Dp is D rounded up to a multiple of 4, so query rows load as float4.
//
// Rounding follows the TPU kernels: scores, the running max m and the sum
// l are fp32; p is rounded to the value dtype before the PV product while
// l sums the unrounded p; the caller divides by l at the end. An int8
// pool stages its integer values as fp32 (exact) and hands tile_update
// the tile's per-position scales: the score becomes (q . k) * scale *
// k_scale and the PV product takes p * v_scale rounded to the value dtype,
// while l still sums the unscaled p (the TPU kernels' column-wise dequant).
// With attention dropout (the flash forward) the PV product takes p times
// the keep multiplier (dropout.cuh), and l again sums the raw p.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout.cuh"
#include "numeric.cuh"

namespace paddle_attn {

constexpr int kTile = 32;  // KV positions per staged tile, one per lane
constexpr float kNegInf = -1e30f;

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

// Block-wide: rows [0, n) of src (row stride D) into dst (row stride ld) as
// fp32; columns [D, Dp) and rows [n, rows) are zero-filled, so padding
// never carries NaN bit patterns into a product.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int n,
                                           int rows, int D, int Dp, int ld) {
  for (int i = threadIdx.x; i < rows * Dp; i += blockDim.x) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    dst[r * ld + d] = (r < n && d < D) ? to_f(src[(size_t)r * D + d]) : 0.f;
  }
}

// Block-wide: one K/V tile, rows [0, n) of ksrc and vsrc (row stride D,
// the same offsets in both) into ks and vs as stage_rows does. With vec
// (D a multiple of 16 bytes' worth of T, both sources 16-byte aligned) the
// loads are 16-byte vectors issued kBatch at a time per thread, so many
// are in flight at once: a loop of one dependent load per iteration pays
// the memory latency per element, which is what bounds a small tile.
template <typename T>
__device__ __forceinline__ void stage_kv(float* ks, float* vs,
                                         const T* ksrc, const T* vsrc, int n,
                                         int D, int Dp, int ld, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBatch = 4;
  if (!vec) {
    stage_rows(ks, ksrc, n, kTile, D, Dp, ld);
    stage_rows(vs, vsrc, n, kTile, D, Dp, ld);
    return;
  }
  const int per_row = D / kVec;  // here Dp == D
  const int nvec = kTile * per_row;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += blockDim.x * kBatch) {
    uint4 kr[kBatch], vr[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int iv = i0 + j * blockDim.x;
      if (iv < nvec && iv / per_row < n) {
        kr[j] = *reinterpret_cast<const uint4*>(ksrc + (size_t)iv * kVec);
        vr[j] = *reinterpret_cast<const uint4*>(vsrc + (size_t)iv * kVec);
      } else {
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int iv = i0 + j * blockDim.x;
      if (iv < nvec) {
        const int r = iv / per_row;
        float* kd = ks + r * ld + (iv - r * per_row) * kVec;
        float* vd = vs + r * ld + (iv - r * per_row) * kVec;
        const T* ke = reinterpret_cast<const T*>(&kr[j]);
        const T* ve = reinterpret_cast<const T*>(&vr[j]);
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          kd[t] = to_f(ke[t]);
          vd[t] = to_f(ve[t]);
        }
      }
    }
  }
}

// Whether stage_kv may take 16-byte vectors for rows of D elements of T.
template <typename T>
inline int vec_ok(int D, const void* a, const void* b) {
  return D % (16 / (int)sizeof(T)) == 0 &&
         (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
                 16 ==
             0;
}

// One warp: R query rows against one staged tile of n (<= kTile) positions
// whose first global position is c0. Row rr attends position c0 + c iff
// c < n and c0 + c <= limit[rr]; a row with limit[rr] < c0 is left as it
// is. DPL: output dims per lane (D <= 32 * DPL). T is the value dtype p
// is rounded to. With kScaled, ksc and vsc [kTile] are the tile's K and V
// scales (an int8 pool). With kDrop, the rows are rows row0 .. row0 + R - 1
// (row0 and R multiples of 4) of head bh, and drop says which p are kept.
template <typename T, int R, int DPL, bool kScaled = false, bool kDrop = false>
__device__ __forceinline__ void tile_update(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ ps, int D, int Dp,
    int c0, int n, const int (&limit)[R], float scale, float (&m)[R],
    float (&l)[R], float (&acc)[R][DPL], const float* __restrict__ ksc = nullptr,
    const float* __restrict__ vsc = nullptr, const DropParams* drop = nullptr,
    uint32_t bh = 0, int row0 = 0) {
  const int lane = threadIdx.x & 31;
  const int ld = Dp + 1;
  uint4 bits[kDrop ? R / 4 : 1];
  if constexpr (kDrop) {
    static_assert(R % 4 == 0, "dropout draws come four rows at a time");
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      bits[j] = drop_bits(*drop, bh, (row0 >> 2) + j, c0 + lane);
  }
  float s[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
  const float* kr = ks + lane * ld;
  for (int d = 0; d < Dp; d += 4) {
    const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + rr * Dp + d);
      s[rr] = fmaf(qv.x, k0, s[rr]);
      s[rr] = fmaf(qv.y, k1, s[rr]);
      s[rr] = fmaf(qv.z, k2, s[rr]);
      s[rr] = fmaf(qv.w, k3, s[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (limit[rr] < c0) continue;  // uniform across the warp
    const bool valid = lane < n && c0 + lane <= limit[rr];
    float sc = valid ? s[rr] * scale : kNegInf;
    if constexpr (kScaled) sc = valid ? sc * ksc[lane] : kNegInf;
    const float m_new = fmaxf(m[rr], warp_max(sc));
    const float alpha = expf(m[rr] - m_new);
    const float p = valid ? expf(sc - m_new) : 0.f;
    l[rr] = l[rr] * alpha + warp_sum(p);
    m[rr] = m_new;
    float pv = p;
    if constexpr (kScaled) pv = p * vsc[lane];
    if constexpr (kDrop)
      pv = word(bits[rr >> 2], rr & 3) >= drop->thresh ? pv * drop->inv_keep
                                                       : 0.f;
    ps[rr * kTile + lane] = to_f(from_f<T>(pv));
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
  }
  __syncwarp();
  for (int c = 0; c < n; c += 4) {
    float v[4][DPL];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        v[j][i] = d < D ? vs[(c + j) * ld + d] : 0.f;
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      if (limit[rr] < c0) continue;
      const float4 p4 = *reinterpret_cast<const float4*>(ps + rr * kTile + c);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[rr][i];
        a = fmaf(p4.x, v[0][i], a);
        a = fmaf(p4.y, v[1][i], a);
        a = fmaf(p4.z, v[2][i], a);
        a = fmaf(p4.w, v[3][i], a);
        acc[rr][i] = a;
      }
    }
  }
  __syncwarp();
}

// Block-wide: the tile walk over positions [0, last_pos] of one contiguous
// K/V row (a dense ring row: position c at kr + c * D and vr + c * D), 32
// positions at a time: stage the tile (the last one short, so no position
// past last_pos is ever read), then each warp's tile_update of its R query
// rows (qs, ps: the warp's slices). C is the stored dtype, T the value
// dtype p is rounded to. With kScaled, ksr and vsr hold each position's K
// and V scale (an int8 ring), staged into kss and vss beside the tile.
template <typename T, typename C, int R, int DPL, bool kScaled>
__device__ __forceinline__ void walk_row(
    float* ks, float* vs, float* kss, float* vss, const float* qs, float* ps,
    const C* __restrict__ kr, const C* __restrict__ vr,
    const float* __restrict__ ksr, const float* __restrict__ vsr,
    int last_pos, int D, int Dp, int vec, const int (&limit)[R], float scale,
    float (&m)[R], float (&l)[R], float (&acc)[R][DPL]) {
  const int ld = Dp + 1;
  for (int c0 = 0; c0 <= last_pos; c0 += kTile) {
    const int n = min(kTile, last_pos + 1 - c0);
    __syncthreads();  // everyone is done with the previous tile
    stage_kv(ks, vs, kr + (size_t)c0 * D, vr + (size_t)c0 * D, n, D, Dp, ld,
             vec);
    if constexpr (kScaled) {
      if (threadIdx.x < kTile) {
        const int c = threadIdx.x;
        kss[c] = c < n ? ksr[c0 + c] : 0.f;
        vss[c] = c < n ? vsr[c0 + c] : 0.f;
      }
    }
    __syncthreads();
    tile_update<T, R, DPL, kScaled>(qs, ks, vs, ps, D, Dp, c0, n, limit,
                                    scale, m, l, acc, kss, vss);
  }
}

}  // namespace paddle_attn
