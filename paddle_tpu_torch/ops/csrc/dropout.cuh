// Attention dropout's keep mask, shared by the flash attention forward and
// both backward kernels: a counter-based hash, so every kernel regenerates
// the same bits from the seed whatever its tiling, and the mask is never
// stored (the TPU kernels' design: the residual is the seed,
// paddle_tpu/ops/pallas/flash_attention.py::_drop_tile).
//
// The draw for element (b, h, q_pos, k_pos) of a [B, H, Sq, Sk] score
// matrix is word (q_pos & 3) of Philox4x32-10 (Salmon et al., SC'11) with
// key (seed low 32 bits, seed high 32 bits) and counter (k_pos, q_pos >> 2,
// b * H + h, 0); the element is kept iff the draw is >= thresh (=
// floor(p * 2^32)), and a kept value is scaled by inv_keep = 1 / (1 - p).
// One hash call gives the draws of four consecutive query rows at one key.
// ops/flash_attention.py::dropout_keep computes the same bits with torch
// integer ops.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace paddle_attn {

struct DropParams {
  uint32_t k0, k1;   // the seed's low and high words
  uint32_t thresh;   // keep iff the draw >= thresh
  float inv_keep;    // 1 / (1 - p), rounded to fp32
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// The draws of query rows 4 * row4 .. 4 * row4 + 3 at key column col of
// head bh (= b * H + h).
__device__ __forceinline__ uint4 drop_bits(const DropParams& dp,
                                           uint32_t bh, int row4, int col) {
  return philox4x32_10(
      make_uint4((uint32_t)col, (uint32_t)row4, bh, 0u), dp.k0, dp.k1);
}

__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The keep draw of one element.
__device__ __forceinline__ bool keep(const DropParams& dp, uint32_t bh,
                                     int row, int col) {
  return word(drop_bits(dp, bh, row >> 2, col), row & 3) >= dp.thresh;
}

}  // namespace paddle_attn
