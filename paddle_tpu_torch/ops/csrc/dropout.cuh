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

// The keep bits of one 8-key block of a tensor-core score tile whose rows
// are query rows (the m64nN accumulator of wgmma_tile.cuh: lane l of warp
// w holds rows row0 + 16 w + l / 4 and that + 8, keys col0 + 2 (l % 4)
// and that + 1). Bit h = 2 i + c of the result is the element of row i,
// key c, its accumulator register 4 j + h. The four lanes 4 apart that
// hold rows 4 r4 .. 4 r4 + 3 need one word each of the same four Philox
// calls, so each lane makes one call and three shuffles hand the words
// round: no call is repeated. row0 is a multiple of 4.
__device__ __forceinline__ uint32_t keep_rows(const DropParams& dp,
                                              uint32_t bh, int row0,
                                              int col0, int warp, int lane) {
  const int kq = (lane >> 2) & 3;  // the word this lane's rows take
  const int row4 = (row0 >> 2) + 4 * warp + (lane >> 4) + 2 * (kq >> 1);
  const uint4 bits =
      drop_bits(dp, bh, row4, col0 + 2 * (lane & 3) + (kq & 1));
  // call x of the four (x = 2 i + c) is made by the lane with kq == x;
  // from the lane with kq ^ s comes word kq of call kq ^ s
  const uint32_t got[4] = {
      word(bits, kq),
      __shfl_xor_sync(0xffffffffu, word(bits, kq ^ 1), 4),
      __shfl_xor_sync(0xffffffffu, word(bits, kq ^ 2), 8),
      __shfl_xor_sync(0xffffffffu, word(bits, kq ^ 3), 12)};
  uint32_t mask = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int s = kq ^ h;
    const uint32_t w = s == 0 ? got[0] : s == 1 ? got[1]
                                       : s == 2 ? got[2] : got[3];
    mask |= (uint32_t)(w >= dp.thresh) << h;
  }
  return mask;
}

// The same for a transposed tile whose rows are keys and whose columns are
// query rows (the dK/dV kernel's S^T): lane l holds keys key0 and key0 + 8
// and query rows qrow0 + 2 (l % 4) and that + 1 (qrow0 a multiple of 8);
// bit h = 2 i + c is key i, query row c. The lanes l and l ^ 1 share two
// Philox calls (one per key, four consecutive query rows each): each makes
// one and two shuffles swap the halves the other needs.
__device__ __forceinline__ uint32_t keep_cols(const DropParams& dp,
                                              uint32_t bh, int qrow0,
                                              int key0, int lane) {
  const bool odd = lane & 1;
  const uint4 bits = drop_bits(dp, bh, (qrow0 >> 2) + ((lane & 3) >> 1),
                               odd ? key0 + 8 : key0);
  // even lanes take words 0, 1 of both calls, odd lanes words 2, 3
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? bits.x : bits.z, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? bits.y : bits.w, 1);
  const uint32_t w[4] = {odd ? r0 : bits.x, odd ? r1 : bits.y,
                         odd ? bits.z : r0, odd ? bits.w : r1};
  uint32_t mask = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) mask |= (uint32_t)(w[h] >= dp.thresh) << h;
  return mask;
}

}  // namespace paddle_attn
