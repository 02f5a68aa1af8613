// Split-KV flash-decoding for Hopper (sm_90a), bf16 and fp16 queries: the
// device code of the "split_kv" design of five kernels, decode_attention_
// paged.cu (a paged pool in the query's dtype), decode_attention_paged_i8.cu
// (an int8 pool with per-position fp32 scales), and three contiguous caches
// read as a pool of B blocks of Smax positions with no table (row b's block
// is b): decode_attention_stacked.cu (the fp dense ring),
// decode_attention_stacked_i8.cu (the int8 dense ring) and
// decode_attention_bhsd.cu (the one-layer cache, its K and V two tensors).
// A launch takes the K and V planes it reads as two bases (and the int8
// flavor's two scale planes): a layer of a pool or ring, or the two tensors.
// The same kernel has a write mode (kNew) for the fused write+attend of one
// new token a row over the dense rings, decode_attention_stacked_write.cu
// and decode_attention_stacked_i8_write.cu: see "The write mode" below; and
// a flat mode (kFlat) for the flat budget's ragged query stream over the
// fp pool and the int8 pool, decode_attention_paged_flat.cu and
// decode_attention_paged_flat_i8.cu: see "The flat mode".
//
// The work of one (row b, KV head hk) is split along the KV length into S
// ranges of `span` positions; the grid is (B * Hk, S), S chosen by the
// wrapper from the shapes and the SM count alone, so the launch reads
// nothing back from the card (CUDA-graph capturable). The fp pool cuts its
// ranges at table blocks (span = cb * Bt), the others at 64-position
// tiles. A block whose range lies wholly past its row's last attendable
// position writes an empty partial (m = -1e30, l = 0) and exits.
//
// A block holds all R = G * Sq query rows of its KV head (G = H / Hk), so
// each KV position is read once per GQA group. K and V tiles of 64
// positions are staged through a ring of stages by cp.async copies (every
// thread issues 8-32 of them a tile, all in flight together), each position
// resolved through the block table (or, with none, in the row's block);
// positions past the range are zero-filled. The fp flavor stages the stored
// dtype in 16-byte chunks (dims past D zero-filled). The int8 flavor stages
// the int8 rows in 16-byte chunks (8 where D is not a multiple of 16) and
// each position's K and V scale by a 4-byte copy beside them (any Bt), in
// more stages than the fp flavor (the tile is half the bytes); after the
// wait each warp converts its own 16 positions of the stage into a K and a
// V tile in the query dtype (exact: |int8| < 2^8) and fences them with
// __syncwarp (or a named barrier over the warps that share those
// positions), so both flavors read the same tile layout. The products run on the tensor cores: mma.sync
// m16n8k16 with fp32 sums, Q K^T with the 16-row query groups as A
// fragments held in registers and K read by ldmatrix, P V with P's
// accumulator turned into A fragments in place (rounded to the value
// dtype) and V read by ldmatrix.trans. Rows are padded to 16 per group (an
// Sq = 1 decode uses one row of each mma; the card's bytes, not its
// products, bound it). The int8 flavor multiplies each score column by its
// K scale after Q K^T and p by its V scale before p is rounded, as the TPU
// kernel does; K and V themselves are never rescaled.
//
// The four warps split a tile between them as WP position slices x (4 / WP)
// row groups: WP = 4 when R <= 16 (decode: each warp takes its own 16
// positions of every tile), 2 when R <= 32, else 1 (each warp a 16-row
// group over the whole tile, in passes over the KV range when R > 64).
// Warps that share a row group keep their own fp32 online softmax (m, l and
// the [16, D] accumulator) and merge through shared memory at the end. With
// S = 1 the block writes the normalised output; otherwise (o unnormalised,
// m, l) go to an fp32 workspace, and merge_kernel combines the S partials
// of each query row in split order (deterministic), an all-empty row
// giving 0.
//
// The write mode (kNew; Sq = 1, the new token's K and V rows in `NewRow`,
// T or, for the int8 flavor, fp32). The ranges are exclusive: range s
// covers positions [s * span, min((s + 1) * span, lens[b])), the prefix
// below the new token, so the cp.async loads zero-fill every position at or
// past lens[b] and no block of the launch ever loads position lens[b]. One
// designated block per (row, KV head), range 0 (which every row has):
// - stores the new K/V row at position lens[b] of the planes, in place,
//   exactly once (the int8 flavor quantizes it first by the engine's absmax
//   recipe: s = amax / 127 in fp32, values rint(r / max(s, 1e-8)) clipped
//   to +-127, a true division; the row and its two scales), unless the row
//   is full (lens[b] == Smax: the write is dropped). No load of the launch
//   reads that position, so the store races no read. Warps 0 and 1 do it
//   first, and stage the two rows as fp32 in Cfg::kNewBytes of shared
//   memory past the ring;
// - seeds its query rows' online softmax with the new column before its
//   walk, in the TPU kernel's order: m = q . k_new * scale (int8: (q .
//   k_int) * scale * k_scale), l = 1, acc = v_new (int8: round_T(v_scale)
//   * v_int), from the staged rows and the Q fragments in registers;
// - runs even where its range is empty (lens[b] == 0), so it writes the
//   seeded partial (or, with S = 1, the output) and never the empty one.
// The other ranges never touch the new token. With S > 1 merge_kernel
// combines the partials as for a read; no launch is added for the write.
//
// The flat mode (kFlat; Sq = FLAT_CHUNK = 8, B the stream's T / 8 chunks).
// Row b of the launch is chunk ci = b: its lens is cbase[ci] (the `lens`
// argument), its table row tables[clamp(cslot[ci], 0, rows - 1)], and its
// query row r is token ci * 8 + r, which attends positions <= cbase + r
// when r < cn[ci] and nothing otherwise (then, exactly 0). The reach of the
// chunk is cbase + cn (a pad chunk, cn = 0, reads nothing: every range is
// empty and writes the empty partial, or with S = 1 zeros). q and out stay
// in the stream layout [T, H, D]: the row of (chunk, head h, r) is (ci * 8 +
// r) * H + h, for the Q loads, the S = 1 store and the partials alike, so
// merge_kernel writes the stream layout too.
//
// Semantics are decode_attention_paged's (and its int8 flavor's): query row
// r attends positions <= lens[b] + r; an unmapped table entry (the sentinel
// NB) reads block NB - 1, values and scales alike; scores, m and l are
// fp32, an int8 score (q . k_int) * scale * k_scale; p (int8: p * v_scale)
// is rounded to the value (int8: query) dtype before P V and l sums the
// unrounded, unscaled p; a row whose sum is 0 returns 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "numeric.cuh"
#include "wgmma_tile.cuh"

namespace paddle_attn {

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // KV positions a stage
constexpr float kNeg = -1e30f;

// DP: the head dim padded to the instantiation's width (64, 128 or 256);
// I8: the int8 flavor.
template <int DP, bool I8 = false>
struct Cfg {
  static constexpr int kLd = DP + 8;  // shared row stride: ldmatrix's eight
                                      // rows land on distinct banks
  static constexpr int kTileBytes = kTile * kLd * 2;  // a K or V tile in T
  // int8: a stage holds the K and V tiles as staged, rows of DP bytes, and
  // their scales; the converted K and V tiles follow the ring
  static constexpr int kI8Tile = kTile * DP;
  static constexpr int kStages =
      I8 ? (DP <= 128 ? 4 : 3) : (DP <= 128 ? 3 : 2);
  static constexpr int kStageBytes =
      I8 ? 2 * kI8Tile + 2 * kTile * 4 : 2 * kTileBytes;
  static constexpr int kConv = I8 ? kStages * kStageBytes : 0;  // offset
  static constexpr int kSmem =
      kStages * kStageBytes + (I8 ? 2 * kTileBytes : 0);
  // the write mode's new K and V rows as fp32 and the K row's scale, past
  // kSmem (so no ring stage or merge slot overlaps them)
  static constexpr int kNewBytes = (2 * DP + 4) * 4;
  static constexpr int kAcc = DP / 2;  // accumulator floats a lane
  // blocks an SM must hold: the int8 flavor at D 64 asks for four (at
  // most 128 registers a thread; unbounded it takes more, three blocks an
  // SM, and runs its decode shapes slower), as the fp flavor gets unasked
  static constexpr int kMinBlocks = I8 && DP == 64 ? 4 : 1;
  // the warps' (m, l, acc) exchange reuses the ring
  static_assert(kWarps * 32 * (kAcc + 4) * 4 <= kSmem, "merge slots fit");
};

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Where a block's KV lives: the K and V planes it reads, the row's table,
// and the planes' shape; the int8 flavor's K and V scale planes, and the
// row's block where there is no table (a ring or the one-layer cache).
template <typename T>
struct PagedKV {
  const T* k;       // [NB, Hk, Bt, D]
  const T* v;
  const int* tbl;   // [nblk] of row b; nullptr: block `blk` (nblk 1)
  int NB, Hk, Bt, D;
  const float* ks;  // [NB, Hk, 1, Bt] (int8)
  const float* vs;
  int blk;
};

// The row of position p (< nblk * Bt) in its K or V plane (and its scale
// plane): through the table, where an unmapped entry (the sentinel NB)
// reads block NB - 1, or with no table in block blk, where p < Bt.
template <typename T>
__device__ __forceinline__ size_t row_of(const PagedKV<T>& kv, int hk,
                                         int p) {
  if (kv.tbl)
    return (size_t)(min(__ldg(kv.tbl + p / kv.Bt), kv.NB - 1) * kv.Hk + hk) *
               kv.Bt + p % kv.Bt;
  return (size_t)(kv.blk * kv.Hk + hk) * kv.Bt + p;
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 8 : 0)
               : "memory");
}

// The write mode's new token, one a row: its K and V rows [B, Hk, D] each
// (kv_new's two planes), in T for the fp flavor and fp32 for the int8 one.
// Both nullptr in a read.
struct NewRow {
  const void* k;
  const void* v;
};

// The flat mode's per-chunk slot and count [B] (the chunks' base positions
// are the lens), and the table's rows for the slot's clamp. All zero in the
// other modes.
struct FlatMeta {
  const int* slot;
  const int* n;
  int rows;
};

// Warp-wide: the absmax scale amax / 127 of a D-element fp32 row (the
// engine's recipe; a true division).
__device__ __forceinline__ float row_scale(const float* r, int D, int lane) {
  float a = 0.f;
  for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(r[d]));
  return warp_max(a) / 127.0f;
}

// An fp32 value's int8 code under the scale's divisor max(s, 1e-8): round
// half to even, clipped to +-127.
__device__ __forceinline__ float quant_i8(float r, float div) {
  return fminf(fmaxf(rintf(r / div), -127.f), 127.f);
}

// Warps 0 (K) and 1 (V) of the write mode's designated block: the new K
// and V rows of (row b, KV head hk), kv_new's row nrow, stored at position
// `pos` of the planes in place (pos < 0: a full row, the write dropped) and
// staged as fp32 at nw for the seed: nw[0, D) K as the walk would read it
// (T's value, or the int8 code), nw[DP, DP + D) V times what p = 1 carries
// into P V (1, or the V scale rounded to T), nw[2 DP] K's scale (int8;
// else 1). The int8 flavor quantizes each row once, here.
template <typename T, typename KV, int DP>
__device__ __forceinline__ void stage_new(const PagedKV<KV>& kv,
                                          const NewRow& nr, int nrow, int hk,
                                          int pos, float* nw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 2) return;
  const size_t row = pos >= 0 ? row_of(kv, hk, pos) : 0;
  KV* dst = const_cast<KV*>(warp ? kv.v : kv.k) + row * kv.D;
  float* out = nw + warp * DP;
  if constexpr (std::is_same<KV, int8_t>::value) {
    const float* r =
        static_cast<const float*>(warp ? nr.v : nr.k) + (size_t)nrow * kv.D;
    const float sc = row_scale(r, kv.D, lane);
    const float div = fmaxf(sc, 1e-8f);
    const float carry = warp ? to_f(from_f<T>(sc)) : 1.f;
    for (int d = lane; d < kv.D; d += 32) {
      const float c = quant_i8(r[d], div);
      out[d] = carry * c;
      if (pos >= 0) dst[d] = static_cast<int8_t>(c);
    }
    if (lane == 0) {
      if (warp == 0) nw[2 * DP] = sc;
      if (pos >= 0) const_cast<float*>(warp ? kv.vs : kv.ks)[row] = sc;
    }
  } else {
    const T* r =
        static_cast<const T*>(warp ? nr.v : nr.k) + (size_t)nrow * kv.D;
    for (int d = lane; d < kv.D; d += 32) {
      out[d] = to_f(r[d]);
      if (pos >= 0) dst[d] = r[d];
    }
    if (warp == 0 && lane == 0) nw[2 * DP] = 1.f;
  }
}

// Block-wide: positions [p0, p0 + kTile) of KV head hk into a stage (K tile
// then V tile, [kTile][kLd] each), 16-byte cp.async chunks; positions at or
// past p_end and dims at or past D zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(uint32_t stage,
                                          const PagedKV<T>& kv, int hk,
                                          int p0, int p_end) {
  using C = Cfg<DP>;
  constexpr int kCpr = DP / 8;  // chunks a row
  constexpr int kChunks = 2 * kTile * kCpr;
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int plane = i / (kTile * kCpr);
    const int rem = i - plane * (kTile * kCpr);
    const int j = rem / kCpr;
    const int c = rem - j * kCpr;
    const int p = p0 + j;
    const bool ok = p < p_end && c * 8 < kv.D;
    const T* src = plane ? kv.v : kv.k;
    if (ok) src += row_of(kv, hk, p) * kv.D + c * 8;
    wg::cp_async16(stage + plane * C::kTileBytes + (j * C::kLd + c * 8) * 2,
                   src, ok);
  }
}

// Block-wide, int8 flavor: positions [p0, p0 + kTile) of KV head hk into a
// stage (K tile then V tile, [kTile][DP] bytes each, in CB-byte cp.async
// chunks; then kTile K and kTile V scales by 4-byte copies); positions at
// or past p_end zero-filled (a zero V scale keeps their p * v_scale 0).
template <int DP, int CB>
__device__ __forceinline__ void load_tile_i8(uint32_t stage,
                                             const PagedKV<int8_t>& kv,
                                             int hk, int p0, int p_end) {
  using C = Cfg<DP, true>;
  constexpr int kCpr = DP / CB;  // chunks a row
  constexpr int kChunks = 2 * kTile * kCpr;
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int plane = i / (kTile * kCpr);
    const int rem = i - plane * (kTile * kCpr);
    const int j = rem / kCpr;
    const int c = rem - j * kCpr;
    const int p = p0 + j;
    const bool ok = p < p_end && c * CB < kv.D;
    const int8_t* src = plane ? kv.v : kv.k;
    if (ok) src += row_of(kv, hk, p) * kv.D + c * CB;
    const uint32_t dst = stage + plane * C::kI8Tile + j * DP + c * CB;
    if constexpr (CB == 16)
      wg::cp_async16(dst, src, ok);
    else
      cp_async8(dst, src, ok);
  }
  for (int i = threadIdx.x; i < 2 * kTile; i += kThreads) {
    const int plane = i / kTile;
    const int p = p0 + i - plane * kTile;
    const bool ok = p < p_end;
    const float* src = plane ? kv.vs : kv.ks;
    if (ok) src += row_of(kv, hk, p);
    wg::cp_async4(stage + 2 * C::kI8Tile + i * 4, src, ok);
  }
}

// Four int8 values (one 32-bit word) as two packed pairs of T, exactly and
// without the quarter-rate int-to-float unit: each byte b, biased to b +
// 128 (xor 0x80), becomes the mantissa of a float whose exponent makes it
// an integer (fp16: 1024 + b + 128 in the halves of a pair; bf16: 2^23 + b
// + 128 in an fp32), and one subtraction leaves b. A bf16 is then the upper
// half of that fp32 (|b| <= 128 fits its 8 significant bits).
template <typename T>
__device__ __forceinline__ uint2 i8x4_to(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                        __ushort_as_half(0x6480));  // 1152
    uint32_t lo = __byte_perm(u, 0x64646464u, 0x5140);  // bytes 0, 1
    uint32_t hi = __byte_perm(u, 0x64646464u, 0x5342);  // bytes 2, 3
    const __half2 l2 = __hsub2(*reinterpret_cast<__half2*>(&lo), bias);
    const __half2 h2 = __hsub2(*reinterpret_cast<__half2*>(&hi), bias);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&l2),
                      *reinterpret_cast<const uint32_t*>(&h2));
  } else {
    uint32_t f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) -
          8388736.f);  // 2^23 + 128
    return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                      __byte_perm(f[2], f[3], 0x7632));
  }
}

// Warp-wide: positions [j0, j0 + 16) of a staged int8 stage's K and V tiles
// into the converted [kTile][kLd] K and V tiles in T at conv (all DP dims;
// those past D hold finite values that meet zero queries or are never
// written out).
template <typename T, int DP>
__device__ __forceinline__ void convert_i8(uint32_t stage, uint32_t conv,
                                           int j0, int lane) {
  using C = Cfg<DP, true>;
  constexpr int kCpr = DP / 16;  // 16-byte chunks a staged row
  constexpr int kN = 2 * 16 * kCpr;
#pragma unroll
  for (int i = lane; i < kN; i += 32) {
    const int plane = i / (16 * kCpr);
    const int rem = i - plane * (16 * kCpr);
    const int j = j0 + rem / kCpr;
    const int c = rem % kCpr;
    uint32_t w[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(stage + plane * C::kI8Tile + j * DP + c * 16)
                 : "memory");
    uint2 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = i8x4_to<T>(w[e]);
    const uint32_t dst =
        conv + plane * C::kTileBytes + (j * C::kLd + c * 16) * 2;
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(h[0].x), "r"(h[0].y), "r"(h[1].x), "r"(h[1].y)
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + 16),
                 "r"(h[2].x), "r"(h[2].y), "r"(h[3].x), "r"(h[3].y)
                 : "memory");
  }
}

// A packed pair of T (the low half first) as two floats.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Warp-wide, the write mode's designated block: the online softmax state
// of this lane's two query rows (lim < 0: not a row) seeded with the new
// column staged at nw (stage_new), as the TPU kernel seeds it: m = q .
// k_new * scale (int8: (q . k_int) * scale * k_scale), from the Q fragments
// qa; l = 1 (summed over the row's four lanes later, so lane t = 0 holds
// it); acc = v_new (int8: round_T(1 * v_scale) * v_int), each lane its own
// dims 8 n + 2 t (+ 1).
template <typename T, int DP>
__device__ __forceinline__ void seed_new(const float* nw, int D, int lane,
                                         float scale,
                                         const uint32_t (&qa)[DP / 16][4],
                                         const int (&lim)[2], float (&m)[2],
                                         float (&l)[2],
                                         float (&acc)[DP / 8][4]) {
  const int t = lane & 3;
  float dot[2] = {0.f, 0.f};  // over this lane's dims, its Q fragments'
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int d = 16 * kk + 8 * hi + 2 * t;
      if (d < D) {
        const float2 k2 = *reinterpret_cast<const float2*>(nw + d);
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const float2 q2 = unpack2<T>(qa[kk][2 * hi + ri]);
          dot[ri] += q2.x * k2.x + q2.y * k2.y;
        }
      }
    }
  const float k_sc = nw[2 * DP];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    dot[ri] += __shfl_xor_sync(0xffffffffu, dot[ri], 1);
    dot[ri] += __shfl_xor_sync(0xffffffffu, dot[ri], 2);
    if (lim[ri] < 0) continue;
    m[ri] = dot[ri] * scale * k_sc;
    l[ri] = t == 0 ? 1.f : 0.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) {
        const float2 v2 = *reinterpret_cast<const float2*>(nw + DP + d);
        acc[n][2 * ri] = v2.x;
        acc[n][2 * ri + 1] = v2.y;
      }
    }
  }
}

// grid (B * Hk, S), kThreads threads, Cfg<DP, I8>::kSmem bytes of shared
// memory. KV: the stored type, T or int8_t (then the scale planes ks_base
// and vs_base [NB, Hk, 1, Bt] fp32 beside the K and V planes). tables
// nullptr: a contiguous cache, row b's block is b (nblk 1, Bt Smax). span:
// positions a split. With S = 1 writes out; else the partials: o [S, B * H
// * Sq, D] and (m, l) [S, B * H * Sq, 2], fp32. kNew: the write mode (Sq =
// 1, the new token in nr; the planes are written at lens[b]). kFlat: the
// flat mode (Sq = 8, row b a chunk of the stream, its slot and count in
// fl).
template <typename T, typename KV, int DP, int WP, bool kNew, bool kFlat>
__global__ void __launch_bounds__(
    kThreads, Cfg<DP, std::is_same<KV, int8_t>::value>::kMinBlocks)
    split_kernel(const T* __restrict__ q, const KV* __restrict__ k_base,
                 const KV* __restrict__ v_base,
                 const float* __restrict__ ks_base,
                 const float* __restrict__ vs_base,
                 const int* __restrict__ tables, const int* __restrict__ lens,
                 T* __restrict__ out, float* __restrict__ o_part,
                 float* __restrict__ ml_part, int B, int H, int Sq, int D,
                 int NB, int Hk, int Bt, int nblk, int span, float scale,
                 NewRow nr, FlatMeta fl) {
  constexpr bool kI8 = std::is_same<KV, int8_t>::value;
  using C = Cfg<DP, kI8>;
  constexpr int WR = kWarps / WP;   // row groups a pass
  constexpr int PW = kTile / WP;    // positions a warp takes of a tile
  constexpr int NT = PW / 8;        // its n8 score tiles
  constexpr int KS = DP / 16;       // k16 steps of Q K^T
  static_assert(PW % 16 == 0, "whole k16 steps of P V");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t ring = wg::smem_u32(smem_raw);

  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x - b * Hk;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int G = H / Hk;
  const int R = G * Sq;
  const int rows = B * H * Sq;  // query rows of the whole call
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp / WP;
  const int wp = warp - wr * WP;

  // this split's positions, cut at the last one any row attends (the
  // write mode: below lens[b], the position it writes)
  const int n_pos = nblk * Bt;
  const int p_lo = s * span;
  // the flat mode: the chunk's count of query rows (a pad chunk has none
  // and reaches no position)
  const int cnt = kFlat ? fl.n[b] : Sq;
  const int reach = kNew ? len : kFlat ? (cnt > 0 ? len + cnt : 0) : len + Sq;
  const int p_end = min(min((s + 1) * span, n_pos), min(reach, n_pos));
  // query row i of this block: head hk * G + i / Sq, row i % Sq; its
  // index among the call's rows (the flat mode: token b * Sq + i % Sq of
  // the stream)
  auto row_index = [&](int i) {
    if constexpr (kFlat)
      return (b * Sq + i % Sq) * H + hk * G + i / Sq;
    else
      return (b * H + hk * G + i / Sq) * Sq + i % Sq;
  };
  // nothing to attend here: an empty partial (the designated block always
  // has the new column; the flat mode with S = 1: zero rows)
  if (p_lo >= p_end && !(kNew && s == 0)) {
    if constexpr (kFlat) {
      if (S == 1) {
        for (int i = threadIdx.x; i < R * D; i += kThreads)
          out[(size_t)row_index(i / D) * D + i % D] = from_f<T>(0.f);
        return;
      }
    }
    for (int i = threadIdx.x; i < R; i += kThreads) {
      float* ml = ml_part + 2 * ((size_t)s * rows + row_index(i));
      ml[0] = kNeg;
      ml[1] = 0.f;
    }
    return;
  }

  // the flat mode: the chunk's slot, clamped into the table
  const int trow = kFlat ? min(max(fl.slot[b], 0), fl.rows - 1) : b;
  const PagedKV<KV> kv{k_base, v_base,
                       tables ? tables + (size_t)trow * nblk : nullptr,
                       NB, Hk, Bt, D, ks_base, vs_base, b};
  // the write mode's designated block: the new row lands once (a full row
  // drops it) and is staged past the ring for the seed
  if constexpr (kNew) {
    if (s == 0) {
      stage_new<T, KV, DP>(kv, nr, b * Hk + hk, hk, len < n_pos ? len : -1,
                           reinterpret_cast<float*>(smem_raw + C::kSmem));
      __syncthreads();
    }
  }
  // D not a multiple of 16 (int8): 8-byte chunks
  const bool v16 = !kI8 || D % 16 == 0;
  auto load = [&](int stage_i, int p0) {
    const uint32_t st = ring + stage_i * C::kStageBytes;
    if constexpr (kI8) {
      if (v16)
        load_tile_i8<DP, 16>(st, kv, hk, p0, p_end);
      else
        load_tile_i8<DP, 8>(st, kv, hk, p0, p_end);
    } else {
      load_tile<T, DP>(st, kv, hk, p0, p_end);
    }
  };
  const int n_tiles = (p_end - p_lo + kTile - 1) / kTile;
  const int n_groups = (R + 15) / 16;

  for (int rg0 = 0; rg0 < n_groups; rg0 += WR) {
    const int rg = rg0 + wr;
    const bool active = rg < n_groups;  // uniform across the warp
    // this lane's two rows (g and g + 8 of the group): validity and the
    // last position each attends (-1: not a row; the flat mode's -2: a row
    // past its chunk's count, which attends nothing)
    int lim[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int i = rg * 16 + g + 8 * ri;
      lim[ri] = (active && i < R)
                    ? (!kFlat || i % Sq < cnt ? len + i % Sq : -2)
                    : -1;
    }
    // Q as A fragments: rows g / g + 8, dims 16 kk + 2 t (+ 8)
    uint32_t qa[KS][4];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int i = rg * 16 + g + 8 * ri;
      const T* qrow = q + (size_t)row_index(i < R ? i : 0) * D;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = 16 * kk + 8 * hi + 2 * t;
          qa[kk][2 * hi + ri] =
              (lim[ri] >= 0 && d < D)
                  ? *reinterpret_cast<const uint32_t*>(qrow + d)
                  : 0u;
        }
    }
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float acc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if constexpr (kNew) {
      // the designated block's first warp of each row group seeds its rows
      // with the new column (the others merge into it at the end)
      if (s == 0 && active && wp == 0)
        seed_new<T, DP>(reinterpret_cast<const float*>(smem_raw + C::kSmem),
                        D, lane, scale, qa, lim, m, l, acc);
    }

#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < n_tiles) load(st, p_lo + st * kTile);
      wg::cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      wg::cp_async_wait<C::kStages - 2>();
      __syncthreads();  // tile it landed; every warp is done with it - 1
      {
        const int nx = it + C::kStages - 1;
        if (nx < n_tiles) load(nx % C::kStages, p_lo + nx * kTile);
        wg::cp_async_commit();
      }
      const int pw0 = wp * PW;  // the warp's first position in the tile
      uint32_t ks = ring + (it % C::kStages) * C::kStageBytes;
      const float* kscl = nullptr;  // int8: the tile's K and V scales
      if constexpr (kI8) {
        // this warp converts 16 of its slice's positions; the WR warps
        // that share the slice (one per row group) then meet
        convert_i8<T, DP>(ks, ring + C::kConv, pw0 + 16 * wr, lane);
        if constexpr (WR == 1)
          __syncwarp();
        else
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wp), "n"(32 * WR)
                       : "memory");
        kscl = reinterpret_cast<const float*>(
            smem_raw + (it % C::kStages) * C::kStageBytes + 2 * C::kI8Tile);
        ks = ring + C::kConv;
      }
      const uint32_t vs = ks + C::kTileBytes;
      if (!active) continue;
      const int p_tile = p_lo + it * kTile + pw0;

      // scores of rows g, g + 8 at positions 8 n + 2 t (+ 1)
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t kb[4];
          ldsm_x4(ks + ((pw0 + 8 * n + (lane & 7)) * C::kLd + 16 * kk +
                        8 * (lane >> 3)) * 2,
                  kb);
          mma16816<T>(sc[n], qa[kk], kb[0], kb[1]);
          mma16816<T>(sc[n], qa[kk + 1], kb[2], kb[3]);
        }
      uint32_t okm = 0;  // bit 4 n + e: a position the row attends
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p_tile + 8 * n + 2 * t + (e & 1);
          const bool ok = p < p_end && p <= lim[e >> 1];
          okm |= (uint32_t)ok << (4 * n + e);
          float s_e = sc[n][e] * scale;
          if constexpr (kI8) s_e = s_e * kscl[pw0 + 8 * n + 2 * t + (e & 1)];
          sc[n][e] = ok ? s_e : kNeg;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
        const float m_new = fmaxf(m[ri], mx[ri]);
        alpha[ri] = expf(m[ri] - m_new);
        m[ri] = m_new;
        l[ri] *= alpha[ri];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (okm >> (4 * n + e)) & 1u
                              ? expf(sc[n][e] - m[e >> 1])
                              : 0.f;
          l[e >> 1] += p;  // the unrounded, unscaled p
          if constexpr (kI8)
            sc[n][e] = p * kscl[kTile + pw0 + 8 * n + 2 * t + (e & 1)];
          else
            sc[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // P V: p rounded to T as the A fragments of k16 steps of positions
#pragma unroll
      for (int kk = 0; kk < PW / 16; ++kk) {
        const uint32_t pa[4] = {
            wg::pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
            wg::pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
            wg::pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            wg::pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          uint32_t vb[4];
          ldsm_x4_t(vs + ((pw0 + 16 * kk + 8 * ((lane >> 3) & 1) +
                           (lane & 7)) * C::kLd +
                          8 * n + 8 * (lane >> 4)) * 2,
                    vb);
          mma16816<T>(acc[n], pa, vb[0], vb[1]);
          mma16816<T>(acc[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    wg::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // l over the row's four lanes
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
      l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
    }
    if constexpr (WP > 1) {
      // the warps of a row group merge in warp wp = 0: each lane's (m, l,
      // acc) in fragment order, so a lane reads only its own elements
      float* slot = reinterpret_cast<float*>(smem_raw);
      constexpr int kSlot = C::kAcc + 4;
      float* mine = slot + (size_t)(warp * 32 + lane) * kSlot;
      if (active && wp > 0) {
        mine[0] = m[0];
        mine[1] = m[1];
        mine[2] = l[0];
        mine[3] = l[1];
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[4 + 4 * n + e] = acc[n][e];
      }
      __syncthreads();
      if (active && wp == 0) {
#pragma unroll
        for (int w2 = 1; w2 < WP; ++w2) {
          const float* other = mine + (size_t)w2 * 32 * kSlot;
          float fa[2], fb[2];
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const float mm = fmaxf(m[ri], other[ri]);
            fa[ri] = expf(m[ri] - mm);
            fb[ri] = expf(other[ri] - mm);
            m[ri] = mm;
            l[ri] = l[ri] * fa[ri] + other[2 + ri] * fb[ri];
          }
#pragma unroll
          for (int n = 0; n < DP / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[n][e] = acc[n][e] * fa[e >> 1] +
                          other[4 + 4 * n + e] * fb[e >> 1];
        }
      }
      __syncthreads();  // the slots are free for the next pass's ring
    }
    if (active && wp == 0) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        // a lane past the rows writes nothing (a flat row past its
        // chunk's count writes its zero output)
        if (kFlat ? lim[ri] == -1 : lim[ri] < 0) continue;
        const int idx = row_index(rg * 16 + g + 8 * ri);
        if (S == 1) {
          const float denom = l[ri] == 0.f ? 1.f : l[ri];
          T* orow = out + (size_t)idx * D;
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            const int d = 8 * n + 2 * t;
            if (d < D)
              *reinterpret_cast<uint32_t*>(orow + d) = wg::pack2<T>(
                  acc[n][2 * ri] / denom, acc[n][2 * ri + 1] / denom);
          }
        } else {
          float* orow = o_part + ((size_t)s * rows + idx) * D;
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            const int d = 8 * n + 2 * t;
            if (d < D)
              *reinterpret_cast<float2*>(orow + d) =
                  make_float2(acc[n][2 * ri], acc[n][2 * ri + 1]);
          }
          if (t == 0) {
            float* ml = ml_part + 2 * ((size_t)s * rows + idx);
            ml[0] = m[ri];
            ml[1] = l[ri];
          }
        }
      }
    }
  }
}

// One warp a query row: the S partials combined in split order, o / l
// rounded to T (0 where l is 0). D <= 256. Lane s reads split s's (m, l)
// (32 splits a pass), so the loads of a row go out together; the o rows of
// the splits that hold positions are added in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ o_part,
                 const float* __restrict__ ml_part, T* __restrict__ out,
                 int rows, int D, int S) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mmax = kNeg;
  for (int s = lane; s < S; s += 32)
    mmax = fmaxf(mmax, ml_part[2 * ((size_t)s * rows + row)]);
  mmax = warp_max(mmax);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float lsum = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    // this lane's split: its weight, 0 where it is empty (its o unwritten)
    float w = 0.f;
    if (s0 + lane < S) {
      const float* ml = ml_part + 2 * ((size_t)(s0 + lane) * rows + row);
      if (ml[1] != 0.f) {
        w = expf(ml[0] - mmax);
        lsum += w * ml[1];
      }
    }
    const int n = min(32, S - s0);
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (wj == 0.f) continue;  // the same for every lane
      const float* o = o_part + ((size_t)(s0 + j) * rows + row) * D;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += wj * o[d];
      }
    }
  }
  const float l = warp_sum(lsum);
  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[(size_t)row * D + d] = from_f<T>(acc[i] / denom);
  }
}

// The K and V planes a launch reads, [NB, Hk, Bt, D] each in the stored
// type (one layer of a pool or ring, or the one-layer cache's two
// tensors), and the int8 flavor's K and V scale planes [NB, Hk, 1, Bt].
struct Planes {
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
};

// Layer `layer`'s planes of a pool [L, 2, NB, Hk, Bt, D] of `elem`-byte
// values (a ring [L, 2, B, Hk, Smax, D]: NB = B, Bt = Smax) and of its
// scales [L, 2, NB, Hk, 1, Bt] fp32 (nullptr: none).
inline Planes layer_planes(const void* pool, const void* scales, int layer,
                           int NB, int Hk, int Bt, int D, int elem) {
  const size_t pos = (size_t)NB * Hk * Bt;  // positions a plane
  const size_t bytes = pos * D * elem;
  const char* k = static_cast<const char*>(pool) + (size_t)layer * 2 * bytes;
  const float* ks = scales ? static_cast<const float*>(scales) +
                                 (size_t)layer * 2 * pos
                           : nullptr;
  return Planes{k, k + bytes, ks, ks ? ks + pos : nullptr};
}

template <typename T, typename KV, int DP, int WP, bool kNew, bool kFlat>
cudaError_t launch(const void* q, const Planes& kv, const void* tables,
                   const void* lens, void* out, void* work, int B, int H,
                   int Sq, int D, int NB, int Hk, int Bt, int nblk, int S,
                   int span, float scale, cudaStream_t stream,
                   const NewRow& nr, const FlatMeta& fl) {
  auto kernel = split_kernel<T, KV, DP, WP, kNew, kFlat>;
  using C = Cfg<DP, std::is_same<KV, int8_t>::value>;
  constexpr int smem = C::kSmem + (kNew ? C::kNewBytes : 0);
  // set on every launch (a function-local static in a header template
  // would be one object across every library built from it)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = B * H * Sq;
  float* o_part = static_cast<float*>(work);
  float* ml_part = S > 1 ? o_part + (size_t)S * rows * D : nullptr;
  kernel<<<dim3(B * Hk, S), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kv.k),
      static_cast<const KV*>(kv.v), kv.ks, kv.vs,
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), o_part, ml_part, B, H, Sq, D, NB, Hk, Bt, nblk,
      span, scale, nr, fl);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  merge_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      o_part, ml_part, static_cast<T*>(out), rows, D, S);
  return cudaGetLastError();
}

#define PADDLE_SPLIT_ARGS                                                  \
  q, kv, tables, lens, out, work, B, H, Sq, D, NB, Hk, Bt, nblk, S, span, \
      scale, stream, nr, fl

// The instantiation for D (<= 256, a multiple of 8) and R = (H / Hk) * Sq
// query rows a block: the warps' split (WP) and the padded width (DP).
template <typename T, typename KV, int DP, bool kNew, bool kFlat>
cudaError_t launch_wp(const void* q, const Planes& kv, const void* tables,
                      const void* lens, void* out, void* work, int B, int H,
                      int Sq, int D, int NB, int Hk, int Bt, int nblk, int S,
                      int span, float scale, cudaStream_t stream,
                      const NewRow& nr, const FlatMeta& fl) {
  const int R = H / Hk * Sq;
  if (R <= 16) return launch<T, KV, DP, 4, kNew, kFlat>(PADDLE_SPLIT_ARGS);
  if (R <= 32) return launch<T, KV, DP, 2, kNew, kFlat>(PADDLE_SPLIT_ARGS);
  return launch<T, KV, DP, 1, kNew, kFlat>(PADDLE_SPLIT_ARGS);
}

template <typename T, typename KV, bool kNew, bool kFlat>
cudaError_t launch_d(const void* q, const Planes& kv, const void* tables,
                     const void* lens, void* out, void* work, int B, int H,
                     int Sq, int D, int NB, int Hk, int Bt, int nblk, int S,
                     int span, float scale, cudaStream_t stream,
                     const NewRow& nr, const FlatMeta& fl) {
  if (D <= 64) return launch_wp<T, KV, 64, kNew, kFlat>(PADDLE_SPLIT_ARGS);
  if (D <= 128) return launch_wp<T, KV, 128, kNew, kFlat>(PADDLE_SPLIT_ARGS);
  return launch_wp<T, KV, 256, kNew, kFlat>(PADDLE_SPLIT_ARGS);
}

// A C entry's split path: S ranges of `span` positions over the nblk * Bt
// positions of a table (tables nullptr: a contiguous cache, nblk 1, Bt
// Smax) in the planes kv, for dtype 1 (bf16) or 2 (fp16) queries over KV
// in T or int8 (its scale planes beside it). Refuses
// (cudaErrorInvalidValue) what the kernel does not take: D not a multiple
// of 8, S != ceil(nblk * Bt / span), a missing workspace (S > 1: fp32 [S *
// B * H * Sq * (D + 2)]) or table (nblk > 1), another dtype; q, out and
// the K and V planes must be 16-byte aligned (int8 with D not a multiple
// of 16: the planes 8), else cudaErrorMisalignedAddress. kNew: the write
// mode, which takes Sq = 1 and the new token's two rows in nr (and writes
// the planes, and the int8 flavor's scale planes, at lens[b]). kFlat: the
// flat mode, which takes Sq = 8, a table, and the chunks' slots and counts
// in fl (lens their base positions).
template <bool kI8, bool kNew = false, bool kFlat = false>
int run(const void* q, const Planes& kv, const void* tables,
        const void* lens, void* out, void* work, int B, int H, int Sq, int D,
        int NB, int Hk, int Bt, int nblk, int S, int span, float scale,
        int dtype, cudaStream_t stream, const NewRow& nr = NewRow{},
        const FlatMeta& fl = FlatMeta{}) {
  if (D % 8 || span < 1 || ((long long)nblk * Bt + span - 1) / span != S ||
      (S > 1 && work == nullptr) || (!tables && nblk != 1) ||
      (kI8 && (kv.ks == nullptr || kv.vs == nullptr)) ||
      (kNew && (Sq != 1 || nr.k == nullptr || nr.v == nullptr)) ||
      (kFlat && (kNew || Sq != 8 || !tables || fl.slot == nullptr ||
                 fl.n == nullptr || fl.rows < 1)))
    return (int)cudaErrorInvalidValue;
  auto plane_ok = [&](const void* p) {
    return kI8 && D % 16 ? reinterpret_cast<uintptr_t>(p) % 8 == 0
                         : wg::aligned16(p);
  };
  if (!wg::aligned16(q, out) || !plane_ok(kv.k) || !plane_ok(kv.v))
    return (int)cudaErrorMisalignedAddress;
  switch (dtype) {
    case 1:
      return (int)launch_d<__nv_bfloat16,
                           std::conditional_t<kI8, int8_t, __nv_bfloat16>,
                           kNew, kFlat>(PADDLE_SPLIT_ARGS);
    case 2:
      return (int)launch_d<__half, std::conditional_t<kI8, int8_t, __half>,
                           kNew, kFlat>(PADDLE_SPLIT_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef PADDLE_SPLIT_ARGS

}  // namespace split

}  // namespace paddle_attn
