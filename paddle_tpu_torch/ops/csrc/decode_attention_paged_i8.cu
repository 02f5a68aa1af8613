// Paged flash-decode attention over an int8 KV pool, for Hopper (sm_90a),
// plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_paged_i8 (_paged_i8_kernel + _online_softmax_block with
// column scales): the new queries of each row attend, block-causally, to
// the row's KV prefix in the shared int8 block pool, resolved through the
// row's block table, with each position's K and V scale read from a scale
// pool that mirrors the KV pool block for block.
//
//   q      [B, H, Sq, D]             fp32, bf16 or fp16 (Sq <= 128, D <= 256)
//   pool   [L, 2, NB, Hk, Bt, D]     int8
//   scales [L, 2, NB, Hk, 1, Bt]     fp32, one per (kv, block, head, position)
//   tables [B, nblk] int32           unmapped entries hold the sentinel NB
//   lens   [B] int32                 query row r attends positions <= lens+r
//   out    [B, H, Sq, D]             q's dtype
//
// Semantics kept from the TPU kernel: the int8 values convert exactly to
// the compute type; the score is (q . k) * scale * k_scale in fp32; after
// the online-softmax update p * v_scale is rounded to q's dtype before the
// PV product, while l sums the unscaled p; an unmapped table entry reads
// block min(entry, NB - 1) for both the values and the scales; blocks past
// the last attendable position are never read; a row whose softmax sum is
// 0 returns 0.
//
// What bounds it on the card: bytes. A decode step reads the row's valid
// prefix once per KV head, one byte per element plus 4 bytes of scale per
// position (68 of 128 bytes per K/V row at D = 64, against bf16), and does
// 4*D flops per position and query row, far below the ~295 flop/byte ridge;
// at the serving shape (B 8, H 12, 1025 positions, D 64) the 13.4 MB take
// 4.0 us at 3.35 TB/s.
//
// Two designs; the wrapper picks one (ops/decode_attention.py's paged_path,
// the rule of the fp pool too) and passes it as `path`; the entry runs that
// design or fails:
// - path 1, "split_kv" (bf16 and fp16 queries, D a multiple of 8): the int8
//   flavor of split_decode.cuh. The KV length is split over S blocks per
//   (row, KV head), ranges of `span` positions (a multiple of 64) from the
//   shapes and the SM count (the wrapper's decode_splits), each block
//   holding the GQA group's query rows, staging the int8 K/V tiles and
//   their scales by cp.async through a ring of 3-4 stages, converting each
//   warp's positions to the query dtype in shared memory and multiplying on
//   mma.sync; a second kernel merges the S partials of each row from the
//   fp32 workspace `work` in split order.
// - path 0, "per_head" (fp32 queries, or D not a multiple of 8): the first
//   design, one thread block per (row, head); tiles of 32 positions (or one
//   block when Bt < 32) staged as fp32 through shared memory, with 16-byte
//   loads that carry 16 int8 values each, four per thread in flight, and
//   the tile's 32 K and 32 V scales staged beside them; four warps each own
//   four query rows of a 16-row pass with an fp32 online softmax in
//   registers (attention_tile.cuh, shared with the fp flat and flash
//   kernels); GQA heads of one KV head re-read the same blocks (from L2).
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ pool,
                    const float* __restrict__ scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H,
                    int Sq, int D, int NB, int Hk, int Bt, int nblk,
                    int layer, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                      // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;           // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;           // [kRowsPerPass][Dp]
  float* ps = qs + kRowsPerPass * Dp;    // [kRowsPerPass][kTile]
  float* kss = ps + kRowsPerPass * kTile;  // [kTile] K scales
  float* vss = kss + kTile;                // [kTile] V scales

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tk = Bt < kTile ? Bt : kTile;

  const size_t splane = (size_t)NB * Hk * Bt;  // positions per K or V plane
  const int8_t* k_base = pool + (size_t)layer * 2 * splane * D;
  const int8_t* v_base = k_base + splane * D;
  const float* ks_base = scales + (size_t)layer * 2 * splane;
  const float* vs_base = ks_base + splane;
  const T* q_bh = q + ((size_t)b * H + h) * Sq * D;
  T* o_bh = out + ((size_t)b * H + h) * Sq * D;
  const int* tbl = tables + (size_t)b * nblk;

  for (int r0 = 0; r0 < Sq; r0 += kRowsPerPass) {
    const int nrows = min(kRowsPerPass, Sq - r0);
    __syncthreads();  // the previous pass is done with qs
    for (int i = threadIdx.x; i < kRowsPerPass * Dp; i += blockDim.x) {
      const int r = i / Dp;
      const int d = i - r * Dp;
      qs[i] = (r < nrows && d < D) ? to_f(q_bh[(size_t)(r0 + r) * D + d])
                                   : 0.f;
    }

    int limit[kRowsPerWarp];
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      limit[rr] = r < nrows ? len + r0 + r : -1;
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
      const size_t off = ((size_t)blk * Hk + hk) * Bt + (c0 % Bt);
      __syncthreads();  // everyone is done with the previous tile
      stage_kv(ks, vs, k_base + off * D, v_base + off * D, tk, D, Dp, ld,
               vec);
      if (threadIdx.x < kTile) {
        const int c = threadIdx.x;
        kss[c] = c < tk ? ks_base[off + c] : 0.f;
        vss[c] = c < tk ? vs_base[off + c] : 0.f;
      }
      __syncthreads();
      tile_update<T, kRowsPerWarp, DPL, true>(
          qs + warp * kRowsPerWarp * Dp, ks, vs,
          ps + warp * kRowsPerWarp * kTile, D, Dp, c0, tk, limit, scale, m,
          l, acc, kss, vss);
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r < nrows) {
        const float denom = l[rr] == 0.f ? 1.f : l[rr];
        T* o = o_bh + (size_t)(r0 + r) * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) o[d] = from_f<T>(acc[rr][i] / denom);
        }
      }
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* pool, const void* scales,
                   const void* tables, const void* lens, void* out, int B,
                   int H, int Sq, int D, int NB, int Hk, int Bt, int nblk,
                   int layer, float scale, cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kTile * (Dp + 1) + kRowsPerPass * Dp +
                               kRowsPerPass * kTile + 2 * kTile) *
                      sizeof(float);
  auto kernel = paged_i8_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(pool),
      static_cast<const float*>(scales), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), H, Sq, D, NB, Hk,
      Bt, nblk, layer, scale, vec_ok<int8_t>(D, pool, pool));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* pool, const void* scales,
                     const void* tables, const void* lens, void* out, int B,
                     int H, int Sq, int D, int NB, int Hk, int Bt, int nblk,
                     int layer, float scale, cudaStream_t stream) {
#define PADDLE_PAGED_I8_LAUNCH(DPL)                                        \
  launch<T, DPL>(q, pool, scales, tables, lens, out, B, H, Sq, D, NB, Hk, \
                 Bt, nblk, layer, scale, stream)
  if (D <= 32) return PADDLE_PAGED_I8_LAUNCH(1);
  if (D <= 64) return PADDLE_PAGED_I8_LAUNCH(2);
  if (D <= 128) return PADDLE_PAGED_I8_LAUNCH(4);
  return PADDLE_PAGED_I8_LAUNCH(8);
#undef PADDLE_PAGED_I8_LAUNCH
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16. path: 1 =
// split_kv (bf16 or fp16, D a multiple of 8; splits S >= 1 ranges of span
// positions each, S = ceil(nblk * Bt / span); work: fp32 [S * B * H * Sq *
// (D + 2)] when S > 1; q and out 16-byte aligned, the pool 16 (D a multiple
// of 16) or 8), 0 = per_head (splits 1; work unused); any other pairing
// returns cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the
// caller has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_paged_i8(
    const void* q, const void* pool, const void* scales, const void* tables,
    const void* lens, void* out, void* work, int B, int H, int Sq, int D,
    int NB, int Hk, int Bt, int nblk, int layer, int splits, int span,
    float scale, int dtype, int path, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > 128 || D < 1 || D > 256 || Hk < 1 ||
      H % Hk || NB < 1 || Bt < 1 || (Bt > kTile && Bt % kTile) || nblk < 1 ||
      splits < 1 || splits > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return paddle_attn::split::run<true>(
        q, paddle_attn::split::layer_planes(pool, scales, layer, NB, Hk, Bt,
                                            D, 1),
        tables, lens, out, work, B, H, Sq, D, NB, Hk, Bt, nblk, splits, span,
        scale, dtype, s);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, pool, scales, tables, lens, out, B, H,
                                  Sq, D, NB, Hk, Bt, nblk, layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, pool, scales, tables, lens, out,
                                          B, H, Sq, D, NB, Hk, Bt, nblk,
                                          layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, pool, scales, tables, lens, out, B, H,
                                   Sq, D, NB, Hk, Bt, nblk, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
