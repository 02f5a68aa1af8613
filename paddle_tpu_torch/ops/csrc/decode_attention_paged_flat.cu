// Flat-stream paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_paged_flat (_paged_flat_kernel): the token-flattened
// budget dispatch packs every request's segment into one ragged [T] query
// stream whose 8-token chunks each belong to one slot; chunk ci holds the
// queries at positions cbase[ci] .. cbase[ci] + cn[ci] - 1 of slot
// cslot[ci], and each attends its slot's table-resolved positions up to its
// own (the chunk's K/V is already written).
//
//   q      [T, H, D]                 T % 8 == 0, D <= 256
//   pool   [L, 2, NB, Hk, Bt, D]     q's dtype (fp32, bf16 or fp16)
//   tables [rows, nblk] int32        unmapped entries hold the sentinel NB
//   cslot, cbase, cn [T / 8] int32   per-chunk slot, base position, count
//   out    [T, H, D]                 q's dtype
//
// Semantics kept from the TPU kernel: a chunk reads blocks up to
// (cbase + max(cn, 1) - 1) / Bt and no further; an unmapped entry reads
// block min(entry, NB - 1); rows r >= cn and pad chunks (cn == 0) read
// nothing and return exactly 0 (the l == 0 guard). The slot id is clamped
// into the table, as the caller does.
//
// What bounds it on the card: bytes. Each chunk reads its slot's prefix
// once per KV head for its GQA group's 8-row query blocks, 4*D flops per
// position and row, far below the ~295 flop/byte ridge. Chunks of one slot
// re-read its prefix (from L2).
//
// Two designs; the wrapper picks one (ops/decode_attention.py's paged_path,
// the rule of every decode read) and passes it as `path`; the entry runs
// that design or fails:
// - path 1, "split_kv" (bf16 and fp16, D a multiple of 8): the flat mode
//   of split_decode.cuh's fp flavor, as decode_attention_paged_flat_i8.cu
//   runs its int8 flavor. Each chunk is a row of 8 query positions whose
//   lens is cbase and whose table row is its slot's; its positions are
//   split over S blocks per (chunk, KV head), ranges of `span` positions
//   (a multiple of 64) from the shapes and the SM count (the wrapper's
//   decode_splits over T / 8 chunks), each block holding the GQA group's
//   8-row blocks, staging the K/V tiles in the stored dtype by cp.async,
//   a ring of stages in flight, and multiplying on mma.sync with fp32
//   sums; a second kernel merges the S partials of each row from the fp32
//   workspace `work` in split order. q, out and the partials keep the
//   stream layout [T, H, D].
// - path 0, "per_head" (fp32, or D not a multiple of 8): the first design.
//   One thread block per (chunk, head); K/V tiles of 32 positions (or one
//   block when Bt < 32) are staged as fp32 in shared memory with 16-byte
//   loads issued in batches, and shared by four warps, each of which owns
//   two of the chunk's eight rows with an fp32 online softmax in registers
//   (attention_tile.cuh, shared with the flash forward kernel).
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kChunk = 8;  // FLAT_CHUNK
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kChunk / kWarps;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    flat_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                const int* __restrict__ tables, const int* __restrict__ cslot,
                const int* __restrict__ cbase, const int* __restrict__ cn,
                T* __restrict__ out, int H, int D, int NB, int Hk, int Bt,
                int nblk, int n_rows, int layer, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                 // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;      // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;      // [kChunk][Dp]
  float* ps = qs + kChunk * Dp;     // [kChunk][kTile]

  const int ci = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = cn[ci];
  const int base = cbase[ci];
  const int slot = min(max(cslot[ci], 0), n_rows - 1);
  const int* tbl = tables + (size_t)slot * nblk;

  // the chunk's rows of head h: row r at q[(ci * 8 + r) * H + h]
  for (int i = threadIdx.x; i < kChunk * Dp; i += blockDim.x) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    qs[i] = (r < n && d < D)
                ? to_f(q[((size_t)(ci * kChunk + r) * H + h) * D + d])
                : 0.f;
  }

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    limit[rr] = r < n ? base + r : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  if (n > 0) {  // uniform across the block
    const int tk = Bt < kTile ? Bt : kTile;
    const size_t plane = (size_t)NB * Hk * Bt * D;  // K plane -> V plane
    const T* k_base = pool + (size_t)layer * 2 * plane;
    const T* v_base = k_base + plane;
    const int last_pos = min(base + n - 1, nblk * Bt - 1);
    for (int c0 = 0; c0 <= last_pos; c0 += tk) {
      const int blk = min(tbl[c0 / Bt], NB - 1);
      const size_t off = (((size_t)blk * Hk + hk) * Bt + (c0 % Bt)) * D;
      __syncthreads();  // everyone is done with the previous tile
      stage_kv(ks, vs, k_base + off, v_base + off, tk, D, Dp, ld, vec);
      __syncthreads();
      tile_update<T, kRowsPerWarp, DPL>(
          qs + warp * kRowsPerWarp * Dp, ks, vs,
          ps + warp * kRowsPerWarp * kTile, D, Dp, c0, tk, limit, scale, m,
          l, acc);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    T* o = out + ((size_t)(ci * kChunk + r) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f<T>(acc[rr][i] / denom);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* pool, const void* tables,
                   const void* cslot, const void* cbase, const void* cn,
                   void* out, int T_, int H, int D, int NB, int Hk, int Bt,
                   int nblk, int n_rows, int layer, float scale,
                   cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem =
      (size_t)(2 * kTile * (Dp + 1) + kChunk * Dp + kChunk * kTile) *
      sizeof(float);
  auto kernel = flat_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(T_ / kChunk) * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(cslot),
      static_cast<const int*>(cbase), static_cast<const int*>(cn),
      static_cast<T*>(out), H, D, NB, Hk, Bt, nblk, n_rows, layer, scale,
      vec_ok<T>(D, pool, pool));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* pool, const void* tables,
                     const void* cslot, const void* cbase, const void* cn,
                     void* out, int T_, int H, int D, int NB, int Hk, int Bt,
                     int nblk, int n_rows, int layer, float scale,
                     cudaStream_t stream) {
#define PADDLE_FLAT_LAUNCH(DPL)                                             \
  launch<T, DPL>(q, pool, tables, cslot, cbase, cn, out, T_, H, D, NB, Hk, \
                 Bt, nblk, n_rows, layer, scale, stream)
  if (D <= 32) return PADDLE_FLAT_LAUNCH(1);
  if (D <= 64) return PADDLE_FLAT_LAUNCH(2);
  if (D <= 128) return PADDLE_FLAT_LAUNCH(4);
  return PADDLE_FLAT_LAUNCH(8);
#undef PADDLE_FLAT_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 1 = split_kv
// (bf16 or fp16, D a multiple of 8; splits S >= 1 ranges of span positions
// each, S = ceil(nblk * Bt / span); work: fp32 [S * T * H * (D + 2)] when
// S > 1; q, pool and out 16-byte aligned), 0 = per_head (splits 1; work
// unused); any other pairing returns cudaErrorInvalidValue. Returns a
// cudaError_t (0 on success); the caller has validated shapes, devices and
// layout.
extern "C" int paddle_decode_attention_paged_flat(
    const void* q, const void* pool, const void* tables, const void* cslot,
    const void* cbase, const void* cn, void* out, void* work, int T, int H,
    int D, int NB, int Hk, int Bt, int nblk, int n_rows, int layer,
    int splits, int span, float scale, int dtype, int path, void* stream) {
  if (T < kChunk || T % kChunk || H < 1 || D < 1 || D > 256 || Hk < 1 ||
      H % Hk || NB < 1 || Bt < 1 || (Bt > kTile && Bt % kTile) || nblk < 1 ||
      n_rows < 1 || splits < 1 || splits > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return paddle_attn::split::run<false, false, true>(
        q, paddle_attn::split::layer_planes(pool, nullptr, layer, NB, Hk, Bt,
                                            D, 2),
        tables, cbase, out, work, T / kChunk, H, kChunk, D, NB, Hk, Bt, nblk,
        splits, span, scale, dtype, s, paddle_attn::split::NewRow{},
        paddle_attn::split::FlatMeta{static_cast<const int*>(cslot),
                                     static_cast<const int*>(cn), n_rows});
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, pool, tables, cslot, cbase, cn, out, T,
                                  H, D, NB, Hk, Bt, nblk, n_rows, layer,
                                  scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, pool, tables, cslot, cbase, cn,
                                          out, T, H, D, NB, Hk, Bt, nblk,
                                          n_rows, layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, pool, tables, cslot, cbase, cn, out, T,
                                   H, D, NB, Hk, Bt, nblk, n_rows, layer,
                                   scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
