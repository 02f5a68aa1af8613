// Fused write + flash-decode attention over the dense KV ring, for Hopper
// (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_stacked_write (_stacked_write_kernel): one new token
// per row lands its K/V row in layer `layer`'s ring at position lens[b], in
// place, and its query attends the row's prefix [0, lens[b]) plus itself
// in the same launch.
//
//   q       [B, H, 1, D]             (D <= 256)
//   kv_new  [2, B, Hk, 1, D]         the new token's K (0) and V (1) rows
//   ring    [L, 2, B, Hk, Smax, D]   written in place at position lens[b]
//   lens    [B] int32
//   out     [B, H, 1, D]             q, kv_new, ring and out share a dtype
//
// Semantics kept from the TPU kernel: the online softmax is seeded with the
// new token's own column from kv_new (m = q . k_new * scale, l = 1, acc =
// v_new), then walks the prefix positions < lens[b] only (the `exclusive`
// mask), so no launch ever reads the position being written; scores and the
// softmax state are fp32 and p is rounded to the value dtype before the PV
// product. A full row (lens[b] == Smax) drops the write and still returns
// the seeded term.
//
// What bounds it on the card: bytes, as the read kernel: the prefix once
// per KV head plus one K/V row written.
//
// Two designs, as the read's: the wrapper picks one (ops/
// decode_attention.py's paged_path) and passes it as `path`; the entry runs
// that design or fails:
// - path 1, "split_kv" (bf16 and fp16, D a multiple of 8): split_decode.cuh's
//   fp flavor in its write mode, the ring's layer read as a pool of B blocks
//   of Smax positions with no table. The ranges are exclusive: S ranges of
//   `span` positions (the wrapper's decode_splits) per (row, KV head), each
//   cut at lens[b], so every load zero-fills position lens[b] and none
//   reads it. The designated block of each (row, KV head), range 0, stores
//   the new K/V row there once (a full row drops it), seeds its GQA group's
//   query rows with the new column before its walk, and writes the seeded
//   partial even where the prefix is empty; with S > 1 the merge combines
//   the partials in `work`. The store races no read: no block loads that
//   position. One split launch plus at most one merge launch a call.
// - path 0, "per_head" (fp32, or D not a multiple of 8): one thread block
//   per (row, head), the 32-position walk over the contiguous ring row
//   (attention_tile.cuh); with Sq = 1 only the first warp holds a query
//   row. Several query heads share a KV head under GQA, so exactly one of
//   them (h % (H / Hk) == 0) stores the row; the others only read positions
//   below it, so no launch races the store.
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    stacked_write_kernel(const T* __restrict__ q, const T* __restrict__ kv_new,
                         T* __restrict__ ring, const int* __restrict__ lens,
                         T* __restrict__ out, int B, int H, int D, int Hk,
                         int Smax, int layer, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                    // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;         // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;         // [kRowsPerPass][Dp], row 0 used
  float* ps = qs + kRowsPerPass * Dp;  // [kRowsPerPass][kTile]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int group = H / Hk;
  const int hk = h / group;
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const size_t row = (size_t)Smax * D;
  T* kr = ring + (((size_t)layer * 2 * B + b) * Hk + hk) * row;
  T* vr = ring + ((((size_t)layer * 2 + 1) * B + b) * Hk + hk) * row;
  const T* kn = kv_new + ((size_t)b * Hk + hk) * D;
  const T* vn = kv_new + (((size_t)B + b) * Hk + hk) * D;
  const T* q_bh = q + ((size_t)b * H + h) * D;

  for (int i = threadIdx.x; i < kRowsPerPass * Dp; i += blockDim.x)
    qs[i] = i < D ? to_f(q_bh[i]) : 0.f;
  __syncthreads();

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    // the one query row attends the prefix [0, len): positions <= len - 1
    limit[rr] = (warp == 0 && rr == 0) ? len - 1 : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }
  if (warp == 0) {
    // seed the running state with the new token's own column
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[d], to_f(kn[d]), s);
    m[0] = warp_sum(s) * scale;
    l[0] = 1.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[0][i] = d < D ? to_f(vn[d]) : 0.f;
    }
  }

  walk_row<T, T, kRowsPerWarp, DPL, false>(
      ks, vs, nullptr, nullptr, qs + warp * kRowsPerWarp * Dp,
      ps + warp * kRowsPerWarp * kTile, kr, vr, nullptr, nullptr,
      min(len, Smax) - 1, D, Dp, vec, limit, scale, m, l, acc);

  if (warp == 0) {
    T* o = out + ((size_t)b * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f<T>(acc[0][i] / l[0]);
    }
  }
  if (h % group == 0 && len < Smax) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      kr[(size_t)len * D + d] = kn[d];
      vr[(size_t)len * D + d] = vn[d];
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kv_new, void* ring,
                   const void* lens, void* out, int B, int H, int D, int Hk,
                   int Smax, int layer, float scale, cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kTile * (Dp + 1) + kRowsPerPass * Dp +
                               kRowsPerPass * kTile) *
                      sizeof(float);
  auto kernel = stacked_write_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new),
      static_cast<T*>(ring), static_cast<const int*>(lens),
      static_cast<T*>(out), B, H, D, Hk, Smax, layer, scale,
      vec_ok<T>(D, ring, ring));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* kv_new, void* ring,
                     const void* lens, void* out, int B, int H, int D,
                     int Hk, int Smax, int layer, float scale,
                     cudaStream_t stream) {
#define PADDLE_STACKED_WRITE_LAUNCH(DPL)                                  \
  launch<T, DPL>(q, kv_new, ring, lens, out, B, H, D, Hk, Smax, layer, \
                 scale, stream)
  if (D <= 32) return PADDLE_STACKED_WRITE_LAUNCH(1);
  if (D <= 64) return PADDLE_STACKED_WRITE_LAUNCH(2);
  if (D <= 128) return PADDLE_STACKED_WRITE_LAUNCH(4);
  return PADDLE_STACKED_WRITE_LAUNCH(8);
#undef PADDLE_STACKED_WRITE_LAUNCH
}

}  // namespace

// dtype (of q, kv_new, ring and out): 0 = float32, 1 = bfloat16,
// 2 = float16. path: 1 = split_kv (bf16 or fp16, D a multiple of 8; splits
// S >= 1 ranges of span positions each, S = ceil(Smax / span); work: fp32
// [S * B * H * (D + 2)] when S > 1; q, out and the ring 16-byte aligned), 0
// = per_head (splits 1; work unused); any other pairing returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_stacked_write(
    const void* q, const void* kv_new, void* ring, const void* lens,
    void* out, void* work, int B, int H, int D, int Hk, int Smax, int layer,
    int splits, int span, float scale, int dtype, int path, void* stream) {
  if (B < 1 || H < 1 || D < 1 || D > 256 || Hk < 1 || H % Hk || Smax < 1 ||
      layer < 0 || splits < 1 || splits > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {  // the ring as a pool of B blocks of Smax positions
    // kv_new [2, B, Hk, 1, D] in the ring's 2-byte dtype: its K and V rows
    const char* kn = static_cast<const char*>(kv_new);
    const paddle_attn::split::NewRow nr{kn, kn + (size_t)B * Hk * D * 2};
    return paddle_attn::split::run<false, true>(
        q, paddle_attn::split::layer_planes(ring, nullptr, layer, B, Hk,
                                            Smax, D, 2),
        nullptr, lens, out, work, B, H, 1, D, B, Hk, Smax, 1, splits, span,
        scale, dtype, s, nr);
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, kv_new, ring, lens, out, B, H, D, Hk,
                                  Smax, layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, kv_new, ring, lens, out, B, H,
                                          D, Hk, Smax, layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, kv_new, ring, lens, out, B, H, D, Hk,
                                   Smax, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
