// Fused quantize + write + flash-decode attention over an int8 dense KV
// ring, for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_stacked_i8_write (_stacked_i8_write_kernel): one new
// token per row has its K and V rows quantized in the kernel (per-row
// absmax), lands them with their scales in layer `layer`'s ring at
// position lens[b], in place, and its query attends the row's prefix
// [0, lens[b]) plus itself in the same launch.
//
//   q       [B, H, 1, D]             fp32, bf16 or fp16 (D <= 256)
//   kv_new  [2, B, Hk, 1, D]         fp32, the new token's K (0) and V (1)
//   ring    [L, 2, B, Hk, Smax, D]   int8, written in place at lens[b]
//   scales  [L, 2, B, Hk, 1, Smax]   fp32, written in place at lens[b]
//   lens    [B] int32
//   out     [B, H, 1, D]             q's dtype
//
// Semantics kept from the TPU kernel: the row's quantization is the
// engine's absmax recipe bit for bit (s = amax / 127 in fp32; values
// rint(r / max(s, 1e-8)) clipped to [-127, 127], a true division and
// round-half-to-even); the softmax is seeded with the new column from the
// quantized values (score (q . k_int) * scale * k_scale, p = 1, acc =
// (1 * v_scale rounded to q's dtype) * v_int), then walks the prefix
// positions < lens[b] with the int8 read kernel's arithmetic. A full row
// (lens[b] == Smax) drops the write and still returns the seeded term.
//
// What bounds it on the card: bytes, as the int8 read kernel.
//
// Two designs, as the int8 read's: the wrapper picks one (ops/
// decode_attention.py's paged_path) and passes it as `path`; the entry runs
// that design or fails:
// - path 1, "split_kv" (bf16 and fp16 queries, D a multiple of 8):
//   split_decode.cuh's int8 flavor in its write mode, the ring's layer and
//   its scale planes read as a pool of B blocks of Smax positions with no
//   table. The ranges are exclusive: S ranges of `span` positions (the
//   wrapper's decode_splits) per (row, KV head), each cut at lens[b], so
//   every load zero-fills position lens[b] (rows and scales) and none reads
//   it. The designated block of each (row, KV head), range 0, quantizes the
//   new K and V rows once and stores them with their two scales there (a
//   full row drops them), seeds its GQA group's query rows with the new
//   column before its walk, and writes the seeded partial even where the
//   prefix is empty; with S > 1 the merge combines the partials in `work`.
//   The store races no read: no block loads that position. One split
//   launch plus at most one merge launch a call.
// - path 0, "per_head" (fp32 queries, or D not a multiple of 8): the fp
//   write kernel's (one thread block per (row, head), the 32-position walk
//   over the contiguous ring row with the tile's scales beside it); each
//   block quantizes the two D-element rows itself (warp 0 the K row, warp 1
//   the V row) into shared memory, and only the first head of each GQA
//   group (h % (H / Hk) == 0) stores them.
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    stacked_i8_write_kernel(const T* __restrict__ q,
                            const float* __restrict__ kv_new,
                            int8_t* __restrict__ ring,
                            float* __restrict__ scales,
                            const int* __restrict__ lens,
                            T* __restrict__ out, int B, int H, int D, int Hk,
                            int Smax, int layer, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                        // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;             // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;             // [kRowsPerPass][Dp], row 0 used
  float* ps = qs + kRowsPerPass * Dp;      // [kRowsPerPass][kTile]
  float* kss = ps + kRowsPerPass * kTile;  // [kTile] K scales
  float* vss = kss + kTile;                // [kTile] V scales
  float* newq = vss + kTile;               // [2][D] the quantized new rows
  float* news = newq + 2 * D;              // [2] their scales

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int group = H / Hk;
  const int hk = h / group;
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const size_t row = (size_t)Smax * D;
  const size_t k_row = ((size_t)layer * 2 * B + b) * Hk + hk;
  const size_t v_row = (((size_t)layer * 2 + 1) * B + b) * Hk + hk;
  int8_t* kr = ring + k_row * row;
  int8_t* vr = ring + v_row * row;
  float* ksr = scales + k_row * Smax;
  float* vsr = scales + v_row * Smax;
  const T* q_bh = q + ((size_t)b * H + h) * D;

  for (int i = threadIdx.x; i < kRowsPerPass * Dp; i += blockDim.x)
    qs[i] = i < D ? to_f(q_bh[i]) : 0.f;
  if (warp < 2) {
    // absmax quantization of the new K (warp 0) or V (warp 1) row
    const float* r = kv_new + (((size_t)warp * B + b) * Hk + hk) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(r[d]));
    const float s = warp_max(amax) / 127.0f;
    const float div = fmaxf(s, 1e-8f);
    for (int d = lane; d < D; d += 32)
      newq[warp * D + d] = fminf(fmaxf(rintf(r[d] / div), -127.f), 127.f);
    if (lane == 0) news[warp] = s;
  }
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
    // seed with the new token's own column, as the read kernel would score
    // it from the ring: (q . k_int) * scale * k_scale, p = 1
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[d], newq[d], s);
    m[0] = warp_sum(s) * scale * news[0];
    l[0] = 1.f;
    const float pv = to_f(from_f<T>(news[1]));
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[0][i] = d < D ? pv * newq[D + d] : 0.f;
    }
  }

  walk_row<T, int8_t, kRowsPerWarp, DPL, true>(
      ks, vs, kss, vss, qs + warp * kRowsPerWarp * Dp,
      ps + warp * kRowsPerWarp * kTile, kr, vr, ksr, vsr,
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
      kr[(size_t)len * D + d] = static_cast<int8_t>(newq[d]);
      vr[(size_t)len * D + d] = static_cast<int8_t>(newq[D + d]);
    }
    if (threadIdx.x == 0) {
      ksr[len] = news[0];
      vsr[len] = news[1];
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kv_new, void* ring,
                   void* scales, const void* lens, void* out, int B, int H,
                   int D, int Hk, int Smax, int layer, float scale,
                   cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kTile * (Dp + 1) + kRowsPerPass * Dp +
                               kRowsPerPass * kTile + 2 * kTile + 2 * D + 2) *
                      sizeof(float);
  auto kernel = stacked_i8_write_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(kv_new),
      static_cast<int8_t*>(ring), static_cast<float*>(scales),
      static_cast<const int*>(lens), static_cast<T*>(out), B, H, D, Hk, Smax,
      layer, scale, vec_ok<int8_t>(D, ring, ring));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* kv_new, void* ring,
                     void* scales, const void* lens, void* out, int B, int H,
                     int D, int Hk, int Smax, int layer, float scale,
                     cudaStream_t stream) {
#define PADDLE_STACKED_I8_WRITE_LAUNCH(DPL)                                   \
  launch<T, DPL>(q, kv_new, ring, scales, lens, out, B, H, D, Hk, Smax,    \
                 layer, scale, stream)
  if (D <= 32) return PADDLE_STACKED_I8_WRITE_LAUNCH(1);
  if (D <= 64) return PADDLE_STACKED_I8_WRITE_LAUNCH(2);
  if (D <= 128) return PADDLE_STACKED_I8_WRITE_LAUNCH(4);
  return PADDLE_STACKED_I8_WRITE_LAUNCH(8);
#undef PADDLE_STACKED_I8_WRITE_LAUNCH
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16. path: 1 =
// split_kv (bf16 or fp16, D a multiple of 8; splits S >= 1 ranges of span
// positions each, S = ceil(Smax / span); work: fp32 [S * B * H * (D + 2)]
// when S > 1; q and out 16-byte aligned, the ring 16 (D a multiple of 16)
// or 8), 0 = per_head (splits 1; work unused); any other pairing returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_stacked_i8_write(
    const void* q, const void* kv_new, void* ring, void* scales,
    const void* lens, void* out, void* work, int B, int H, int D, int Hk,
    int Smax, int layer, int splits, int span, float scale, int dtype,
    int path, void* stream) {
  if (B < 1 || H < 1 || D < 1 || D > 256 || Hk < 1 || H % Hk || Smax < 1 ||
      layer < 0 || splits < 1 || splits > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {  // the ring and its scales as a pool of B blocks
    // kv_new [2, B, Hk, 1, D] fp32: its K and V rows
    const float* kn = static_cast<const float*>(kv_new);
    const paddle_attn::split::NewRow nr{kn, kn + (size_t)B * Hk * D};
    return paddle_attn::split::run<true, true>(
        q, paddle_attn::split::layer_planes(ring, scales, layer, B, Hk, Smax,
                                            D, 1),
        nullptr, lens, out, work, B, H, 1, D, B, Hk, Smax, 1, splits, span,
        scale, dtype, s, nr);
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, kv_new, ring, scales, lens, out, B, H,
                                  D, Hk, Smax, layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, kv_new, ring, scales, lens, out,
                                          B, H, D, Hk, Smax, layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, kv_new, ring, scales, lens, out, B, H,
                                   D, Hk, Smax, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
