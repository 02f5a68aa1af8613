// Flash-decode attention over the dense KV ring, for Hopper (sm_90a), plain
// C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_stacked (_stacked_kernel + _online_softmax_block): the
// new queries of each row attend, block-causally, to layer `layer`'s prefix
// of the row's ring, which the multi-layer decode loop keeps as one
// stacked buffer; the layer is an argument, so no per-layer copy is made.
//
//   q      [B, H, Sq, D]             (Sq <= 128, D <= 256)
//   ring   [L, 2, B, Hk, Smax, D]    same dtype as q (fp32, bf16 or fp16)
//   lens   [B] int32                 query row r attends positions <= lens+r
//   out    [B, H, Sq, D]             q's dtype
//
// Semantics kept from the TPU kernel: scores and the softmax state are
// fp32, p is rounded to the value dtype before the PV product while l sums
// the unrounded p; a row whose softmax sum is 0 returns 0; positions past
// the last attendable one are never read (the TPU kernel's last-valid-block
// clamp; here the walk stops there).
//
// What bounds it on the card: bytes. A decode step reads the row's valid
// prefix once per KV head and does 4*D flops per position and query row,
// far below the H100's ~295 flop/byte ridge.
//
// Two designs, as the int8 ring's: the wrapper picks one (ops/
// decode_attention.py's paged_path) and passes it as `path`; the entry runs
// that design or fails:
// - path 1, "split_kv" (bf16 and fp16, D a multiple of 8): the fp flavor of
//   split_decode.cuh with the ring read as a pool of B blocks of Smax
//   positions and no table (row b's block is b, layer `layer`'s K and V
//   planes its two bases): S ranges of `span` positions (a multiple of 64;
//   the wrapper's decode_splits) per (row, KV head), each block holding the
//   GQA group's query rows, 64-position K/V tiles staged by cp.async,
//   products on mma.sync, then the merge of the S fp32 partials in `work`.
// - path 0, "per_head" (fp32, or D not a multiple of 8): one thread block
//   per (row, head); a ring row [Smax, D] of one (layer, kv, row, kv head)
//   is contiguous, so the walk stages 32 positions at a time straight from
//   it as fp32, with 16-byte loads, four per thread in flight
//   (attention_tile.cuh, shared with the paged kernels); four warps each
//   own four query rows of a 16-row pass with an fp32 online softmax in
//   registers. GQA heads of one KV head re-read the same row (from L2).
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    stacked_kernel(const T* __restrict__ q, const T* __restrict__ ring,
                   const int* __restrict__ lens, T* __restrict__ out, int B,
                   int H, int Sq, int D, int Hk, int Smax, int layer,
                   float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                    // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;         // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;         // [kRowsPerPass][Dp]
  float* ps = qs + kRowsPerPass * Dp;  // [kRowsPerPass][kTile]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const size_t row = (size_t)Smax * D;
  const T* kr = ring + (((size_t)layer * 2 * B + b) * Hk + hk) * row;
  const T* vr = ring + ((((size_t)layer * 2 + 1) * B + b) * Hk + hk) * row;
  const T* q_bh = q + ((size_t)b * H + h) * Sq * D;
  T* o_bh = out + ((size_t)b * H + h) * Sq * D;

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

    // the last position any row of this pass attends; the ring ends at Smax
    const int last_pos = min(len + r0 + nrows - 1, Smax - 1);
    walk_row<T, T, kRowsPerWarp, DPL, false>(
        ks, vs, nullptr, nullptr, qs + warp * kRowsPerWarp * Dp,
        ps + warp * kRowsPerWarp * kTile, kr, vr, nullptr, nullptr, last_pos,
        D, Dp, vec, limit, scale, m, l, acc);

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
cudaError_t launch(const void* q, const void* ring, const void* lens,
                   void* out, int B, int H, int Sq, int D, int Hk, int Smax,
                   int layer, float scale, cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kTile * (Dp + 1) + kRowsPerPass * Dp +
                               kRowsPerPass * kTile) *
                      sizeof(float);
  auto kernel = stacked_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ring),
      static_cast<const int*>(lens), static_cast<T*>(out), B, H, Sq, D, Hk,
      Smax, layer, scale, vec_ok<T>(D, ring, ring));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* ring, const void* lens,
                     void* out, int B, int H, int Sq, int D, int Hk,
                     int Smax, int layer, float scale, cudaStream_t stream) {
#define PADDLE_STACKED_LAUNCH(DPL) \
  launch<T, DPL>(q, ring, lens, out, B, H, Sq, D, Hk, Smax, layer, scale, \
                 stream)
  if (D <= 32) return PADDLE_STACKED_LAUNCH(1);
  if (D <= 64) return PADDLE_STACKED_LAUNCH(2);
  if (D <= 128) return PADDLE_STACKED_LAUNCH(4);
  return PADDLE_STACKED_LAUNCH(8);
#undef PADDLE_STACKED_LAUNCH
}

}  // namespace

// dtype (of q, ring and out): 0 = float32, 1 = bfloat16, 2 = float16.
// path: 1 = split_kv (bf16 or fp16, D a multiple of 8; splits S >= 1
// ranges of span positions each, S = ceil(Smax / span); work: fp32 [S * B
// * H * Sq * (D + 2)] when S > 1; q, out and the ring 16-byte aligned), 0
// = per_head (splits 1; work unused); any other pairing returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_stacked(
    const void* q, const void* ring, const void* lens, void* out,
    void* work, int B, int H, int Sq, int D, int Hk, int Smax, int layer,
    int splits, int span, float scale, int dtype, int path, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > 128 || D < 1 || D > 256 || Hk < 1 ||
      H % Hk || Smax < 1 || layer < 0 || splits < 1 || splits > 65535 ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1)  // the ring as a pool of B blocks of Smax positions
    return paddle_attn::split::run<false>(
        q, paddle_attn::split::layer_planes(ring, nullptr, layer, B, Hk,
                                            Smax, D, 2),
        nullptr, lens, out, work, B, H, Sq, D, B, Hk, Smax, 1, splits, span,
        scale, dtype, s);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, ring, lens, out, B, H, Sq, D, Hk, Smax,
                                  layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, ring, lens, out, B, H, Sq, D,
                                          Hk, Smax, layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, ring, lens, out, B, H, Sq, D, Hk, Smax,
                                   layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
