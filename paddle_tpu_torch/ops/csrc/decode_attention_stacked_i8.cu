// Flash-decode attention over an int8 dense KV ring, for Hopper (sm_90a),
// plain C interface.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::
// decode_attention_stacked_i8 (_stacked_i8_kernel + _online_softmax_block
// with column scales): decode_attention_stacked over an int8 ring whose
// every position carries an fp32 K and V scale.
//
//   q      [B, H, Sq, D]             fp32, bf16 or fp16 (Sq <= 128, D <= 256)
//   ring   [L, 2, B, Hk, Smax, D]    int8
//   scales [L, 2, B, Hk, 1, Smax]    fp32, positions on the last axis
//   lens   [B] int32                 query row r attends positions <= lens+r
//   out    [B, H, Sq, D]             q's dtype
//
// Semantics kept from the TPU kernel: the int8 values convert exactly to
// the compute type; the score is (q . k) * scale * k_scale in fp32; after
// the online-softmax update p * v_scale is rounded to q's dtype before the
// PV product, while l sums the unscaled p; positions past the last
// attendable one are never read; a row whose softmax sum is 0 returns 0.
//
// What bounds it on the card: bytes, one byte per element plus 4 bytes of
// scale per position (68 of 128 bytes per K/V row at D = 64, against bf16),
// at 4*D flops per position and query row.
//
// Two designs, as the int8 pool's: the wrapper picks one (ops/
// decode_attention.py's paged_path) and passes it as `path`; the entry runs
// that design or fails:
// - path 1, "split_kv" (bf16 and fp16 queries, D a multiple of 8): the int8
//   flavor of split_decode.cuh with the ring read as a pool of B blocks of
//   Smax positions and no table (row b's block is b): S ranges of `span`
//   positions (a multiple of 64; the wrapper's decode_splits, the pool's
//   rule over the same positions) per (row, KV head), each block holding
//   the GQA group's query rows, int8 tiles and scales staged by cp.async,
//   converted per warp in shared memory, products on mma.sync, then the
//   merge of the S fp32 partials in `work`.
// - path 0, "per_head" (fp32 queries, or D not a multiple of 8): the fp
//   stacked kernel's design (one thread block per (row, head), a
//   32-position walk over the contiguous ring row, four warps of four query
//   rows), with 16-byte loads that carry 16 int8 values each and the tile's
//   32 K and 32 V scales staged beside it (attention_tile.cuh's scaled tile
//   update, shared with the int8 paged kernels).
#include "attention_tile.cuh"
#include "split_decode.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    stacked_i8_kernel(const T* __restrict__ q,
                      const int8_t* __restrict__ ring,
                      const float* __restrict__ scales,
                      const int* __restrict__ lens, T* __restrict__ out,
                      int B, int H, int Sq, int D, int Hk, int Smax,
                      int layer, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                    // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;         // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;         // [kRowsPerPass][Dp]
  float* ps = qs + kRowsPerPass * Dp;  // [kRowsPerPass][kTile]
  float* kss = ps + kRowsPerPass * kTile;  // [kTile] K scales
  float* vss = kss + kTile;                // [kTile] V scales

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int len = lens[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const size_t row = (size_t)Smax * D;
  const size_t k_row = ((size_t)layer * 2 * B + b) * Hk + hk;
  const size_t v_row = (((size_t)layer * 2 + 1) * B + b) * Hk + hk;
  const int8_t* kr = ring + k_row * row;
  const int8_t* vr = ring + v_row * row;
  const float* ksr = scales + k_row * Smax;
  const float* vsr = scales + v_row * Smax;
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
    walk_row<T, int8_t, kRowsPerWarp, DPL, true>(
        ks, vs, kss, vss, qs + warp * kRowsPerWarp * Dp,
        ps + warp * kRowsPerWarp * kTile, kr, vr, ksr, vsr, last_pos, D, Dp,
        vec, limit, scale, m, l, acc);

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
cudaError_t launch(const void* q, const void* ring, const void* scales,
                   const void* lens, void* out, int B, int H, int Sq, int D,
                   int Hk, int Smax, int layer, float scale,
                   cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem = (size_t)(2 * kTile * (Dp + 1) + kRowsPerPass * Dp +
                               kRowsPerPass * kTile + 2 * kTile) *
                      sizeof(float);
  auto kernel = stacked_i8_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(ring),
      static_cast<const float*>(scales), static_cast<const int*>(lens),
      static_cast<T*>(out), B, H, Sq, D, Hk, Smax, layer, scale,
      vec_ok<int8_t>(D, ring, ring));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* ring, const void* scales,
                     const void* lens, void* out, int B, int H, int Sq,
                     int D, int Hk, int Smax, int layer, float scale,
                     cudaStream_t stream) {
#define PADDLE_STACKED_LAUNCH(DPL)                                    \
  launch<T, DPL>(q, ring, scales, lens, out, B, H, Sq, D, Hk, Smax, layer, \
                 scale, stream)
  if (D <= 32) return PADDLE_STACKED_LAUNCH(1);
  if (D <= 64) return PADDLE_STACKED_LAUNCH(2);
  if (D <= 128) return PADDLE_STACKED_LAUNCH(4);
  return PADDLE_STACKED_LAUNCH(8);
#undef PADDLE_STACKED_LAUNCH
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16. path: 1 =
// split_kv (bf16 or fp16, D a multiple of 8; splits S >= 1 ranges of span
// positions each, S = ceil(Smax / span); work: fp32 [S * B * H * Sq * (D +
// 2)] when S > 1; q and out 16-byte aligned, the ring 16 (D a multiple of
// 16) or 8), 0 = per_head (splits 1; work unused); any other pairing
// returns cudaErrorInvalidValue. Returns a cudaError_t (0 on success); the
// caller has validated shapes, devices and layout.
extern "C" int paddle_decode_attention_stacked_i8(
    const void* q, const void* ring, const void* scales, const void* lens,
    void* out, void* work, int B, int H, int Sq, int D, int Hk, int Smax,
    int layer, int splits, int span, float scale, int dtype, int path,
    void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > 128 || D < 1 || D > 256 || Hk < 1 ||
      H % Hk || Smax < 1 || layer < 0 || splits < 1 || splits > 65535 ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1)  // the ring as a pool of B blocks of Smax positions
    return paddle_attn::split::run<true>(
        q, paddle_attn::split::layer_planes(ring, scales, layer, B, Hk, Smax,
                                            D, 1),
        nullptr, lens, out, work, B, H, Sq, D, B, Hk, Smax, 1, splits, span,
        scale, dtype, s);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, ring, scales, lens, out, B, H, Sq, D,
                                  Hk, Smax, layer, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, ring, scales, lens, out, B, H,
                                          Sq, D, Hk, Smax, layer, scale, s);
    case 2:
      return (int)launch_d<__half>(q, ring, scales, lens, out, B, H, Sq, D,
                                   Hk, Smax, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
