// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd (_fwd_kernel,
// the forward half of flash_attention): FA-2 forward with causal masking,
// GQA/MQA, ragged sequence tails and attention dropout, returning the
// output and the row log-sum-exp that the backward kernels read.
//
//   q   [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k,v [B, Hk, Sk, D]    q's dtype; Hk divides H, head h reads h / (H/Hk)
//   o   [B, H, Sq, D]     q's dtype
//   lse [B, H, Sq]        fp32
//
// Semantics kept from the TPU kernel: causal masking is aligned bottom-
// right (row i attends key j iff j <= i + Sk - Sq); key tiles wholly above
// the diagonal are skipped; scores, m and l are fp32; p is rounded to v's
// dtype before the PV product; o = acc / l with l == 0 read as 1, and
// lse = m + log(l) with the same guard, so a row that attends nothing
// returns o = 0 and lse = -1e30. Dropout (p > 0) multiplies the p that
// enter the PV product by keep / (1 - p) and leaves l the sum of the raw p
// (post-normalization dropout, as the TPU kernel); the keep bits come from
// dropout.cuh's hash of (seed, b, h, q_pos, k_pos), which the backward
// kernels regenerate. paddle_flash_dropout_mask writes those bits out, so a
// check can hold them byte for byte against the plain version's.
//
// What bounds it on the card: by the roofline, bytes at the bulk
// prefill's shapes, narrowly (a causal pass does 2*D*S^2 flops per head
// against 8*S*D bytes of bf16 q, k, v and o, so operations lead only past
// S = 4 * 295); in practice the arithmetic, since the plain version and
// SDPA use the tensor cores and this kernel does not.
// Design: one thread block per (b, h, 64-row q tile); K/V tiles of 32
// keys staged as fp32 in shared memory with 16-byte loads issued in
// batches; eight warps, each owning eight query rows whose dot products
// share every key read and whose fp32 online softmax lives in registers (attention_tile.cuh, shared with the flat paged kernel); the
// products run on the fp32 cores, so fp32 inputs never go through TF32.
// wgmma on bf16 tiles fed by TMA is the next step.
#include "attention_tile.cuh"

namespace {

using namespace paddle_attn;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kQTile = kWarps * kRowsPerWarp;  // 64 query rows per block

template <typename T, int DPL, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                     int D, int causal, float scale, DropParams drop,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = round4(D);
  const int ld = Dp + 1;
  float* ks = smem;                 // [kTile][Dp + 1]
  float* vs = ks + kTile * ld;      // [kTile][Dp + 1]
  float* qs = vs + kTile * ld;      // [kQTile][Dp]
  float* ps = qs + kQTile * Dp;     // [kQTile][kTile]

  const int n_qt = (Sq + kQTile - 1) / kQTile;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kQTile;
  const int nrows = min(kQTile, Sq - q0);
  const int offset = Sk - Sq;

  const T* q_t = q + (((size_t)b * H + h) * Sq + q0) * D;
  const T* k_bh = k + ((size_t)b * Hk + hk) * Sk * D;
  const T* v_bh = v + ((size_t)b * Hk + hk) * Sk * D;
  stage_rows(qs, q_t, nrows, kQTile, D, Dp, Dp);

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    // the last key this row attends; -1 for rows past Sq
    limit[rr] = row < Sq ? (causal ? min(row + offset, Sk - 1) : Sk - 1)
                         : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // tiles past the tile's last attended key are skipped
  const int last = causal ? min(q0 + nrows - 1 + offset, Sk - 1) : Sk - 1;
  for (int c0 = 0; c0 <= last; c0 += kTile) {
    const int n = min(kTile, Sk - c0);
    __syncthreads();  // everyone is done with the previous tile
    stage_kv(ks, vs, k_bh + (size_t)c0 * D, v_bh + (size_t)c0 * D, n, D, Dp,
             ld, vec);
    __syncthreads();
    tile_update<T, kRowsPerWarp, DPL, false, kDrop>(
        qs + warp * kRowsPerWarp * Dp, ks, vs,
        ps + warp * kRowsPerWarp * kTile, D, Dp, c0, n, limit, scale, m, l,
        acc, nullptr, nullptr, &drop, (uint32_t)bh,
        q0 + warp * kRowsPerWarp);
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= Sq) continue;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    const size_t r_idx = ((size_t)b * H + h) * Sq + row;
    T* o_r = o + r_idx * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o_r[d] = from_f<T>(acc[rr][i] / denom);
    }
    if (lane == 0) lse[r_idx] = m[rr] + logf(denom);
  }
}

template <typename T, int DPL, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                   int causal, float scale, DropParams drop,
                   cudaStream_t stream) {
  const int Dp = round4(D);
  const size_t smem =
      (size_t)(2 * kTile * (Dp + 1) + kQTile * Dp + kQTile * kTile) *
      sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPL, kDrop>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)B * H * ((Sq + kQTile - 1) / kQTile);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hk, Sq, Sk, D, causal, scale, drop, vec_ok<T>(D, k, v));
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                     int causal, float scale, DropParams drop,
                     cudaStream_t stream) {
#define PADDLE_FLASH_LAUNCH(DPL)                                          \
  launch<T, DPL, kDrop>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D, causal, scale, \
                        drop, stream)
  if (D <= 32) return PADDLE_FLASH_LAUNCH(1);
  if (D <= 64) return PADDLE_FLASH_LAUNCH(2);
  if (D <= 128) return PADDLE_FLASH_LAUNCH(4);
  return PADDLE_FLASH_LAUNCH(8);
#undef PADDLE_FLASH_LAUNCH
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                     int causal, float scale, DropParams drop, int dropout,
                     cudaStream_t stream) {
  return dropout ? launch_d<T, true>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                     causal, scale, drop, stream)
                 : launch_d<T, false>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                      causal, scale, drop, stream);
}

// One thread per (b * H + h, q_pos / 4, k_pos): the keep bits of four rows.
__global__ void dropout_mask_kernel(uint8_t* __restrict__ mask, int Sq,
                                    int Sk, long long n, DropParams drop) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = (int)(i % Sk);
  const long long r = i / Sk;
  const int sq4 = (Sq + 3) / 4;
  const int row4 = (int)(r % sq4);
  const uint32_t bh = (uint32_t)(r / sq4);
  const uint4 bits = drop_bits(drop, bh, row4, col);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 4 * row4 + j;
    if (row < Sq)
      mask[((size_t)bh * Sq + row) * Sk + col] = word(bits, j) >= drop.thresh;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. dropout: 0 = none, else
// keep iff the draw >= thresh, kept values times inv_keep, the draws keyed
// by (seed_lo, seed_hi). Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int H, int Hk, int Sq,
                                          int Sk, int D, int causal,
                                          float scale, int dtype, int dropout,
                                          unsigned seed_lo, unsigned seed_hi,
                                          unsigned thresh, float inv_keep,
                                          void* stream) {
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropParams drop{seed_lo, seed_hi, thresh, inv_keep};
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                  causal, scale, drop, dropout, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, Sq, Sk,
                                          D, causal, scale, drop, dropout, s);
    case 2:
      return (int)launch_t<__half>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                   causal, scale, drop, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The keep bits the kernels draw, as uint8 [B, H, Sq, Sk] (1 = kept): the
// check that holds them against the plain version's, byte for byte.
extern "C" int paddle_flash_dropout_mask(void* mask, int B, int H, int Sq,
                                         int Sk, unsigned seed_lo,
                                         unsigned seed_hi, unsigned thresh,
                                         void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * ((Sq + 3) / 4) * Sk;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dropout_mask_kernel<<<(unsigned)blocks, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), Sq, Sk, n,
      DropParams{seed_lo, seed_hi, thresh, 1.f});
  return (int)cudaGetLastError();
}
