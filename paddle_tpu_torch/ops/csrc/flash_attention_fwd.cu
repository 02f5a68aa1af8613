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
// S = 4 * 295), operations at the training shapes (flash_fwd.cuh).
// Design: flash_fwd.cuh's (shared with the ring attention chunk
// forward): bf16 and fp16 at D 64 and 128 on the tensor cores (wgmma on
// 16-bit K/V tiles of 64 keys, double-buffered with cp.async, P from
// registers), fp32 and other D on the fp32 cores.
#include "flash_fwd.cuh"

namespace {

using namespace paddle_attn;

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                     int causal, float scale, DropParams drop, int dropout,
                     bool tc, cudaStream_t stream) {
  return dropout ? flash_fwd::launch<T, true, false>(
                       q, k, v, o, lse, B, H, Hk, Sq, Sk, D, causal, scale,
                       drop, tc, stream)
                 : flash_fwd::launch<T, false, false>(
                       q, k, v, o, lse, B, H, Hk, Sq, Sk, D, causal, scale,
                       drop, tc, stream);
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

// tc: 1 = the tensor-core kernel (bf16 / fp16 at D 64 and 128 only; else
// cudaErrorInvalidValue), 0 = the fp32-core kernel, as the wrapper chose
// (ops/flash_attention.py's kernel_path).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. dropout: 0 = none, else
// keep iff the draw >= thresh, kept values times inv_keep, the draws keyed
// by (seed_lo, seed_hi). Returns a cudaError_t (0 on success); the caller
// has validated shapes, devices and layout.
extern "C" int paddle_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int H, int Hk, int Sq,
                                          int Sk, int D, int causal,
                                          float scale, int dtype, int tc,
                                          int dropout,
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
                                  causal, scale, drop, dropout, tc, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, Sq, Sk,
                                          D, causal, scale, drop, dropout,
                                          tc, s);
    case 2:
      return (int)launch_t<__half>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                   causal, scale, drop, dropout, tc, s);
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
