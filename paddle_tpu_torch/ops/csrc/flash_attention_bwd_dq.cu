// Flash attention backward, dQ half, for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel (the
// dQ half of the split backward, pallas_call :589) and the dQ output of
// _bwd_fused_kernel (:470), which the TPU takes when one tile covers the
// sequence: both compute, per query row i,
//   p_ij  = exp(scale * q_i . k_j - lse_i)           (masked: 0)
//   dp_ij = (dO_i . v_j) * keep_ij / (1 - p)          (dropout; else 1)
//   ds_ij = p_ij * (dp_ij - delta_i) * scale,  delta_i = rowsum(dO_i * o_i)
//   dq_i  = sum_j ds_ij k_j
// with ds rounded to k's dtype before the product and fp32 sums.
//
//   q, dout [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k, v    [B, Hk, Sk, D]    q's dtype; head h reads h / (H/Hk)
//   lse     [B, H, Sq]        fp32, the forward's (row guard -1e30)
//   delta   [B, H, Sq]        fp32, rowsum(dO * O) (a torch op, as the TPU
//                             computes it in XLA outside its kernels)
//   dq      [B, H, Sq, D]     q's dtype
//
// Causal masking is aligned bottom-right like the forward's (row i sees key
// j iff j <= i + Sk - Sq); a row that sees no key gets ds = 0, so dq = 0,
// and its lse guard never enters an exp. The keep bits are regenerated from
// dropout.cuh's hash of (seed, b, h, q_pos, k_pos), equal to the forward's.
//
// What bounds it on the card: operations (three S-sized products of D-deep
// dots against 2 * S * D reads per head). Design: flash_bwd_dq.cuh's
// (shared with the ring attention chunk backward): one block per (b, h,
// 64-row q tile); bf16 and fp16 at D 64 and 128 on the tensor cores
// (three wgmma products a key tile, dS as the register A operand), fp32
// and other D on the fp32 cores.
#include "flash_bwd_dq.cuh"

namespace {

using namespace paddle_attn;

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int B, int H, int Hk, int Sq, int Sk, int D,
                     int causal, float scale, DropParams drop, int dropout,
                     bool tc, cudaStream_t stream) {
  return dropout ? flash_bwd_dq::launch<T, true, false>(
                       q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Sk, D,
                       causal, scale, drop, tc, stream)
                 : flash_bwd_dq::launch<T, false, false>(
                       q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Sk, D,
                       causal, scale, drop, tc, stream);
}

}  // namespace

// tc: 1 = the tensor-core kernel (bf16 / fp16 at D 64 and 128 only; else
// cudaErrorInvalidValue), 0 = the fp32-core kernel, as the wrapper chose
// (ops/flash_attention.py's kernel_path).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; dropout as in
// paddle_flash_attention_fwd. Returns a cudaError_t (0 on success); the
// caller has validated shapes, devices and layout.
extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hk,
    int Sq, int Sk, int D, int causal, float scale, int dtype, int tc,
    int dropout, unsigned seed_lo, unsigned seed_hi, unsigned thresh,
    float inv_keep, void* stream) {
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropParams drop{seed_lo, seed_hi, thresh, inv_keep};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Sk,
                                  D, causal, scale, drop, dropout, tc, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, H, Hk,
                                          Sq, Sk, D, causal, scale, drop,
                                          dropout, tc, s);
    case 2:
      return (int)launch_t<__half>(q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Sk,
                                   D, causal, scale, drop, dropout, tc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
