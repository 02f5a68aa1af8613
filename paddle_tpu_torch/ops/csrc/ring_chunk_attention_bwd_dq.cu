// Ring attention's chunk backward, dQ half, for Hopper (sm_90a), plain C
// interface.
//
// Replaces paddle_tpu/ops/pallas/ring_chunk_attention.py::_bwd_dq_kernel
// (pallas_call :321 in _vjp_bwd): the dQ of one ring step from the
// cotangents (dO, dlse) of its (o, lse), with dlse folded into delta =
// rowsum(dO * O) - dlse by the wrapper (a torch op, as JAX's XLA op
// outside its kernels): ds = P * (dP - delta) * scale, dq = ds K, ds
// rounded to k's dtype before the product, fp32 sums, dq in q's dtype.
//
//   q, dout [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k, v    [B, Hk, Sk, D]    q's dtype; head h reads h / (H/Hk)
//   lse     [B, H, Sq]        fp32, the chunk forward's (-1e30: no key)
//   delta   [B, H, Sq]        fp32, rowsum(dO * O) - dlse
//   dq      [B, H, Sq, D]     q's dtype
//
// Row i sees key j iff j <= i + offset. A row that sees no key gets dq = 0
// and never evaluates exp(s - lse) (inf at lse = -1e30, and inf * 0 NaN:
// JAX selects with jnp.where); a launch whose offset masks everything
// writes zeros without reading a key.
//
// What bounds it on the card: operations (6 * H * Sq * Sk * D at full
// offset, half on the diagonal). Design: flash_bwd_dq.cuh's kernels with
// the offset an argument (bf16 and fp16 at D 64 and 128 on the tensor
// cores, fp32 on the fp32 cores): one block per (b, h, 64-row q tile),
// key tiles past its last seen key skipped.
#include "flash_bwd_dq.cuh"

// tc: 1 = the tensor-core kernel (bf16 / fp16 at D 64 and 128 only; else
// cudaErrorInvalidValue), 0 = the fp32-core kernel, as the wrapper chose
// (ops/flash_attention.py's kernel_path).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0
// on success); the caller has validated shapes, devices and layout and
// clamped the offset to [-Sq, Sk].
extern "C" int paddle_ring_chunk_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hk,
    int Sq, int Sk, int D, int offset, float scale, int dtype, int tc,
    void* stream) {
  using namespace paddle_attn;
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || offset < -Sq || offset > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return (int)flash_bwd_dq::launch<float, false, true>(
          q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    case 1:
      return (int)flash_bwd_dq::launch<__nv_bfloat16, false, true>(
          q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    case 2:
      return (int)flash_bwd_dq::launch<__half, false, true>(
          q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
