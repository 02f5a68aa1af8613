// Ring attention's chunk backward, dK/dV half, for Hopper (sm_90a), plain
// C interface.
//
// Replaces paddle_tpu/ops/pallas/ring_chunk_attention.py::_bwd_dkv_kernel
// (pallas_call :299 in _vjp_bwd): the dK/dV of one ring step, q chunk
// against one K/V chunk under the step's diagonal offset, from the
// cotangents of both of the forward's outputs (dO, dlse). The lse
// cotangent folds into the delta exactly (ds = P * (dP - rowsum(dO * O) +
// dlse)), so the wrapper hands the kernel delta = rowsum(dO * O) - dlse,
// a torch op as JAX's XLA op outside its kernels, and the kernel is the
// flash backward's. dK and dV are summed over a GQA group in fp32 and cast
// to k's dtype once (the TPU kernel writes per-head fp32 and sums after).
//
//   q, dout [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k, v    [B, Hk, Sk, D]    q's dtype; Hk divides H
//   lse     [B, H, Sq]        fp32, the chunk forward's (-1e30: no key)
//   delta   [B, H, Sq]        fp32, rowsum(dO * O) - dlse
//   dk, dv  [B, Hk, Sk, D]    k's dtype
//
// Row i sees key j iff j <= i + offset. A masked element never evaluates
// exp(s - lse): a fully masked row has lse = -1e30, where the exp would be
// inf and inf * 0 NaN (JAX selects with jnp.where); a launch whose offset
// masks everything writes dk = dv = 0 without reading a q tile.
//
// What bounds it on the card: operations (8 * H * Sq * Sk * D at full
// offset, half on the diagonal). Design: flash_bwd_dkv.cuh's kernels with
// the offset an argument (bf16 and fp16 at D 64 and 128 on the tensor
// cores, fp32 on the fp32 cores): one block per (b, kv head, key tile)
// that owns its rows (no atomics), walks the GQA group and the q tiles
// from the first row that sees its first key, with P recomputed from
// lse.
#include "flash_bwd_dkv.cuh"

// tc: 1 = the tensor-core kernel (bf16 / fp16 at D 64 and 128 only; else
// cudaErrorInvalidValue), 0 = the fp32-core kernel, as the wrapper chose
// (ops/flash_attention.py's kernel_path).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0
// on success); the caller has validated shapes, devices and layout and
// clamped the offset to [-Sq, Sk].
extern "C" int paddle_ring_chunk_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hk, int Sq, int Sk, int D, int offset, float scale, int dtype, int tc,
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
      return (int)flash_bwd_dkv::launch<float, false, true>(
          q, k, v, dout, l, dl, dk, dv, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    case 1:
      return (int)flash_bwd_dkv::launch<__nv_bfloat16, false, true>(
          q, k, v, dout, l, dl, dk, dv, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    case 2:
      return (int)flash_bwd_dkv::launch<__half, false, true>(
          q, k, v, dout, l, dl, dk, dv, B, H, Hk, Sq, Sk, D, offset, scale,
          DropParams{}, tc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
