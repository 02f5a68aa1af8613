// Ring attention's chunk forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/ring_chunk_attention.py::_fwd
// (_fwd_kernel, pallas_call :240): one ring step, a q chunk against one
// visiting K/V chunk, returning the normalised output and the row
// log-sum-exp by which the ring merges the chunks.
//
//   q   [B, H, Sq, D]     fp32, bf16 or fp16; D <= 256
//   k,v [B, Hk, Sk, D]    q's dtype; Hk divides H, head h reads h / (H/Hk)
//   o   [B, H, Sq, D]     q's dtype
//   lse [B, H, Sq]        fp32
//
// Row i attends key j iff j <= i + offset, with the offset a launch
// argument (the TPU kernel's traced scalar): the ring knows each step's
// on the host, (my - src) * Sq under a causal mask and Sk without one. An
// offset >= Sk - 1 is full attention, a negative one shifts the diagonal,
// and one <= -Sq masks every row: such a row returns o = 0 and lse =
// -1e30 exactly, the values the ring's merge gives zero weight, and a
// launch that masks every row still writes them. No dropout (the TPU
// kernel has none).
//
// What bounds it on the card: operations at the ring's chunk shape
// ([1, 32, 1024, 128] bf16: 4 * H * Sq * Sk * D = 17.2 GFLOP over 33.8 MB
// of q, k, v and o; 0.0174 ms at the bf16 peak). Design: the flash
// forward's kernels (flash_fwd.cuh) with the diagonal taken from the
// argument, so bf16 and fp16 at D 64 and 128 run on the tensor cores
// (wgmma) and fp32 on the fp32 cores: one block per (b, h, 64-row q
// tile), key tiles past a tile's last attended key skipped (a fully
// masked launch reads no key).
#include "flash_fwd.cuh"

namespace {

using namespace paddle_attn;

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                     int offset, float scale, bool tc,
                     cudaStream_t stream) {
  return flash_fwd::launch<T, false, true>(q, k, v, o, lse, B, H, Hk, Sq, Sk,
                                           D, offset, scale, DropParams{},
                                           tc, stream);
}

}  // namespace

// tc: 1 = the tensor-core kernel (bf16 / fp16 at D 64 and 128 only; else
// cudaErrorInvalidValue), 0 = the fp32-core kernel, as the wrapper chose
// (ops/flash_attention.py's kernel_path).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0
// on success); the caller has validated shapes, devices and layout and
// clamped the offset to [-Sq, Sk].
extern "C" int paddle_ring_chunk_attention_fwd(const void* q, const void* k,
                                               const void* v, void* o,
                                               void* lse, int B, int H,
                                               int Hk, int Sq, int Sk, int D,
                                               int offset, float scale,
                                               int dtype, int tc,
                                               void* stream) {
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || offset < -Sq || offset > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                  offset, scale, tc, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, Sq, Sk,
                                          D, offset, scale, tc, s);
    case 2:
      return (int)launch_t<__half>(q, k, v, o, lse, B, H, Hk, Sq, Sk, D,
                                   offset, scale, tc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
