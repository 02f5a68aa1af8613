// Fused int4 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/fused_dequant_matmul.py::
// fused_dequant_matmul (_fused_dequant_mm_kernel): out = (a @ W) * s with W
// int4, packed two values a byte along the contracted axis (the low nibble
// is the even k, the high nibble the odd k, both sign-extended, in
// [-7, 7]), s the per-out-channel fp32 scale, fp32 accumulation, the scale
// applied to the accumulator before the cast to a's dtype. The unpacked
// weight never exists outside shared memory.
//
//   a      [M, K]      fp32, bf16 or fp16, row-major (K = 2 * K2, any M)
//   w      [K2, O]     int8, either contiguous (k_contig = 0: O fastest) or
//                      the transpose of a contiguous [O, K2] (k_contig = 1)
//   scales [O]         fp32
//   work   [S, M, O]   fp32 partial sums when the K walk is split (S > 1)
//   out    [M, O]      a's dtype
//
// What bounds it on the card: at decode (M = 8) bytes — the packed weight,
// K*O/2 bytes, is read once per M tile while the products are 2*M*K*O
// flops; in bulk prefill (M up to 1024) operations. Design: one thread
// block of 256 threads per (64 output columns, BM = 16/32/64 rows) tile
// walks K in steps of 32 packed rows: the A tile is staged as fp32 and the
// weight bytes, read coalesced in whichever orientation W has, are
// unpacked with arithmetic shifts into an fp32 [64 k][64 o] tile; each
// thread accumulates TM x 4 outputs with fp32 FMAs (exact products for
// bf16 and fp16 inputs, and never TF32 for fp32 ones). When the output
// tiles alone would leave the card idle (decode), the K walk is split over
// blockIdx.z into fp32 partials that a second, tiny kernel sums in a fixed
// order before applying the scale. Tensor-core (mma / wgmma) products and
// a pipelined load of the next step are left for later work.
#include "attention_tile.cuh"  // to_f / from_f

namespace {

using paddle_attn::from_f;
using paddle_attn::to_f;

constexpr int kBO = 64;          // output columns per block
constexpr int kBK2 = 32;         // packed rows per step
constexpr int kBK = 2 * kBK2;    // contracted elements per step
constexpr int kThreads = 256;    // 16 column groups x 16 row groups

// TM: rows per thread; the block covers BM = 16 * TM rows.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ a, const int8_t* __restrict__ w,
              const float* __restrict__ scales, float* __restrict__ work,
              T* __restrict__ out, int M, int K2, int O, int k_contig,
              int chunk) {
  constexpr int BM = 16 * TM;
  constexpr int kAPer = BM * kBK / kThreads;    // A elements per thread
  constexpr int kWPer = kBK2 * kBO / kThreads;  // weight bytes per thread
  __shared__ float As[kBK][BM + 1];  // k-major; odd stride for the stores
  __shared__ __align__(16) float Ws[kBK][kBO + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // columns 4 * tx .. 4 * tx + 3
  const int ty = tid >> 4;   // rows TM * ty .. TM * ty + TM - 1
  const int o0 = blockIdx.x * kBO;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * chunk;
  const int ke = min(K2, kb + chunk);
  const int K = 2 * K2;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k2_0 = kb; k2_0 < ke; k2_0 += kBK2) {
    // every load of the step is issued before any is used
    float av[kAPer];
    int8_t wb[kWPer];
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / kBK;
      const int k = 2 * k2_0 + i % kBK;
      av[j] = (m < M && k < 2 * ke) ? to_f(a[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      // neighbouring threads on neighbouring bytes in either orientation
      const int kk = k_contig ? i % kBK2 : i / kBO;
      const int oo = k_contig ? i / kBK2 : i % kBO;
      const int k2 = k2_0 + kk;
      const int o = o0 + oo;
      wb[j] = 0;
      if (k2 < ke && o < O)
        wb[j] = k_contig ? w[(size_t)o * K2 + k2] : w[(size_t)k2 * O + o];
    }
    __syncthreads();  // the previous step is done with As and Ws
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kThreads;
      As[i % kBK][i / kBK] = av[j];
    }
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      const int kk = k_contig ? i % kBK2 : i / kBO;
      const int oo = k_contig ? i / kBK2 : i % kBO;
      // sign-extending nibble unpack with arithmetic shifts
      const int lo = static_cast<int8_t>(static_cast<uint8_t>(wb[j]) << 4) >> 4;
      const int hi = wb[j] >> 4;
      Ws[2 * kk][oo] = (float)lo;       // even k
      Ws[2 * kk + 1][oo] = (float)hi;   // odd k
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[k][4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = As[k][ty * TM + i];
        acc[i][0] = fmaf(x, wv.x, acc[i][0]);
        acc[i][1] = fmaf(x, wv.y, acc[i][1]);
        acc[i][2] = fmaf(x, wv.z, acc[i][2]);
        acc[i][3] = fmaf(x, wv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o >= O) continue;
      if (gridDim.z == 1)
        out[(size_t)m * O + o] = from_f<T>(acc[i][j] * scales[o]);
      else
        work[((size_t)blockIdx.z * M + m) * O + o] = acc[i][j];
    }
  }
}

// out = (sum over the S partials, in order) * scale, cast to T.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ work,
                              const float* __restrict__ scales,
                              T* __restrict__ out, int M, int O, int S) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)M * O;
  if (idx >= n) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += work[z * n + idx];
  out[idx] = from_f<T>(s * scales[idx % O]);
}

template <typename T>
cudaError_t launch(const void* a, const void* w, const void* scales,
                   void* work, void* out, int M, int K2, int O, int k_contig,
                   int bm, int splits, int chunk, cudaStream_t stream) {
  const dim3 grid((O + kBO - 1) / kBO, (M + bm - 1) / bm, splits);
  const T* a_ = static_cast<const T*>(a);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* s_ = static_cast<const float*>(scales);
  float* work_ = static_cast<float*>(work);
  T* out_ = static_cast<T*>(out);
  if (bm == 16)
    dq_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a_, w_, s_, work_, out_,
                                                   M, K2, O, k_contig, chunk);
  else if (bm == 32)
    dq_kernel<T, 2><<<grid, kThreads, 0, stream>>>(a_, w_, s_, work_, out_,
                                                   M, K2, O, k_contig, chunk);
  else
    dq_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a_, w_, s_, work_, out_,
                                                   M, K2, O, k_contig, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)M * O;
  reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      work_, s_, out_, M, O, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype (of a and out): 0 = float32, 1 = bfloat16, 2 = float16. bm: rows
// per block (16, 32 or 64); the K walk is split into `splits` ranges of
// `chunk` packed rows (a multiple of 32), `work` holding their partials.
// Returns a cudaError_t (0 on success); the caller has validated shapes,
// devices and layout.
extern "C" int paddle_fused_dequant_matmul(const void* a, const void* w,
                                           const void* scales, void* work,
                                           void* out, int M, int K2, int O,
                                           int k_contig, int bm, int splits,
                                           int chunk, int dtype,
                                           void* stream) {
  if (M < 1 || K2 < 1 || O < 1 || (bm != 16 && bm != 32 && bm != 64) ||
      splits < 1 || chunk < kBK2 || chunk % kBK2 ||
      (long long)(splits - 1) * chunk >= K2 ||
      (long long)splits * chunk < K2 || (M + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(a, w, scales, work, out, M, K2, O, k_contig,
                                bm, splits, chunk, s);
    case 1:
      return (int)launch<__nv_bfloat16>(a, w, scales, work, out, M, K2, O,
                                        k_contig, bm, splits, chunk, s);
    case 2:
      return (int)launch<__half>(a, w, scales, work, out, M, K2, O, k_contig,
                                 bm, splits, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
