// Fused transformer FFN forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/fused_ffn.py::_kernel (pallas_call :90):
//
//   out[M, K] = act(x[M, K] @ W1[K, F] + b1) @ W2[F, K] + b2
//
// with the [M, F] intermediate kept out of device memory. Rounding as the
// TPU kernel: x @ W1 summed in fp32, b1 added in fp32, act in fp32 and
// rounded to x's dtype before the second product, that product summed in
// fp32, b2 added in fp32, one rounding of the output. act: 0 = tanh gelu,
// 1 = exact gelu (ffn_tile.cuh).
//
// What bounds it on the card: operations (2 * 2 * M * K * F against
// (2 * M * K + 2 * K * F) elements moved; at GPT-2's training shape 77
// GFLOP for 43 MB).
//
// Design, and what it does about the TPU kernel's revisited [bm, K] fp32
// accumulator (bm * 3 KB at K = 768, more than a block's shared memory at
// the TPU's bm): a block owns 32 rows and BN output columns (the largest of
// 768, 512, 384, 256, 128 dividing K, picked by the wrapper; BN = K at
// GPT-2's K = 768) and keeps its [32, BN] fp32 accumulator in registers.
// Over F tiles of 128 it computes the [32, 128] pre-activation tile,
// applies b1 and act into shared memory, then adds that tile's product with
// W2. Where BN < K, each column block recomputes the pre-activation (K / BN
// times the first product). Rows past M are zero in the stage and never
// stored. Two instantiations of that design:
//   - fp32 (ffn_fwd_kernel): the fp32 cores; four rows by TN = BN / 32
//     columns of the accumulator a thread, [32, 32] x and [32, 128] W1
//     chunks and [16, BN] W2 chunks staged as fp32;
//   - bf16 and fp16 (ffn_fwd_tc_kernel): the tensor cores through
//     nvcuda::wmma 16x16x16 tiles with fp32 accumulation; the warps split
//     the accumulator 2 (row halves) x 4 (column quarters), NF = BN / 64
//     tiles a warp, and the pre-activation tile 2 x 4; [32, 128] x, [128,
//     128] W1 and [32, BN] W2 chunks staged in the stored dtype with
//     asynchronous 16-byte copies (cp.async).
// TMA, asynchronous copies, wgmma and a larger row tile are left for later
// work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

#include "ffn_tile.cuh"

namespace {

using namespace paddle_ffn;

constexpr int kBM = 32;   // rows of x per block
constexpr int kBF = 128;  // F columns per pre-activation tile
constexpr int kKC = 32;   // K depth of a staged x / W1 chunk
constexpr int kFC = 16;   // F depth of a staged W2 chunk

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, T* __restrict__ out, int M,
                   int K, int F, int act) {
  constexpr int BN = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kBM][kKC]
  float* w1s = xs + kBM * kKC;     // [kKC][kBF]
  float* ts = w1s + kKC * kBF;     // [kBM][kBF]  act(pre), rounded to T
  float* w2s = ts + kBM * kBF;     // [kFC][BN]

  const int ty = threadIdx.x >> 5;  // rows ty * 4 .. + 3
  const int tx = threadIdx.x & 31;  // columns tx + 32 j
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int n_valid = min(kBM, M - m0);

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF) {
    float pre[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pre[i][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      stage(xs, kKC, x, K, m0, n_valid, k0, kBM, kKC);
      stage(w1s, kBF, w1, F, k0, kKC, f0, kKC, kBF);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * kKC + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = w1s[kk * kBF + tx + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) pre[i][c] = fmaf(a[i], b[c], pre[i][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bias = to_f(b1[f0 + tx + 32 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ts[(ty * 4 + i) * kBF + tx + 32 * c] =
            round_to<T>(act_fwd(pre[i][c] + bias, act));
    }
    for (int kk0 = 0; kk0 < kBF; kk0 += kFC) {
      __syncthreads();  // ts written; the previous W2 chunk consumed
      stage(w2s, BN, w2, K, f0 + kk0, kFC, n0, kFC, BN);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kFC; ++kk) {
        float a[4], b[TN];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ts[(ty * 4 + i) * kBF + kk0 + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = w2s[kk * BN + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + 32 * j;
    const float bias = to_f(b2[n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < n_valid)
        out[(size_t)(m0 + r) * K + n] = from_f<T>(acc[i][j] + bias);
    }
  }
}

// ---- bf16 / fp16: tensor cores (wmma)
constexpr int kTcKC = 128;  // K depth of a staged x / W1 chunk
constexpr int kTcFC = 32;  // F depth of a staged W2 chunk

template <typename T, int NF>
struct TcLayout {
  static constexpr int BN = 64 * NF;
  static constexpr int LX = kTcKC + 8, LW1 = kBF + 8, LP = kBF + 4,
                       LT = kBF + 8, LW2 = BN + 8;
  // byte offsets, each a multiple of 32 (wmma's pointer alignment)
  static constexpr size_t xs = 0;
  static constexpr size_t w1s = xs + sizeof(T) * kBM * LX;
  static constexpr size_t pre = w1s + sizeof(T) * kTcKC * LW1;
  static constexpr size_t ts = pre + sizeof(float) * kBM * LP;
  static constexpr size_t w2s = ts + sizeof(T) * kBM * LT;
  static constexpr size_t scratch = w2s + sizeof(T) * kTcFC * LW2;
  static constexpr size_t bytes = scratch + sizeof(float) * 8 * 256;
};

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_fwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ out, int M,
                      int K, int F, int act, int vec) {
  using namespace nvcuda;
  using L = TcLayout<T, NF>;
  using FragA =
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
  using FragB =
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L::xs);          // [32][LX]
  T* w1s = reinterpret_cast<T*>(smem_raw + L::w1s);        // [KC][LW1]
  float* pre = reinterpret_cast<float*>(smem_raw + L::pre);  // [32][LP]
  T* ts = reinterpret_cast<T*>(smem_raw + L::ts);          // [32][LT]
  T* w2s = reinterpret_cast<T*>(smem_raw + L::w2s);        // [FC][LW2]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* scratch =
      reinterpret_cast<float*>(smem_raw + L::scratch) + warp * 256;
  const int wr = warp & 1;   // rows wr * 16 .. + 15
  const int wc = warp >> 1;  // accumulator columns (wc * NF + j) * 16
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * L::BN;
  const int n_valid = min(kBM, M - m0);

  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += kBF) {
    FragC pf[2];  // pre-activation columns wc * 32 + 16 j
    wmma::fill_fragment(pf[0], 0.f);
    wmma::fill_fragment(pf[1], 0.f);
    for (int k0 = 0; k0 < K; k0 += kTcKC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      copy_tile(xs, L::LX, x, K, m0, n_valid, k0, kBM, kTcKC, vec);
      copy_tile(w1s, L::LW1, w1, F, k0, kTcKC, f0, kTcKC, kBF, vec);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcKC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, xs + wr * 16 * L::LX + kk, L::LX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, w1s + kk * L::LW1 + wc * 32 + j * 16,
                                 L::LW1);
          wmma::mma_sync(pf[j], a, b, pf[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(pre + wr * 16 * L::LP + wc * 32 + j * 16,
                              pf[j], L::LP, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBF; i += blockDim.x) {
      const int r = i / kBF;
      const int c = i - r * kBF;
      ts[r * L::LT + c] = from_f<T>(
          act_fwd(pre[r * L::LP + c] + to_f(b1[f0 + c]), act));
    }
    for (int kk0 = 0; kk0 < kBF; kk0 += kTcFC) {
      __syncthreads();  // ts written; the previous W2 chunk consumed
      copy_tile(w2s, L::LW2, w2, K, f0 + kk0, kTcFC, n0, kTcFC, L::BN,
                vec);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcFC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ts + wr * 16 * L::LT + kk0 + kk, L::LT);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, w2s + kk * L::LW2 + (wc * NF + j) * 16,
                                 L::LW2);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  // each warp writes its tiles through its own 16x16 fp32 scratch
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = wr * 16 + (e >> 4);
      const int n = n0 + (wc * NF + j) * 16 + (e & 15);
      if (r < n_valid)
        out[(size_t)(m0 + r) * K + n] =
            from_f<T>(scratch[e] + to_f(b2[n]));
    }
    __syncwarp();
  }
}

template <typename T, int NF>
cudaError_t launch_tc(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int M,
                      int K, int F, int act, cudaStream_t stream) {
  using L = TcLayout<T, NF>;
  auto kernel = ffn_fwd_tc_kernel<T, NF>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, K / L::BN);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), M, K, F, act,
      vec16(x, w1, w2, out));
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int K,
                   int F, int act, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {  // BN = 32 * TN = 64 * (TN / 2)
    return launch_tc<T, TN / 2>(x, w1, b1, w2, b2, out, M, K, F, act,
                                stream);
  } else {
    constexpr int BN = 32 * TN;
    const size_t smem = (size_t)(kBM * kKC + kKC * kBF + kBM * kBF +
                                 kFC * BN) *
                        sizeof(float);
    auto kernel = ffn_fwd_kernel<T, TN>;
    static size_t smem_set = 48 * 1024;
    cudaError_t err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + kBM - 1) / kBM, K / BN);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(out), M, K, F, act);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int M,
                      int K, int F, int BN, int act, cudaStream_t stream) {
  switch (BN) {
    case 128:
      return launch<T, 4>(x, w1, b1, w2, b2, out, M, K, F, act, stream);
    case 256:
      return launch<T, 8>(x, w1, b1, w2, b2, out, M, K, F, act, stream);
    case 384:
      return launch<T, 12>(x, w1, b1, w2, b2, out, M, K, F, act, stream);
    case 512:
      return launch<T, 16>(x, w1, b1, w2, b2, out, M, K, F, act, stream);
    case 768:
      return launch<T, 24>(x, w1, b1, w2, b2, out, M, K, F, act, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K], w1 [K, F], b1 [F], w2 [F, K], b2 [K], out [M, K], all of one
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. BN: the output columns of
// a block (128, 256, 384, 512 or 768, dividing K); F a multiple of 128.
// act: 0 = tanh gelu, 1 = exact gelu. Returns a cudaError_t (0 on
// success); the caller has validated shapes, devices and layout.
extern "C" int paddle_fused_ffn_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* out, int M, int K,
                                    int F, int BN, int act, int dtype,
                                    void* stream) {
  if (M < 1 || K < 1 || F < 1 || F % kBF || BN < 1 || K % BN ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bn<float>(x, w1, b1, w2, b2, out, M, K, F, BN, act,
                                   s);
    case 1:
      return (int)launch_bn<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, K, F,
                                           BN, act, s);
    case 2:
      return (int)launch_bn<__half>(x, w1, b1, w2, b2, out, M, K, F, BN, act,
                                    s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
