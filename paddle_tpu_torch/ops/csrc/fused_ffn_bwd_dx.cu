// Fused transformer FFN backward, dx half, for Hopper (sm_90a), plain C
// interface.
//
// Replaces paddle_tpu/ops/pallas/fused_ffn.py::_bwd_dx_kernel (pallas_call
// :273): from the forward's inputs and the output gradient g [M, K],
//
//   pre  = x @ W1 + b1              [M, F], fp32
//   dt   = g @ W2^T                 [M, F], fp32
//   dpre = dt * act'(pre)           rounded to x's dtype
//   dx   = dpre @ W1^T              [M, K], fp32 sums, one rounding
//
// with pre, dt and dpre recomputed tile by tile and never written to
// device memory (the forward saved only its inputs). act' is the TPU
// kernel's `_dgelu` (ffn_tile.cuh).
//
// What bounds it on the card: operations (three products, 2 * 3 * M * K *
// F; 116 GFLOP at GPT-2's training shape).
//
// Design: the forward's (fused_ffn_fwd.cu). A block owns 32 rows and BN
// columns of dx, its [32, BN] fp32 accumulator in registers; per F tile of
// 128 it computes the pre and dt tiles together, forms dpre in shared
// memory, then adds dpre @ W1^T. fp32 (ffn_bwd_dx_kernel) on the fp32
// cores: [32, 32] chunks of x and g and [32, 128] chunks of W1 and W2^T
// (W2 staged transposed, odd row stride), then [16, BN] chunks of W1^T
// (staged transposed). bf16 and fp16 (ffn_bwd_dx_tc_kernel) on the tensor
// cores through nvcuda::wmma, warps split as in the forward: [32, 128]
// chunks of x and g and [128, 128] of W1 row-major, W2's [128, 128] rows
// read as a column-major W2^T, then W1's [BN, 32] rows read as a
// column-major W1^T chunk, all staged in the stored dtype with
// asynchronous 16-byte copies (cp.async).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

#include "ffn_tile.cuh"

namespace {

using namespace paddle_ffn;

constexpr int kBM = 32;
constexpr int kBF = 128;
constexpr int kKC = 32;
constexpr int kFC = 16;

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ w2, T* __restrict__ dx, int M,
                      int K, int F, int act) {
  constexpr int BN = 32 * TN;
  constexpr int kLdT = kBF + 1;  // W2^T chunk row stride
  constexpr int kLdW = BN + 1;   // W1^T chunk row stride
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kBM][kKC]
  float* gs = xs + kBM * kKC;      // [kBM][kKC]
  float* w1s = gs + kBM * kKC;     // [kKC][kBF]
  float* w2ts = w1s + kKC * kBF;   // [kKC][kLdT]   W2^T chunk
  float* ds = w2ts + kKC * kLdT;   // [kBM][kBF]    dpre, rounded to T
  float* w1ts = ds + kBM * kBF;    // [kFC][kLdW]   W1^T chunk

  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int n_valid = min(kBM, M - m0);

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF) {
    float pre[4][4], dt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pre[i][c] = dt[i][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();
      stage(xs, kKC, x, K, m0, n_valid, k0, kBM, kKC);
      stage(gs, kKC, g, K, m0, n_valid, k0, kBM, kKC);
      stage(w1s, kBF, w1, F, k0, kKC, f0, kKC, kBF);
      // w2ts[k][f] = W2[f0 + f][k0 + k]
      stage_t(w2ts, kLdT, w2, K, f0, k0, kBF, kKC);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4], e[4], b[4], d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = xs[(ty * 4 + i) * kKC + kk];
          e[i] = gs[(ty * 4 + i) * kKC + kk];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c] = w1s[kk * kBF + tx + 32 * c];
          d[c] = w2ts[kk * kLdT + tx + 32 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pre[i][c] = fmaf(a[i], b[c], pre[i][c]);
            dt[i][c] = fmaf(e[i], d[c], dt[i][c]);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bias = to_f(b1[f0 + tx + 32 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[(ty * 4 + i) * kBF + tx + 32 * c] =
            round_to<T>(dt[i][c] * act_grad(pre[i][c] + bias, act));
    }
    for (int kk0 = 0; kk0 < kBF; kk0 += kFC) {
      __syncthreads();
      // w1ts[f][n] = W1[n0 + n][f0 + kk0 + f]
      stage_t(w1ts, kLdW, w1, F, n0, f0 + kk0, BN, kFC);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kFC; ++kk) {
        float a[4], b[TN];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ds[(ty * 4 + i) * kBF + kk0 + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = w1ts[kk * kLdW + tx + 32 * j];
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < n_valid) dx[(size_t)(m0 + r) * K + n] = from_f<T>(acc[i][j]);
    }
  }
}

// ---- bf16 / fp16: tensor cores (wmma)
constexpr int kTcKC = 128;  // K depth of a staged x / g / W1 / W2 chunk
constexpr int kTcFC = 32;  // F depth of a staged W1^T chunk

template <typename T, int NF>
struct TcLayout {
  static constexpr int BN = 64 * NF;
  static constexpr int LX = kTcKC + 8, LW1 = kBF + 8, LW2 = kTcKC + 8,
                       LP = kBF + 4, LD = kBF + 8, LW1T = kTcFC + 8;
  // byte offsets, each a multiple of 32 (wmma's pointer alignment)
  static constexpr size_t xs = 0;
  static constexpr size_t gs = xs + sizeof(T) * kBM * LX;
  static constexpr size_t w1s = gs + sizeof(T) * kBM * LX;
  static constexpr size_t w2s = w1s + sizeof(T) * kTcKC * LW1;
  static constexpr size_t pre = w2s + sizeof(T) * kBF * LW2;
  static constexpr size_t dt = pre + sizeof(float) * kBM * LP;
  static constexpr size_t ds = dt + sizeof(float) * kBM * LP;
  static constexpr size_t w1t = ds + sizeof(T) * kBM * LD;
  static constexpr size_t scratch = w1t + sizeof(T) * BN * LW1T;
  static constexpr size_t bytes = scratch + sizeof(float) * 8 * 256;
};

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dx_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, T* __restrict__ dx, int M,
                         int K, int F, int act, int vec) {
  using namespace nvcuda;
  using L = TcLayout<T, NF>;
  using FragA =
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
  using FragB =
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
  using FragBt =
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L::xs);          // [32][LX]
  T* gs = reinterpret_cast<T*>(smem_raw + L::gs);          // [32][LX]
  T* w1s = reinterpret_cast<T*>(smem_raw + L::w1s);        // [KC][LW1]
  T* w2s = reinterpret_cast<T*>(smem_raw + L::w2s);        // [128][LW2]
  float* pre = reinterpret_cast<float*>(smem_raw + L::pre);  // [32][LP]
  float* dt = reinterpret_cast<float*>(smem_raw + L::dt);    // [32][LP]
  T* ds = reinterpret_cast<T*>(smem_raw + L::ds);          // [32][LD]
  T* w1t = reinterpret_cast<T*>(smem_raw + L::w1t);        // [BN][LW1T]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* scratch =
      reinterpret_cast<float*>(smem_raw + L::scratch) + warp * 256;
  const int wr = warp & 1;
  const int wc = warp >> 1;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * L::BN;
  const int n_valid = min(kBM, M - m0);

  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += kBF) {
    FragC pf[2], df[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(pf[j], 0.f);
      wmma::fill_fragment(df[j], 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += kTcKC) {
      __syncthreads();
      copy_tile(xs, L::LX, x, K, m0, n_valid, k0, kBM, kTcKC, vec);
      copy_tile(gs, L::LX, g, K, m0, n_valid, k0, kBM, kTcKC, vec);
      copy_tile(w1s, L::LW1, w1, F, k0, kTcKC, f0, kTcKC, kBF, vec);
      // W2 rows f0 .. f0 + 127, columns k0 ..: element (k, f) of W2^T at
      // w2s[f * LW2 + k], a column-major operand
      copy_tile(w2s, L::LW2, w2, K, f0, kBF, k0, kBF, kTcKC, vec);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcKC; kk += 16) {
        FragA a, e;
        wmma::load_matrix_sync(a, xs + wr * 16 * L::LX + kk, L::LX);
        wmma::load_matrix_sync(e, gs + wr * 16 * L::LX + kk, L::LX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = wc * 32 + j * 16;
          FragB b;
          FragBt bt;
          wmma::load_matrix_sync(b, w1s + kk * L::LW1 + c, L::LW1);
          wmma::load_matrix_sync(bt, w2s + c * L::LW2 + kk, L::LW2);
          wmma::mma_sync(pf[j], a, b, pf[j]);
          wmma::mma_sync(df[j], e, bt, df[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = wr * 16 * L::LP + wc * 32 + j * 16;
      wmma::store_matrix_sync(pre + off, pf[j], L::LP, wmma::mem_row_major);
      wmma::store_matrix_sync(dt + off, df[j], L::LP, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBF; i += blockDim.x) {
      const int r = i / kBF;
      const int c = i - r * kBF;
      ds[r * L::LD + c] = from_f<T>(
          dt[r * L::LP + c] *
          act_grad(pre[r * L::LP + c] + to_f(b1[f0 + c]), act));
    }
    for (int kk0 = 0; kk0 < kBF; kk0 += kTcFC) {
      __syncthreads();
      // W1 rows n0 .., columns f0 + kk0 ..: element (f, n) of W1^T at
      // w1t[n * LW1T + f], a column-major operand
      copy_tile(w1t, L::LW1T, w1, F, n0, L::BN, f0 + kk0, L::BN, kTcFC,
                vec);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcFC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ds + wr * 16 * L::LD + kk0 + kk, L::LD);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          FragBt b;
          wmma::load_matrix_sync(
              b, w1t + (wc * NF + j) * 16 * L::LW1T + kk, L::LW1T);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = wr * 16 + (e >> 4);
      const int n = n0 + (wc * NF + j) * 16 + (e & 15);
      if (r < n_valid) dx[(size_t)(m0 + r) * K + n] = from_f<T>(scratch[e]);
    }
    __syncwarp();
  }
}

template <typename T, int NF>
cudaError_t launch_tc(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dx, int M,
                      int K, int F, int act, cudaStream_t stream) {
  using L = TcLayout<T, NF>;
  auto kernel = ffn_bwd_dx_tc_kernel<T, NF>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, K / L::BN);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<T*>(dx), M, K, F, act,
      vec16(x, g, w1, w2) && vec16(dx, dx, dx));
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch(const void* x, const void* g, const void* w1,
                   const void* b1, const void* w2, void* dx, int M, int K,
                   int F, int act, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {  // BN = 32 * TN = 64 * (TN / 2)
    return launch_tc<T, TN / 2>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
  } else {
    constexpr int BN = 32 * TN;
    const size_t smem = (size_t)(2 * kBM * kKC + kKC * kBF +
                                 kKC * (kBF + 1) + kBM * kBF +
                                 kFC * (BN + 1)) *
                        sizeof(float);
    auto kernel = ffn_bwd_dx_kernel<T, TN>;
    static size_t smem_set = 48 * 1024;
    cudaError_t err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + kBM - 1) / kBM, K / BN);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<T*>(dx), M, K, F, act);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dx, int M, int K,
                      int F, int BN, int act, cudaStream_t stream) {
  switch (BN) {
    case 128:
      return launch<T, 4>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 256:
      return launch<T, 8>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 384:
      return launch<T, 12>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 512:
      return launch<T, 16>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 768:
      return launch<T, 24>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g [M, K], w1 [K, F], b1 [F], w2 [F, K], dx [M, K], all of one dtype:
// 0 = float32, 1 = bfloat16, 2 = float16. BN: the dx columns of a block
// (128, 256, 384, 512 or 768, dividing K); F a multiple of 128. act: 0 =
// tanh gelu, 1 = exact gelu. Returns a cudaError_t (0 on success); the
// caller has validated shapes, devices and layout.
extern "C" int paddle_fused_ffn_bwd_dx(const void* x, const void* g,
                                       const void* w1, const void* b1,
                                       const void* w2, void* dx, int M,
                                       int K, int F, int BN, int act,
                                       int dtype, void* stream) {
  if (M < 1 || K < 1 || F < 1 || F % kBF || BN < 1 || K % BN ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bn<float>(x, g, w1, b1, w2, dx, M, K, F, BN, act,
                                   s);
    case 1:
      return (int)launch_bn<__nv_bfloat16>(x, g, w1, b1, w2, dx, M, K, F, BN,
                                           act, s);
    case 2:
      return (int)launch_bn<__half>(x, g, w1, b1, w2, dx, M, K, F, BN, act,
                                    s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
