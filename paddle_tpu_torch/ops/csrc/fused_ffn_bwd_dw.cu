// Fused transformer FFN backward, weight half, for Hopper (sm_90a), plain C
// interface.
//
// Replaces paddle_tpu/ops/pallas/fused_ffn.py::_bwd_dw_kernel (pallas_call
// :289): from the forward's inputs and the output gradient g [M, K],
//
//   pre    = x @ W1 + b1            [M, F], fp32
//   t      = act(pre)               rounded to x's dtype
//   dt     = g @ W2^T               [M, F], fp32
//   dpre32 = dt * act'(pre);  dpre = dpre32 rounded to x's dtype
//   dW1    = x^T @ dpre             [K, F]
//   dW2    = t^T @ g                [F, K]
//   db1    = sum over rows of dpre32 (fp32)
//
// with the [M, F] intermediates recomputed tile by tile and never written.
//
// What bounds it on the card: operations (four products, 2 * 4 * M * K * F;
// 155 GFLOP at GPT-2's training shape).
//
// Design, and what it does about the accumulators: the TPU kernel keeps
// dW1 and dW2 of one F tile, 2 * K * bf fp32 (393 KB at K = 768, bf = 64),
// in VMEM while it walks all of M; no SM holds that. Here a block owns an
// F tile of 32 columns, a K tile of BN = 32 * RPT (the largest of 512, 384,
// 256, 128 dividing K, picked by the wrapper) and one of S row ranges, and
// keeps its dW1 [BN, 32] and dW2 [32, BN] tiles in registers. Per step of
// rows of its range it recomputes the pre and dt tiles over all of K from
// staged chunks (so K / BN column blocks repeat that recompute), forms t
// and dpre in shared memory, and adds the rows' outer products with staged
// slices of x and g. Each block writes its partial sums to its own
// slot of fp32 partials [S, K, F], [S, F, K] and (from the K tile 0 blocks)
// [S, F]; the wrapper sums the S partials after the kernel. No atomics, so
// the result does not depend on scheduling (layer_norm_bwd.cu's dgamma
// discipline). fp32 (ffn_bwd_dw_kernel) runs on the fp32 cores, 32 rows a
// step, [32, 32] chunks staged as fp32, lane tx owning K rows tx + 32 j and
// warp ty F columns 4 ty .. 4 ty + 3 of the accumulators, and [8, BN]
// slices of x and g; bf16 and fp16 (ffn_bwd_dw_tc_kernel) on the
// tensor cores through nvcuda::wmma, 64 rows a step: the recompute as
// sixteen 16x16 tiles (two a warp, pre or dt) over [64, 128] chunks of x
// and g, W1's [128, 32] and W2's [32, 128] (read as a column-major W2^T),
// then per 16 rows the outer products with x^T and t^T read column-major
// from the staged [64, BN] slices (in the region the recompute staged in)
// and the [64, 32] t / dpre tiles, BN / 128 column tiles of dW1 and dW2 a
// warp, stored to the partials straight from the fragments; tiles staged
// with asynchronous 16-byte copies (cp.async).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

#include "ffn_tile.cuh"

namespace {

using namespace paddle_ffn;

constexpr int kBF = 32;   // F columns of a block
constexpr int kBM = 32;   // rows per recompute step
constexpr int kKC = 32;   // K depth of a staged recompute chunk
constexpr int kSub = 8;   // rows per staged x / g slice of the update

template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ w2, float* __restrict__ dw1p,
                      float* __restrict__ dw2p, float* __restrict__ db1p,
                      int M, int K, int F, int rows_per_split, int act) {
  constexpr int BN = 32 * RPT;
  constexpr int kLdT = kBF + 1;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kBM][kKC]
  float* gs = xs + kBM * kKC;       // [kBM][kKC]
  float* w1s = gs + kBM * kKC;      // [kKC][kBF]
  float* w2ts = w1s + kKC * kBF;    // [kKC][kLdT]  W2^T chunk
  float* ts = w2ts + kKC * kLdT;    // [kBM][kBF]   t, rounded to T
  float* dps = ts + kBM * kBF;      // [kBM][kBF]   dpre, rounded to T
  float* xn = dps + kBM * kBF;      // [kSub][BN]
  float* gn = xn + kSub * BN;       // [kSub][BN]
  float* red = gn + kSub * BN;      // [8][kBF]     db1 reduction

  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int f0 = blockIdx.x * kBF;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int row_begin = min(M, split * rows_per_split);
  const int row_end = min(M, row_begin + rows_per_split);
  const float bias = to_f(b1[f0 + tx]);

  float acc1[RPT][4], acc2[4][RPT];  // dW1[n][f], dW2[f][n]
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc1[j][c] = acc2[c][j] = 0.f;
  float db = 0.f;  // column f0 + tx, rows of this thread

  for (int mc = row_begin; mc < row_end; mc += kBM) {
    const int n_valid = min(kBM, row_end - mc);
    float pre[4], dt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pre[i] = dt[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();
      stage(xs, kKC, x, K, mc, n_valid, k0, kBM, kKC);
      stage(gs, kKC, g, K, mc, n_valid, k0, kBM, kKC);
      stage(w1s, kBF, w1, F, k0, kKC, f0, kKC, kBF);
      // w2ts[k][f] = W2[f0 + f][k0 + k]
      stage_t(w2ts, kLdT, w2, K, f0, k0, kBF, kKC);
      __syncthreads();
      const float* x_r = xs + ty * 4 * kKC;
      const float* g_r = gs + ty * 4 * kKC;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float b = w1s[kk * kBF + tx];
        const float d = w2ts[kk * kLdT + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pre[i] = fmaf(x_r[i * kKC + kk], b, pre[i]);
          dt[i] = fmaf(g_r[i * kKC + kk], d, dt[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float p = pre[i] + bias;
      const float d32 = r < n_valid ? dt[i] * act_grad(p, act) : 0.f;
      db += d32;
      ts[r * kBF + tx] = r < n_valid ? round_to<T>(act_fwd(p, act)) : 0.f;
      dps[r * kBF + tx] = round_to<T>(d32);
    }
    for (int s0 = 0; s0 < n_valid; s0 += kSub) {
      __syncthreads();  // ts / dps written; the previous slice consumed
      const int sub_valid = min(kSub, n_valid - s0);
      stage(xn, BN, x, K, mc + s0, sub_valid, n0, kSub, BN);
      stage(gn, BN, g, K, mc + s0, sub_valid, n0, kSub, BN);
      __syncthreads();
      for (int r = 0; r < sub_valid; ++r) {
        float xv[RPT], gv[RPT], dv[4], tv[4];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          xv[j] = xn[r * BN + tx + 32 * j];
          gv[j] = gn[r * BN + tx + 32 * j];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dv[c] = dps[(s0 + r) * kBF + ty * 4 + c];
          tv[c] = ts[(s0 + r) * kBF + ty * 4 + c];
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc1[j][c] = fmaf(xv[j], dv[c], acc1[j][c]);
            acc2[c][j] = fmaf(tv[c], gv[j], acc2[c][j]);
          }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int n = n0 + tx + 32 * j;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + ty * 4 + c;
      dw1p[((size_t)split * K + n) * F + f] = acc1[j][c];
      dw2p[((size_t)split * F + f) * K + n] = acc2[c][j];
    }
  }
  if (blockIdx.y == 0) {
    __syncthreads();
    red[ty * kBF + tx] = db;
    __syncthreads();
    if (ty == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * kBF + tx];
      db1p[(size_t)split * F + f0 + tx] = s;
    }
  }
}

// ---- bf16 / fp16: tensor cores (wmma)
constexpr int kTcBM = 64;   // rows per recompute step
constexpr int kTcKC = 128;  // K depth of a staged recompute chunk

template <typename T, int NBW>
struct TcLayout {
  static constexpr int BN = 128 * NBW;
  static constexpr int LX = kTcKC + 8, LW1 = kBF + 8, LP = kBF + 4,
                       LT = kBF + 8, LN = BN + 8;
  // byte offsets, each a multiple of 32 (wmma's pointer alignment). The
  // recompute's staging (xs, gs, w1s, w2s) and the update's x / g slices
  // (xn, gn) share one region: a chunk uses them one after the other.
  static constexpr size_t xs = 0;
  static constexpr size_t gs = xs + sizeof(T) * kTcBM * LX;
  static constexpr size_t w1s = gs + sizeof(T) * kTcBM * LX;
  static constexpr size_t w2s = w1s + sizeof(T) * kTcKC * LW1;
  static constexpr size_t staging = w2s + sizeof(T) * kBF * LX;
  static constexpr size_t xn = 0;
  static constexpr size_t gn = xn + sizeof(T) * kTcBM * LN;
  static constexpr size_t slices = gn + sizeof(T) * kTcBM * LN;
  static constexpr size_t pre = staging > slices ? staging : slices;
  static constexpr size_t dt = pre + sizeof(float) * kTcBM * LP;
  static constexpr size_t ts = dt + sizeof(float) * kTcBM * LP;
  static constexpr size_t dps = ts + sizeof(T) * kTcBM * LT;
  static constexpr size_t red = dps + sizeof(T) * kTcBM * LT;
  static constexpr size_t bytes = red + sizeof(float) * 8 * kBF;
};

template <typename T, int NBW>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dw_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, float* __restrict__ dw1p,
                         float* __restrict__ dw2p, float* __restrict__ db1p,
                         int M, int K, int F, int rows_per_split, int act,
                         int vec) {
  using namespace nvcuda;
  using L = TcLayout<T, NBW>;
  using FragA =
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
  using FragAt =
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major>;
  using FragB =
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
  using FragBt =
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L::xs);          // [64][LX]
  T* gs = reinterpret_cast<T*>(smem_raw + L::gs);          // [64][LX]
  T* w1s = reinterpret_cast<T*>(smem_raw + L::w1s);        // [KC][LW1]
  T* w2s = reinterpret_cast<T*>(smem_raw + L::w2s);        // [32][LX]
  T* xn = reinterpret_cast<T*>(smem_raw + L::xn);          // [64][LN]
  T* gn = reinterpret_cast<T*>(smem_raw + L::gn);          // [64][LN]
  float* pre = reinterpret_cast<float*>(smem_raw + L::pre);  // [64][LP]
  float* dtm = reinterpret_cast<float*>(smem_raw + L::dt);   // [64][LP]
  T* ts = reinterpret_cast<T*>(smem_raw + L::ts);          // [64][LT]
  T* dps = reinterpret_cast<T*>(smem_raw + L::dps);        // [64][LT]
  float* red = reinterpret_cast<float*>(smem_raw + L::red);  // [8][kBF]

  const int warp = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  // the recompute: warps 0-3 two tiles of pre, 4-7 two of dt (rows
  // 16 fr .. and 16 (fr + 1) .., columns 16 fc ..)
  const bool is_dt = warp >= 4;
  const int fr = ((warp >> 1) & 1) * 2, fc = warp & 1;
  const int f0 = blockIdx.x * kBF;
  const int n0 = blockIdx.y * L::BN;
  const int split = blockIdx.z;
  const int row_begin = min(M, split * rows_per_split);
  const int row_end = min(M, row_begin + rows_per_split);
  const float bias = to_f(b1[f0 + tx]);
  const T zero = from_f<T>(0.f);
  const T* a_src = is_dt ? gs : xs;

  FragC acc1[NBW][2], acc2[2][NBW];  // dW1 [n][f], dW2 [f][n] tiles
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int fb = 0; fb < 2; ++fb) {
      wmma::fill_fragment(acc1[nb][fb], 0.f);
      wmma::fill_fragment(acc2[fb][nb], 0.f);
    }
  float db = 0.f;  // column f0 + tx, rows 8 i + warp of each chunk

  for (int mc = row_begin; mc < row_end; mc += kTcBM) {
    const int n_valid = min(kTcBM, row_end - mc);
    FragC rc[2];
    wmma::fill_fragment(rc[0], 0.f);
    wmma::fill_fragment(rc[1], 0.f);
    for (int k0 = 0; k0 < K; k0 += kTcKC) {
      __syncthreads();  // the previous chunk's update (same region) is done
      copy_tile(xs, L::LX, x, K, mc, n_valid, k0, kTcBM, kTcKC, vec);
      copy_tile(gs, L::LX, g, K, mc, n_valid, k0, kTcBM, kTcKC, vec);
      copy_tile(w1s, L::LW1, w1, F, k0, kTcKC, f0, kTcKC, kBF, vec);
      // W2 rows f0 .., columns k0 ..: W2^T read column-major
      copy_tile(w2s, L::LX, w2, K, f0, kBF, k0, kBF, kTcKC, vec);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcKC; kk += 16) {
        FragA a[2];
        wmma::load_matrix_sync(a[0], a_src + fr * 16 * L::LX + kk, L::LX);
        wmma::load_matrix_sync(a[1], a_src + (fr + 1) * 16 * L::LX + kk,
                               L::LX);
        if (is_dt) {
          FragBt b;
          wmma::load_matrix_sync(b, w2s + fc * 16 * L::LX + kk, L::LX);
          wmma::mma_sync(rc[0], a[0], b, rc[0]);
          wmma::mma_sync(rc[1], a[1], b, rc[1]);
        } else {
          FragB b;
          wmma::load_matrix_sync(b, w1s + kk * L::LW1 + fc * 16, L::LW1);
          wmma::mma_sync(rc[0], a[0], b, rc[0]);
          wmma::mma_sync(rc[1], a[1], b, rc[1]);
        }
      }
    }
    float* rdst = is_dt ? dtm : pre;
    wmma::store_matrix_sync(rdst + fr * 16 * L::LP + fc * 16, rc[0], L::LP,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(rdst + (fr + 1) * 16 * L::LP + fc * 16, rc[1],
                            L::LP, wmma::mem_row_major);
    __syncthreads();  // pre / dt complete; the staging region is free
#pragma unroll
    for (int i = 0; i < kTcBM / 8; ++i) {
      const int r = i * 8 + warp;
      const float p = pre[r * L::LP + tx] + bias;
      const float d32 =
          r < n_valid ? dtm[r * L::LP + tx] * act_grad(p, act) : 0.f;
      db += d32;
      ts[r * L::LT + tx] = r < n_valid ? from_f<T>(act_fwd(p, act)) : zero;
      dps[r * L::LT + tx] = from_f<T>(d32);
    }
    copy_tile(xn, L::LN, x, K, mc, n_valid, n0, kTcBM, L::BN, vec);
    copy_tile(gn, L::LN, g, K, mc, n_valid, n0, kTcBM, L::BN, vec);
    copy_wait();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcBM; kk += 16) {
      FragB dpb[2];
      FragAt tsa[2];
#pragma unroll
      for (int fb = 0; fb < 2; ++fb) {
        wmma::load_matrix_sync(dpb[fb], dps + kk * L::LT + fb * 16, L::LT);
        wmma::load_matrix_sync(tsa[fb], ts + kk * L::LT + fb * 16, L::LT);
      }
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb) {
        const int n = (warp * NBW + nb) * 16;
        FragAt xa;
        FragB gb;
        wmma::load_matrix_sync(xa, xn + kk * L::LN + n, L::LN);
        wmma::load_matrix_sync(gb, gn + kk * L::LN + n, L::LN);
#pragma unroll
        for (int fb = 0; fb < 2; ++fb) {
          wmma::mma_sync(acc1[nb][fb], xa, dpb[fb], acc1[nb][fb]);
          wmma::mma_sync(acc2[fb][nb], tsa[fb], gb, acc2[fb][nb]);
        }
      }
    }
  }

#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) {
    const int n = n0 + (warp * NBW + nb) * 16;
#pragma unroll
    for (int fb = 0; fb < 2; ++fb) {
      const int f = f0 + fb * 16;
      wmma::store_matrix_sync(dw1p + ((size_t)split * K + n) * F + f,
                              acc1[nb][fb], F, wmma::mem_row_major);
      wmma::store_matrix_sync(dw2p + ((size_t)split * F + f) * K + n,
                              acc2[fb][nb], K, wmma::mem_row_major);
    }
  }
  if (blockIdx.y == 0) {
    __syncthreads();
    red[warp * kBF + tx] = db;
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * kBF + tx];
      db1p[(size_t)split * F + f0 + tx] = s;
    }
  }
}

template <typename T, int NBW>
cudaError_t launch_tc(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dw1p, void* dw2p,
                      void* db1p, int M, int K, int F, int rows_per_split,
                      int splits, int act, cudaStream_t stream) {
  using L = TcLayout<T, NBW>;
  auto kernel = ffn_bwd_dw_tc_kernel<T, NBW>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kBF, K / L::BN, splits);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<float*>(dw1p),
      static_cast<float*>(dw2p), static_cast<float*>(db1p), M, K, F,
      rows_per_split, act, vec16(x, g, w1, w2));
  return cudaGetLastError();
}

template <typename T, int RPT>
cudaError_t launch(const void* x, const void* g, const void* w1,
                   const void* b1, const void* w2, void* dw1p, void* dw2p,
                   void* db1p, int M, int K, int F, int splits, int act,
                   cudaStream_t stream) {
  // rows of a split: a multiple of the recompute step, so every split
  // but the last is whole steps
  constexpr int step = sizeof(T) == 2 ? kTcBM : kBM;
  const int chunks = (M + step - 1) / step;
  const int rows_per_split = (chunks + splits - 1) / splits * step;
  if constexpr (sizeof(T) == 2) {  // BN = 32 * RPT = 128 * (RPT / 4)
    return launch_tc<T, RPT / 4>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                 F, rows_per_split, splits, act, stream);
  } else {
    constexpr int BN = 32 * RPT;
    const size_t smem = (size_t)(2 * kBM * kKC + kKC * kBF +
                                 kKC * (kBF + 1) + 2 * kBM * kBF +
                                 2 * kSub * BN + 8 * kBF) *
                        sizeof(float);
    auto kernel = ffn_bwd_dw_kernel<T, RPT>;
    static size_t smem_set = 48 * 1024;
    cudaError_t err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(F / kBF, K / BN, splits);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<float*>(dw1p),
        static_cast<float*>(dw2p), static_cast<float*>(db1p), M, K, F,
        rows_per_split, act);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dw1p, void* dw2p,
                      void* db1p, int M, int K, int F, int BN, int splits,
                      int act, cudaStream_t stream) {
  switch (BN) {
    case 128:
      return launch<T, 4>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                          splits, act, stream);
    case 256:
      return launch<T, 8>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                          splits, act, stream);
    case 384:
      return launch<T, 12>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                           splits, act, stream);
    case 512:
      return launch<T, 16>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                           splits, act, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g [M, K], w1 [K, F], b1 [F], w2 [F, K] of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16); fp32 partials dw1p [splits, K, F], dw2p
// [splits, F, K], db1p [splits, F], every element written. BN: the K rows
// of a block (128, 256, 384 or 512, dividing K); F a multiple of 32;
// 1 <= splits <= 65535. act: 0 = tanh gelu, 1 = exact gelu. Returns a
// cudaError_t (0 on success); the caller has validated shapes, devices
// and layout.
extern "C" int paddle_fused_ffn_bwd_dw(const void* x, const void* g,
                                       const void* w1, const void* b1,
                                       const void* w2, void* dw1p,
                                       void* dw2p, void* db1p, int M, int K,
                                       int F, int BN, int splits, int act,
                                       int dtype, void* stream) {
  if (M < 1 || K < 1 || F < 1 || F % kBF || BN < 1 || K % BN ||
      splits < 1 || splits > 65535 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bn<float>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                   F, BN, splits, act, s);
    case 1:
      return (int)launch_bn<__nv_bfloat16>(x, g, w1, b1, w2, dw1p, dw2p,
                                           db1p, M, K, F, BN, splits, act,
                                           s);
    case 2:
      return (int)launch_bn<__half>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                    F, BN, splits, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
