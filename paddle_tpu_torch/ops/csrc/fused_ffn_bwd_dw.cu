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
// 155 GFLOP at GPT-2's training shape, 0.156 ms at the bf16 peak).
//
// The TPU kernel keeps dW1 and dW2 of one F tile, 2 * K * bf fp32, in VMEM
// while it walks all of M; no SM holds that. Here a block owns an F tile,
// a K tile of BN columns and one of S row ranges, and writes its partial
// sums to its own slot of fp32 partials [S, K, F], [S, F, K] and (from the
// K tile 0 blocks) [S, F]; the wrapper sums the S partials after the
// kernel. No atomics, so the result does not depend on scheduling
// (layer_norm_bwd.cu's dgamma discipline). Two designs; the wrapper picks
// one (ops/fused_ffn.py's kernel_path) and passes it as `tc`; each entry
// runs that design or fails:
// - bf16 and fp16, tc = 1 (ffn_dw_tc::kernel): flash dK/dV's shape on
//   wgmma, in the transposed formulation. A block owns 64 F rows (one
//   wgmma m64 tile) and BN = 256 columns (128 where 256 does not divide
//   K), and walks its row range 64 rows a step. Two consumer warpgroups
//   split the work by role. Per step, K / 64 chunks deep, consumer 0
//   recomputes dt^T [64 F, 64 M] = W2[f, :] g^T (A and B K-major) and
//   consumer 1 pre^T = W1[:, f]^T x^T, its A the W1 chunk [64 K][64 F]
//   read MN-major through wgmma's transpose flag for A (wgmma_tile.cuh's
//   mma_ss_t; no transposed copy). Consumer 1 adds b1, forms t^T =
//   act(pre^T) in its registers and hands act'(pre^T) to consumer 0
//   through 16 KB of shared memory (fp32); consumer 0 forms dpre32^T =
//   dt^T act'(pre^T) and takes db1 as its rows' sums, unrounded (quad
//   shuffles at the end). Each turns its tile into A fragments in place
//   (to_frags: the rounding to T) and runs its register-A wgmma: dW1^T[f,
//   n] += dpre^T x[:, n] (consumer 0) and dW2[f, n] += t^T g[:, n]
//   (consumer 1), [64, BN] fp32 accumulators, 128 registers a thread at
//   BN = 256. Their B is the swizzled x / g chunks the recompute read
//   K-major, now read MN-major: each block copies the chunks of its own
//   columns out of the ring into an update region that holds them until
//   the step's products. The recompute repeats once per K tile: K / BN = 3
//   times at K = 768, so 8 of the 2 M K F products run where the bound
//   counts 4.
//   As in fused_ffn_bwd_dx.cu, the K / BN blocks of one F tile and row
//   range need the same chunks, so they form a cluster whose rank 0 loads
//   each [64, 64] x, g, W1 and W2 chunk (32 KB a stage, four stages) once
//   with TMA, multicast to all (tma_tile.cuh), a third warpgroup
//   producing (setmaxnreg: 24 registers; the consumers 240). The role
//   split's branch around the two kinds of wgmma still makes ptxas
//   serialize them (C7520 in the build log), so each chunk's products
//   complete before the next is issued. 209 KB of shared memory, one
//   block an SM; registers: 168 at launch, the consumers' 240, no spills;
//   the wrapper picks S so the clusters fill the card's cluster slots in
//   nearly whole waves. The dW1^T accumulator is stored transposed,
//   straight into [S, K, F] (a warp's stores cover 32 contiguous bytes of
//   4 rows). Rows past M read as zero (TMA), and a range is whole steps:
//   their pre is b1 and t = act(b1) is not 0, but g's zero rows make dt,
//   dpre and their terms of dW2 zero.
// - fp32, tc = 0 (ffn_bwd_dw_kernel): the fp32 cores. A block owns 32 F
//   columns and BN = 32 * RPT of K (the largest of 512, 384, 256, 128
//   dividing K), 32 rows a step, [32, 32] chunks staged as fp32, lane tx
//   owning K rows tx + 32 j and warp ty F columns 4 ty .. 4 ty + 3 of the
//   accumulators, and [8, BN] slices of x and g for the outer products.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "ffn_tile.cuh"
#include "tma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace paddle_ffn;

constexpr int kBF = 32;   // F columns of a block
constexpr int kBM = 32;   // rows per recompute step
constexpr int kKC = 32;   // K depth of a staged recompute chunk
constexpr int kSub = 8;   // rows per staged x / g slice of the update

template <int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dw_kernel(const float* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ dw1p,
                      float* __restrict__ dw2p, float* __restrict__ db1p,
                      int M, int K, int F, int rows_per_split, int act) {
  constexpr int BN = 32 * RPT;
  constexpr int kLdT = kBF + 1;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kBM][kKC]
  float* gs = xs + kBM * kKC;       // [kBM][kKC]
  float* w1s = gs + kBM * kKC;      // [kKC][kBF]
  float* w2ts = w1s + kKC * kBF;    // [kKC][kLdT]  W2^T chunk
  float* ts = w2ts + kKC * kLdT;    // [kBM][kBF]   t
  float* dps = ts + kBM * kBF;      // [kBM][kBF]   dpre
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
  const float bias = b1[f0 + tx];

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
      ts[r * kBF + tx] = r < n_valid ? act_fwd(p, act) : 0.f;
      dps[r * kBF + tx] = d32;
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

template <int RPT>
cudaError_t launch_fp32_cores(const void* x, const void* g, const void* w1,
                              const void* b1, const void* w2, void* dw1p,
                              void* dw2p, void* db1p, int M, int K, int F,
                              int splits, int act, cudaStream_t stream) {
  constexpr int BN = 32 * RPT;
  // rows of a split: a multiple of the recompute step, so every split
  // but the last is whole steps
  const int chunks = (M + kBM - 1) / kBM;
  const int rows_per_split = (chunks + splits - 1) / splits * kBM;
  const size_t smem = (size_t)(2 * kBM * kKC + kKC * kBF + kKC * (kBF + 1) +
                               2 * kBM * kBF + 2 * kSub * BN + 8 * kBF) *
                      sizeof(float);
  auto kernel = ffn_bwd_dw_kernel<RPT>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kBF, K / BN, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<float*>(dw1p),
      static_cast<float*>(dw2p), static_cast<float*>(db1p), M, K, F,
      rows_per_split, act);
  return cudaGetLastError();
}

cudaError_t launch_fp32_bn(const void* x, const void* g, const void* w1,
                           const void* b1, const void* w2, void* dw1p,
                           void* dw2p, void* db1p, int M, int K, int F,
                           int BN, int splits, int act,
                           cudaStream_t stream) {
  if (F % kBF) return cudaErrorInvalidValue;
  switch (BN) {
    case 128:
      return launch_fp32_cores<4>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                  F, splits, act, stream);
    case 256:
      return launch_fp32_cores<8>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                  F, splits, act, stream);
    case 384:
      return launch_fp32_cores<12>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                   F, splits, act, stream);
    case 512:
      return launch_fp32_cores<16>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K,
                                   F, splits, act, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- bf16 / fp16: wgmma (the design in the note at the top)
namespace ffn_dw_tc {

namespace wg = paddle_attn::wg;
namespace tma = paddle_attn::tma;

constexpr int kConsumers = 2;  // 0: dt^T, dW1^T; 1: pre^T, dW2
constexpr int kThreadsTc = (kConsumers + 1) * wg::kThreads;  // + producer
constexpr int kTile = 64;         // F rows a block, rows a step, K a chunk
constexpr int kPanel = 64 * 128;  // a [64][64] 16-bit chunk
constexpr int kStages = 4;
constexpr int kStageBytes = 4 * kPanel;  // x, g, W1 and W2 chunks
constexpr int kXchgBytes = 32 * wg::kThreads * 4;  // act'(pre^T), fp32
constexpr int kMaxCluster = 4;

template <int NB>
constexpr int smem_bytes() {
  // the ring, the update region (x and g at the block's BN columns), the
  // hand-over, the mbarriers, alignment
  return kStages * kStageBytes + 2 * (2 * NB) * kPanel + kXchgBytes + 128 +
         1024;
}

// NB = BN / 128: the m64n128 accumulators of a warpgroup's [64, BN] tile.
// The csize blocks of a cluster share their F tile and row range and
// differ in their columns, so they need the same chunks: the cluster's
// rank 0 loads each once, multicast to all. Warpgroup 0 produces (one
// thread), 1 and 2 consume.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreadsTc, 1)
    kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_g,
           const __grid_constant__ CUtensorMap tm_w1,
           const __grid_constant__ CUtensorMap tm_w2,
           const T* __restrict__ b1, float* __restrict__ dw1p,
           float* __restrict__ dw2p, float* __restrict__ db1p, int M, int K,
           int F, int rows_per_split, int act, int csize) {
  constexpr int BN = 128 * NB;
  constexpr int npan = BN / 64;  // K chunks (panels) of the block's columns
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t upd_x = ring + kStages * kStageBytes;
  const uint32_t upd_g = upd_x + npan * kPanel;
  const uint32_t xchg_s = upd_g + npan * kPanel;
  float* xchg = reinterpret_cast<float*>(smem_raw + (xchg_s - raw));
  // mbarriers: full[kStages] (the chunk landed here), empty[kStages] (this
  // CTA's consumers are done with it), cempty[kStages] (the cluster's
  // are: rank 0's is the one used)
  const uint32_t full0 = xchg_s + kXchgBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t cempty0 = empty0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int t = tid % wg::kThreads;
  const int f0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int row_begin = min(M, split * rows_per_split);
  const int row_end = min(M, row_begin + rows_per_split);
  const int nc = K / kTile;
  const int cn0 = n0 / kTile;
  // chunk c: row step c / nc, K chunk c % nc
  const int total = (row_end - row_begin + kTile - 1) / kTile * nc;
  const uint32_t rank = tma::cta_rank();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(full0 + 8 * s, 1);
      tma::bar_init(empty0 + 8 * s, kConsumers);
      tma::bar_init(cempty0 + 8 * s, kConsumers * csize);
    }
    tma::fence_bar_init();
  }
  tma::cluster_sync();  // every CTA's mbarriers exist before any load

  if (wgi == 0) {
    tma::regs_dec<24>();
    if (t == 0) {
      // chunk c into stage c % kStages: its bytes expected here once this
      // CTA is done with chunk c - kStages; on rank 0 its four loads once
      // the cluster is. Rows past M read as zero; a step never crosses
      // its range's end before M (ranges are whole steps)
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int c = 0; c < total; ++c) {
        const int s = c % kStages;
        const uint32_t full = full0 + 8 * s;
        if (c >= kStages) tma::wait(empty0 + 8 * s, (c / kStages - 1) & 1);
        tma::expect_tx(full, kStageBytes);
        if (rank != 0) continue;
        if (c >= kStages) tma::wait(cempty0 + 8 * s, (c / kStages - 1) & 1);
        const int mc = row_begin + c / nc * kTile, k0 = c % nc * kTile;
        const uint32_t st = ring + s * kStageBytes;
        tma::load(st, &tm_x, k0, mc, full, mask);
        tma::load(st + kPanel, &tm_g, k0, mc, full, mask);
        tma::load(st + 2 * kPanel, &tm_w1, f0, k0, full, mask);
        tma::load(st + 3 * kPanel, &tm_w2, k0, f0, full, mask);
      }
    }
  } else {
    tma::regs_inc<240>();
    const int grp = wgi - 1;
    const int ct = tid - wg::kThreads;  // thread among the consumers
    const int lane = t & 31;
    const int fr = 16 * (t >> 5) + (lane >> 2);  // F rows fr and fr + 8
    float acc[NB][64];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    float r[32];  // dt^T (warpgroup 0) or pre^T (1) of the step
    float db[2] = {0.f, 0.f};  // warpgroup 0: sums of dpre32 at rows fr, + 8
    const float bias[2] = {paddle_attn::to_f(b1[f0 + fr]),
                           paddle_attn::to_f(b1[f0 + fr + 8])};

    for (int it = 0; it < total; ++it) {
      const int kc = it % nc;
      const int s = it % kStages;
      const uint32_t st = ring + s * kStageBytes;
      tma::wait(full0 + 8 * s, (it / kStages) & 1);
      if (kc >= cn0 && kc < cn0 + npan) {
        // the block's own columns: keep the x and g chunks for the step's
        // dW products (the previous step's are done: the barrier after
        // them)
        const uint32_t off = (kc - cn0) * kPanel;
        const uint4* src =
            reinterpret_cast<const uint4*>(smem_raw + (st - raw));
        uint4* dst_x =
            reinterpret_cast<uint4*>(smem_raw + (upd_x + off - raw));
        uint4* dst_g =
            reinterpret_cast<uint4*>(smem_raw + (upd_g + off - raw));
        for (int i = ct; i < kPanel / 16; i += kConsumers * wg::kThreads) {
          dst_x[i] = src[i];
          dst_g[i] = src[kPanel / 16 + i];
        }
        tma::fence_async_smem();
        // the warpgroup's reads of the stage are done before it is freed
        tma::named_sync(2 + grp, wg::kThreads);
      }
      wg::fence();
      if (grp == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_ss<T>(r, wg::desc_k<kTile>(st + 3 * kPanel, kk),
                        wg::desc_k<kTile>(st + kPanel, kk), kc > 0 || kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_ss_t<T, 1, 0>(r, wg::desc_mn<kTile>(st + 2 * kPanel, kk),
                                wg::desc_k<kTile>(st, kk), kc > 0 || kk > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(r);
      // this warpgroup is done with the stage: tell this CTA's producer
      // and the cluster's rank 0
      tma::arrive(empty0 + 8 * s, t == 0);
      tma::arrive_at(cempty0 + 8 * s, 0, t == 0);
      if (kc != nc - 1) continue;

      // register q holds row fr + 8 ((q >> 1) & 1) of the tile
      if (grp == 1) {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          float tv, av;
          act_fwd_grad(r[q] + bias[(q >> 1) & 1], act, tv, av);
          xchg[q * wg::kThreads + t] = av;
          r[q] = tv;
        }
      }
      // act'(pre^T) handed over; the kept chunks copied
      tma::named_sync(1, kConsumers * wg::kThreads);
      if (grp == 0) {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          r[q] *= xchg[q * wg::kThreads + t];
          db[(q >> 1) & 1] += r[q];
        }
      }
      uint32_t a[4][4];
      wg::to_frags<T>(r, a);
      const uint32_t upd = grp == 0 ? upd_x : upd_g;
      wg::fence();
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_rs<T, 64>(acc[h], a[kk],
                            wg::desc_mn<kTile>(upd + 2 * h * kPanel, kk), 1);
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int h = 0; h < NB; ++h) wg::fence_regs(acc[h]);
      // the update region and the hand-over are free
      tma::named_sync(1, kConsumers * wg::kThreads);
    }

    // element (fr + 8 i, 128 h + 8 jj + 2 (lane % 4) + c) of the tile at
    // acc[h][4 jj + 2 i + c]
    const int nl = n0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = f0 + fr + 8 * i;
          const int n = nl + 128 * h + 8 * jj;
          const float v0 = acc[h][4 * jj + 2 * i];
          const float v1 = acc[h][4 * jj + 2 * i + 1];
          if (grp == 0) {  // dW1^T, stored as dW1 [K, F]
            dw1p[((size_t)split * K + n) * F + f] = v0;
            dw1p[((size_t)split * K + n + 1) * F + f] = v1;
          } else {
            *reinterpret_cast<float2*>(dw2p + ((size_t)split * F + f) * K +
                                       n) = make_float2(v0, v1);
          }
        }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = db[i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (blockIdx.y == 0 && (lane & 3) == 0)
          db1p[(size_t)split * F + f0 + fr + 8 * i] = v;
      }
    }
  }
  tma::cluster_sync();  // no CTA leaves while another may still signal it
}

// The launch of kernel<T, NB> for K columns: its cluster size and config
// (grid, shared memory, the cluster attribute in attr).
template <typename T, int NB>
cudaLaunchConfig_t config(int K, int F, int splits, cudaLaunchAttribute* attr,
                          int* csize, cudaStream_t stream) {
  const int nblk = K / (128 * NB);
  *csize = tma::cluster_size(nblk, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F / kTile, nblk, splits);
  cfg.blockDim = dim3(kThreadsTc);
  cfg.dynamicSmemBytes = smem_bytes<NB>();
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = *csize;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of kernel<T, NB> the card holds at once, for K
// columns (the wrapper's row split reads it), or a negative cudaError_t.
template <typename T, int NB>
int slots(int K) {
  auto fn = kernel<T, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NB>());
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  int csize;
  const cudaLaunchConfig_t cfg = config<T, NB>(K, kTile, 1, attr, &csize, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int NB>
cudaError_t launch_nb(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dw1p, void* dw2p,
                      void* db1p, int M, int K, int F, int rows_per_split,
                      int splits, int act, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NB>();
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap maps[4];
  const void* ptrs[4] = {x, g, w1, w2};
  const uint64_t rows[4] = {(uint64_t)M, (uint64_t)M, (uint64_t)K,
                            (uint64_t)F};
  const uint64_t cols[4] = {(uint64_t)K, (uint64_t)K, (uint64_t)F,
                            (uint64_t)K};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = tma::make_map(&maps[i], ptrs[i], half, rows[i],
                                    cols[i], cols[i], kTile);
    if (err != cudaSuccess) return err;
  }
  auto fn = kernel<T, NB>;
  // set on every launch (a function-local static in a template would be
  // one object across every library loaded with this code's headers)
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  int csize;
  const cudaLaunchConfig_t cfg =
      config<T, NB>(K, F, splits, attr, &csize, stream);
  err = cudaLaunchKernelEx(&cfg, fn, maps[0], maps[1], maps[2], maps[3],
                           static_cast<const T*>(b1),
                           static_cast<float*>(dw1p),
                           static_cast<float*>(dw2p),
                           static_cast<float*>(db1p), M, K, F,
                           rows_per_split, act, csize);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BN 256 or 128 (dividing K); F a multiple of 64; x, g, W1, W2 16-byte
// aligned (the tensor maps' rule), dw2p 8-byte aligned.
template <typename T>
cudaError_t launch(const void* x, const void* g, const void* w1,
                   const void* b1, const void* w2, void* dw1p, void* dw2p,
                   void* db1p, int M, int K, int F, int BN, int splits,
                   int act, cudaStream_t stream) {
  if (F % kTile || K % BN) return cudaErrorInvalidValue;
  if (!wg::aligned16(x, g, w1, w2) ||
      reinterpret_cast<uintptr_t>(dw2p) % 8)
    return cudaErrorMisalignedAddress;
  // rows of a split: whole steps, so every split but the last is whole
  const int steps = (M + kTile - 1) / kTile;
  const int rows_per_split = (steps + splits - 1) / splits * kTile;
  if (BN == 256)
    return launch_nb<T, 2>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                           rows_per_split, splits, act, stream);
  if (BN == 128)
    return launch_nb<T, 1>(x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F,
                           rows_per_split, splits, act, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ffn_dw_tc

// x, g [M, K], w1 [K, F], b1 [F], w2 [F, K] of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16); fp32 partials dw1p [splits, K, F], dw2p
// [splits, F, K], db1p [splits, F], every element written. BN: the K
// columns of a block, dividing K (tc: 256 or 128; fp32 cores: 128, 256,
// 384 or 512); 1 <= splits <= 65535. act: 0 = tanh gelu, 1 = exact gelu.
// tc: the design the wrapper chose (1 = wgmma, bf16 and fp16 only; 0 =
// fp32 cores, fp32 only); any other pairing returns cudaErrorInvalidValue.
// Returns a cudaError_t (0 on success); the caller has validated shapes
// and devices.
extern "C" int paddle_fused_ffn_bwd_dw(const void* x, const void* g,
                                       const void* w1, const void* b1,
                                       const void* w2, void* dw1p,
                                       void* dw2p, void* db1p, int M, int K,
                                       int F, int BN, int splits, int act,
                                       int dtype, int tc, void* stream) {
  if (M < 1 || K < 1 || F < 1 || BN < 1 || K % BN || splits < 1 ||
      splits > 65535 || (act != 0 && act != 1) || (tc != 0 && tc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc)
    return dtype == 0 ? (int)launch_fp32_bn(x, g, w1, b1, w2, dw1p, dw2p,
                                            db1p, M, K, F, BN, splits, act,
                                            s)
                      : (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return (int)ffn_dw_tc::launch<__nv_bfloat16>(
          x, g, w1, b1, w2, dw1p, dw2p, db1p, M, K, F, BN, splits, act, s);
    case 2:
      return (int)ffn_dw_tc::launch<__half>(x, g, w1, b1, w2, dw1p, dw2p,
                                            db1p, M, K, F, BN, splits, act,
                                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the tensor-core dW kernel (bf16 or fp16: dtype 1
// or 2) at K columns with blocks of BN the card holds at once, or a
// negative cudaError_t: the wrapper's choice of row ranges reads it.
extern "C" int paddle_fused_ffn_bwd_dw_slots(int K, int BN, int dtype) {
  if (K < 1 || (BN != 128 && BN != 256) || K % BN ||
      (dtype != 1 && dtype != 2))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 1)
    return BN == 256 ? ffn_dw_tc::slots<__nv_bfloat16, 2>(K)
                     : ffn_dw_tc::slots<__nv_bfloat16, 1>(K);
  return BN == 256 ? ffn_dw_tc::slots<__half, 2>(K)
                   : ffn_dw_tc::slots<__half, 1>(K);
}
