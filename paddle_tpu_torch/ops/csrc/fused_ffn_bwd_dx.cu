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
// F; 116 GFLOP at GPT-2's training shape, 0.117 ms at the bf16 peak).
//
// Two designs; the wrapper picks one (ops/fused_ffn.py's kernel_path) and
// passes it as `tc`; each entry runs that design or fails:
// - bf16 and fp16, tc = 1 (ffn_dx_tc::kernel): flash dQ's shape on
//   wgmma. A block owns 128 rows (64 a consumer warpgroup, two of them)
//   and BN = 256 columns of dx (128 where 256 does not divide K), its
//   [64, BN] fp32 accumulator in each consumer's registers (128 a
//   thread). It walks F in tiles of 64; per tile it recomputes pre = x
//   W1[:, f] (B MN-major: the W1 chunk's rows run along the depth) and dt
//   = g W2[f, :]^T (B K-major) into fp32 accumulators, K / 64 chunks
//   deep, one chunk's products in flight while the next is issued; then
//   forms dpre = dt * act'(pre + b1) in the registers, turns it into A
//   fragments in place (wgmma_tile.cuh's to_frags: the rounding to T),
//   and adds dpre W1[n, f]^T as register-A wgmma against the [BN, 64] W1
//   slice read K-major. The recompute repeats once per column block: K /
//   BN = 3 times at K = 768, so 7 of the 2 M K F products run where the
//   bound counts 3 (registers set BN: a [64, 384] accumulator would not
//   fit beside pre and dt).
//   The K / BN blocks of one row block need the same x, g, W1 and W2
//   chunks: loaded by each, they are 5.6 GB from L2 at GPT-2's shape, and
//   L2's bandwidth bounds the kernel. So those blocks form a thread block
//   cluster and rank 0 loads each [128, 64] x / g and [64, 64] W1 / W2
//   chunk (48 KB a stage, four stages) once with TMA, multicast to all
//   (tma_tile.cuh); each block loads its own W1 slice. A third warpgroup produces (setmaxnreg: 24 registers; the
//   consumers 240), so no thread that issues loads or waits on the ring
//   sits in the consumers' path, where ptxas serialized the wgmmas in
//   flight. The card holds 39 clusters of three (117 SMs): where 64 row
//   blocks would leave a 1.64-wave tail, the wrapper splits F into up to
//   four ranges (fp32 partials [S, M, K], summed in a fixed order, dx
//   rounded once) so the clusters fill whole waves. 225 KB of shared
//   memory, one block an SM; registers: 168 at launch, the consumers' 240
//   by setmaxnreg, no spills (ptxas -v in the build log). Rows past M
//   read as zero (TMA), so their dpre is 0.
// - fp32, tc = 0 (ffn_bwd_dx_kernel): the fp32 cores, the forward's
//   (fused_ffn_fwd.cu) shape. A block owns 32 rows and BN columns of dx,
//   its [32, BN] fp32 accumulator in registers; per F tile of 128 it
//   computes the pre and dt tiles together from [32, 32] chunks of x and
//   g and [32, 128] chunks of W1 and W2^T (W2 staged transposed, odd row
//   stride), forms dpre in shared memory, then adds dpre @ W1^T from [16,
//   BN] chunks of W1^T (staged transposed).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "ffn_tile.cuh"
#include "tma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace paddle_ffn;

constexpr int kBM = 32;
constexpr int kBF = 128;
constexpr int kKC = 32;
constexpr int kFC = 16;

template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dx_kernel(const float* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ dx,
                      int M, int K, int F, int act) {
  constexpr int BN = 32 * TN;
  constexpr int kLdT = kBF + 1;  // W2^T chunk row stride
  constexpr int kLdW = BN + 1;   // W1^T chunk row stride
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kBM][kKC]
  float* gs = xs + kBM * kKC;      // [kBM][kKC]
  float* w1s = gs + kBM * kKC;     // [kKC][kBF]
  float* w2ts = w1s + kKC * kBF;   // [kKC][kLdT]   W2^T chunk
  float* ds = w2ts + kKC * kLdT;   // [kBM][kBF]    dpre
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
      const float bias = b1[f0 + tx + 32 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[(ty * 4 + i) * kBF + tx + 32 * c] =
            dt[i][c] * act_grad(pre[i][c] + bias, act);
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
      if (r < n_valid) dx[(size_t)(m0 + r) * K + n] = acc[i][j];
    }
  }
}

template <int TN>
cudaError_t launch_fp32_cores(const void* x, const void* g, const void* w1,
                              const void* b1, const void* w2, void* dx,
                              int M, int K, int F, int act,
                              cudaStream_t stream) {
  constexpr int BN = 32 * TN;
  const size_t smem = (size_t)(2 * kBM * kKC + kKC * kBF + kKC * (kBF + 1) +
                               kBM * kBF + kFC * (BN + 1)) *
                      sizeof(float);
  auto kernel = ffn_bwd_dx_kernel<TN>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, K / BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<float*>(dx), M, K, F, act);
  return cudaGetLastError();
}

cudaError_t launch_fp32_bn(const void* x, const void* g, const void* w1,
                           const void* b1, const void* w2, void* dx, int M,
                           int K, int F, int BN, int act,
                           cudaStream_t stream) {
  if (F % kBF) return cudaErrorInvalidValue;
  switch (BN) {
    case 128:
      return launch_fp32_cores<4>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 256:
      return launch_fp32_cores<8>(x, g, w1, b1, w2, dx, M, K, F, act, stream);
    case 384:
      return launch_fp32_cores<12>(x, g, w1, b1, w2, dx, M, K, F, act,
                                   stream);
    case 512:
      return launch_fp32_cores<16>(x, g, w1, b1, w2, dx, M, K, F, act,
                                   stream);
    case 768:
      return launch_fp32_cores<24>(x, g, w1, b1, w2, dx, M, K, F, act,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- bf16 / fp16: wgmma (the design in the note at the top)
namespace ffn_dx_tc {

namespace wg = paddle_attn::wg;
namespace tma = paddle_attn::tma;

constexpr int kConsumers = 2;               // warpgroups, 64 rows each
constexpr int kThreadsTc = (kConsumers + 1) * wg::kThreads;  // + producer
constexpr int kRows = 64 * kConsumers;      // rows of dx a block
constexpr int kTile = 64;                   // F columns a tile, K a chunk
constexpr int kStages = 4;
constexpr int kXBytes = kRows * kTile * 2;  // an x or g chunk [128][64]
constexpr int kWBytes = kTile * kTile * 2;  // a W1 or W2 chunk [64][64]
constexpr int kStageBytes = 2 * kXBytes + 2 * kWBytes;
constexpr int kMaxCluster = 4;

template <int BN>
constexpr int smem_bytes() {
  // the ring, the W1 slice [BN][64], the mbarriers, alignment
  return kStages * kStageBytes + BN * kTile * 2 + 128 + 1024;
}

// NB = BN / 128: the m64n128 accumulators of a warpgroup's [64, BN] dx.
// The csize blocks of a cluster share their rows and differ in their
// columns, so they need the same chunks: the cluster's rank 0 loads each
// once, multicast to all. Warpgroup 0 produces (one thread the chunks,
// one the W1 slices), 1 and 2 consume.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreadsTc, 1)
    kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_g,
           const __grid_constant__ CUtensorMap tm_w1,
           const __grid_constant__ CUtensorMap tm_w2,
           const __grid_constant__ CUtensorMap tm_w1t,
           const T* __restrict__ b1, T* __restrict__ dx,
           float* __restrict__ dx32, int M, int K, int F, int act,
           int csize) {
  constexpr int BN = 128 * NB;
  constexpr int kW1tBytes = BN * kTile * 2;  // the W1 slice of an F tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t w1t = ring + kStages * kStageBytes;
  // mbarriers: full[kStages] (the chunk landed here), empty[kStages] (this
  // CTA's consumers are done with it), cempty[kStages] (the cluster's
  // are: rank 0's is the one used), the W1 slice's full and empty
  const uint32_t full0 = w1t + kW1tBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t cempty0 = empty0 + 8 * kStages;
  const uint32_t w1t_full = cempty0 + 8 * kStages;
  const uint32_t w1t_empty = w1t_full + 8;

  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int t = tid % wg::kThreads;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * BN;
  const int nc = K / kTile;            // K chunks an F tile
  // this block's F tiles: range blockIdx.z of gridDim.z
  const int f_lo = (int)blockIdx.z * (F / kTile) / (int)gridDim.z;
  const int nf = ((int)blockIdx.z + 1) * (F / kTile) / (int)gridDim.z - f_lo;
  const int total = nf * nc;           // chunks of the walk
  const uint32_t rank = tma::cta_rank();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(full0 + 8 * s, 1);
      tma::bar_init(empty0 + 8 * s, kConsumers);
      tma::bar_init(cempty0 + 8 * s, kConsumers * csize);
    }
    tma::bar_init(w1t_full, 1);
    tma::bar_init(w1t_empty, kConsumers);
    tma::fence_bar_init();
  }
  tma::cluster_sync();  // every CTA's mbarriers exist before any load

  if (wgi == 0) {
    tma::regs_dec<24>();
    if (t == 0) {
      // chunk c (F tile f_lo + c / nc, K chunk c % nc) into stage c %
      // kStages:
      // its bytes expected here once this CTA is done with chunk c -
      // kStages; on rank 0 its four loads once the cluster is
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int c = 0; c < total; ++c) {
        const int s = c % kStages;
        const uint32_t full = full0 + 8 * s;
        if (c >= kStages) tma::wait(empty0 + 8 * s, (c / kStages - 1) & 1);
        tma::expect_tx(full, kStageBytes);
        if (rank != 0) continue;
        if (c >= kStages) tma::wait(cempty0 + 8 * s, (c / kStages - 1) & 1);
        const int f0 = (f_lo + c / nc) * kTile, k0 = c % nc * kTile;
        const uint32_t st = ring + s * kStageBytes;
        tma::load(st, &tm_x, k0, m0, full, mask);
        tma::load(st + kXBytes, &tm_g, k0, m0, full, mask);
        tma::load(st + 2 * kXBytes, &tm_w1, f0, k0, full, mask);
        tma::load(st + 2 * kXBytes + kWBytes, &tm_w2, k0, f0, full, mask);
      }
    } else if (t == 32) {
      // the W1 slice of each F tile, this block's own columns, once the
      // consumers are done with the previous one
      for (int ft = 0; ft < nf; ++ft) {
        if (ft > 0) tma::wait(w1t_empty, (ft - 1) & 1);
        tma::expect_tx(w1t_full, kW1tBytes);
        tma::load(w1t, &tm_w1t, (f_lo + ft) * kTile, n0, w1t_full, 1);
      }
    }
  } else {
    tma::regs_inc<240>();
    const int grp = wgi - 1;  // this warpgroup's 64 rows
    const int lane = t & 31;
    float acc[NB][64];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    float pre[32], dt[32];

    // a stage goes back to this CTA's producer and the cluster's rank 0
    auto release = [&](int c) {
      tma::arrive(empty0 + 8 * (c % kStages), t == 0);
      tma::arrive_at(cempty0 + 8 * (c % kStages), 0, t == 0);
    };
    for (int ft = 0; ft < nf; ++ft) {
      // pre and dt of F tile ft, K / 64 chunks deep, the products of one
      // chunk in flight while the next is issued (no other instruction
      // touches pre and dt meanwhile: ptxas would serialize them)
      for (int kc = 0; kc < nc; ++kc) {
        const int it = ft * nc + kc;
        const uint32_t st = ring + (it % kStages) * kStageBytes;
        tma::wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
        const uint32_t xs = st + grp * 64 * 128;
        const uint32_t gs = st + kXBytes + grp * 64 * 128;
        const uint32_t w1s = st + 2 * kXBytes;
        const uint32_t w2s = w1s + kWBytes;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_ss_t<T, 0, 1>(pre, wg::desc_k<kRows>(xs, kk),
                                wg::desc_mn<kTile>(w1s, kk),
                                kc > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_ss<T>(dt, wg::desc_k<kRows>(gs, kk),
                        wg::desc_k<kTile>(w2s, kk), kc > 0 || kk > 0);
        wg::commit();
        wg::wait<1>();
        if (kc > 0) release(it - 1);
      }
      wg::wait<0>();
      wg::fence_regs(pre);
      wg::fence_regs(dt);
      release(ft * nc + nc - 1);

      // dpre = dt * act'(pre + b1) at columns f0 + 8 j + 2 (lane % 4) + c
      const int f0 = (f_lo + ft) * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = f0 + 8 * j + 2 * (lane & 3);
        const float bias[2] = {paddle_attn::to_f(b1[f]),
                               paddle_attn::to_f(b1[f + 1])};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            dt[r] *= act_grad(pre[r] + bias[c], act);
          }
      }
      uint32_t da[4][4];
      wg::to_frags<T>(dt, da);
      tma::wait(w1t_full, ft & 1);
      wg::fence();
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_rs128_t<T, 0>(acc[h], da[kk],
                                wg::desc_k<BN>(w1t + h * 128 * 128, kk), 1);
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int h = 0; h < NB; ++h) wg::fence_regs(acc[h]);
      tma::arrive(w1t_empty, t == 0);
    }

    const int n_valid = min(kRows, M - m0) - 64 * grp;
    if (dx32 == nullptr) {  // one F range: dx, rounded once
      const float one[2] = {1.f, 1.f};
#pragma unroll
      for (int h = 0; h < NB; ++h)
        wg::store_rows<T, 64>(
            dx + (size_t)(m0 + 64 * grp) * K + n0 + 128 * h, K, n_valid,
            acc[h], one, t);
    } else {  // this range's fp32 partial of dx, slot blockIdx.z
      const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
      float* base = dx32 + ((size_t)blockIdx.z * M + m0 + 64 * grp) * K +
                    n0 + 2 * (t & 3);
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (r0 + 8 * i >= n_valid) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(base + (size_t)(r0 + 8 * i) * K +
                                       128 * h + 8 * j) =
                make_float2(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1]);
        }
    }
  }
  tma::cluster_sync();  // no CTA leaves while another may still signal it
}

// The launch of kernel<T, NB> for K columns: its cluster size and config
// (grid, shared memory, the cluster attribute in attr).
template <typename T, int NB>
cudaLaunchConfig_t config(int M, int K, int splits, cudaLaunchAttribute* attr,
                          int* csize, cudaStream_t stream) {
  const int nblk = K / (128 * NB);
  *csize = tma::cluster_size(nblk, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kRows - 1) / kRows, nblk, splits);
  cfg.blockDim = dim3(kThreadsTc);
  cfg.dynamicSmemBytes = smem_bytes<128 * NB>();
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
// columns (the wrapper's F split reads it), or a negative cudaError_t.
template <typename T, int NB>
int slots(int K) {
  auto fn = kernel<T, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<128 * NB>());
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  int csize;
  const cudaLaunchConfig_t cfg = config<T, NB>(1, K, 1, attr, &csize, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int NB>
cudaError_t launch_nb(const void* x, const void* g, const void* w1,
                      const void* b1, const void* w2, void* dx, int M, int K,
                      int F, int splits, int act, cudaStream_t stream) {
  constexpr int BN = 128 * NB;
  constexpr int smem = smem_bytes<BN>();
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap maps[5];
  const void* ptrs[5] = {x, g, w1, w2, w1};
  const uint64_t rows[5] = {(uint64_t)M, (uint64_t)M, (uint64_t)K,
                            (uint64_t)F, (uint64_t)K};
  const uint64_t cols[5] = {(uint64_t)K, (uint64_t)K, (uint64_t)F,
                            (uint64_t)K, (uint64_t)F};
  const uint32_t box[5] = {kRows, kRows, kTile, kTile, BN};
  for (int i = 0; i < 5; ++i) {
    cudaError_t err = tma::make_map(&maps[i], ptrs[i], half, rows[i],
                                    cols[i], cols[i], box[i]);
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
      config<T, NB>(M, K, splits, attr, &csize, stream);
  // one F range writes dx; several write fp32 partials [splits, M, K]
  err = cudaLaunchKernelEx(
      &cfg, fn, maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const T*>(b1), splits == 1 ? static_cast<T*>(dx) : nullptr,
      splits == 1 ? nullptr : static_cast<float*>(dx), M, K, F, act, csize);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BN 256 or 128 (dividing K); F a multiple of 64; 1 <= splits <= F / 64
// F ranges; x, g, W1, W2 16-byte aligned (the tensor maps' rule), dx
// 8-byte aligned.
template <typename T>
cudaError_t launch(const void* x, const void* g, const void* w1,
                   const void* b1, const void* w2, void* dx, int M, int K,
                   int F, int BN, int splits, int act, cudaStream_t stream) {
  if (F % kTile || K % BN || splits > F / kTile || splits > 65535)
    return cudaErrorInvalidValue;
  if (!wg::aligned16(x, g, w1, w2) ||
      reinterpret_cast<uintptr_t>(dx) % 8)
    return cudaErrorMisalignedAddress;
  if (BN == 256)
    return launch_nb<T, 2>(x, g, w1, b1, w2, dx, M, K, F, splits, act,
                           stream);
  if (BN == 128)
    return launch_nb<T, 1>(x, g, w1, b1, w2, dx, M, K, F, splits, act,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace ffn_dx_tc

// x, g [M, K], w1 [K, F], b1 [F], w2 [F, K], all of one dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. dx: [M, K] in that dtype when
// splits is 1, else fp32 partials [splits, M, K] over that many ranges of
// F (tc only; the caller sums them). BN: the dx columns of a block,
// dividing K (tc: 256 or 128; fp32 cores: 128, 256, 384, 512 or 768).
// act: 0 = tanh gelu, 1 = exact gelu. tc: the design the wrapper chose
// (1 = wgmma, bf16 and fp16 only; 0 = fp32 cores, fp32 only); any other
// pairing returns cudaErrorInvalidValue. Returns a cudaError_t (0 on
// success); the caller has validated shapes and devices.
extern "C" int paddle_fused_ffn_bwd_dx(const void* x, const void* g,
                                       const void* w1, const void* b1,
                                       const void* w2, void* dx, int M,
                                       int K, int F, int BN, int splits,
                                       int act, int dtype, int tc,
                                       void* stream) {
  if (M < 1 || K < 1 || F < 1 || BN < 1 || K % BN || splits < 1 ||
      (act != 0 && act != 1) || (tc != 0 && tc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc)
    return dtype == 0 && splits == 1
               ? (int)launch_fp32_bn(x, g, w1, b1, w2, dx, M, K, F, BN, act,
                                     s)
               : (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return (int)ffn_dx_tc::launch<__nv_bfloat16>(x, g, w1, b1, w2, dx, M,
                                                   K, F, BN, splits, act, s);
    case 2:
      return (int)ffn_dx_tc::launch<__half>(x, g, w1, b1, w2, dx, M, K, F,
                                            BN, splits, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the tensor-core dx kernel (bf16 or fp16: dtype 1
// or 2) at K columns with blocks of BN the card holds at once, or a
// negative cudaError_t: the wrapper's choice of F ranges reads it.
extern "C" int paddle_fused_ffn_bwd_dx_slots(int K, int BN, int dtype) {
  if (K < 1 || (BN != 128 && BN != 256) || K % BN ||
      (dtype != 1 && dtype != 2))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 1)
    return BN == 256 ? ffn_dx_tc::slots<__nv_bfloat16, 2>(K)
                     : ffn_dx_tc::slots<__nv_bfloat16, 1>(K);
  return BN == 256 ? ffn_dx_tc::slots<__half, 2>(K)
                   : ffn_dx_tc::slots<__half, 1>(K);
}
