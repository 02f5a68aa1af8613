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
// GFLOP for 43 MB, 0.078 ms at the bf16 peak).
//
// Two designs; the wrapper picks one (ops/fused_ffn.py's kernel_path) and
// passes it as `tc`; the entry runs that design or fails:
// - bf16 and fp16, tc = 1 (ffn_fwd_tc::kernel): wgmma, with the tiles of
//   t = act(x W1 + b1) shared across a thread block cluster. A block owns
//   128 rows (64 a consumer warpgroup, two of them) and BN = 256 output
//   columns (128 where 256 does not divide K), its [64, BN] fp32
//   accumulator in each consumer's registers (128 a thread). The K / BN
//   column blocks of one row block need the same t: they form a cluster
//   (of up to four) and walk F in steps of csize sub-tiles of 64. In a
//   step, rank r computes pre = x W1[:, f] for sub-tile r (m64n64
//   products, both operands in shared memory, the W1 chunk MN-major, K /
//   64 chunks deep, one chunk's products in flight while the next is
//   issued; rank 0 multicasts each [128, 64] x chunk with TMA, each rank
//   loads its own [64, 64] W1 chunk), adds b1, applies act and rounds t to
//   T into its slot of its shared memory, and copies the slot into the same
//   slot of every peer (cp.async.bulk between the cluster's shared
//   memories, completing on the peer's mbarrier). Then every block adds
//   the step's t slots times its own W2 columns (m64n128 products: A the
//   t slot, K-major; B a [64, BN] W2 slice, MN-major, two slices in
//   flight through TMA). Per consumer, the mbarriers t_full (the step's
//   slots of its rows landed) and t_empty (every rank's consumer of those
//   rows is done with the last step's: they may be overwritten) order the
//   steps. So pre runs once per cluster: 2 of the 2 M K F products, what
//   the bound counts. Recomputing pre in every column block, as dx does
//   (fused_ffn_bwd_dx.cu), runs 4 and was slower (PERF.md's row 13 has
//   both designs' times); so was leaving a step's second product in
//   flight across the next step's pre, where ptxas serialized the wgmmas
//   (C7515). A third warpgroup produces (setmaxnreg: 24 registers; the
//   consumers 240, of which the accumulator and pre take 160). Where the
//   clusters do not fill a wave, the wrapper splits F into ranges whose
//   fp32 partials it sums in a fixed order (range 0 adds b2), rounding
//   once. Rows past M read as zero (TMA) and are never stored.
// - fp32, tc = 0 (ffn_fwd_kernel): the fp32 cores. A block owns 32 rows
//   and BN output columns (the largest of 768, 512, 384, 256, 128
//   dividing K) and keeps its [32, BN] fp32 accumulator in registers:
//   four rows by BN / 32 columns a thread. Over F tiles of 128 it computes
//   the [32, 128] pre-activation tile from [32, 32] x and [32, 128] W1
//   chunks, applies b1 and act into shared memory, then adds that tile's
//   product with W2 from [16, BN] chunks, all staged as fp32. Where BN <
//   K, each column block recomputes the pre-activation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "ffn_tile.cuh"
#include "tma_tile.cuh"
#include "wgmma_tile.cuh"

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


template <int TN>
cudaError_t launch_fp32_cores(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int M, int K, int F, int act,
                              cudaStream_t stream) {
  constexpr int BN = 32 * TN;
  const size_t smem =
      (size_t)(kBM * kKC + kKC * kBF + kBM * kBF + kFC * BN) * sizeof(float);
  auto kernel = ffn_fwd_kernel<float, TN>;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, K / BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), M, K, F, act);
  return cudaGetLastError();
}

cudaError_t launch_fp32_bn(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int M,
                           int K, int F, int BN, int act,
                           cudaStream_t stream) {
  switch (BN) {
    case 128:
      return launch_fp32_cores<4>(x, w1, b1, w2, b2, out, M, K, F, act,
                                  stream);
    case 256:
      return launch_fp32_cores<8>(x, w1, b1, w2, b2, out, M, K, F, act,
                                  stream);
    case 384:
      return launch_fp32_cores<12>(x, w1, b1, w2, b2, out, M, K, F, act,
                                   stream);
    case 512:
      return launch_fp32_cores<16>(x, w1, b1, w2, b2, out, M, K, F, act,
                                   stream);
    case 768:
      return launch_fp32_cores<24>(x, w1, b1, w2, b2, out, M, K, F, act,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- bf16 / fp16: wgmma (the design in the note at the top)
namespace ffn_fwd_tc {

namespace wg = paddle_attn::wg;
namespace tma = paddle_attn::tma;

constexpr int kConsumers = 2;               // warpgroups, 64 rows each
constexpr int kThreadsTc = (kConsumers + 1) * wg::kThreads;  // + producer
constexpr int kRows = 64 * kConsumers;      // rows of out a block
constexpr int kChunk = 64;                  // K depth of a chunk
constexpr int kSub = 64;                    // F columns a sub-tile
constexpr int kStages = 4;
constexpr int kXBytes = kRows * kChunk * 2;   // an x chunk [128][64]
constexpr int kW1Bytes = kChunk * kSub * 2;   // a W1 chunk [64][64]
constexpr int kStageBytes = kXBytes + kW1Bytes;
constexpr int kTBytes = 64 * kSub * 2;        // a consumer's t [64][64]
constexpr int kMaxCluster = 4;

template <int BN>
constexpr int smem_bytes() {
  // the ring, two W2 slices [64][BN], the t slots (a sub-tile of each
  // rank for each consumer), the mbarriers, alignment
  return kStages * kStageBytes + 2 * kSub * BN * 2 +
         kMaxCluster * kConsumers * kTBytes + 256 + 1024;
}

// NB = BN / 128: the m64n128 accumulators of a warpgroup's [64, BN] out.
// The csize blocks of a cluster share their rows and differ in their
// columns. They walk F in steps of csize sub-tiles of 64: rank r computes
// t = act(x W1[:, f] + b1) of sub-tile r of the step (rank 0 multicasts
// each x chunk, every rank loads its own W1 chunk), writes it into its
// slot of its own shared memory and copies it into the same slot of every
// peer (copy_to_peer); then every block adds the step's csize t slots
// times its own W2 columns. So pre runs once per cluster, not once per
// block. Warpgroup 0 produces (one thread the x / W1 chunks, one the W2
// slices), 1 and 2 consume.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreadsTc, 1)
    kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_w1,
           const __grid_constant__ CUtensorMap tm_w2,
           const T* __restrict__ b1, const T* __restrict__ b2,
           T* __restrict__ out, float* __restrict__ out32, int M, int K,
           int F, int act, int csize) {
  constexpr int BN = 128 * NB;
  constexpr int kW2Bytes = kSub * BN * 2;  // the W2 slice of a sub-tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t w2s = ring + kStages * kStageBytes;
  const uint32_t ts = w2s + 2 * kW2Bytes;
  // mbarriers: full[kStages] (the chunk landed here), empty[kStages] (this
  // CTA's consumers are done with it), cempty[kStages] (the cluster's
  // are: rank 0's is the one used), the two W2 slices' full and empty,
  // each consumer's t_full (the step's t slots landed) and t_empty (every
  // rank's consumer of those rows is done with the step's slots)
  const uint32_t full0 = ts + kMaxCluster * kConsumers * kTBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t cempty0 = empty0 + 8 * kStages;
  const uint32_t w2_full0 = cempty0 + 8 * kStages;
  const uint32_t w2_empty0 = w2_full0 + 16;
  const uint32_t t_full0 = w2_empty0 + 16;
  const uint32_t t_empty0 = t_full0 + 16;

  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int t = tid % wg::kThreads;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * BN;
  const int nc = K / kChunk;           // K chunks a sub-tile
  // this block's F sub-tiles: range blockIdx.z of gridDim.z
  const int s_lo = (int)blockIdx.z * (F / kSub) / (int)gridDim.z;
  const int nsub = ((int)blockIdx.z + 1) * (F / kSub) / (int)gridDim.z - s_lo;
  const int nstep = (nsub + csize - 1) / csize;
  const uint32_t rank = tma::cta_rank();
  // the sub-tiles of step s: csize of them, fewer in the last step
  auto valid = [&](int s) { return min(csize, nsub - s * csize); };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(full0 + 8 * s, 1);
      tma::bar_init(empty0 + 8 * s, kConsumers);
      tma::bar_init(cempty0 + 8 * s, kConsumers * csize);
    }
    for (int b = 0; b < 2; ++b) {
      tma::bar_init(w2_full0 + 8 * b, 1);
      tma::bar_init(w2_empty0 + 8 * b, kConsumers);
      tma::bar_init(t_full0 + 8 * b, 1);
      tma::bar_init(t_empty0 + 8 * b, csize);
    }
    tma::fence_bar_init();
  }
  tma::cluster_sync();  // every CTA's mbarriers exist before any load

  if (wgi == 0) {
    tma::regs_dec<24>();
    if (t == 0) {
      // chunk c (step c / nc, K chunk c % nc) into stage c % kStages: its
      // bytes expected here once this CTA is done with chunk c - kStages,
      // this rank's W1 chunk loaded here; on rank 0 the x chunk once the
      // cluster is done, multicast
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int c = 0; c < nstep * nc; ++c) {
        const int s = c % kStages;
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + s * kStageBytes;
        if (c >= kStages) tma::wait(empty0 + 8 * s, (c / kStages - 1) & 1);
        tma::expect_tx(full, kStageBytes);
        // a rank past the last step's sub-tiles computes a t it never
        // sends: it loads the last sub-tile's W1 again
        const int sub = s_lo + min(c / nc * csize + (int)rank, nsub - 1);
        const int k0 = c % nc * kChunk;
        tma::load(st + kXBytes, &tm_w1, sub * kSub, k0, full, 1);
        if (rank != 0) continue;
        if (c >= kStages) tma::wait(cempty0 + 8 * s, (c / kStages - 1) & 1);
        tma::load(st, &tm_x, k0, m0, full, mask);
      }
    } else if (t == 32) {
      // the W2 slice of each sub-tile of each step, this block's own
      // columns, through two buffers: BN / 64 panels [64][64]
      int n = 0;
      for (int step = 0; step < nstep; ++step)
        for (int i = 0; i < valid(step); ++i, ++n) {
          const int b = n & 1;
          if (n >= 2) tma::wait(w2_empty0 + 8 * b, (n / 2 - 1) & 1);
          tma::expect_tx(w2_full0 + 8 * b, kW2Bytes);
          for (int p = 0; p < BN / 64; ++p)
            tma::load(w2s + b * kW2Bytes + p * kSub * 128, &tm_w2,
                      n0 + 64 * p, (s_lo + step * csize + i) * kSub,
                      w2_full0 + 8 * b, 1);
        }
    }
  } else {
    tma::regs_inc<240>();
    const int grp = wgi - 1;  // this warpgroup's 64 rows
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);
    float acc[NB][64];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    float pre[32];
    // slot (i, grp): sub-tile i of the step, this consumer's rows
    auto slot = [&](int i) { return ts + (i * kConsumers + grp) * kTBytes; };
    const uint32_t t_full = t_full0 + 8 * grp;
    const uint32_t t_empty = t_empty0 + 8 * grp;

    // a stage goes back to this CTA's producer and the cluster's rank 0
    auto release = [&](int c) {
      tma::arrive(empty0 + 8 * (c % kStages), t == 0);
      tma::arrive_at(cempty0 + 8 * (c % kStages), 0, t == 0);
    };
    int n = 0;  // W2 slices used so far
    for (int step = 0; step < nstep; ++step) {
      const int nv = valid(step);
      const bool mine = (int)rank < nv;
      // pre of this rank's sub-tile, K / 64 chunks deep, the products of
      // one chunk in flight while the next is issued
      for (int kc = 0; kc < nc; ++kc) {
        const int it = step * nc + kc;
        const uint32_t st = ring + (it % kStages) * kStageBytes;
        tma::wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
        const uint32_t xs = st + grp * 64 * 128;
        const uint32_t w1s = st + kXBytes;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_ss_t<T, 0, 1>(pre, wg::desc_k<kRows>(xs, kk),
                                wg::desc_mn<kChunk>(w1s, kk),
                                kc > 0 || kk > 0);
        wg::commit();
        wg::wait<1>();
        if (kc > 0) release(it - 1);
      }
      wg::wait<0>();
      wg::fence_regs(pre);
      release(step * nc + nc - 1);

      // every rank is done with the last step's slots
      if (step > 0) tma::wait(t_empty, (step - 1) & 1);
      // t = act(pre + b1) at columns f + 8 j + 2 (lane % 4) + c, rounded
      // to T into this rank's slot (K-major A of the second product)
      if (mine) {
        const int f = (s_lo + step * csize + (int)rank) * kSub;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int fj = f + 8 * j + 2 * (lane & 3);
          const float bias[2] = {paddle_attn::to_f(b1[fj]),
                                 paddle_attn::to_f(b1[fj + 1])};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t v = wg::pack2<T>(
                act_fwd(pre[4 * j + 2 * i] + bias[0], act),
                act_fwd(pre[4 * j + 2 * i + 1] + bias[1], act));
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             slot(rank) + wg::tile_offset<64>(r0 + 8 * i, j) +
                             4 * (lane & 3)),
                         "r"(v)
                         : "memory");
          }
        }
      }
      tma::fence_async_smem();
      tma::named_sync(1 + grp, wg::kThreads);
      if (t == 0) {
        // the peers' slots of this step land here; this rank's goes out
        tma::expect_tx(t_full, (nv - (mine ? 1 : 0)) * kTBytes);
        if (mine)
          for (int q = 0; q < csize; ++q)
            if (q != (int)rank)
              tma::copy_to_peer(slot(rank), slot(rank), kTBytes, t_full, q);
      }
      tma::wait(t_full, step & 1);

      // out += t W2[f, n0:n0 + BN] over the step's sub-tiles, each W2
      // slice back to the producer once its products are done
      wg::fence();
      for (int i = 0; i < nv; ++i) {
        const int b = (n + i) & 1;
        tma::wait(w2_full0 + 8 * b, ((n + i) >> 1) & 1);
#pragma unroll
        for (int h = 0; h < NB; ++h)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg::mma_ss128_t<T, 0, 1>(
                acc[h], wg::desc_k<64>(slot(i), kk),
                wg::desc_mn<kSub>(w2s + b * kW2Bytes + h * 2 * kSub * 128,
                                  kk),
                1);
        wg::commit();
        wg::wait<1>();
        tma::arrive(w2_empty0 + 8 * ((n + i + 1) & 1), t == 0 && i > 0);
      }
      wg::wait<0>();
#pragma unroll
      for (int h = 0; h < NB; ++h) wg::fence_regs(acc[h]);
      n += nv;
      tma::arrive(w2_empty0 + 8 * ((n + 1) & 1), t == 0);
      // this step's slots are read here: every writer may go on
      for (int q = 0; q < csize; ++q) tma::arrive_at(t_empty, q, t == 0);
    }

    // rows 16 w + l / 4 (+ 8) of this warpgroup's 64, columns n0 + 128 h
    // + 8 j + 2 (l % 4) (+ 1); range 0 adds b2
    const int n_valid = min(kRows, M - m0) - 64 * grp;
    const bool bias = out32 == nullptr || blockIdx.z == 0;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 128 * h + 8 * j + 2 * (lane & 3);
        const float bb[2] = {bias ? paddle_attn::to_f(b2[col]) : 0.f,
                             bias ? paddle_attn::to_f(b2[col + 1]) : 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          if (r >= n_valid) continue;
          const size_t row = (size_t)(m0 + 64 * grp + r);
          const float v0 = acc[h][4 * j + 2 * i] + bb[0];
          const float v1 = acc[h][4 * j + 2 * i + 1] + bb[1];
          if (out32 == nullptr)  // one F range: out, rounded once
            *reinterpret_cast<uint32_t*>(out + row * K + col) =
                wg::pack2<T>(v0, v1);
          else  // this range's fp32 partial, slot blockIdx.z
            *reinterpret_cast<float2*>(
                out32 + ((size_t)blockIdx.z * M + row) * K + col) =
                make_float2(v0, v1);
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
cudaError_t launch_nb(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int M,
                      int K, int F, int splits, int act,
                      cudaStream_t stream) {
  constexpr int smem = smem_bytes<128 * NB>();
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap maps[3];
  const void* ptrs[3] = {x, w1, w2};
  const uint64_t rows[3] = {(uint64_t)M, (uint64_t)K, (uint64_t)F};
  const uint64_t cols[3] = {(uint64_t)K, (uint64_t)F, (uint64_t)K};
  const uint32_t box[3] = {kRows, kChunk, kSub};
  for (int i = 0; i < 3; ++i) {
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
  // one F range writes out; several write fp32 partials [splits, M, K]
  err = cudaLaunchKernelEx(
      &cfg, fn, maps[0], maps[1], maps[2], static_cast<const T*>(b1),
      static_cast<const T*>(b2), splits == 1 ? static_cast<T*>(out) : nullptr,
      splits == 1 ? nullptr : static_cast<float*>(out), M, K, F, act, csize);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BN 256 or 128 (dividing K); F a multiple of 128; 1 <= splits <= F / 128
// F ranges; x, W1, W2 16-byte aligned (the tensor maps' rule), out 8-byte
// aligned.
template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int K,
                   int F, int BN, int splits, int act, cudaStream_t stream) {
  if (F % 128 || K % BN || splits > F / 128 || splits > 65535)
    return cudaErrorInvalidValue;
  if (!wg::aligned16(x, w1, w2) || reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorMisalignedAddress;
  if (BN == 256)
    return launch_nb<T, 2>(x, w1, b1, w2, b2, out, M, K, F, splits, act,
                           stream);
  if (BN == 128)
    return launch_nb<T, 1>(x, w1, b1, w2, b2, out, M, K, F, splits, act,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace ffn_fwd_tc

// x [M, K], w1 [K, F], b1 [F], w2 [F, K], b2 [K], all of one dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. out: [M, K] in that dtype when splits
// is 1, else fp32 partials [splits, M, K] over that many ranges of F, b2
// in range 0 (tc only; the caller sums them). BN: the output columns of a
// block, dividing K (tc: 256 or 128; fp32 cores: 128, 256, 384, 512 or
// 768); F a multiple of 128. act: 0 = tanh gelu, 1 = exact gelu. tc: the
// design the wrapper chose (1 = wgmma, bf16 and fp16 only; 0 = fp32
// cores, fp32 only); any other pairing returns cudaErrorInvalidValue.
// Returns a cudaError_t (0 on success); the caller has validated shapes
// and devices.
extern "C" int paddle_fused_ffn_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* out, int M, int K,
                                    int F, int BN, int splits, int act,
                                    int dtype, int tc, void* stream) {
  if (M < 1 || K < 1 || F < 1 || F % kBF || BN < 1 || K % BN ||
      splits < 1 || (act != 0 && act != 1) || (tc != 0 && tc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc)
    return dtype == 0 && splits == 1
               ? (int)launch_fp32_bn(x, w1, b1, w2, b2, out, M, K, F, BN,
                                     act, s)
               : (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return (int)ffn_fwd_tc::launch<__nv_bfloat16>(x, w1, b1, w2, b2, out,
                                                    M, K, F, BN, splits, act,
                                                    s);
    case 2:
      return (int)ffn_fwd_tc::launch<__half>(x, w1, b1, w2, b2, out, M, K, F,
                                             BN, splits, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the tensor-core forward kernel (bf16 or fp16: dtype
// 1 or 2) at K columns with blocks of BN the card holds at once, or a
// negative cudaError_t: the wrapper's choice of F ranges reads it.
extern "C" int paddle_fused_ffn_fwd_slots(int K, int BN, int dtype) {
  if (K < 1 || (BN != 128 && BN != 256) || K % BN ||
      (dtype != 1 && dtype != 2))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 1)
    return BN == 256 ? ffn_fwd_tc::slots<__nv_bfloat16, 2>(K)
                     : ffn_fwd_tc::slots<__nv_bfloat16, 1>(K);
  return BN == 256 ? ffn_fwd_tc::slots<__half, 2>(K)
                   : ffn_fwd_tc::slots<__half, 1>(K);
}
