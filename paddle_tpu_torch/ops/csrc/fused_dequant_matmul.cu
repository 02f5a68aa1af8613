// Fused int4 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/fused_dequant_matmul.py::
// fused_dequant_matmul (_fused_dequant_mm_kernel): out = (a @ W) * s with W
// int4, packed two values a byte along the contracted axis (the low nibble
// is the even k, the high nibble the odd k, both sign-extended, in
// [-7, 7]), s the per-out-channel fp32 scale, fp32 accumulation, the scale
// applied to the accumulator before the cast to the output dtype. The
// unpacked weight never exists outside registers or shared memory.
//
//   a      [M, K]      fp32, bf16 or fp16, row-major (K = 2 * K2, any M)
//   w      [K2, O]     int8, either contiguous (k_contig = 0: O fastest) or
//                      the transpose of a contiguous [O, K2] (k_contig = 1)
//   scales [O]         fp32
//   work   [S, M, O]   fp32 partial sums of a split K walk (fma design)
//   out    [M, O]      fp32, bf16 or fp16 (out_dtype, whatever a's is)
//
// What bounds it on the card: at decode (M = 8) bytes — the packed weight,
// K*O/2 bytes, is read once while the products are 2*M*K*O operations —
// and, for the weights of GPT-2 (0.3-1.2 MB), a launch's latency more than
// its bytes; in bulk prefill (M = 512) operations. Two designs; the wrapper
// picks one (ops/fused_dequant_matmul.py's dequant_path) and passes it as
// `path`; the entry runs that design or fails:
//
// - path 1, "tensor_core" (bf16 and fp16 activations; K a multiple of 8,
//   and the packed rows 16-byte aligned: O % 16 == 0 contiguous, K2 % 16 ==
//   0 and O % 8 == 0 transposed). fp32 sums; every int4 value is exact in
//   bf16 and fp16, and so is each product with a bf16 or fp16 activation:
//   only the order of the sums differs from the plain version. A block
//   takes 128 output columns by bm rows and walks its K range in steps of
//   32 packed rows (64 k) through a ring of four stages: the packed weight
//   bytes, in whichever orientation W has, staged by 16-byte cp.async
//   copies, and the activation rows the same way (bm 16) or by one TMA
//   box a stage (bm 64, 128). A nibble becomes a bf16 / fp16 value by
//   a byte permute, a mask and one subtraction (i4x2_to): biased by 8 it is
//   the low mantissa bits of 128 + u (bf16) or 1024 + u (fp16). One packed
//   byte is the (k = 2 i, 2 i + 1) pair of one column, one 32-bit register
//   of a B fragment. Where the output tiles do not fill the card, the K
//   walk is split into S ranges (blockIdx.z, the wrapper's rule from the
//   shapes alone: CUDA-graph capturable) whose S blocks form a thread block
//   cluster: each keeps its fp32 tile in shared memory and block z sums the
//   z-th share of the tile over the cluster's S tiles in rank order (split
//   order, deterministic) through distributed shared memory, then scales
//   and stores it in 16- or 8-byte vectors: one launch (fold_store).
//   * bm 16, decode (M <= 16; dq_mma_kernel): one m16 row tile, rows past M
//     zero; four warps of 32 columns each turn their own weight bytes into B
//     fragments in registers for mma.sync m16n8k16. The step's k are
//     permuted, the same way for A and B, so that a thread's eight weight
//     bytes of a column lie next to each other (one 8-byte load transposed,
//     one 4-byte load of four columns contiguous) and its A values are 16
//     consecutive k of a row (two 16-byte loads).
//   * bm 64 and 128 (dq_wgmma_kernel): one or two warpgroups of 64 rows.
//     Each step the block converts its 32 x 128 weight bytes once into a
//     bf16 / fp16 tile W^T [128][64] in shared memory (double-buffered, so
//     the next step's conversion runs while this step's products are in
//     flight), and each warpgroup issues four wgmma m64n128k16 of its A rows
//     (K-major) against it (K-major), fp32 sums in registers. The A tiles
//     come by TMA (a tensor map built on the host each launch, an mbarrier
//     a stage): staged by every thread's cp.async they ran 7-8% slower at
//     M 512.
// - path 0, "fma" (fp32 activations, or a shape the tensor-core path does
//   not take): the first design, products as fp32 FMAs, exact for every
//   input dtype and never TF32. One block of 256 threads per (64 output
//   columns, BM = 16/32/64 rows) tile walks K in steps of 32 packed rows:
//   the A tile staged as fp32 and the weight bytes unpacked with arithmetic
//   shifts into an fp32 [64 k][64 o] tile; each thread accumulates TM x 4
//   outputs. A split K walk writes fp32 partials that a second, tiny
//   kernel sums in split order before applying the scale.
#include "numeric.cuh"         // to_f
#include "tma_tile.cuh"      // tensor maps, mbarriers
#include "wgmma_tile.cuh"    // wg:: cp.async helpers

namespace {

using paddle_attn::to_f;
namespace wg = paddle_attn::wg;
namespace tma = paddle_attn::tma;

// The output element i as out_dtype (0 fp32, 1 bf16, 2 fp16).
__device__ __forceinline__ void store_out(void* out, int code, size_t i,
                                          float v) {
  if (code == 0)
    static_cast<float*>(out)[i] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(out)[i] = __float2half(v);
}

// ---------------------------------------------------------------- path 0
namespace scalar {

constexpr int kBO = 64;          // output columns per block
constexpr int kBK2 = 32;         // packed rows per step
constexpr int kBK = 2 * kBK2;    // contracted elements per step
constexpr int kThreads = 256;    // 16 column groups x 16 row groups

// TM: rows per thread; the block covers BM = 16 * TM rows.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ a, const int8_t* __restrict__ w,
              const float* __restrict__ scales, float* __restrict__ work,
              void* __restrict__ out, int out_code, int M, int K2, int O,
              int k_contig, int chunk) {
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
        store_out(out, out_code, (size_t)m * O + o, acc[i][j] * scales[o]);
      else
        work[((size_t)blockIdx.z * M + m) * O + o] = acc[i][j];
    }
  }
}

// out = (sum over the S partials, in order) * scale, as out_dtype.
__global__ void reduce_kernel(const float* __restrict__ work,
                              const float* __restrict__ scales,
                              void* __restrict__ out, int out_code, int M,
                              int O, int S) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)M * O;
  if (idx >= n) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += work[z * n + idx];
  store_out(out, out_code, idx, s * scales[idx % O]);
}

template <typename T>
cudaError_t launch(const void* a, const void* w, const void* scales,
                   void* work, void* out, int out_code, int M, int K2, int O,
                   int k_contig, int bm, int splits, int chunk,
                   cudaStream_t stream) {
  const dim3 grid((O + kBO - 1) / kBO, (M + bm - 1) / bm, splits);
  const T* a_ = static_cast<const T*>(a);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* s_ = static_cast<const float*>(scales);
  float* work_ = static_cast<float*>(work);
#define PADDLE_DQ_FMA(TM)                                               \
  dq_kernel<T, TM><<<grid, kThreads, 0, stream>>>(                      \
      a_, w_, s_, work_, out, out_code, M, K2, O, k_contig, chunk)
  if (bm == 16)
    PADDLE_DQ_FMA(1);
  else if (bm == 32)
    PADDLE_DQ_FMA(2);
  else
    PADDLE_DQ_FMA(4);
#undef PADDLE_DQ_FMA
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)M * O;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      work_, s_, out, out_code, M, O, splits);
  return cudaGetLastError();
}

}  // namespace scalar

// ---------------------------------------------------------------- path 1
namespace tc {

constexpr int kBK2 = 32;     // packed rows a step (64 k)
constexpr int kNT = 4;       // n8 tiles a warp: 32 columns
constexpr int kWN = 4;       // warps across the block's columns
constexpr int kBN = 8 * kNT * kWN;  // 128 output columns a block
constexpr int kStages = 4;
constexpr int kMaxSplits = 16;  // a cluster's blocks (non-portable past 8)
constexpr int kPLd = kBN + 4;   // the fp32 output tile's row stride

// The decode kernel (mma.sync): 16 rows a block, four warps across its
// columns. A stage: the A tile [16][64] in T (rows of 128 bytes, 16-byte
// chunk c of row r at chunk c ^ (r & 7)), then the weight tile of 32 * 128
// bytes: contiguous W [32 packed rows][128 columns] (chunk c of row p at c
// ^ 2 ((p >> 3) & 3)), or transposed W [128 columns][32 packed rows].
struct DCfg {
  static constexpr int kThreads = 32 * kWN;
  static constexpr int BM = 16;
  static constexpr int kABytes = BM * 128;
  static constexpr int kStageBytes = kABytes + kBK2 * kBN;
  static constexpr int kSmem = kStages * kStageBytes;
  // after the walk the ring holds the block's fp32 output tile [BM][kPLd]
  static_assert(BM * kPLd * 4 <= kSmem, "the output tile fits the ring");
};

// mma.sync m16n8k16, fp32 sums; not volatile, so ptxas may interleave it
// with the step's shared loads and conversions.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Nibble pair I (byte I of the word that u = w ^ 0x88888888 was made from;
// v = u >> 4) as a packed pair of T: the low nibble (even k) in the low
// half, the high nibble (odd k) in the high half. Each biased nibble u' =
// q + 8 lands in the low mantissa bits of T's 128 + u' (bf16, 0x4300) or
// 1024 + u' (fp16, 0x6400), and subtracting 136 / 1032 leaves q exactly.
template <typename T, int I>
__device__ __forceinline__ uint32_t i4x2_to(uint32_t u, uint32_t v) {
  constexpr uint32_t kSel = I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12);
  const uint32_t x = __byte_perm(u, v, kSel) & 0x000F000Fu;
  if constexpr (std::is_same<T, __half>::value) {
    uint32_t r = x | 0x64006400u;
    const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&r),
                              __halves2half2(__ushort_as_half(0x6408),
                                             __ushort_as_half(0x6408)));
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    uint32_t r = x | 0x43004300u;
    const __nv_bfloat162 h =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                   __ushort_as_bfloat16(0x4308)));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Block-wide: step rows [k2_0, k2_0 + 32) (packed; below ke) of the weight
// and the matching 64 k of A rows [m0, m0 + 16) into a stage; chunks past
// M, ke or O zero-filled (a zero byte is two zero weights).
template <typename T, int KC>
__device__ __forceinline__ void load_step(uint32_t stage, const T* a,
                                          const int8_t* w, int M, int K2,
                                          int O, int m0, int n0, int k2_0,
                                          int ke) {
  using C = DCfg;
  const int K = 2 * K2;
  for (int i = threadIdx.x; i < C::BM * 8; i += C::kThreads) {
    const int r = i >> 3, c = i & 7;
    const int m = m0 + r, k = 2 * k2_0 + 8 * c;
    const bool ok = m < M && k < 2 * ke;
    wg::cp_async16(stage + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? a + (size_t)m * K + k : a, ok);
  }
  const uint32_t ws = stage + C::kABytes;
  for (int i = threadIdx.x; i < kBK2 * kBN / 16; i += C::kThreads) {
    if constexpr (KC == 0) {
      const int p = i >> 3, c = i & 7;
      const int k2 = k2_0 + p, o = n0 + 16 * c;
      const bool ok = k2 < ke && o < O;
      wg::cp_async16(ws + p * kBN + ((c ^ (2 * ((p >> 3) & 3))) << 4),
                     ok ? w + (size_t)k2 * O + o : w, ok);
    } else {
      const int oo = i >> 1, c = i & 1;
      const int o = n0 + oo, k2 = k2_0 + 16 * c;
      const bool ok = o < O && k2 < ke;
      wg::cp_async16(ws + oo * kBK2 + 16 * c,
                     ok ? w + (size_t)o * K2 + k2 : w, ok);
    }
  }
}

// Every thread of every block of the cluster; the arrive releases this
// block's shared stores, the wait acquires the others'.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                   "memory");
}

// Four outputs at element i of out: v times the columns' scales s, as
// out_dtype, in one 16- or 8-byte store (i % 4 == 0).
__device__ __forceinline__ void store4(void* out, int code, size_t i,
                                       float4 v, float4 s) {
  v = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
  if (code == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = v;
  } else if (code == 1) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    const __half2 lo = __floats2half2_rn(v.x, v.y);
    const __half2 hi = __floats2half2_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<__half*>(out) + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// Four fp32 values at shared address addr of CTA `rank` of the cluster.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [ra];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(addr), "r"(rank)
      : "memory");
  return v;
}

// Block-wide, the end of both tensor-core kernels: each block of the
// cluster (1, 1, S) holds its fp32 tile [BM][kPLd] at the start of its
// shared memory; block z sums the z-th share of the tile's 4-column groups
// over the S blocks in rank order (split order) through distributed shared
// memory, scales and stores it in 16- or 8-byte vectors.
template <int kThreads, int BM>
__device__ __forceinline__ void fold_store(const uint8_t* smem,
                                           const float* scales, void* out,
                                           int out_code, int M, int O,
                                           int m0, int n0) {
  static_assert(kThreads % (kBN / 4) == 0, "a thread keeps its columns");
  const int S = gridDim.z;
  const int rows = min(BM, M - m0);
  const int groups = rows * (kBN / 4);
  const int z = blockIdx.z;
  const int g_end = (int)((long long)groups * (z + 1) / S);
  const int i0 = (int)((long long)groups * z / S) + threadIdx.x;
  // the thread's four columns, the same in every pass; their scales are
  // loaded once, before the barrier
  const int c4 = 4 * (i0 % (kBN / 4));
  const bool col_ok = n0 + c4 < O;
  const float4 sc = col_ok
                        ? *reinterpret_cast<const float4*>(scales + n0 + c4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  if (S > 1)
    cluster_sync();  // every block's tile is in place
  else
    __syncthreads();
  const float* tile = reinterpret_cast<const float*>(smem);
  for (int i = i0; i < g_end; i += kThreads) {
    const int r = i / (kBN / 4);
    if (!col_ok) continue;
    const int off = r * kPLd + c4;
    float4 v;
    if (S == 1) {
      v = *reinterpret_cast<const float4*>(tile + off);
    } else {
      // the S ranks' values in split order, four loads in flight before
      // their adds (each remote load is an ordered asm statement)
      v = make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t addr = wg::smem_u32(smem) + off * 4;
      for (int z0 = 0; z0 < S; z0 += 4) {
        float4 p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          p[u] = ld_cluster4(addr, min(z0 + u, S - 1));
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (z0 + u < S)
            v = make_float4(v.x + p[u].x, v.y + p[u].y, v.z + p[u].z,
                            v.w + p[u].w);
      }
    }
    store4(out, out_code, (size_t)(m0 + r) * O + n0 + c4, v, sc);
  }
  if (S > 1) cluster_sync();  // no block leaves while a peer reads it
}

// grid (ceil(O / 128), ceil(M / 16), S) in clusters of (1, 1, S): the S
// blocks of an output tile, one per K range, form a cluster. DCfg threads
// and bytes. KC: the weight's orientation (k_contig). The
// step's 64 k are permuted for the mma: its k index 2 t + 8 h + e (t =
// lane & 3, h, e in {0, 1}) of k16 step j is the step's k 16 t + 4 j + 2 h
// + e, so a thread's A values are k 16 t .. 16 t + 15 of its rows and its
// B bytes packed rows 8 t .. 8 t + 7 (byte 2 j + h). Output columns: n8
// tile nt, B column q of warp wn is column 32 wn + 8 nt + q (transposed W)
// or 32 wn + 4 q + nt (contiguous W: a 4-byte load holds the four tiles'
// bytes). Then fold_store.
template <typename T, int KC>
__global__ void __launch_bounds__(DCfg::kThreads)
    dq_mma_kernel(const T* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ scales, void* __restrict__ out,
                  int out_code, int M, int K2, int O, int chunk) {
  using C = DCfg;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = wg::smem_u32(smem_raw);
  const int wn = threadIdx.x >> 5;  // the warp's columns: 32 wn ..
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * C::BM;
  const int kb = blockIdx.z * chunk;
  const int ke = min(K2, kb + chunk);
  const int n_steps = (ke - kb + kBK2 - 1) / kBK2;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps)
      load_step<T, KC>(ring + st * C::kStageBytes, a, w, M, K2, O, m0, n0,
                       kb + st * kBK2, ke);
    wg::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    wg::cp_async_wait<kStages - 2>();
    __syncthreads();  // step it landed; every warp is done with it - 1
    {
      const int nx = it + kStages - 1;
      if (nx < n_steps)
        load_step<T, KC>(ring + (nx % kStages) * C::kStageBytes, a, w, M, K2,
                         O, m0, n0, kb + nx * kBK2, ke);
      wg::cp_async_commit();
    }
    const uint8_t* st = smem_raw + (it % kStages) * C::kStageBytes;
    const uint8_t* ws = st + C::kABytes;
    // this warp's weight bytes as B fragments: bf[j][nt] the two
    // registers of k16 step j and n8 tile nt
    uint32_t bf[4][kNT][2];
    if constexpr (KC == 1) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint2 wd = *reinterpret_cast<const uint2*>(
            ws + (32 * wn + 8 * nt + g) * kBK2 + 8 * t);
#pragma unroll
        for (int hw = 0; hw < 2; ++hw) {
          const uint32_t u = (hw ? wd.y : wd.x) ^ 0x88888888u, v = u >> 4;
          // bytes 2 j + h: j = 2 hw + (byte >> 1), h = byte & 1
          bf[2 * hw][nt][0] = i4x2_to<T, 0>(u, v);
          bf[2 * hw][nt][1] = i4x2_to<T, 1>(u, v);
          bf[2 * hw + 1][nt][0] = i4x2_to<T, 2>(u, v);
          bf[2 * hw + 1][nt][1] = i4x2_to<T, 3>(u, v);
        }
      }
    } else {
      const int c = (8 * wn + g) >> 2;  // the chunk of columns 32 wn + 4 g
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int p = 8 * t + r;
        const uint32_t wd = *reinterpret_cast<const uint32_t*>(
            ws + p * kBN + ((c ^ (2 * t)) << 4) + 4 * (g & 3));
        const uint32_t u = wd ^ 0x88888888u, v = u >> 4;
        bf[r >> 1][0][r & 1] = i4x2_to<T, 0>(u, v);
        bf[r >> 1][1][r & 1] = i4x2_to<T, 1>(u, v);
        bf[r >> 1][2][r & 1] = i4x2_to<T, 2>(u, v);
        bf[r >> 1][3][r & 1] = i4x2_to<T, 3>(u, v);
      }
    }
    // rows g and g + 8: k 16 t .. 16 t + 15 each, pair i of a row (k 16 t
    // + 2 i, + 1) in ar[row][i]
    uint32_t ar[2][8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            st + r * 128 + (((2 * t + q) ^ (r & 7)) << 4));
        ar[hr][4 * q] = v.x;
        ar[hr][4 * q + 1] = v.y;
        ar[hr][4 * q + 2] = v.z;
        ar[hr][4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // k 16 t + 4 j (+ 1) and 16 t + 4 j + 2 (+ 3) of rows g and g + 8
      const uint32_t af[4] = {ar[0][2 * j], ar[1][2 * j], ar[0][2 * j + 1],
                              ar[1][2 * j + 1]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mma<T>(acc[nt], af, bf[j][nt][0], bf[j][nt][1]);
    }
  }
  wg::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the block's fp32 tile into the ring: acc[nt][2 hr + e] is row g + 8
  // hr, B column 2 t + e of tile nt
  float* tile = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * t + e;
        tile[(g + 8 * hr) * kPLd + 32 * wn + (KC ? 8 * nt + q : 4 * q + nt)] =
            acc[nt][2 * hr + e];
      }
  fold_store<C::kThreads, C::BM>(smem_raw, scales, out, out_code, M, O, m0,
                                  n0);
}

// ------------------------------------------- path 1 above decode: wgmma
// WG consumer warpgroups, each 64 rows of A: BM = 64 WG rows a block, the
// block's 128 columns shared by its warpgroups.
template <int WG>
struct WCfg {
  static constexpr int kThreads = 128 * WG;
  static constexpr int BM = 64 * WG;
  // a stage: the A tile [BM][64] in T (wgmma_tile.cuh's K-major layout:
  // 128-byte rows, chunk c of row r at c ^ (r & 7)), then the packed weight
  // as staged: contiguous W [32 packed rows][128 columns] (chunk c of row p
  // at c ^ ((p >> 2) & 7)), or transposed W [128 columns][32 packed rows]
  static constexpr int kABytes = BM * 128;
  static constexpr int kStageBytes = kABytes + kBK2 * kBN;
  // then, past the ring, two converted weight tiles W^T [128][64] in T,
  // K-major like A: B of the products
  static constexpr int kConv = kStages * kStageBytes;
  static constexpr int kConvBytes = kBN * 128;
  // then the stages' mbarriers (the A tile's TMA load)
  static constexpr int kBars = kConv + 2 * kConvBytes;
  static constexpr int kSmem = kBars + 8 * kStages;
  static_assert(kABytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "wgmma tiles 1024-byte aligned");
  // after the walk the ring holds the block's fp32 output tile [BM][kPLd]
  static_assert(BM * kPLd * 4 <= kSmem, "the output tile fits");
};

// Block-wide: a stage's A tile (rows [m0, m0 + BM), the step's 64 k at
// column 2 k2_0) by one TMA box that thread 0 issues and reports to the
// stage's mbarrier bar (rows past M and columns past K zero-filled),
// predicated inside the asm (no thread-dependent branch while a wgmma is
// in flight); then the step's packed weight rows [k2_0, k2_0 + 32) (below
// ke) by cp.async, every loop of a fixed trip count, chunks past ke or O
// zero-filled.
template <int WG, int KC>
__device__ __forceinline__ void wload_step(uint32_t stage,
                                           const CUtensorMap* tm_a,
                                           uint32_t bar, const int8_t* w,
                                           int K2, int O, int m0, int n0,
                                           int k2_0, int ke) {
  using C = WCfg<WG>;
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %5, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%4], %6;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(stage),
      "l"(reinterpret_cast<uint64_t>(tm_a)), "r"(2 * k2_0), "r"(m0),
      "r"(bar), "r"((uint32_t)threadIdx.x), "r"((uint32_t)C::kABytes)
      : "memory");
  const uint32_t ws = stage + C::kABytes;
#pragma unroll
  for (int rep = 0; rep < kBK2 * kBN / 16 / C::kThreads; ++rep) {
    const int i = threadIdx.x + rep * C::kThreads;
    if constexpr (KC == 0) {
      const int p = i >> 3, c = i & 7;
      const int k2 = k2_0 + p, o = n0 + 16 * c;
      const bool ok = k2 < ke && o < O;
      wg::cp_async16(ws + p * kBN + ((c ^ ((p >> 2) & 7)) << 4),
                     ok ? w + (size_t)k2 * O + o : w, ok);
    } else {
      const int oo = i >> 1, c = i & 1;
      const int o = n0 + oo, k2 = k2_0 + 16 * c;
      const bool ok = o < O && k2 < ke;
      wg::cp_async16(ws + oo * kBK2 + 16 * c,
                     ok ? w + (size_t)o * K2 + k2 : w, ok);
    }
  }
}

// Four words (eight T) into shared memory at addr.
__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t x0,
                                           uint32_t x1, uint32_t x2,
                                           uint32_t x3) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x0), "r"(x1), "r"(x2), "r"(x3)
               : "memory");
}

// Block-wide: a stage's packed weight (ws) into the converted tile W^T
// [128 columns][64 k] in T at conv, exactly (i4x2_to), in 16-byte chunks:
// chunk c of column o holds k 8 c .. 8 c + 7, the packed rows 4 c .. 4 c +
// 3 of that column. Contiguous W: a thread takes four packed rows by four
// columns (four 4-byte loads, one per row; byte j of each is column j's);
// transposed W: a column's 16 packed rows (one 16-byte load).
template <typename T, int WG, int KC>
__device__ __forceinline__ void convert_w(const uint8_t* ws, uint32_t conv) {
  using C = WCfg<WG>;
#pragma unroll
  for (int rep = 0; rep < 256 / C::kThreads; ++rep) {
    const int b = threadIdx.x + rep * C::kThreads;
    if constexpr (KC == 0) {
      const int rg = b & 7, cg = b >> 3;  // rows 4 rg.., columns 4 cg..
      uint32_t u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        u[r] = *reinterpret_cast<const uint32_t*>(
                   ws + (4 * rg + r) * kBN + (((cg >> 2) ^ rg) << 4) +
                   4 * (cg & 3)) ^
               0x88888888u;
        v[r] = u[r] >> 4;
      }
#define PADDLE_DQ_COL(J)                                                  \
  st_shared4(conv + wg::tile_offset<kBN>(4 * cg + J, rg),                 \
             i4x2_to<T, J>(u[0], v[0]), i4x2_to<T, J>(u[1], v[1]),        \
             i4x2_to<T, J>(u[2], v[2]), i4x2_to<T, J>(u[3], v[3]))
      PADDLE_DQ_COL(0);
      PADDLE_DQ_COL(1);
      PADDLE_DQ_COL(2);
      PADDLE_DQ_COL(3);
#undef PADDLE_DQ_COL
    } else {
      const int o = b >> 1, h = b & 1;  // column o, packed rows 16 h..
      const uint4 q = *reinterpret_cast<const uint4*>(ws + o * kBK2 + 16 * h);
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        const uint32_t u = words[qi] ^ 0x88888888u, v = u >> 4;
        st_shared4(conv + wg::tile_offset<kBN>(o, 4 * h + qi),
                   i4x2_to<T, 0>(u, v), i4x2_to<T, 1>(u, v),
                   i4x2_to<T, 2>(u, v), i4x2_to<T, 3>(u, v));
      }
    }
  }
}

// grid (ceil(O / 128), ceil(M / BM), S) in clusters of (1, 1, S), WCfg
// threads and bytes. Each step the block converts its 32 x 128 packed
// weight bytes once into W^T [128][64] (double-buffered: step it + 1's
// conversion runs while step it's products are in flight), and each
// warpgroup issues four wgmma m64n128k16 of its 64 A rows against it, fp32
// sums in registers. Then fold_store.
template <typename T, int WG, int KC>
__global__ void __launch_bounds__(WCfg<WG>::kThreads)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scales, void* __restrict__ out,
                    int out_code, int M, int K2, int O, int chunk) {
  using C = WCfg<WG>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = wg::smem_u32(smem_raw);
  const uint32_t bars = ring + C::kBars;  // stage s's at bars + 8 s
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) tma::bar_init(bars + 8 * st, 1);
    tma::fence_bar_init();
  }
  __syncthreads();
  const int wgi = threadIdx.x >> 7;  // this warpgroup's rows: 64 wgi ..
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * C::BM;
  const int kb = blockIdx.z * chunk;
  const int ke = min(K2, kb + chunk);
  const int n_steps = (ke - kb + kBK2 - 1) / kBK2;

  // the first product overwrites acc (scale-d 0): no other instruction
  // defines it while a wgmma is in flight
  float acc[64];

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps)
      wload_step<WG, KC>(ring + st * C::kStageBytes, &tm_a, bars + 8 * st,
                         w, K2, O, m0, n0, kb + st * kBK2, ke);
    wg::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    // step it landed: the packed weight (cp.async; the proxy fence below,
    // after the conversion, makes the converted tile visible to wgmma) and
    // the A tile (TMA, through the async proxy)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2)
                 : "memory");
    tma::wait(bars + 8 * (it % kStages), (it / kStages) & 1);
    __syncthreads();  // ... for every thread; its conversion buffer is free
    const uint32_t st = ring + (it % kStages) * C::kStageBytes;
    const uint32_t conv = ring + C::kConv + (it & 1) * C::kConvBytes;
    convert_w<T, WG, KC>(smem_raw + (it % kStages) * C::kStageBytes +
                             C::kABytes,
                         conv);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the converted tile is visible to wgmma
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss128_t<T, 0, 0>(acc,
                               wg::desc_k<C::BM>(st + wgi * 64 * 128, kk),
                               wg::desc_k<kBN>(conv, kk), (it | kk) != 0);
    wg::commit();
    wg::wait<1>();  // step it - 1's products are done
    __syncthreads();  // in every warpgroup: its stage may be refilled
    {
      const int nx = it + kStages - 1;
      if (nx < n_steps)
        wload_step<WG, KC>(ring + (nx % kStages) * C::kStageBytes, &tm_a,
                           bars + 8 * (nx % kStages), w, K2, O, m0, n0,
                           kb + nx * kBK2, ke);
      wg::cp_async_commit();
    }
  }
  wg::wait<0>();
  wg::fence_regs(acc);
  wg::cp_async_wait<0>();
  __syncthreads();  // every product and load is done with the ring

  // the block's fp32 tile: acc[4 j + 2 i + e] is row 64 wgi + 16 warp + g
  // + 8 i, column 8 j + 2 t + e
  {
    const int lane = threadIdx.x & 31;
    const int r0 = 64 * wgi + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    float* tile = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(tile + (r0 + 8 * i) * kPLd + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  fold_store<C::kThreads, C::BM>(smem_raw, scales, out, out_code, M, O, m0,
                                  n0);
}

// A launch of `kernel` over grid (ceil(O / 128), ceil(M / bm), splits) in
// clusters of (1, 1, splits).
template <typename A, typename K>
cudaError_t launch_cluster(K kernel, int threads, int smem, int bm,
                           const A& a, const int8_t* w, const float* scales,
                           void* out, int out_code, int M, int K2, int O,
                           int splits, int chunk, cudaStream_t stream) {
  // set on every launch (a function-local static in a header template
  // would be one object across every library built from it)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + kBN - 1) / kBN, (M + bm - 1) / bm, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, w, scales, out, out_code, M,
                            K2, O, chunk);
}

template <typename T, int KC>
cudaError_t launch(const void* a, const void* w, const void* scales,
                   void* out, int out_code, int M, int K2, int O, int bm,
                   int splits, int chunk, cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* s_ = static_cast<const float*>(scales);
#define PADDLE_DQ_ARGS \
  a_, w_, s_, out, out_code, M, K2, O, splits, chunk, stream
  if (bm == 16)
    return launch_cluster(dq_mma_kernel<T, KC>, DCfg::kThreads, DCfg::kSmem,
                          bm, PADDLE_DQ_ARGS);
#undef PADDLE_DQ_ARGS
  // the A operand of the wgmma kernel: a tensor map of a [M][K] for boxes
  // of [bm][64] in wgmma_tile.cuh's layout
  CUtensorMap tm_a;
  cudaError_t err =
      tma::make_map(&tm_a, a, std::is_same<T, __half>::value, (uint64_t)M,
                    (uint64_t)(2 * K2), (uint64_t)(2 * K2), (uint32_t)bm);
  if (err != cudaSuccess) return err;
#define PADDLE_DQ_ARGS \
  tm_a, w_, s_, out, out_code, M, K2, O, splits, chunk, stream
  if (bm == 64)
    return launch_cluster(dq_wgmma_kernel<T, 1, KC>, WCfg<1>::kThreads,
                          WCfg<1>::kSmem, bm, PADDLE_DQ_ARGS);
  return launch_cluster(dq_wgmma_kernel<T, 2, KC>, WCfg<2>::kThreads,
                        WCfg<2>::kSmem, bm, PADDLE_DQ_ARGS);
#undef PADDLE_DQ_ARGS
}

}  // namespace tc

}  // namespace

// dtype (of a): 0 = float32, 1 = bfloat16, 2 = float16; out_dtype the
// same codes. path: 1 = tensor_core (bf16 or fp16 a; bm 16, 64 or 128; splits
// <= 16, the blocks of a cluster; K2 % 4 == 0, and for k_contig = 0 O % 16
// == 0, for k_contig = 1 K2 % 16 == 0 and O % 8 == 0, else
// cudaErrorInvalidValue; a, w and scales 16-byte aligned, else
// cudaErrorMisalignedAddress; work unused), 0 = fma (any dtype; bm 16, 32
// or 64; work fp32 [splits, M, O] holding the partials when splits > 1).
// The K walk is split into `splits` ranges of `chunk` packed rows (a
// multiple of 32). Any other pairing returns cudaErrorInvalidValue.
// Returns a cudaError_t (0 on success); the caller has validated shapes,
// devices and layout.
extern "C" int paddle_fused_dequant_matmul(const void* a, const void* w,
                                           const void* scales, void* work,
                                           void* out, int M, int K2, int O,
                                           int k_contig, int bm, int splits,
                                           int chunk, int dtype,
                                           int out_dtype, int path,
                                           void* stream) {
  if (M < 1 || K2 < 1 || O < 1 || splits < 1 || chunk < 32 || chunk % 32 ||
      (long long)(splits - 1) * chunk >= K2 ||
      (long long)splits * chunk < K2 || out_dtype < 0 || out_dtype > 2 ||
      (k_contig != 0 && k_contig != 1) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if ((bm != 16 && bm != 64 && bm != 128) || (M + bm - 1) / bm > 65535 ||
        splits > tc::kMaxSplits || (dtype != 1 && dtype != 2) || K2 % 4 ||
        (k_contig ? K2 % 16 || O % 8 : O % 16))
      return (int)cudaErrorInvalidValue;
    if (!wg::aligned16(a, w, scales)) return (int)cudaErrorMisalignedAddress;
#define PADDLE_DQ_TC_ARGS \
  a, w, scales, out, out_dtype, M, K2, O, bm, splits, chunk, s
    if (dtype == 1)
      return (int)(k_contig ? tc::launch<__nv_bfloat16, 1>(PADDLE_DQ_TC_ARGS)
                            : tc::launch<__nv_bfloat16, 0>(PADDLE_DQ_TC_ARGS));
    return (int)(k_contig ? tc::launch<__half, 1>(PADDLE_DQ_TC_ARGS)
                          : tc::launch<__half, 0>(PADDLE_DQ_TC_ARGS));
#undef PADDLE_DQ_TC_ARGS
  }
  if ((bm != 16 && bm != 32 && bm != 64) || (M + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
#define PADDLE_DQ_FMA_ARGS                                                 \
  a, w, scales, work, out, out_dtype, M, K2, O, k_contig, bm, splits, chunk, \
      s
  switch (dtype) {
    case 0:
      return (int)scalar::launch<float>(PADDLE_DQ_FMA_ARGS);
    case 1:
      return (int)scalar::launch<__nv_bfloat16>(PADDLE_DQ_FMA_ARGS);
    case 2:
      return (int)scalar::launch<__half>(PADDLE_DQ_FMA_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PADDLE_DQ_FMA_ARGS
}
