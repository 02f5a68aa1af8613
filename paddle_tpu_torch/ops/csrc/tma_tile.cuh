// Hopper's tensor memory accelerator (TMA), mbarriers and thread block
// clusters, as the fused FFN backward's tensor-core kernels use them
// (fused_ffn_bwd_dx.cu, fused_ffn_bwd_dw.cu).
//
// A tensor map (make_map, on the host) describes a row-major matrix of
// 16-bit values and a box of [rows][64] columns; one TMA load copies a box
// into shared memory in wgmma_tile.cuh's layout (128-byte rows, 16-byte
// chunk c of row r at c ^ (r & 7), a 1024-byte-aligned base: the 128-byte
// swizzle), rows past the matrix zero-filled, and reports its bytes to an
// mbarrier. With .multicast::cluster one load lands at the same offset in
// every CTA of the mask and reports to each CTA's mbarrier there: CTAs of
// a cluster that need the same tiles read them from L2 once.
//
// Pipelines here are rings of stages, each with a "full" mbarrier in every
// CTA (one arrival: that CTA's expect_tx, plus the bytes), an "empty"
// mbarrier in every CTA (one arrival per local consumer warpgroup: its
// producer may expect the stage's next bytes) and a cluster-wide "empty"
// in the CTA that issues the loads (one arrival per consumer warpgroup of
// the cluster, from remote CTAs through mapa). A producer warpgroup gives
// its registers to the consumers (setmaxnreg), and every wait and arrival
// on the consumers' path is a single asm statement, so ptxas sees no
// divergent path beside the wgmmas in flight.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace paddle_attn {

namespace tma {

// The tensor map of a row-major [rows][cols] matrix of 16-bit values (fp16
// if half, else bf16) at ptr, row stride ld elements (ld * 2 a multiple of
// 16, ptr 16-byte aligned), for boxes of [box_rows][64] with the 128-byte
// swizzle. Looks up the driver's encoder through the loaded libcuda.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, bool half,
                            uint64_t rows, uint64_t cols, uint64_t ld,
                            uint32_t box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
  if (!lib) return cudaErrorSharedObjectInitFailed;
  const auto encode =
      reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"));
  dlclose(lib);  // libcuda stays loaded: the runtime holds it
  if (!encode) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map,
      half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The largest divisor of n that is at most most: a cluster size along a
// grid dimension of n blocks.
inline int cluster_size(int n, int most) {
  for (int c = most; c > 1; --c)
    if (n % c == 0) return c;
  return 1;
}

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (the non-.aligned form: the
// threads of a warp may arrive from different paths).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive;\n"
      "barrier.cluster.wait;\n" ::
          : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the inits, before the cluster_sync that publishes them.
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transfers this phase.
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of the given parity has completed. The loop is inside
// the asm, so the caller's path stays convergent for ptxas.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on the mbarrier at the same offset in CTA `rank` of the
// cluster, by the threads where `pred` holds. Predicated inside the asm:
// a branch around it would be a divergent path, where ptxas serializes
// the wgmmas in flight.
__device__ __forceinline__ void arrive_at(uint32_t bar, uint32_t rank,
                                          bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank), "r"((uint32_t)pred)
      : "memory");
}

// One arrival on this CTA's mbarrier, by the threads where `pred` holds.
__device__ __forceinline__ void arrive(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

// A warpgroup's register budget: the producer gives registers back, the
// consumers take them (every thread of the warpgroup executes it).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The `count` threads of named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The box at (col, row) of map into this CTA's dst (1024-byte aligned),
// its bytes reported to bar; with mask > 1 into every CTA of mask, each
// reporting to its own mbarrier at bar's offset.
__device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map,
                                     int col, int row, uint32_t bar,
                                     uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask > 1)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
            dst),
        "l"(m), "r"(col), "r"(row), "r"(bar), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(m), "r"(col), "r"(row), "r"(bar)
        : "memory");
}

// `bytes` (a multiple of 16) of this CTA's shared memory at src copied to
// the same offset dst in CTA `rank` of the cluster, reported to that CTA's
// mbarrier at bar's offset (complete_tx). An async-proxy read: threads'
// writes to src are fenced (fence_async_smem) and synchronised first.
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar,
                                             uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 rd, rb;\n"
      "mapa.shared::cluster.u32 rd, %0, %4;\n"
      "mapa.shared::cluster.u32 rb, %3, %4;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [rd], [%1], %2, [rb];\n}\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar), "r"(rank)
      : "memory");
}

// Generic-proxy writes to shared memory (a copy by the threads) visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tma

}  // namespace paddle_attn
