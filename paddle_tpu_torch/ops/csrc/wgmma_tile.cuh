// Hopper's warpgroup tensor-core products (wgmma) and the shared-memory
// tiles they read, shared by the flash attention kernels' tensor-core
// path (flash_fwd.cuh, flash_bwd_dkv.cuh, flash_bwd_dq.cuh) and the fused
// FFN kernels' (fused_ffn_fwd.cu, fused_ffn_bwd_dx.cu, fused_ffn_bwd_dw.cu:
// the products with the operand orders as template arguments, mma_ss_t,
// mma_ss128_t and mma_rs128_t; their tiles come in through TMA,
// tma_tile.cuh, in this layout).
//
// A tile holds ROWS rows of D (64 or 128) bf16 or fp16 values as D / 64
// panels of [ROWS][64], one after the other; a panel row is 128 bytes, and
// its 16-byte chunk c sits at chunk c ^ (row & 7): the 128-byte swizzle
// that wgmma's descriptors name (layout type 1), on a 1024-byte-aligned
// base. One layout serves both operand orders:
//   - K-major (the product's depth runs along D, as Q and K in Q K^T):
//     k-step kk of 16 columns starts at panel kk / 4, byte 32 * (kk % 4);
//     8-row groups are 1024 bytes apart (SBO);
//   - MN-major (the depth runs along the rows, as V in P V or dO in
//     P^T dO): k-step kk of 16 rows starts 2048 * kk bytes in; the 64-wide
//     panels along N are ROWS * 128 bytes apart (LBO), 8-row groups 1024
//     (SBO), and the instruction's transpose flag for B is set.
// Tiles are filled with cp.async, 16 bytes a thread, rows past the valid
// ones zero-filled, so a ragged edge never carries stale values into a
// product.
//
// Products: wgmma.mma_async m64nNk16 with an fp32 accumulator, A and B
// from shared memory (ss, N = 64) or A from registers (rs, N = 64 or 128).
// The m64nN accumulator of thread t of the warpgroup (warp w = t / 32,
// lane l) holds rows 16 w + l / 4 and that + 8, columns 8 j + 2 (l % 4)
// and that + 1 for j < N / 8, at register 4 j + 2 i + c (row i, column
// c). For 16-bit types the A fragment of k-step kk in registers has the
// same layout over columns 16 kk .. 16 kk + 15, so an accumulator turns
// into the A operand of the next product by rounding pairs (to_frags):
// this is how P enters P V and dS enters dS K (as in FlashAttention-3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace paddle_attn {

namespace wg {

constexpr int kThreads = 128;  // one warpgroup

// Whether the tensor-core kernels exist for T: bf16 and fp16 (wgmma's
// 16-bit inputs); fp32 never goes through TF32. Which calls take them is
// the wrapper's choice (ops/flash_attention.py's kernel_path).
template <typename T>
constexpr bool tc_type() {
  return !std::is_same<T, float>::value;
}

// Whether every pointer is 16-byte aligned, as cp.async's 16-byte chunks
// need.
template <typename... P>
inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (c < D / 8) of row r in a ROWS-row tile.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight, then make the
// landed bytes visible to wgmma (the async proxy).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Warpgroup-wide: rows [0, n) of src (row stride D elements of 2 bytes)
// into the ROWS-row tile at dst; rows [n, ROWS) zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const void* src,
                                          int n, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes");
  const char* s = static_cast<const char*>(src);
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r < n;
    cp_async16(dst + tile_offset<ROWS>(r, c),
               s + ((size_t)(ok ? r : 0) * D + c * 8) * 2, ok);
  }
}

// Warpgroup-wide: n (<= ROWS) fp32 values of src into dst, zero past n.
template <int ROWS>
__device__ __forceinline__ void load_row_values(uint32_t dst,
                                                const float* src, int n,
                                                int tid) {
  if (tid < ROWS) cp_async4(dst + 4 * tid, src + (tid < n ? tid : 0),
                            tid < n);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of k-step kk of a K-major operand (depth along D).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// Descriptor of k-step kk of an MN-major operand (depth along the rows).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait
// that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async wrappers, one per shape and type (the operand lists
// written out: PTX names every accumulator register).
__device__ __forceinline__ void ss_n64_bf16(float (&d)[32], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void rs_n64_bf16(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void rs_n128_bf16(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void ss_n64_f16(float (&d)[32], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void rs_n64_f16(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void rs_n128_f16(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


// d (+)= A B over one k-step of 16: A and B K-major tiles in shared
// memory, B's N = 64 rows. acc = 0 overwrites d.
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value)
    ss_n64_f16(d, a, b, acc);
  else
    ss_n64_bf16(d, a, b, acc);
}

// d (+)= A B over one k-step of 16: A in registers, B an MN-major tile of
// N = 2 * NR columns.
template <typename T, int NR>
__device__ __forceinline__ void mma_rs(float (&d)[NR],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  static_assert(NR == 32 || NR == 64, "N is 64 or 128");
  if constexpr (NR == 32) {
    if constexpr (std::is_same<T, __half>::value)
      rs_n64_f16(d, a, b, acc);
    else
      rs_n64_bf16(d, a, b, acc);
  } else {
    if constexpr (std::is_same<T, __half>::value)
      rs_n128_f16(d, a, b, acc);
    else
      rs_n128_bf16(d, a, b, acc);
  }
}

// The fused FFN backward's products (fused_ffn_bwd_dx.cu, _dw.cu), with
// the operand orders as template arguments (PTX's imm-trans-a / -b, which
// 16-bit types allow in both operands): 0 K-major, 1 MN-major. An
// MN-major A is a tile whose rows run along the depth (a W1 chunk [K][F]
// as the A of W1^T x^T), read through desc_mn as an MN-major B is.
#define PADDLE_WG_D32                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])
#define PADDLE_WG_D64                                                   \
  PADDLE_WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),  \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),  \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),  \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),  \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PADDLE_WG_R32                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define PADDLE_WG_R64                                                   \
  PADDLE_WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "  \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "   \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (+)= A B over one k-step of 16, m64n64, A and B in shared memory in
// the orders TA and TB.
template <typename T, int TA, int TB>
__device__ __forceinline__ void mma_ss_t(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{" PADDLE_WG_R32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : PADDLE_WG_D32
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" PADDLE_WG_R32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : PADDLE_WG_D32
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B over one k-step of 16, m64n128, A and B in shared memory in
// the orders TA and TB (the fused FFN forward's t W2, t a K-major tile).
template <typename T, int TA, int TB>
__device__ __forceinline__ void mma_ss128_t(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{" PADDLE_WG_R64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : PADDLE_WG_D64
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PADDLE_WG_R64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : PADDLE_WG_D64
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B over one k-step of 16, m64n128: A in registers, B in shared
// memory in the order TB.
template <typename T, int TB>
__device__ __forceinline__ void mma_rs128_t(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{" PADDLE_WG_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : PADDLE_WG_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PADDLE_WG_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : PADDLE_WG_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
}

#undef PADDLE_WG_D32
#undef PADDLE_WG_D64
#undef PADDLE_WG_R32
#undef PADDLE_WG_R64

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The m64n64 accumulator d, rounded to T, as the A fragments of four
// k-steps (columns 16 kk .. 16 kk + 15).
template <typename T>
__device__ __forceinline__ void to_frags(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

// Stores rows [0, 64) of an m64nN accumulator (N = 2 * NR) rounded to T
// at dst (row stride ld elements), rows at or past n skipped, each row
// divided by div[i] (i = 0: the thread's first row, 1: that + 8).
template <typename T, int NR>
__device__ __forceinline__ void store_rows(T* dst, int ld, int n,
                                           const float (&d)[NR],
                                           const float (&div)[2], int tid) {
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n) continue;
    T* row = dst + (size_t)r * ld + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NR / 4; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack2<T>(d[4 * j + 2 * i] / div[i], d[4 * j + 2 * i + 1] / div[i]);
  }
}

}  // namespace wg

}  // namespace paddle_attn
