// 16-byte vector loads and stores of a row's elements, converted to and
// from fp32, for the row kernels (RMSNorm): V elements a load, with V = 1
// the scalar form for rows whose length or pointers do not allow vectors;
// and the same conversions of a vector already held in registers.
#pragma once

#include <cstdint>

#include "numeric.cuh"

namespace paddle_attn {

constexpr int kVecBytes = 16;

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f(*p);
  } else {
    static_assert(V * sizeof(T) == kVecBytes, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(in[0]);
  } else {
    static_assert(V * sizeof(T) == kVecBytes, "a vector is 16 bytes");
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// A 16-byte vector held in registers as V elements of T, to and from fp32.
template <typename T, int V>
__device__ __forceinline__ void unpack_vec(const uint4& raw,
                                           float (&out)[V]) {
  static_assert(V * sizeof(T) == kVecBytes, "a vector is 16 bytes");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ uint4 pack_vec(const float (&in)[V]) {
  static_assert(V * sizeof(T) == kVecBytes, "a vector is 16 bytes");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f<T>(in[j]);
  return raw;
}

// True when rows of D elements of T can be read as 16-byte vectors: D a
// multiple of the vector and every pointer 16-byte aligned (then every
// row start is too).
template <typename T, typename... P>
inline bool vec_ok(int D, P... ptrs) {
  bool ok = D % (kVecBytes / (int)sizeof(T)) == 0;
  ((ok = ok && reinterpret_cast<uintptr_t>(ptrs) % kVecBytes == 0), ...);
  return ok;
}

}  // namespace paddle_attn
