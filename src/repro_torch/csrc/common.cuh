// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here works on the STACKED rank axis: tensors lead with
// [P, ...] (one slice per emulated rank) and the rank is a grid
// dimension, so one launch covers all P ranks. Element offsets are int64.
// Each exported C function returns cudaGetLastError() right after its
// launch; the Python wrapper raises when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes shared with kernels/build.py
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements of a row, from column j on, as float32. With
// kVec (n % 4 == 0 and the row 4-element aligned, so j < n implies
// j + 3 < n) it is one 16-byte (float32) or 8-byte (bfloat16) access;
// otherwise one element at a time, with zeros past column n. Both give the
// same values, so the arithmetic does not depend on the access width.
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ row, long long j, long long n,
                                      float (&v)[4]) {
  if constexpr (kVec) {
    if (j < n) {
      if constexpr (sizeof(T) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + j);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(row + j);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = to_f32(e[q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = 0.0f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = j + q < n ? to_f32(row[j + q]) : 0.0f;
  }
}

// The store of load4: each element rounded once to T.
template <typename T, bool kVec>
__device__ __forceinline__ void store4(T* __restrict__ row, long long j, long long n,
                                       const float (&v)[4]) {
  if constexpr (kVec) {
    if (j >= n) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + j) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = from_f32<T>(v[q]);
      *reinterpret_cast<uint2*>(row + j) = raw;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < n) row[j + q] = from_f32<T>(v[q]);
    }
  }
}

// True when rows of n elements at ptr allow load4/store4's vector access.
inline bool vec4_ok(const void* ptr, long long n, int elem_bytes) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % (4 * elem_bytes) == 0;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// grid dimensions y and z are capped at 65535
inline bool grid_fits(long long x, long long y, long long z) {
  return x >= 1 && x <= 2147483647LL && y >= 1 && y <= 65535 && z >= 1 && z <= 65535;
}

}  // namespace repro_torch
