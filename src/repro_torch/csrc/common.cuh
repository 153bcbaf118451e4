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

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// grid dimensions y and z are capped at 65535
inline bool grid_fits(long long x, long long y, long long z) {
  return x >= 1 && x <= 2147483647LL && y >= 1 && y <= 65535 && z >= 1 && z <= 65535;
}

}  // namespace repro_torch
