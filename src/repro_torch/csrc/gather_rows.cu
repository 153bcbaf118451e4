// K1 — comm-buffer pack and the coo gather, two forms of one kernel:
//   pack:   out[p, s, :] = B[p, idx[p, s], :], a row of +0.0 where idx < 0;
//   scaled: out[p, s, :] = cast_out(float(B[p, idx[p, s], :]) * val[p, s]),
//           where idx < 0 the zero row is multiplied too (a negative val gives -0.0).
//
// Replaces: src/repro/kernels/gather_rows.py::gather_rows_pallas (the
// stage-① send-buffer pack of every flat executor body). The scaled form
// carries the coo compute's gather and multiply, which the reference
// leaves to one XLA fusion (src/repro/kernels/ops.py::coo_accumulate_rows_op,
// b[col] * val[:, None]): the multiply happens on the way from B to out, so
// the [P, S, n] products are written once and never read back for scaling.
// The scaled arithmetic is exactly torch's (gather(b) * val).to(out dtype):
// bfloat16 widens to float32 exactly, one __fmul_rn, then one round-to-
// nearest-even to the output type (none for float32).
//
// Bound on the card: memory bytes. Each output row is one read of a B row
// (hub rows of a skewed matrix come from L2) and one write; the only
// arithmetic is the scaled form's one multiply per element.
//
// Design. The output [P*S, n] is one contiguous array, so the work is cut
// into warp tiles of G consecutive slots x W chunks of a row (G * W <= 256
// chunks), where a chunk is one 16-byte vector of a row (4 float32 or 8
// bfloat16 elements):
//  * vector access: when the row's bytes are a multiple of 16 and B and out
//    are aligned, each lane moves whole 16-byte chunks (uint4 loads through
//    the read-only path, __ldg); every other case takes the element
//    instance of the same kernel, one 4- or 2-byte element per access;
//  * rows per warp: short rows are packed several to a warp (n = 40 float32
//    is 10 chunks: 25 slots a warp), a 512-byte row is 32 chunks (8 slots a
//    warp), and rows longer than 4 KB (the dispatch's 8 KB rows) are cut
//    into column tiles of at most 256 chunks, so every tile is one pass;
//  * indices: lane g loads slot g's idx (and val) with one coalesced load
//    for the tile and computes its source row; the lanes take them by
//    __shfl_sync, so no lane waits on an index load of its own;
//  * loads in flight: a lane issues its (up to 8) chunk loads before its
//    first store, so a warp keeps 4 KB in flight;
//  * the grid is one dimension over all P ranks' tiles: one launch packs
//    every rank, and short launches still spread over the SMs.
// No TMA and no tensor cores: there is no product to feed.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 4;    // warps per block
constexpr int kGatherUnroll = 8;   // chunks a lane has in flight
constexpr int kTileChunks = 32 * kGatherUnroll;  // chunks per warp tile

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// One 16-byte chunk of a B row: raw bits (pack) or V float32 values (scaled).
template <typename TI>
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float (&x)[16 / sizeof(TI)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(TI) == 4) {
      x[q] = __uint_as_float(w[q]);
    } else {  // bfloat16 widens exactly
      x[2 * q] = __uint_as_float(w[q] << 16);
      x[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

// Store V = 16 / sizeof(TI) scaled values at dst (aligned to their size).
template <typename TO, int V>
__device__ __forceinline__ void store_scaled(TO* dst, const float (&y)[V]) {
  if constexpr (std::is_same<TO, float>::value) {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      *reinterpret_cast<uint4*>(dst + q) = make_uint4(
          __float_as_uint(y[q]), __float_as_uint(y[q + 1]), __float_as_uint(y[q + 2]),
          __float_as_uint(y[q + 3]));
    }
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2_bits(y[0], y[1]), bf16x2_bits(y[2], y[3]));
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2_bits(y[0], y[1]), bf16x2_bits(y[2], y[3]),
                                                bf16x2_bits(y[4], y[5]), bf16x2_bits(y[6], y[7]));
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint16_t load_word(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// kScale = false: TI = TO = the raw word type (uint32_t / uint16_t), bits copied.
// kScale = true: TI, TO in {float, __nv_bfloat16}.
// kVec: 16-byte chunks (V = 16 / sizeof(TI) elements); otherwise one element.
template <typename TI, typename TO, bool kScale, bool kVec>
__global__ void __launch_bounds__(32 * kGatherWarps)
    gather_rows_kernel(const TI* __restrict__ b, const int32_t* __restrict__ idx,
                       const float* __restrict__ val, TO* __restrict__ out, long long rows,
                       long long S, long long K, long long n, int chunks, int tile_w, int tile_g,
                       int col_tiles) {
  constexpr int V = kVec ? 16 / sizeof(TI) : 1;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  const long long r0 = warp / col_tiles * tile_g;
  if (r0 >= rows) return;  // whole warps only; the kernel has no block barrier
  const int c0 = (int)(warp % col_tiles) * tile_w;
  const int g_rows = (int)min((long long)tile_g, rows - r0);
  const int w = min(tile_w, chunks - c0);
  const int work = g_rows * w;  // <= kTileChunks, warp-uniform

  // lane g: slot r0 + g's source row of the stacked B (-1 = zero row), its value
  long long src = -1;
  float v = 0.0f;
  if (lane < g_rows) {
    const long long r = r0 + lane;
    const int32_t i = __ldg(idx + r);
    if (i >= 0 && i < K) src = r / S * K + i;
    if constexpr (kScale) v = __ldg(val + r);
  }

  if constexpr (kVec) {
    uint4 raw[kGatherUnroll];
    long long dst[kGatherUnroll];
    float vs[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int e = u * 32 + lane;
      const int g = min(e / w, 31);
      const long long sr = __shfl_sync(0xffffffffu, src, g);
      if constexpr (kScale) vs[u] = __shfl_sync(0xffffffffu, v, g);
      const long long col = (long long)(c0 + e % w) * V;
      dst[u] = e < work ? (r0 + g) * n + col : -1;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (e < work && sr >= 0) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(b + sr * n + col));
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      if (dst[u] < 0) continue;
      if constexpr (kScale) {
        float y[V];
        chunk_to_f32<TI>(raw[u], y);
#pragma unroll
        for (int q = 0; q < V; ++q) y[q] = __fmul_rn(y[q], vs[u]);
        store_scaled<TO, V>(out + dst[u], y);
      } else {
        *reinterpret_cast<uint4*>(out + dst[u]) = raw[u];
      }
    }
  } else {
    // one element per access: n is not a multiple of a chunk, or a pointer is unaligned
    using Acc = std::conditional_t<kScale, float, TI>;
    Acc x[kGatherUnroll];
    long long dst[kGatherUnroll];
    float vs[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int e = u * 32 + lane;
      const int g = min(e / w, 31);
      const long long sr = __shfl_sync(0xffffffffu, src, g);
      if constexpr (kScale) vs[u] = __shfl_sync(0xffffffffu, v, g);
      const long long col = c0 + e % w;
      dst[u] = e < work ? (r0 + g) * n + col : -1;
      x[u] = 0;
      if (e < work && sr >= 0) {
        if constexpr (kScale) {
          x[u] = load_f32(b + sr * n + col);
        } else {
          x[u] = load_word(b + sr * n + col);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      if (dst[u] < 0) continue;
      if constexpr (kScale) {
        out[dst[u]] = from_f32<TO>(__fmul_rn(x[u], vs[u]));
      } else {
        out[dst[u]] = x[u];
      }
    }
  }
}

template <typename TI, typename TO, bool kScale>
int launch_gather(const void* b, const void* idx, const void* val, void* out, long long P,
                  long long K, long long S, long long n, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(TI);
  const size_t out_align = kV * sizeof(TO) < 16 ? kV * sizeof(TO) : 16;
  const bool vec = n % kV == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % out_align == 0;
  const long long rows = P * S;
  const long long chunks = vec ? n / kV : n;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // column tiles of at most kTileChunks chunks, as even as they go
  const long long col_tiles = ceil_div(chunks, kTileChunks);
  const long long tile_w = ceil_div(chunks, col_tiles);
  const long long tile_g = std::max(1LL, std::min(32LL, kTileChunks / tile_w));
  const long long warps = ceil_div(rows, tile_g) * col_tiles;
  const long long gx = ceil_div(warps, kGatherWarps);
  if (!grid_fits(gx, 1, 1)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx), block(32 * kGatherWarps);
  auto run = [&](auto vec_tag) {
    gather_rows_kernel<TI, TO, kScale, decltype(vec_tag)::value><<<grid, block, 0, st>>>(
        (const TI*)b, (const int32_t*)idx, (const float*)val, (TO*)out, rows, S, K, n,
        (int)chunks, (int)tile_w, (int)tile_g, (int)col_tiles);
  };
  if (vec) {
    run(std::true_type{});
  } else {
    run(std::false_type{});
  }
  return (int)cudaGetLastError();
}

template <typename TI>
int launch_scaled(const void* b, const void* idx, const void* val, void* out, long long P,
                  long long K, long long S, long long n, int out_dtype, cudaStream_t st) {
  if (out_dtype == kFloat32) return launch_gather<TI, float, true>(b, idx, val, out, P, K, S, n, st);
  if (out_dtype == kBFloat16) {
    return launch_gather<TI, __nv_bfloat16, true>(b, idx, val, out, P, K, S, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

extern "C" int repro_gather_rows(const void* b, const void* idx, void* out, long long P,
                                 long long K, long long S, long long n, int elem_bytes,
                                 void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 1 || S < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4) {
    return launch_gather<uint32_t, uint32_t, false>(b, idx, nullptr, out, P, K, S, n, st);
  }
  if (elem_bytes == 2) {
    return launch_gather<uint16_t, uint16_t, false>(b, idx, nullptr, out, P, K, S, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_gather_rows_scaled(const void* b, const void* idx, const void* val,
                                        void* out, long long P, long long K, long long S,
                                        long long n, int b_dtype, int out_dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 1 || S < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (b_dtype == kFloat32) return launch_scaled<float>(b, idx, val, out, P, K, S, n, out_dtype, st);
  if (b_dtype == kBFloat16) {
    return launch_scaled<__nv_bfloat16>(b, idx, val, out, P, K, S, n, out_dtype, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
