// K5 — block-sparse SDDMM: vals[p, i, t] = blocks[p, i, t] ⊙ (X_blk · Y_blkᵀ), float32 out.
//
// Replaces: src/repro/kernels/sddmm.py:72 bsr_sddmm_pallas (the bsr
// backend's sddmm, which the SDDMM and FusedMM executors call for every
// piece — and through FusedMM, GAT's attention scores).
//
// Layout per rank p: block_cols[p, i, t] names the block column of the
// t-th stored (bm x bk) block of block-row i (-1 = pad slot); blocks[p, i, t]
// holds its stored values (float32); x3[p, i] is the (bm x F) tile of X
// rows of block-row i and y3[p, kb] the (bk x F) tile of Y rows of block
// column kb (float32 or bfloat16, both the same). For every stored block
//   out[p, i, t, r, c] = blocks[p, i, t, r, c] * sum_f x3[p, i, r, f] * y3[p, col, c, f].
//
// What bounds it on the card: bytes. The result keeps the dense slot
// layout [P, mb, t, bm, bk] (the FusedMM executor hands it to K3 as the
// blocks of the same ELL pieces), so every slot, pads included, is written
// once (256 bytes for 8x8), and every stored block is read once (256
// bytes). Beyond those, only the X and Y rows of the stored NONZERO entries
// are needed: at the main path's shapes (8x8 blocks, ogbn-arxiv-sized
// graphs) a stored block holds about one nonzero, so 63 of its 64 dots
// would be multiplied by zero. The products are 2·F + 1 operations per
// nonzero, far below the float32 ridge.
//
// Design (bm, bk) = (8, 8), the backend's default: one warp per block-row
// of one rank, 4 warps per thread block, no block barrier (each warp syncs
// itself with __syncwarp):
//  * the block-row's 8 x F X tile is read once, coalesced, into the warp's
//    slice of shared memory as float32 (rows padded so that the 8 rows at
//    one f fall in distinct banks);
//  * the block columns of 32 slots come in one coalesced load (one per
//    lane) and shuffles broadcast them;
//  * slots go in groups of G = 8: each stored block is read once as one
//    float2 per lane (256 bytes, coalesced), and the next group's 8 tiles
//    are loaded while the current group computes;
//  * two ballots per slot give the tile's nonzero entries; a popc prefix
//    over the group numbers them, and entry k goes to lane k % 32, so the
//    lanes share the group's nonzeros instead of idling on 63 zeros;
//  * a lane forms each of its dots with one Y row from global memory
//    (16-byte float32 / 8-byte bfloat16 loads when F % 4 == 0 and the
//    pointers allow; element by element otherwise, with the same values)
//    and the X row from shared memory, and parks it in shared memory;
//  * lane l then writes elements 2l and 2l + 1 of each slot of the group
//    as one float2: 256 coalesced bytes per slot, each element once.
// The X tile per warp is the only shared memory that grows with F; for very
// wide F the launch runs fewer warps per block (see launch_sddmm8).
// Every other (bm, bk) takes the generic instance: one thread block per
// block-row and one thread per block element, the X tile in shared memory
// and each stored block's Y tile staged there.
// No tensor cores: an 8x8xF product with about one nonzero is below every
// mma/wgmma tile; the work is loads.
//
// The chain (both instances): for a stored value a != 0, acc = +0, then
// acc = __fmaf_rn(x[f], y[f], acc) in ascending f, and out = __fmul_rn(a,
// acc) — one rounding per step, as the plain version repeats. A stored zero
// and a pad slot write +0.0 without forming the dot. For finite X and Y
// that is the value fmul(0, dot) has (up to the sign of zero); where a Y or
// X row holds an inf or a NaN, a zero stored value gives +0.0 here where
// the dense block product gives NaN.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int kSddmmWarps = 4;  // warps per thread block (8x8 instance)
constexpr int kSddmmGroup = 8;  // slots whose tiles are in flight together
// shared memory per warp: the group's dots (kSddmmVals floats), the X tile
// (8 rows, `stride` apart) and the group's entry list (kSddmmVals uint16)
constexpr int kSddmmVals = kSddmmGroup * 64;
constexpr size_t kSmemMax = 232448;  // bytes a Hopper block may use

// Row stride of the X tile in shared memory: a multiple of 4 (float4 reads)
// when F % 4 == 0, else odd; either way the 8 rows at one f fall in
// distinct banks.
inline int sddmm8_stride(long long f) {
  return (int)(f % 4 == 0 ? f + 4 : (f % 2 ? f : f + 1));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kSddmmWarps)
    bsr_sddmm8_kernel(const int32_t* __restrict__ cols, const float* __restrict__ blocks,
                      const T* __restrict__ x3, const T* __restrict__ y3,
                      float* __restrict__ out, long long mb, int t_steps, long long kb, int f,
                      int stride, int warps) {
  extern __shared__ float4 sddmm8_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * warps + warp;
  if (i >= mb) return;  // whole warps only; the kernel has no block barrier
  const long long p = blockIdx.y;
  float* vals = reinterpret_cast<float*>(sddmm8_smem) +
                (long long)warp * (kSddmmVals * 3 / 2 + 8 * stride);
  float* xs = vals + kSddmmVals;
  unsigned short* list = reinterpret_cast<unsigned short*>(xs + 8 * stride);

  const long long row = p * mb + i;
  const int32_t* row_cols = cols + row * t_steps;
  const float2* row_tiles = reinterpret_cast<const float2*>(blocks + row * t_steps * 64);
  float2* row_out = reinterpret_cast<float2*>(out + row * t_steps * 64);
  const T* y_rank = y3 + p * kb * 8 * f;

  // block columns of the current and the next 32 slots, one per lane
  int c_cur = lane < t_steps ? row_cols[lane] : -1;
  int c_nxt = 32 + lane < t_steps ? row_cols[32 + lane] : -1;
  float2 a_nxt[kSddmmGroup];
#pragma unroll
  for (int g = 0; g < kSddmmGroup; ++g) {
    const int c = __shfl_sync(0xffffffffu, c_cur, g);
    a_nxt[g] = (g < t_steps && c >= 0 && c < kb) ? row_tiles[(long long)g * 32 + lane]
                                                  : make_float2(0.0f, 0.0f);
  }
  // the X tile, as float32
  const T* x_tile = x3 + row * 8 * f;
  if constexpr (kVec) {
    for (int e = 4 * lane; e < 8 * f; e += 128) {
      float v[4];
      load4<T, true>(x_tile, e, 8LL * f, v);
      *reinterpret_cast<float4*>(xs + (e / f) * stride + e % f) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = lane; e < 8 * f; e += 32) xs[(e / f) * stride + e % f] = to_f32(x_tile[e]);
  }
  __syncwarp();

  const unsigned lanes_below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < t_steps; t0 += kSddmmGroup) {
    int c_g[kSddmmGroup];
    float2 a_g[kSddmmGroup];
#pragma unroll
    for (int g = 0; g < kSddmmGroup; ++g) {
      c_g[g] = __shfl_sync(0xffffffffu, c_cur, (t0 + g) & 31);
      a_g[g] = a_nxt[g];
    }
    // the next group's tiles, loaded while this group computes
    const int tn = t0 + kSddmmGroup;
    if ((tn & 31) == 0) {
      c_cur = c_nxt;
      c_nxt = tn + 32 + lane < t_steps ? row_cols[tn + 32 + lane] : -1;
    }
#pragma unroll
    for (int g = 0; g < kSddmmGroup; ++g) {
      const int c = __shfl_sync(0xffffffffu, c_cur, (tn + g) & 31);
      a_nxt[g] = (tn + g < t_steps && c >= 0 && c < kb)
                     ? row_tiles[(long long)(tn + g) * 32 + lane]
                     : make_float2(0.0f, 0.0f);
    }
    // number the group's nonzero entries: slot by slot, the even elements
    // (a.x of each lane) before the odd ones (a.y)
    int total = 0;
#pragma unroll
    for (int g = 0; g < kSddmmGroup; ++g) {
      const unsigned mx = __ballot_sync(0xffffffffu, a_g[g].x != 0.0f);  // NaN counts
      const unsigned my = __ballot_sync(0xffffffffu, a_g[g].y != 0.0f);  // as nonzero
      if ((mx >> lane) & 1u) list[total + __popc(mx & lanes_below)] = g * 64 + 2 * lane;
      total += __popc(mx);
      if ((my >> lane) & 1u) list[total + __popc(my & lanes_below)] = g * 64 + 2 * lane + 1;
      total += __popc(my);
    }
    if (total) {  // warp-uniform: totals come from ballots
      __syncwarp();  // the list is in place
      for (int k = lane; k < total; k += 32) {
        const int ent = list[k];
        const int g = ent >> 6, r = (ent >> 3) & 7, c = ent & 7;
        int col = 0;
#pragma unroll
        for (int q = 0; q < kSddmmGroup; ++q) col = q == g ? c_g[q] : col;
        const T* yrow = y_rank + ((long long)col * 8 + c) * f;
        const float* xrow = xs + r * stride;
        float acc = 0.0f;
        if constexpr (kVec) {
#pragma unroll 4
          for (int q = 0; q < f; q += 4) {
            float yv[4];
            load4<T, true>(yrow, q, f, yv);
            const float4 xv = *reinterpret_cast<const float4*>(xrow + q);
            acc = __fmaf_rn(xv.x, yv[0], acc);
            acc = __fmaf_rn(xv.y, yv[1], acc);
            acc = __fmaf_rn(xv.z, yv[2], acc);
            acc = __fmaf_rn(xv.w, yv[3], acc);
          }
        } else {
          for (int q = 0; q < f; ++q) acc = __fmaf_rn(xrow[q], to_f32(yrow[q]), acc);
        }
        vals[ent] = acc;
      }
      __syncwarp();  // the dots are in place; the list may be reused
    }
#pragma unroll
    for (int g = 0; g < kSddmmGroup; ++g) {
      if (t0 + g >= t_steps) break;
      const float2 a = a_g[g];
      const float2 v = reinterpret_cast<const float2*>(vals + g * 64)[lane];
      row_out[(long long)(t0 + g) * 32 + lane] =
          make_float2(a.x != 0.0f ? __fmul_rn(a.x, v.x) : 0.0f,
                      a.y != 0.0f ? __fmul_rn(a.y, v.y) : 0.0f);
    }
  }
}

template <typename T>
int launch_sddmm8(const int32_t* cols, const float* blocks, const T* x3, const T* y3,
                  float* out, long long P, long long mb, int t_steps, long long kb, long long f,
                  cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(blocks) % sizeof(float2) ||
      reinterpret_cast<uintptr_t>(out) % sizeof(float2) || 8 * f > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int stride = sddmm8_stride(f);
  const size_t per_warp = (size_t)kSddmmVals * 6 + (size_t)8 * stride * sizeof(float);
  const int warps = (int)std::min<size_t>(kSddmmWarps, kSmemMax / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps;
  const long long gx = ceil_div(mb, warps);
  if (!grid_fits(gx, P, 1)) return (int)cudaErrorInvalidConfiguration;
  const bool vec = vec4_ok(x3, f, sizeof(T)) && vec4_ok(y3, f, sizeof(T));
  auto kernel = vec ? bsr_sddmm8_kernel<T, true> : bsr_sddmm8_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)gx, (unsigned)P), 32 * warps, smem, st>>>(
      cols, blocks, x3, y3, out, mb, t_steps, kb, (int)f, stride, warps);
  return (int)cudaGetLastError();
}

// Any (bm, bk): one thread block per block-row of one rank, one thread per
// block element.
template <typename T>
__global__ void bsr_sddmm_generic_kernel(const int32_t* __restrict__ cols,
                                         const float* __restrict__ blocks,
                                         const T* __restrict__ x3, const T* __restrict__ y3,
                                         float* __restrict__ out, long long mb, int t_steps,
                                         int bm, int bk, long long kb, long long f, int stride) {
  extern __shared__ float smem[];
  float* xs = smem;                // bm rows of X, `stride` apart
  float* ys = smem + bm * stride;  // bk rows of Y
  const long long p = blockIdx.y;
  const long long i = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int r = tid / bk, c = tid % bk;
  const long long blk = (long long)bm * bk;

  const T* x_tile = x3 + (p * mb + i) * (long long)bm * f;
  for (long long e = tid; e < (long long)bm * f; e += nthr) {
    xs[(e / f) * stride + e % f] = to_f32(x_tile[e]);
  }
  const int32_t* row_cols = cols + (p * mb + i) * t_steps;
  const float* row_blocks = blocks + (p * mb + i) * t_steps * blk;
  float* row_out = out + (p * mb + i) * t_steps * blk;
  for (int t = 0; t < t_steps; ++t) {
    const int32_t cb = row_cols[t];  // the same for every thread of the block
    if (cb < 0 || cb >= kb) {
      row_out[t * blk + tid] = 0.0f;
      continue;
    }
    __syncthreads();  // the previous slot's reads of ys are done
    const T* y_tile = y3 + (p * kb + cb) * (long long)bk * f;
    for (long long e = tid; e < (long long)bk * f; e += nthr) {
      ys[(e / f) * stride + e % f] = to_f32(y_tile[e]);
    }
    __syncthreads();  // xs (first slot) and ys are in place
    const float a = row_blocks[t * blk + tid];
    float acc = 0.0f;
    if (a != 0.0f) {
      const float* xr = xs + r * stride;
      const float* yr = ys + c * stride;
      for (long long k = 0; k < f; ++k) acc = __fmaf_rn(xr[k], yr[k], acc);
    }
    row_out[t * blk + tid] = a != 0.0f ? __fmul_rn(a, acc) : 0.0f;
  }
}

template <typename T>
int launch_generic(const int32_t* cols, const float* blocks, const T* x3, const T* y3,
                   float* out, long long P, long long mb, int t_steps, int bm, int bk,
                   long long kb, long long f, cudaStream_t st) {
  const int threads = bm * bk;
  const int stride = (int)(f % 2 == 0 ? f + 1 : f);
  const size_t smem = (size_t)(bm + bk) * stride * sizeof(float);
  if (!grid_fits(mb, P, 1)) return (int)cudaErrorInvalidConfiguration;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_sddmm_generic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bsr_sddmm_generic_kernel<T><<<dim3((unsigned)mb, (unsigned)P), threads, smem, st>>>(
      cols, blocks, x3, y3, out, mb, t_steps, bm, bk, kb, f, stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sddmm(const void* cols, const void* blocks, const void* x3, const void* y3,
                 void* out, long long P, long long mb, int t_steps, int bm, int bk, long long kb,
                 long long f, cudaStream_t st) {
  if (bm == 8 && bk == 8) {
    return launch_sddmm8<T>((const int32_t*)cols, (const float*)blocks, (const T*)x3,
                            (const T*)y3, (float*)out, P, mb, t_steps, kb, f, st);
  }
  return launch_generic<T>((const int32_t*)cols, (const float*)blocks, (const T*)x3,
                           (const T*)y3, (float*)out, P, mb, t_steps, bm, bk, kb, f, st);
}

}  // namespace repro_torch

extern "C" int repro_bsr_sddmm(const void* cols, const void* blocks, const void* x3,
                               const void* y3, void* out, long long P, long long mb,
                               int t_steps, int bm, int bk, long long kb, long long f,
                               int dtype, void* stream) {
  using namespace repro_torch;
  if (t_steps < 1 || bm < 1 || bk < 1 || bm * bk > 1024 || kb < 1 || f < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch_sddmm<float>(cols, blocks, x3, y3, out, P, mb, t_steps, bm, bk, kb, f, st);
  if (dtype == kBFloat16)
    return launch_sddmm<__nv_bfloat16>(cols, blocks, x3, y3, out, P, mb, t_steps, bm, bk, kb,
                                       f, st);
  return (int)cudaErrorInvalidValue;
}
