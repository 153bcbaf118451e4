// K3 — ELL-BSR SpMM, C = A @ B, and K4 — its accumulator form, acc += A @ B (in place).
//
// Replaces: src/repro/kernels/bsr_spmm.py::bsr_spmm_pallas (K3, the bsr
// backend's local compute) and ::bsr_spmm_acc_pallas (K4, the bsr
// backend's per-round segment compute in the overlapped flat body).
//
// Layout per rank p: block_cols[p, i, t] names the block column of the
// t-th stored (bm x bk) block of block-row i (-1 = pad slot, all-zero
// block); blocks[p, i, t] holds it (float32); B[p] is [K, n] (float32 or
// bfloat16). Rows of B past K read as zero, like the reference's padding.
//
// What bounds it on the card. At the main path's shapes (8x8 blocks,
// n = 128 or 40, ogbn-arxiv-sized graphs) a stored block holds about one
// nonzero, so one of its 8 A columns is nonzero and 63 of its 64 products
// multiply zeros; ~38% of the ELL slots are pads. The bound is bytes: each
// stored block's 256-byte A tile is read once from memory, and each B row
// that a nonzero A column names is read (mostly from L2: one rank's B is
// ~15 MB). What stands between a kernel and that bound is load count and
// latency: B rows fetched for zero A columns, or fetched again per row
// of the block, and one load latency waited out per slot.
//
// Design (bm, bk) = (8, 8), the backend's default, one warp per block-row
// and column tile:
//  * register blocking over the block's rows: a lane owns 4 consecutive
//    columns across R of the 8 rows (R = 8 at n > 64; 4 or 2 for narrower
//    B, so that more lanes have columns), so each B row is read once per
//    warp, as one 16-byte (float32) or 8-byte (bfloat16) access per lane;
//  * the A tile is read once, coalesced (one float2 per lane), and stays
//    in registers; a lane takes the A values of its rows by shuffle;
//  * only the B rows of nonzero A columns are read: two ballots over the
//    tile give its column mask;
//  * latency: the block columns of 32 slots come in one coalesced load,
//    the A tiles of the next G = 4 slots are loaded while the current 4
//    are computed, and the B rows of the current 4 slots' first nonzero
//    columns are all in flight together (further columns, rare on the
//    main path, are read one at a time). Pad slots read nothing.
// Every other (bm, bk), and 8x8 blocks whose array is not 8-byte aligned,
// take the generic instance of the same chain: a
// warp owns 8 rows x 128 columns of a block-row, stages its 8 x bk A rows
// in shared memory and walks the nonzero columns 32 at a time.
// The 8x8 blocks are below every tensor-core tile and TF32 would miss the
// 1e-5 tolerance, so this is float32 FMA arithmetic in IEEE precision.
//
// The chain (both instances, K3 and K4 alike): for each output element and
// each stored block t in ascending t, d_t = sum over the block's nonzero A
// columns k, ascending, of __fmaf_rn(a[k], b[k], d_t) from d_t = +0, then
// acc = __fadd_rn(acc, d_t). A block with no nonzero column (a pad slot,
// or stored zeros) adds nothing. K3 starts from acc = 0, K4 from the
// accumulator, so folding a piece's column segments one K4 call after
// another gives the bits of one K3 call over the whole piece: the
// overlapped executor's C is bit-identical to the staged one. Skipping a
// zero A column is exact for finite B, since fma(+-0, b, d) = d; where B
// holds an inf or a NaN in a row whose A column is zero the result then
// differs from the dense block product (which would give NaN there), as
// the coo backend's does. Accumulation is float32; bfloat16 output is
// rounded once, at the write.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

constexpr int kWarpsPerBlock = 4;
constexpr int kGroup = 4;  // slots whose loads are in flight together (8x8 instance)

// Column mask of one 8x8 A tile held as one float2 per lane (lane l holds
// elements 2l and 2l + 1, i.e. row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1).
__device__ __forceinline__ unsigned tile_col_mask(float2 a) {
  unsigned e = __ballot_sync(0xffffffffu, a.x != 0.0f);  // NaN counts as nonzero
  unsigned o = __ballot_sync(0xffffffffu, a.y != 0.0f);
  e |= e >> 16; e |= e >> 8; e |= e >> 4;
  o |= o >> 16; o |= o >> 8; o |= o >> 4;
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) m |= ((e >> q) & 1u) << (2 * q) | ((o >> q) & 1u) << (2 * q + 1);
  return m;
}

// The columns k of an 8-wide block column whose B row row0 + k exists (< K).
__device__ __forceinline__ unsigned rows_in_b(long long row0, long long K) {
  return (1u << (int)max(0LL, min(8LL, K - row0))) - 1u;
}

// d[r][q] = fma(a of row r, column k, b[q], d[r][q]) for the lane's R rows.
template <int R>
__device__ __forceinline__ void fma_col(float2 a, int k, int row_lane0, const float (&bv)[4],
                                        float (&d)[R][4]) {
  const float sel = (k & 1) ? a.y : a.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float av = __shfl_sync(0xffffffffu, sel, 4 * (row_lane0 + r) + (k >> 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) d[r][q] = __fmaf_rn(av, bv[q], d[r][q]);
  }
}

// (bm, bk) = (8, 8). One warp per (block-row, column tile of TN columns);
// the warp's lanes form 8 / R row groups of 32 R / 8 lanes, each lane owns
// 4 columns of R rows. kAcc = false: out = A @ B (K3); true: out += A @ B (K4).
template <typename TB, bool kAcc, int R, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bsr8_kernel(const int32_t* __restrict__ cols, const float* __restrict__ blocks,
                const TB* __restrict__ b, TB* __restrict__ out, long long mb, int t_steps,
                long long K, long long n, long long m_out) {
  constexpr int kLanesPerGroup = 32 * R / 8;
  constexpr int kTile = 4 * kLanesPerGroup;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= mb) return;  // whole warps only; the kernel has no block barrier
  const long long p = blockIdx.z;
  const int row_lane0 = (lane / kLanesPerGroup) * R;  // first of the lane's rows in the block
  const long long j = (long long)blockIdx.y * kTile + 4 * (lane % kLanesPerGroup);
  const int32_t* row_cols = cols + (p * mb + i) * t_steps;
  const float2* row_tiles =
      reinterpret_cast<const float2*>(blocks + (p * mb + i) * (long long)t_steps * 64);
  const TB* b_rank = b + p * K * n;
  TB* out_rank = out + p * m_out * n;

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long orow = i * 8 + row_lane0 + r;
    if (kAcc && orow < m_out) {
      load4<TB, kVec>(out_rank + orow * n, j, n, acc[r]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
  }

  // block columns of the current and the next 32 slots, one per lane
  int c_cur = lane < t_steps ? row_cols[lane] : -1;
  int c_nxt = 32 + lane < t_steps ? row_cols[32 + lane] : -1;
  float2 a_nxt[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int c = __shfl_sync(0xffffffffu, c_cur, g);
    a_nxt[g] = (g < t_steps && c >= 0) ? row_tiles[(long long)g * 32 + lane] : make_float2(0, 0);
  }
  for (int t0 = 0; t0 < t_steps; t0 += kGroup) {
    int c_g[kGroup];
    float2 a_g[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int c = __shfl_sync(0xffffffffu, c_cur, (t0 + g) & 31);
      c_g[g] = t0 + g < t_steps ? c : -1;
      a_g[g] = a_nxt[g];
    }
    // the next group's A tiles, loaded while this group computes
    const int tn = t0 + kGroup;
    if ((tn & 31) == 0) {
      c_cur = c_nxt;
      c_nxt = tn + 32 + lane < t_steps ? row_cols[tn + 32 + lane] : -1;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int c = __shfl_sync(0xffffffffu, c_cur, (tn + g) & 31);
      a_nxt[g] = (tn + g < t_steps && c >= 0) ? row_tiles[(long long)(tn + g) * 32 + lane]
                                               : make_float2(0, 0);
    }
    // column masks, then the B rows of each slot's first nonzero column
    unsigned mask[kGroup];
    float b_first[kGroup][4];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long brow0 = (long long)c_g[g] * 8;
      mask[g] = tile_col_mask(a_g[g]) & (c_g[g] >= 0 ? rows_in_b(brow0, K) : 0u);
      if (mask[g]) {
        load4<TB, kVec>(b_rank + (brow0 + __ffs(mask[g]) - 1) * n, j, n, b_first[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (mask[g] == 0) continue;  // warp-uniform: the mask comes from ballots
      const long long brow0 = (long long)c_g[g] * 8;
      float d[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) d[r][q] = 0.0f;
      }
      unsigned m = mask[g];
      fma_col<R>(a_g[g], __ffs(m) - 1, row_lane0, b_first[g], d);
      m &= m - 1;
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        float bv[4];
        load4<TB, kVec>(b_rank + (brow0 + k) * n, j, n, bv);
        fma_col<R>(a_g[g], k, row_lane0, bv, d);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = __fadd_rn(acc[r][q], d[r][q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long orow = i * 8 + row_lane0 + r;
    if (orow < m_out) store4<TB, kVec>(out_rank + orow * n, j, n, acc[r]);
  }
}

// Any (bm, bk): one warp per (block-row, 8-row slice of it, 128 columns);
// each lane owns 4 columns of the slice's 8 rows. The slice's 8 x bk A
// values are staged in shared memory (column-major, 8 per column) per slot.
template <typename TB, bool kAcc, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bsr_generic_kernel(const int32_t* __restrict__ cols, const float* __restrict__ blocks,
                       const TB* __restrict__ b, TB* __restrict__ out, long long mb,
                       int t_steps, int bm, int bk, long long K, long long n, long long m_out) {
  extern __shared__ float a_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* a_s = a_smem + (long long)warp * 8 * bk;
  const long long slices = (bm + 7) / 8;
  const long long u = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (u >= mb * slices) return;  // whole warps only
  const long long i = u / slices;
  const int r0 = (int)(u % slices) * 8;
  const long long p = blockIdx.z;
  const long long j = (long long)blockIdx.y * 128 + 4 * lane;
  const int32_t* row_cols = cols + (p * mb + i) * t_steps;
  const float* row_blocks = blocks + (p * mb + i) * (long long)t_steps * bm * bk;
  const TB* b_rank = b + p * K * n;
  TB* out_rank = out + p * m_out * n;

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long orow = i * bm + r0 + r;
    if (kAcc && r0 + r < bm && orow < m_out) {
      load4<TB, kVec>(out_rank + orow * n, j, n, acc[r]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
  }
  for (int t = 0; t < t_steps; ++t) {
    const int c = row_cols[t];
    if (c < 0) continue;  // warp-uniform
    const float* tile = row_blocks + (long long)t * bm * bk;
    for (int e = lane; e < 8 * bk; e += 32) {
      const int r = e / bk, k = e % bk;
      a_s[k * 8 + r] = r0 + r < bm ? tile[(long long)(r0 + r) * bk + k] : 0.0f;
    }
    __syncwarp();
    const long long brow0 = (long long)c * bk;
    float d[8][4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[r][q] = 0.0f;
    }
    for (int k0 = 0; k0 < bk; k0 += 32) {
      const int kl = k0 + lane;
      bool nz = false;
      if (kl < bk && brow0 + kl < K) {
#pragma unroll
        for (int r = 0; r < 8; ++r) nz |= a_s[kl * 8 + r] != 0.0f;
      }
      unsigned m = __ballot_sync(0xffffffffu, nz);
      any |= m != 0;
      while (m) {
        const int k = k0 + __ffs(m) - 1;
        m &= m - 1;
        float bv[4];
        load4<TB, kVec>(b_rank + (brow0 + k) * n, j, n, bv);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = a_s[k * 8 + r];
#pragma unroll
          for (int q = 0; q < 4; ++q) d[r][q] = __fmaf_rn(av, bv[q], d[r][q]);
        }
      }
    }
    if (any) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = __fadd_rn(acc[r][q], d[r][q]);
      }
    }
    __syncwarp();  // every lane is done with a_s before the next slot's tile
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long orow = i * bm + r0 + r;
    if (r0 + r < bm && orow < m_out) store4<TB, kVec>(out_rank + orow * n, j, n, acc[r]);
  }
}

template <typename TB, bool kAcc, bool kVec>
int launch_typed(const int32_t* cols, const float* blocks, const TB* b, TB* out, long long P,
                 long long mb, int t_steps, int bm, int bk, long long K, long long n,
                 long long m_out, cudaStream_t st) {
  const dim3 block(32 * kWarpsPerBlock);
  if (bm == 8 && bk == 8 && reinterpret_cast<uintptr_t>(blocks) % sizeof(float2) == 0) {
    // rows per lane: all 8 where B is wider than 64 columns, else fewer
    // rows per lane and more lanes on the columns
    const int R = n > 64 ? 8 : (n > 32 ? 4 : 2);
    const long long tile = 4 * (32 * R / 8);
    const long long gx = ceil_div(mb, kWarpsPerBlock), gy = ceil_div(n, tile);
    if (!grid_fits(gx, gy, P)) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)P);
    if (R == 8) {
      bsr8_kernel<TB, kAcc, 8, kVec><<<grid, block, 0, st>>>(cols, blocks, b, out, mb, t_steps,
                                                             K, n, m_out);
    } else if (R == 4) {
      bsr8_kernel<TB, kAcc, 4, kVec><<<grid, block, 0, st>>>(cols, blocks, b, out, mb, t_steps,
                                                             K, n, m_out);
    } else {
      bsr8_kernel<TB, kAcc, 2, kVec><<<grid, block, 0, st>>>(cols, blocks, b, out, mb, t_steps,
                                                             K, n, m_out);
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)kWarpsPerBlock * 8 * bk * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // bk > 384
  const long long gx = ceil_div(mb * ((bm + 7) / 8), kWarpsPerBlock), gy = ceil_div(n, 128);
  if (!grid_fits(gx, gy, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)P);
  bsr_generic_kernel<TB, kAcc, kVec><<<grid, block, smem, st>>>(cols, blocks, b, out, mb,
                                                                 t_steps, bm, bk, K, n, m_out);
  return (int)cudaGetLastError();
}

template <typename TB, bool kAcc>
int launch_vec(const void* cols, const void* blocks, const void* b, void* out, long long P,
               long long mb, int t_steps, int bm, int bk, long long K, long long n,
               long long m_out, cudaStream_t st) {
  const bool vec = vec4_ok(b, n, sizeof(TB)) && vec4_ok(out, n, sizeof(TB));
  auto run = [&](auto vec_tag) {
    return launch_typed<TB, kAcc, decltype(vec_tag)::value>(
        (const int32_t*)cols, (const float*)blocks, (const TB*)b, (TB*)out, P, mb, t_steps, bm,
        bk, K, n, m_out, st);
  };
  return vec ? run(std::true_type{}) : run(std::false_type{});
}

// bn, the reference's column tile, is checked and otherwise unused: the
// card's column tile follows from n and the block shape.
template <bool kAcc>
int launch(const void* cols, const void* blocks, const void* b, void* out, long long P,
           long long mb, int t_steps, int bm, int bk, long long K, long long n, long long m_out,
           int bn, int dtype, void* stream) {
  if (bn < 1 || bm < 1 || bk < 1 || t_steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    return launch_vec<float, kAcc>(cols, blocks, b, out, P, mb, t_steps, bm, bk, K, n, m_out,
                                   st);
  }
  if (dtype == kBFloat16) {
    return launch_vec<__nv_bfloat16, kAcc>(cols, blocks, b, out, P, mb, t_steps, bm, bk, K, n,
                                           m_out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

extern "C" int repro_bsr_spmm(const void* cols, const void* blocks, const void* b, void* out,
                              long long P, long long mb, int t_steps, int bm, int bk,
                              long long K, long long n, long long m_out, int bn, int dtype,
                              void* stream) {
  return repro_torch::launch<false>(cols, blocks, b, out, P, mb, t_steps, bm, bk, K, n, m_out,
                                    bn, dtype, stream);
}

extern "C" int repro_bsr_spmm_acc(const void* cols, const void* blocks, const void* b,
                                  void* acc, long long P, long long mb, int t_steps, int bm,
                                  int bk, long long K, long long n, long long m_out, int bn,
                                  int dtype, void* stream) {
  return repro_torch::launch<true>(cols, blocks, b, acc, P, mb, t_steps, bm, bk, K, n, m_out,
                                   bn, dtype, stream);
}
