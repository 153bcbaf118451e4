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
// Bound on the card: at the main path's shapes (8x8 blocks, n = 128) the
// float32 operations of the stored blocks and the bytes of the output and
// the blocks give bounds of the same order; chip_smoke.py prints which is
// larger for each call. The float32 rate outside the tensor cores applies:
// the blocks are too small and mostly zero for an MMA tile to pay.
//
// Design: the 8x8 default blocks are below every tensor-core tile, so
// this is plain float32 arithmetic in IEEE precision (no TF32): one
// thread per output row and kCols = 4 columns (j, j+32, j+64, j+96),
// grid (block-row i, column tile of bn, rank p), 8 warps per block over
// the bm rows, the 32 lanes of a warp over neighbouring columns
// (coalesced B reads; the A element a warp reads is one broadcast
// address, and each A load and block-column index feeds 4 columns). The
// TPU kernel folded one stored block per sequential grid step into a VMEM
// tile; here the t loop runs inside the thread and the sums stay in
// registers.
//
// K3 and K4 share ONE device routine for a t step (bsr_step): it forms
// d_t = sum_k a[k] * b[k] in ascending k with explicit __fmaf_rn, and the
// caller folds acc = __fadd_rn(acc, d_t) in ascending t. The intrinsics
// stop the compiler from contracting the fold differently in the two
// kernels, so folding a piece's segments one K4 call after another gives
// the bits of one K3 call over the whole piece — the overlapped executor's
// C is bit-identical to the staged one. Pad slots are skipped (they would
// add an exact zero). Accumulation is float32; bfloat16 output is rounded
// once, at the write.
#include "common.cuh"

namespace repro_torch {

// columns per thread: the 32 lanes of a warp cover 32 * kCols columns
constexpr int kCols = 4;

// One t step for up to kCols columns of one output row: d[q] = sum_k
// a[k] * B[row0 + k, j + 32 q], k ascending, one explicit FMA each.
template <typename TB>
__device__ __forceinline__ void bsr_step(const float* __restrict__ a,
                                         const TB* __restrict__ b_rank, long long row0,
                                         int bk, long long K, long long n, long long j,
                                         int n_cols, float (&d)[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) d[q] = 0.0f;
  for (int k = 0; k < bk; ++k) {
    const long long r = row0 + k;
    if (r >= K) break;
    const float av = a[k];
    const TB* b_row = b_rank + r * n + j;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (q < n_cols) d[q] = __fmaf_rn(av, to_f32(b_row[32 * q]), d[q]);
    }
  }
}

// kAcc = false: out = A @ B (K3).  kAcc = true: out += A @ B, out is the accumulator (K4).
template <typename TB, bool kAcc>
__global__ void bsr_spmm_kernel(const int32_t* __restrict__ cols,
                                const float* __restrict__ blocks, const TB* __restrict__ b,
                                TB* __restrict__ out, long long mb, int t_steps, int bm, int bk,
                                long long K, long long n, long long m_out, int bn) {
  const long long p = blockIdx.z;
  const long long i = blockIdx.x;
  const long long j0 = (long long)blockIdx.y * bn;
  const long long j_end = min(j0 + (long long)bn, n);
  const int32_t* row_cols = cols + (p * mb + i) * t_steps;
  const float* row_blocks = blocks + (p * mb + i) * (long long)t_steps * bm * bk;
  const TB* b_rank = b + p * K * n;
  for (int ii = threadIdx.y; ii < bm; ii += blockDim.y) {
    const long long r = i * bm + ii;
    if (r >= m_out) break;
    TB* out_row = out + (p * m_out + r) * n;
    for (long long j = j0 + threadIdx.x; j < j_end; j += 32 * kCols) {
      const int n_cols = (int)min((long long)kCols, (j_end - j + 31) / 32);
      float acc[kCols], d[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        acc[q] = (kAcc && q < n_cols) ? to_f32(out_row[j + 32 * q]) : 0.0f;
      }
      for (int t = 0; t < t_steps; ++t) {
        const int32_t c = row_cols[t];
        if (c < 0) continue;
        bsr_step(row_blocks + ((long long)t * bm + ii) * bk, b_rank, (long long)c * bk, bk,
                 K, n, j, n_cols, d);
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[q] = __fadd_rn(acc[q], d[q]);
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q < n_cols) out_row[j + 32 * q] = from_f32<TB>(acc[q]);
      }
    }
  }
}

template <bool kAcc>
int launch(const void* cols, const void* blocks, const void* b, void* out, long long P,
           long long mb, int t_steps, int bm, int bk, long long K, long long n, long long m_out,
           int bn, int dtype, void* stream) {
  if (bn < 1 || bm < 1 || bk < 1 || t_steps < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const long long gy = ceil_div(n, bn);
  if (!grid_fits(mb, gy, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)mb, (unsigned)gy, (unsigned)P);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    bsr_spmm_kernel<float, kAcc><<<grid, block, 0, st>>>(
        (const int32_t*)cols, (const float*)blocks, (const float*)b, (float*)out, mb, t_steps,
        bm, bk, K, n, m_out, bn);
  } else if (dtype == kBFloat16) {
    bsr_spmm_kernel<__nv_bfloat16, kAcc><<<grid, block, 0, st>>>(
        (const int32_t*)cols, (const float*)blocks, (const __nv_bfloat16*)b,
        (__nv_bfloat16*)out, mb, t_steps, bm, bk, K, n, m_out, bn);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
