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
// Bound on the card: memory bytes. Every stored block is read and written
// once, and the X and Y rows are gathered per stored block; the products
// are 2·bm·bk·F operations per block against 2·bm·bk·4 bytes of the block
// itself plus (bm + bk)·F elements of rows, far below the float32 ridge.
// At F = 16 the stored blocks' 2 x 256 bytes dominate; at F = 128 the Y
// gathers do. chip_smoke.py prints the bound of each call.
//
// Design: the TPU kernel ran one grid step per stored block with the Y tile
// chosen by a scalar-prefetched index map. Here one thread block takes one
// block-row of one rank (grid (mb, P)) and loops over its t slots: the X
// tile (bm x F) is loaded into shared memory ONCE and reused for every
// stored block; for each non-pad slot the Y tile (bk x F) of its block
// column is staged in shared memory (contiguous in y3, so the loads
// coalesce), and bm·bk threads each form one dot in ascending f with
// explicit FMAs, multiply by the stored value and write once. The shared
// rows have an odd stride, so the 4 rows and 8 columns a warp reads fall in
// distinct banks. Pad slots (block_cols == -1, or a column outside y3)
// write exact zeros and read nothing: the reference multiplies an all-zero
// block by an arbitrary tile, which is zero for finite inputs. No tensor
// cores: an 8x8xF product is below every wgmma tile.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void bsr_sddmm_kernel(const int32_t* __restrict__ cols,
                                 const float* __restrict__ blocks, const T* __restrict__ x3,
                                 const T* __restrict__ y3, float* __restrict__ out,
                                 long long mb, int t_steps, int bm, int bk, long long kb,
                                 long long f, int stride) {
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
    const float* xr = xs + r * stride;
    const float* yr = ys + c * stride;
    float acc = 0.0f;
    for (long long k = 0; k < f; ++k) acc = __fmaf_rn(xr[k], yr[k], acc);
    row_out[t * blk + tid] = __fmul_rn(row_blocks[t * blk + tid], acc);
  }
}

template <typename T>
int launch_sddmm(const void* cols, const void* blocks, const void* x3, const void* y3,
                 void* out, long long P, long long mb, int t_steps, int bm, int bk, long long kb,
                 long long f, cudaStream_t st) {
  const int threads = bm * bk;
  const int stride = (int)(f % 2 == 0 ? f + 1 : f);
  const size_t smem = (size_t)(bm + bk) * stride * sizeof(float);
  if (!grid_fits(mb, P, 1)) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_sddmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bsr_sddmm_kernel<T><<<dim3((unsigned)mb, (unsigned)P), threads, smem, st>>>(
      (const int32_t*)cols, (const float*)blocks, (const T*)x3, (const T*)y3, (float*)out, mb,
      t_steps, bm, bk, kb, f, stride);
  return (int)cudaGetLastError();
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
