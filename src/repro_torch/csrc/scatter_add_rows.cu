// K2 — sorted result aggregation: C[p, tgt[s], :] += partials[p, perm[s], :], in place.
//
// Replaces: src/repro/kernels/scatter_add_rows.py::scatter_add_rows_sorted_pallas
// (stage ④ of every flat executor body).
//
// Inputs per rank, prepared on the host by prepare_sorted_scatter: perm
// sorts the receive slots by target row (stable, pads last), and meta =
// [tgt_sorted..., n_valid], with the pads re-pointed at the last real
// target. Slots at or beyond n_valid add nothing.
//
// Bound on the card: memory bytes. Every valid partial row is read once
// and every touched C row is read and written once; one add per element.
//
// Design: the TPU kernel is sequential (an "arbitrary" grid in which the
// first visit of a segment seeds the output tile from C). Blocks on the
// card run in no order, so the sequential grid becomes a loop inside one
// thread: the thread of (rank, segment start, column) — a segment start is
// s == 0 or meta[s] != meta[s-1] — seeds from C[tgt], folds its segment's
// slots in slot order with IEEE adds, and writes C once. Every other
// thread returns at once. The result is deterministic, needs no atomics,
// and for float32 repeats the reference's addition chain exactly. With
// every slot a pad, the one segment adds nothing and C is left unchanged.
// Accumulation is in float32 (bfloat16 C is rounded once, at the write).
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void scatter_add_rows_kernel(T* __restrict__ c, const T* __restrict__ partials,
                                        const int32_t* __restrict__ perm,
                                        const int32_t* __restrict__ meta, long long M,
                                        long long S, long long n) {
  const long long p = blockIdx.z;
  const long long s = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long j = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= S || j >= n) return;
  const int32_t* m = meta + p * (S + 1);
  const int32_t tgt = m[s];
  if (s > 0 && m[s - 1] == tgt) return;  // not the start of a segment
  if (tgt < 0 || tgt >= M) return;
  const long long n_valid = m[S];
  const int32_t* pr = perm + p * S;
  T* c_elem = c + (p * M + tgt) * n + j;
  float acc = to_f32(*c_elem);
  for (long long s2 = s; s2 < S && s2 < n_valid && m[s2] == tgt; ++s2) {
    const int32_t src = pr[s2];
    if (src < 0 || src >= S) continue;  // a malformed map reads nothing
    acc = __fadd_rn(acc, to_f32(partials[(p * S + src) * n + j]));
  }
  *c_elem = from_f32<T>(acc);
}

}  // namespace repro_torch

extern "C" int repro_scatter_add_rows(void* c, const void* partials, const void* perm,
                                      const void* meta, long long P, long long M, long long S,
                                      long long n, int dtype, void* stream) {
  using namespace repro_torch;
  const dim3 block(32, 8);
  const long long gx = ceil_div(S, 8), gy = ceil_div(n, 32);
  if (!grid_fits(gx, gy, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)P);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    scatter_add_rows_kernel<float><<<grid, block, 0, st>>>(
        (float*)c, (const float*)partials, (const int32_t*)perm, (const int32_t*)meta, M, S, n);
  } else if (dtype == kBFloat16) {
    scatter_add_rows_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (__nv_bfloat16*)c, (const __nv_bfloat16*)partials, (const int32_t*)perm,
        (const int32_t*)meta, M, S, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
