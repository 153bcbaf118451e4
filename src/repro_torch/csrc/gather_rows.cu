// K1 — comm-buffer pack: out[p, s, :] = B[p, idx[p, s], :], a zero row where idx < 0.
//
// Replaces: src/repro/kernels/gather_rows.py::gather_rows_pallas (the
// stage-① send-buffer pack of every flat executor body).
//
// Bound on the card: memory bytes. Each output row is one read of a B row
// and one write; there is no arithmetic at all.
//
// Design: the TPU kernel fetched one source row per sequential grid step
// through a scalar-prefetched index map. Here every (rank, slot, column)
// is an independent thread: blockIdx.z is the rank, threadIdx.y/blockIdx.x
// walk 8 slots per block, and the 32 threads of a warp cover 32
// neighbouring columns of one row, so each warp's load and store are one
// contiguous run. The element is copied as raw bits (4- or 2-byte words),
// so float32 and bfloat16 share one kernel. A pad slot (idx < 0) writes
// zero bits (+0.0), like the reference's jnp.where.
#include "common.cuh"

namespace repro_torch {

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ b, const int32_t* __restrict__ idx,
                                   W* __restrict__ out, long long K, long long S, long long n) {
  const long long p = blockIdx.z;
  const long long s = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long j = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= S || j >= n) return;
  const int32_t src = idx[p * S + s];
  W v = 0;
  if (src >= 0 && src < K) v = b[(p * K + src) * n + j];
  out[(p * S + s) * n + j] = v;
}

}  // namespace repro_torch

extern "C" int repro_gather_rows(const void* b, const void* idx, void* out, long long P,
                                 long long K, long long S, long long n, int elem_bytes,
                                 void* stream) {
  using namespace repro_torch;
  const dim3 block(32, 8);
  const long long gx = ceil_div(S, 8), gy = ceil_div(n, 32);
  if (!grid_fits(gx, gy, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)P);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    gather_rows_kernel<uint32_t><<<grid, block, 0, st>>>(
        (const uint32_t*)b, (const int32_t*)idx, (uint32_t*)out, K, S, n);
  } else if (elem_bytes == 2) {
    gather_rows_kernel<uint16_t><<<grid, block, 0, st>>>(
        (const uint16_t*)b, (const int32_t*)idx, (uint16_t*)out, K, S, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
