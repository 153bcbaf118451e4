// K6 — RMSNorm over the last dim: y = x · rsqrt(mean(x²) + eps) · g, the reduction in float32.
//
// Replaces: src/repro/kernels/rmsnorm.py:33 rmsnorm_pallas. In the port it
// is the RMSNorm of every transformer block (ln1 and ln2 of each layer)
// and the final norm: 2·L + 1 launches per forward and per decode step.
//
// Layout: x and y are [rows, D] contiguous, g is [D]; float32 or bfloat16,
// x, g and y all of one dtype.
//
// Where the rounding to the storage dtype falls (a compile-time flag):
//   kRoundBeforeGain = false: y = cast(x_f32 · r · g_f32), one rounding to
//     the storage dtype — what rmsnorm_pallas computes (rmsnorm.py:25-29);
//   kRoundBeforeGain = true:  y = cast(cast(x_f32 · r) · g), two roundings
//     — what the model's rms_norm computes (models/layers.py:26-28), and so
//     what the port's layers.rms_norm launches.
// In float32 the two chains are the same. The reciprocal square root is
// __frsqrt_rn (round to nearest; rsqrtf is off by up to 2 ulp), and every
// product and sum is an explicitly rounded __fmul_rn / __fadd_rn (no FMA
// contraction): the plain version in kernels/rmsnorm.py repeats the same
// chain in float32 and gets the same bits.
//
// Bound on the card: memory bytes. A row is read twice (the second read
// hits L1/L2) and written once; the arithmetic is ~4 operations per
// element, far below the float32 ridge. chip_smoke.py prints the bound of
// each call (one read of x and g, one write of y, over 3.35 TB/s).
//
// Design: the TPU kernel kept a (128-row x D) tile in VMEM per grid step.
// Here one thread block of 256 threads takes one row: each thread loads 16
// bytes per step (4 float32 or 8 bfloat16; D = 2048 in bfloat16 is one load
// per thread), accumulates its squares in float32, the 8 warps reduce with
// xor shuffles and one shared-memory pass over the 8 warp sums, thread 0
// forms r, and the row is read again, scaled, multiplied by the gain and
// stored with 16-byte stores. A row whose width or pointers do not allow
// 16-byte access takes the same elements in the same order, one at a time.
// Making it fast (several rows per block for decode's 8-row batches, fusing
// the residual add) is later work.
#include "common.cuh"

namespace repro_torch {

constexpr int kRmsThreads = 256;

template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// The N = 16 / sizeof(T) elements of one step of one thread, from index
// j on; 16-byte access where the row allows it, else one element at a time
// with zeros past the row's end (a zero adds nothing to the sum of squares).
template <typename T, int N, bool kVecIO>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, long long j, long long D,
                                         float (&v)[N]) {
  if constexpr (kVecIO) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = j + i < D ? to_f32(p[j + i]) : 0.0f;
  }
}

template <typename T, int N, bool kVecIO>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p, long long j, long long D,
                                               const float (&v)[N]) {
  if constexpr (kVecIO) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p + j) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j + i < D) p[j + i] = from_f32<T>(v[i]);
  }
}

// Thread t takes elements [s·256·N + t·N, s·256·N + t·N + N) of step s, in
// that order, whatever the access width: the addition chain depends only
// on D and the dtype, and kernels/rmsnorm.py's plain version repeats it.
template <typename T, bool kVecIO, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                   long long D, float eps) {
  constexpr int N = Vec16<T>::N;
  const T* xr = x + (long long)blockIdx.x * D;
  T* yr = y + (long long)blockIdx.x * D;
  const long long step = (long long)kRmsThreads * N;

  float ss = 0.0f;
  for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
    float v[N];
    load_f32<T, N, kVecIO>(xr, j, D, v);
#pragma unroll
    for (int i = 0; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));

  __shared__ float warp_ss[kRmsThreads / 32];
  __shared__ float r_shared;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kRmsThreads / 32; ++w) total = __fadd_rn(total, warp_ss[w]);
    r_shared = __frsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)D), eps));
  }
  __syncthreads();
  const float r = r_shared;

  for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
    float v[N], gv[N];
    load_f32<T, N, kVecIO>(xr, j, D, v);
    load_f32<T, N, kVecIO>(g, j, D, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = __fmul_rn(v[i], r);
      if constexpr (kRoundBeforeGain) s = to_f32(from_f32<T>(s));
      v[i] = __fmul_rn(s, gv[i]);
    }
    store_from_f32<T, N, kVecIO>(yr, j, D, v);
  }
}

template <typename T, bool kRoundBeforeGain>
int launch_rmsnorm(const void* x, const void* g, void* y, long long rows, long long D, float eps,
                   cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const bool vec = D % N == 0 && ((uintptr_t)x | (uintptr_t)g | (uintptr_t)y) % 16 == 0;
  const dim3 grid((unsigned)rows), block(kRmsThreads);
  if (vec) {
    rmsnorm_kernel<T, true, kRoundBeforeGain>
        <<<grid, block, 0, st>>>((const T*)x, (const T*)g, (T*)y, D, eps);
  } else {
    rmsnorm_kernel<T, false, kRoundBeforeGain>
        <<<grid, block, 0, st>>>((const T*)x, (const T*)g, (T*)y, D, eps);
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward (no TPU kernel: the reference differentiates its jnp
// rms_norm, models/layers.py:26-28, through XLA). Given dy, with
// r = rsqrt(mean(x²) + eps) formed by the forward's chain and xn = x·r
// (rounded to T first when kRoundBeforeGain):
//   dg = Σ_rows dy·xn,   dxn = dy·g,   dx = r·dxn − x·r³·(Σ_d dxn·x)/D,
// every product and sum float32 and explicitly rounded, dx rounded once to
// T. One 256-thread block takes a fixed block of kBwdRows rows, one row
// after another, with the forward's element layout (thread t takes the
// elements s·256·N + t·N + i), so r and each row's Σ dxn·x fold in the
// forward's order. dg needs no atomics: each thread adds dy·xn of its own
// columns for the block's rows in ascending row order into shared memory
// it alone touches, the block writes them as one float32 partial row, and
// a second launch folds the partial rows in ascending block order. Two
// runs give the same bits; kernels/rmsnorm.py's rmsnorm_bwd_plain repeats
// the chain.
//
// Bound on the card: memory bytes — x and dy read, dx written, the float32
// partials written and read once (D·4 bytes per kBwdRows rows), ~10
// operations an element.
constexpr int kBwdRows = 8;

// The forward's fold of one value per thread: xor butterflies within each
// warp, then the 8 warp sums added in order by thread 0; every thread gets
// the total.
__device__ __forceinline__ float block_sum_256(float v, float* warp_buf, float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kRmsThreads / 32; ++w) total = __fadd_rn(total, warp_buf[w]);
    *out = total;
  }
  __syncthreads();
  const float total = *out;
  __syncthreads();  // warp_buf and *out are reused by the next fold
  return total;
}

template <typename T, bool kVecIO, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ partial, long long rows,
                       long long D, float eps) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ float dg_acc[];  // [D]: thread t owns its own columns
  __shared__ float warp_buf[kRmsThreads / 32];
  __shared__ float total_buf;
  const long long step = (long long)kRmsThreads * N;
  const long long first = (long long)blockIdx.x * kBwdRows;
  const long long last = first + kBwdRows < rows ? first + kBwdRows : rows;

  for (long long j = (long long)threadIdx.x * N; j < D; j += step)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j + i < D) dg_acc[j + i] = 0.0f;

  for (long long row = first; row < last; ++row) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    T* dxr = dx + row * D;

    float ss = 0.0f;
    for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
      float v[N];
      load_f32<T, N, kVecIO>(xr, j, D, v);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    }
    const float total = block_sum_256(ss, warp_buf, &total_buf);
    const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)D), eps));

    float dot = 0.0f;
    for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
      float v[N], gv[N], dv[N];
      load_f32<T, N, kVecIO>(xr, j, D, v);
      load_f32<T, N, kVecIO>(g, j, D, gv);
      load_f32<T, N, kVecIO>(dyr, j, D, dv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float xn = __fmul_rn(v[i], r);
        if constexpr (kRoundBeforeGain) xn = to_f32(from_f32<T>(xn));
        dot = __fadd_rn(dot, __fmul_rn(__fmul_rn(dv[i], gv[i]), v[i]));
        if (j + i < D) dg_acc[j + i] = __fadd_rn(dg_acc[j + i], __fmul_rn(dv[i], xn));
      }
    }
    const float dsum = block_sum_256(dot, warp_buf, &total_buf);
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), __fdiv_rn(dsum, (float)D));

    for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
      float v[N], gv[N], dv[N];
      load_f32<T, N, kVecIO>(xr, j, D, v);
      load_f32<T, N, kVecIO>(g, j, D, gv);
      load_f32<T, N, kVecIO>(dyr, j, D, dv);
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __fsub_rn(__fmul_rn(r, __fmul_rn(dv[i], gv[i])), __fmul_rn(v[i], c));
      store_from_f32<T, N, kVecIO>(dxr, j, D, v);
    }
  }

  float* pr = partial + (long long)blockIdx.x * D;
  for (long long j = (long long)threadIdx.x * N; j < D; j += step)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j + i < D) pr[j + i] = dg_acc[j + i];
}

// dg[j] = 0 + partial[0, j] + partial[1, j] + …, in ascending block order.
template <typename T>
__global__ void rmsnorm_dg_fold_kernel(const float* __restrict__ partial, T* __restrict__ dg,
                                       long long blocks, long long D) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float total = 0.0f;
  for (long long b = 0; b < blocks; ++b) total = __fadd_rn(total, partial[b * D + j]);
  dg[j] = from_f32<T>(total);
}

template <typename T, bool kRoundBeforeGain>
int launch_rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx, float* partial,
                       void* dg, long long rows, long long D, float eps, cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const bool vec = D % N == 0 &&
                   ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  const long long blocks = ceil_div(rows, kBwdRows);
  const size_t smem = (size_t)D * sizeof(float);
  const dim3 grid((unsigned)blocks), block(kRmsThreads);
  auto kernel = vec ? rmsnorm_bwd_kernel<T, true, kRoundBeforeGain>
                    : rmsnorm_bwd_kernel<T, false, kRoundBeforeGain>;
  // past 48 KB of shared memory a block must opt in: dg_acc plus the
  // static warp_buf / total_buf (36 B) pass it from D = 12,280 on
  int rc = 0;
  if (smem > 47 * 1024)
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
  if (rc) return rc;
  kernel<<<grid, block, smem, st>>>((const T*)x, (const T*)g, (const T*)dy, (T*)dx, partial,
                                    rows, D, eps);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rmsnorm_dg_fold_kernel<T><<<(unsigned)ceil_div(D, 256), 256, 0, st>>>(partial, (T*)dg, blocks,
                                                                        D);
  return (int)cudaGetLastError();
}
}  // namespace repro_torch

extern "C" int repro_rmsnorm(const void* x, const void* g, void* y, long long rows, long long D,
                             float eps, int dtype, int round_before_gain, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || rows > 2147483647LL || D < 1) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    return round_before_gain ? launch_rmsnorm<float, true>(x, g, y, rows, D, eps, st)
                             : launch_rmsnorm<float, false>(x, g, y, rows, D, eps, st);
  }
  if (dtype == kBFloat16) {
    return round_before_gain
               ? launch_rmsnorm<__nv_bfloat16, true>(x, g, y, rows, D, eps, st)
               : launch_rmsnorm<__nv_bfloat16, false>(x, g, y, rows, D, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: dx [rows, D] and dg [D] (x's and g's dtype) from x, g and
// dy; partial is float32 scratch of ceil(rows / 8) · D elements. D up to
// 12,288 (its float32 dg accumulators take 48 KB of shared memory, with
// the static buffers past the default limit: the launch opts in).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx,
                                 void* partial, void* dg, long long rows, long long D, float eps,
                                 int dtype, int round_before_gain, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || D < 1 || ceil_div(rows, kBwdRows) > 2147483647LL || D > 12288)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)partial;
  if (dtype == kFloat32) {
    return round_before_gain
               ? launch_rmsnorm_bwd<float, true>(x, g, dy, dx, p, dg, rows, D, eps, st)
               : launch_rmsnorm_bwd<float, false>(x, g, dy, dx, p, dg, rows, D, eps, st);
  }
  if (dtype == kBFloat16) {
    return round_before_gain
               ? launch_rmsnorm_bwd<__nv_bfloat16, true>(x, g, dy, dx, p, dg, rows, D, eps, st)
               : launch_rmsnorm_bwd<__nv_bfloat16, false>(x, g, dy, dx, p, dg, rows, D, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
