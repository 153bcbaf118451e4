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
// The chain of the sum of squares is that of one 256-thread block a row
// (rmsnorm_kernel below): chunk c of a row (its N = 16 / sizeof(T)
// elements c·N … c·N + N − 1) belongs to thread t = c mod 256 at step
// s = c div 256; each thread adds its elements in ascending (s, i) from
// 0, xor butterflies (16 … 1) fold each warp, and the 8 warp sums are
// added in ascending warp order from 0. r = __frsqrt_rn(total / D + eps).
//
// Bound on the card: memory bytes — x and g read once, y (and r) written
// once; ~4 operations an element, far below the float32 ridge.
// chip_smoke.py prints the bound of each call (over 3.35 TB/s).
//
// Design (rmsnorm_kernel_rows): the TPU kernel kept a (128-row x D) tile
// in VMEM per grid step. Here rows run in parallel, each read once:
// * A row goes to a group of kLanes lanes: at least kernels/rmsnorm.py's
//   _fwd_layout (the smallest power of two from 32 to 256 whose lanes
//   hold the row in at most kHeld 16-byte chunks each: 32 at smollm's
//   D = 576, 64 at OLMoE's 2048 in bfloat16), more for few rows (the
//   launcher below). Lane l holds chunks c ≡ l (mod kLanes), kChunks of
//   them (a template parameter: registers for the chunks it has).
// * One read: a row's chunks and g's are loaded once, 16 bytes a load,
//   into registers, and serve both the sum of squares and y.
// * The 256-thread chain, bit for bit: lane l stands for the threads
//   t = l + m·kLanes, keeping one float32 sum for each, added in the same
//   (s, i) order. Because kLanes >= 32, the block's warp q + m·kLanes/32
//   is 32 consecutive lanes of the group's warp q: one xor butterfly per
//   such virtual warp, then the virtual warps' sums in ascending order
//   (through shared memory across the group's warps; in registers at 32
//   lanes). A virtual warp that holds no chunk sums to an exact +0.0 (a
//   sum of squares is never negative), so it is skipped.
// Rows wider than the lanes hold (bfloat16 D > 8192, float32 D > 4096)
// take rmsnorm_kernel: one 256-thread block a row, the row read twice;
// so do rows whose width or pointers do not allow 16-byte access (the
// same elements in the same order, one at a time). Under grad both
// kernels also store r, one float32 a row, where a pointer is passed
// (the backward reads it instead of summing the squares again); given no
// output, rmsnorm_kernel stops there (the backward's r when none was
// saved).
#include "common.cuh"

namespace repro_torch {

constexpr int kRmsThreads = 256;  // the chain's block; the rows kernel's largest
constexpr int kHeld = 4;          // 16-byte chunks of a row a lane holds (both directions)

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

// 16 bytes of a row, raw, from element j on: one load where the row
// allows it, else one element at a time, zeros past the row's end.
template <typename T, bool kVecIO>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p, long long j, long long D) {
  constexpr int N = Vec16<T>::N;
  if constexpr (kVecIO) {
    if (j < D) return *reinterpret_cast<const uint4*>(p + j);
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = j + i < D ? p[j + i] : from_f32<T>(0.0f);
    return raw;
  }
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  return to_f32(reinterpret_cast<const T*>(&raw)[i]);
}

// Rows wider than the lanes hold: one 256-thread block a row, the head
// comment's chain literally (thread t takes elements s·256·N + t·N + i,
// whatever the access width); thread 0 forms r, and the row is read
// again (from L1/L2) for y.
template <typename T, bool kVecIO, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                   float* __restrict__ r_out, long long D, float eps) {
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
    if (r_out != nullptr) r_out[blockIdx.x] = r_shared;  // under grad: for the backward
  }
  __syncthreads();
  if (y == nullptr) return;  // r alone (the backward's, when none was saved)
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

// The rows kernel (the file's head comment): a row on a group of kLanes
// lanes, each lane holding kChunks 16-byte chunks of it, blockDim /
// kLanes rows a block.
template <typename T, int kLanes, int kChunks, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_kernel_rows(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                        float* __restrict__ r_out, long long rows, long long D, float eps) {
  constexpr int N = Vec16<T>::N;
  constexpr int kVirt = kRmsThreads / kLanes;        // the 256 threads a lane stands for
  constexpr int V = kChunks < kVirt ? kChunks : kVirt;  // of those, the ones its chunks reach
  constexpr int kWarps = kLanes / 32;                // real warps of a group
  __shared__ float warp_sums[kRmsThreads / 32][V];
  const int grp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int q = lane >> 5;  // the group's warp
  const long long nvec = (D + N - 1) / N;
  const long long row = (long long)blockIdx.x * (blockDim.x / kLanes) + grp;
  const bool live = row < rows;  // a spare group of the last block still meets the barrier

  // chunk k of the lane is chunk c = k·kLanes + lane of the row: the
  // 256-thread block's thread lane + (k mod kVirt)·kLanes at step k div kVirt
  uint4 xr[kChunks], gr[kChunks];
  if (live) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      xr[k] = load_raw<T, true>(x + row * D, (long long)(k * kLanes + lane) * N, D);
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      gr[k] = load_raw<T, true>(g, (long long)(k * kLanes + lane) * N, D);
  }
  float vs[V];
#pragma unroll
  for (int m = 0; m < V; ++m) vs[m] = 0.0f;
  if (live) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k * kLanes + lane < nvec) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float v = elem<T>(xr[k], i);
          vs[k % kVirt] = __fadd_rn(vs[k % kVirt], __fmul_rn(v, v));
        }
      }
    }
    // virtual warp (q, m) is the block's warp q + m·kWarps: 32 consecutive
    // lanes of the group's warp q; it holds a chunk when its first lane
    // does (a warp-uniform test)
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if (32 * q + m * kLanes < nvec) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          vs[m] = __fadd_rn(vs[m], __shfl_xor_sync(0xffffffffu, vs[m], off));
      }
    }
  }
  // the 8 warp sums in ascending warp order q + m·kWarps
  float total = 0.0f;
  if constexpr (kWarps == 1) {
#pragma unroll
    for (int m = 0; m < V; ++m) total = __fadd_rn(total, vs[m]);
  } else {
    if ((lane & 31) == 0) {
#pragma unroll
      for (int m = 0; m < V; ++m) warp_sums[threadIdx.x >> 5][m] = vs[m];
    }
    __syncthreads();
    const int lead = grp * kWarps;
#pragma unroll
    for (int m = 0; m < V; ++m)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, warp_sums[lead + w][m]);
  }
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)D), eps));
  if (!live) return;
  if (r_out != nullptr && lane == 0) r_out[row] = r;  // under grad: for the backward
  T* yr = y + row * D;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long j = (long long)(k * kLanes + lane) * N;
    if (j < D) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = __fmul_rn(elem<T>(xr[k], i), r);
        if constexpr (kRoundBeforeGain) s = to_f32(from_f32<T>(s));
        o[i] = __fmul_rn(s, elem<T>(gr[k], i));
      }
      store_from_f32<T, N, true>(yr, j, D, o);
    }
  }
}

// Lanes a row: at least the passed floor (the fewest that hold the row in
// kHeld chunks each), doubled while a lane would hold more than
// kFwdChunks chunks or rows · lanes stays under kFwdThreads: few rows get
// fewer chunks a lane, so a shorter chain a thread; many rows fewer lanes,
// so fewer folds. Blocks of 128 threads (256 at 256 lanes). Chosen from
// variants timed on an H100 at the LM's shapes (PERF.md).
constexpr long long kFwdChunks = 3;
constexpr long long kFwdThreads = 1LL << 16;

template <typename T, int kLanes, int kChunks, bool kRoundBeforeGain>
int launch_rows(const T* x, const T* g, T* y, float* r, long long rows, long long D, float eps,
                cudaStream_t st) {
  constexpr int kGroups = kLanes < 128 ? 128 / kLanes : 1;
  rmsnorm_kernel_rows<T, kLanes, kChunks, kRoundBeforeGain>
      <<<(unsigned)ceil_div(rows, kGroups), kGroups * kLanes, 0, st>>>(x, g, y, r, rows, D, eps);
  return (int)cudaGetLastError();
}

template <typename T, int kLanes, bool kRoundBeforeGain>
int launch_rows_held(const T* x, const T* g, T* y, float* r, long long rows, long long D,
                     long long chunks, float eps, cudaStream_t st) {
  switch (chunks) {
    case 1: return launch_rows<T, kLanes, 1, kRoundBeforeGain>(x, g, y, r, rows, D, eps, st);
    case 2: return launch_rows<T, kLanes, 2, kRoundBeforeGain>(x, g, y, r, rows, D, eps, st);
    case 3: return launch_rows<T, kLanes, 3, kRoundBeforeGain>(x, g, y, r, rows, D, eps, st);
    case 4: return launch_rows<T, kLanes, 4, kRoundBeforeGain>(x, g, y, r, rows, D, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lanes: _fwd_layout's (32, 64, 128 or 256). The wide kernel takes rows
// the lanes do not hold (more than kHeld chunks a lane at 256 lanes),
// rows without 16-byte access (D % N != 0 or an unaligned pointer: one
// element at a time), and r alone (y null: the backward's, when none was
// saved).
template <typename T, bool kRoundBeforeGain>
int launch_rmsnorm(const void* x_, const void* g_, void* y_, float* r, long long rows,
                   long long D, int lanes, float eps, cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const T *x = (const T*)x_, *g = (const T*)g_;
  T* y = (T*)y_;
  const bool vec = D % N == 0 && ((uintptr_t)x | (uintptr_t)g | (uintptr_t)y) % 16 == 0;
  const long long nvec = ceil_div(D, N);
  if (y == nullptr || !vec || ceil_div(nvec, lanes) > kHeld) {
    if (vec) {
      rmsnorm_kernel<T, true, kRoundBeforeGain><<<(unsigned)rows, kRmsThreads, 0, st>>>(
          x, g, y, r, D, eps);
    } else {
      rmsnorm_kernel<T, false, kRoundBeforeGain><<<(unsigned)rows, kRmsThreads, 0, st>>>(
          x, g, y, r, D, eps);
    }
    return (int)cudaGetLastError();
  }
  while (lanes < kRmsThreads && (ceil_div(nvec, lanes) > kFwdChunks || rows * lanes < kFwdThreads))
    lanes *= 2;
  const long long chunks = ceil_div(nvec, lanes);
  switch (lanes) {
    case 32: return launch_rows_held<T, 32, kRoundBeforeGain>(x, g, y, r, rows, D, chunks, eps, st);
    case 64: return launch_rows_held<T, 64, kRoundBeforeGain>(x, g, y, r, rows, D, chunks, eps, st);
    case 128: return launch_rows_held<T, 128, kRoundBeforeGain>(x, g, y, r, rows, D, chunks, eps, st);
    case 256: return launch_rows_held<T, 256, kRoundBeforeGain>(x, g, y, r, rows, D, chunks, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward (no TPU kernel: the reference differentiates its jnp
// rms_norm, models/layers.py:26-28, through XLA). Given dy and the
// forward's r = rsqrt(mean(x²) + eps) (one float32 a row, written by the
// forward under grad; formed here by the forward's kernel when not
// passed), with xn = x·r (rounded to T first when kRoundBeforeGain):
//   dg = Σ_rows dy·xn,   dxn = dy·g,   dx = r·dxn − x·r³·(Σ_d dxn·x)/D,
// every product and sum float32 and explicitly rounded, dx rounded once
// to T. kernels/rmsnorm.py's rmsnorm_bwd_plain repeats the chain.
//
// Bound on the card: memory bytes — x and dy read once, dx written once,
// g, r and dg; ~10 operations an element, far below the ridge. So the
// design reads each byte once and keeps many bytes in flight:
//
// * Rows in parallel. A row belongs to a group of kLanes lanes (a power
//   of two from 32 to 256, the smallest whose lanes hold the row in at
//   most kHeld 16-byte chunks each); a 256-thread block runs 256 /
//   kLanes rows at once over a contiguous chunk of rows, a multiple of
//   the groups. Lane l owns chunks c = 0, 1, …: elements (c·kLanes + l)·N
//   + i, the same columns in every row, so its slice of g and its dg
//   sums stay in registers.
// * One read. A row's x and dy are loaded once, 16 bytes a load, into
//   registers (the next row's loads issued before this row's folds), and
//   serve both the Σ dxn·x pass and the dx pass.
// * Folds. Σ dxn·x: each lane adds its elements in (c, i) order, xor
//   butterflies fold the warp, and the group's warps add in order from 0
//   through shared memory. dg: each lane adds its rows in ascending order
//   (one accumulator per column it owns), the groups' sums are added in
//   ascending group order into one float32 partial row per block, and a
//   second launch folds the partial rows in ascending block order, a
//   thread a column, from tiles of partial rows that a block loads at
//   once into shared memory. No atomics: the same bits every run.
// * The grid: rows / 132 rows a block, rounded up to the groups (a
//   partial row a block, so about one block per SM: more blocks write
//   and fold more partial rows, fewer stream fewer bytes at once).
// * Widths past what the lanes hold (more than 256 · kHeld chunks:
//   bfloat16 D > 8192, float32 D > 4096) take rmsnorm_bwd_wide_kernel:
//   one row at a time on the 256 lanes with the same element layout,
//   the dg sums in shared memory, x and dy read again from L2 for dx.
constexpr int kBwdThreads = 256;
constexpr int kDgThreads = 256;  // the dg fold's block
constexpr int kDgCols = 32;      // columns a fold block takes
constexpr int kDgRows = 128;     // partial rows a fold block loads at once

// One row's Σ dxn·x from the lanes' sums: xor butterflies in each warp,
// then (kWarps > 1) the group's warp sums added in order from 0 through
// buf (alternate buffers on alternate calls: one barrier a call). Every
// thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ float group_sum(float v, float* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if constexpr (kWarps == 1) {
    return v;
  } else {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) buf[warp] = v;
    __syncthreads();
    const int lead = warp - warp % kWarps;
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, buf[lead + w]);
    return total;
  }
}

template <typename T, int kLanes, bool kVecIO, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const T* __restrict__ dy, const float* __restrict__ r_row,
                            T* __restrict__ dx, float* __restrict__ partial, long long rows,
                            long long D, long long chunk) {
  constexpr int N = Vec16<T>::N;
  constexpr int C = kHeld;
  constexpr int kGroups = kBwdThreads / kLanes;
  extern __shared__ float dg_groups[];  // [kGroups][D], when kGroups > 1
  __shared__ float warp_buf[2][kBwdThreads / 32];
  const int grp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long first = (long long)blockIdx.x * chunk;
  const long long last = first + chunk < rows ? first + chunk : rows;

  uint4 graw[C];
  float acc[C][N];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    graw[c] = load_raw<T, kVecIO>(g, (long long)(c * kLanes + lane) * N, D);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[c][i] = 0.0f;
  }

  uint4 xr[C], dyr[C];
  long long row = first + grp;
  if (row < last) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long j = (long long)(c * kLanes + lane) * N;
      xr[c] = load_raw<T, kVecIO>(x + row * D, j, D);
      dyr[c] = load_raw<T, kVecIO>(dy + row * D, j, D);
    }
  }
  for (long long it = 0; first + it * kGroups < last; ++it, row += kGroups) {
    const bool live = row < last;
    // the next row's loads, ahead of this row's folds
    uint4 xn_raw[C], dyn_raw[C];
    const long long next = row + kGroups;
    if (next < last) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long j = (long long)(c * kLanes + lane) * N;
        xn_raw[c] = load_raw<T, kVecIO>(x + next * D, j, D);
        dyn_raw[c] = load_raw<T, kVecIO>(dy + next * D, j, D);
      }
    }
    float dot = 0.0f, r = 0.0f;
    if (live) {
      r = r_row[row];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if ((long long)(c * kLanes + lane) * N < D) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float dxn = __fmul_rn(elem<T>(dyr[c], i), elem<T>(graw[c], i));
            dot = __fadd_rn(dot, __fmul_rn(dxn, elem<T>(xr[c], i)));
          }
        }
      }
    }
    dot = group_sum<kLanes / 32>(dot, warp_buf[it & 1]);
    if (live) {
      const float cc = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), __fdiv_rn(dot, (float)D));
      T* dxr = dx + row * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long j = (long long)(c * kLanes + lane) * N;
        if (j < D) {
          float o[N];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float xv = elem<T>(xr[c], i), dv = elem<T>(dyr[c], i);
            float xn = __fmul_rn(xv, r);
            if constexpr (kRoundBeforeGain) xn = to_f32(from_f32<T>(xn));
            acc[c][i] = __fadd_rn(acc[c][i], __fmul_rn(dv, xn));
            o[i] = __fsub_rn(__fmul_rn(r, __fmul_rn(dv, elem<T>(graw[c], i))),
                             __fmul_rn(xv, cc));
          }
          store_from_f32<T, N, kVecIO>(dxr, j, D, o);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xr[c] = xn_raw[c];
      dyr[c] = dyn_raw[c];
    }
  }

  // the groups' sums in ascending group order: one partial row a block
  float* pr = partial + (long long)blockIdx.x * D;
  if constexpr (kGroups == 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long j = (long long)(c * kLanes + lane) * N;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (j + i < D) pr[j + i] = __fadd_rn(0.0f, acc[c][i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long j = (long long)(c * kLanes + lane) * N;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (j + i < D) dg_groups[grp * D + j + i] = acc[c][i];
    }
    __syncthreads();
    for (long long j = threadIdx.x; j < D; j += kBwdThreads) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) s = __fadd_rn(s, dg_groups[k * D + j]);
      pr[j] = s;
    }
  }
}

// Widths past the held lanes: 256 lanes a row, one row after another, the
// held kernel's element layout and chains (chunk c of lane l: elements
// (c·256 + l)·N + i); each thread's dg sums in shared memory only it
// touches; x, dy and g read again (from L2) for the dx pass.
template <typename T, bool kVecIO, bool kRoundBeforeGain>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const T* __restrict__ dy, const float* __restrict__ r_row,
                            T* __restrict__ dx, float* __restrict__ partial, long long rows,
                            long long D, long long chunk) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ float dg_acc[];  // [D]
  __shared__ float warp_buf[2][kBwdThreads / 32];
  const long long step = (long long)kBwdThreads * N;
  const long long first = (long long)blockIdx.x * chunk;
  const long long last = first + chunk < rows ? first + chunk : rows;

  for (long long j = (long long)threadIdx.x * N; j < D; j += step)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j + i < D) dg_acc[j + i] = 0.0f;

  for (long long row = first; row < last; ++row) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    const float r = r_row[row];
    float dot = 0.0f;
    for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
      const uint4 xv = load_raw<T, kVecIO>(xr, j, D), dv = load_raw<T, kVecIO>(dyr, j, D),
                  gv = load_raw<T, kVecIO>(g, j, D);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float dxn = __fmul_rn(elem<T>(dv, i), elem<T>(gv, i));
        dot = __fadd_rn(dot, __fmul_rn(dxn, elem<T>(xv, i)));
      }
    }
    dot = group_sum<kBwdThreads / 32>(dot, warp_buf[row & 1]);
    const float cc = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), __fdiv_rn(dot, (float)D));
    T* dxr = dx + row * D;
    for (long long j = (long long)threadIdx.x * N; j < D; j += step) {
      const uint4 xv = load_raw<T, kVecIO>(xr, j, D), dv = load_raw<T, kVecIO>(dyr, j, D),
                  gv = load_raw<T, kVecIO>(g, j, D);
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xf = elem<T>(xv, i), df = elem<T>(dv, i);
        float xn = __fmul_rn(xf, r);
        if constexpr (kRoundBeforeGain) xn = to_f32(from_f32<T>(xn));
        if (j + i < D) dg_acc[j + i] = __fadd_rn(dg_acc[j + i], __fmul_rn(df, xn));
        o[i] = __fsub_rn(__fmul_rn(r, __fmul_rn(df, elem<T>(gv, i))), __fmul_rn(xf, cc));
      }
      store_from_f32<T, N, kVecIO>(dxr, j, D, o);
    }
  }

  float* pr = partial + (long long)blockIdx.x * D;
  for (long long j = (long long)threadIdx.x * N; j < D; j += step)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j + i < D) pr[j + i] = __fadd_rn(0.0f, dg_acc[j + i]);
}

// dg[j] = 0 + partial[0, j] + partial[1, j] + …, in ascending block order.
// A block takes kDgCols columns: its 256 threads load a tile of up to
// kDgRows partial rows at once (a warp a row, 128 coalesced bytes), and
// one thread a column adds the tile's rows in order from shared memory,
// so the chain waits on one L2 round trip per tile, not per row.
template <typename T>
__global__ void __launch_bounds__(kDgThreads)
    rmsnorm_bwd_dg_kernel(const float* __restrict__ partial, T* __restrict__ dg,
                          long long blocks, long long D) {
  __shared__ float tile[kDgRows][kDgCols];
  const long long j0 = (long long)blockIdx.x * kDgCols;
  const int col = threadIdx.x % kDgCols;
  const long long j = j0 + col;
  float total = 0.0f;
  for (long long b0 = 0; b0 < blocks; b0 += kDgRows) {
    for (int i = threadIdx.x / kDgCols; i < kDgRows; i += kDgThreads / kDgCols)
      tile[i][col] = b0 + i < blocks && j < D ? __ldcg(partial + (b0 + i) * D + j) : 0.0f;
    __syncthreads();
    if (threadIdx.x < kDgCols) {
      const int n = blocks - b0 < kDgRows ? (int)(blocks - b0) : kDgRows;
#pragma unroll 8
      for (int i = 0; i < n; ++i) total = __fadd_rn(total, tile[i][col]);
    }
    __syncthreads();
  }
  if (threadIdx.x < kDgCols && j < D) dg[j] = from_f32<T>(total);
}

template <typename T, bool kVecIO, bool kRoundBeforeGain>
int launch_bwd_rows(const T* x, const T* g, const T* dy, const float* r, T* dx, float* partial,
                    long long rows, long long D, int lanes, long long chunk, long long blocks,
                    cudaStream_t st) {
  const dim3 grid((unsigned)blocks), block(kBwdThreads);
  const size_t groups_smem = (size_t)(kBwdThreads / lanes) * D * sizeof(float);
  switch (lanes) {
    case 32:
      rmsnorm_bwd_rows_kernel<T, 32, kVecIO, kRoundBeforeGain>
          <<<grid, block, groups_smem, st>>>(x, g, dy, r, dx, partial, rows, D, chunk);
      break;
    case 64:
      rmsnorm_bwd_rows_kernel<T, 64, kVecIO, kRoundBeforeGain>
          <<<grid, block, groups_smem, st>>>(x, g, dy, r, dx, partial, rows, D, chunk);
      break;
    case 128:
      rmsnorm_bwd_rows_kernel<T, 128, kVecIO, kRoundBeforeGain>
          <<<grid, block, groups_smem, st>>>(x, g, dy, r, dx, partial, rows, D, chunk);
      break;
    case 256:
      rmsnorm_bwd_rows_kernel<T, 256, kVecIO, kRoundBeforeGain>
          <<<grid, block, 0, st>>>(x, g, dy, r, dx, partial, rows, D, chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kVecIO, bool kRoundBeforeGain>
int launch_bwd_wide(const T* x, const T* g, const T* dy, const float* r, T* dx, float* partial,
                    long long rows, long long D, long long chunk, long long blocks,
                    cudaStream_t st) {
  auto kernel = rmsnorm_bwd_wide_kernel<T, kVecIO, kRoundBeforeGain>;
  const size_t smem = (size_t)D * sizeof(float);
  // past 48 KB of shared memory a block must opt in: dg_acc plus the
  // static warp_buf (64 B) pass it from D = 12,273 on
  if (smem > 47 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc) return rc;
  }
  kernel<<<(unsigned)blocks, kBwdThreads, smem, st>>>(x, g, dy, r, dx, partial, rows, D, chunk);
  return (int)cudaGetLastError();
}

template <typename T, bool kRoundBeforeGain>
int launch_rmsnorm_bwd(const void* x_, const void* g_, const void* dy_, const float* r, void* dx_,
                       void* dg, float* work, long long rows, long long D, int lanes,
                       long long chunk, float eps, cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const T *x = (const T*)x_, *g = (const T*)g_, *dy = (const T*)dy_;
  T* dx = (T*)dx_;
  const long long blocks = ceil_div(rows, chunk);
  float* partial = work;
  int rc = 0;
  if (r == nullptr) {  // r in the forward's chain, by the forward's kernel
    float* r_work = work + blocks * D;
    rc = launch_rmsnorm<T, kRoundBeforeGain>(x_, g_, nullptr, r_work, rows, D, lanes, eps,
                                              st);
    if (rc) return rc;
    r = r_work;
  }
  const bool vec = D % N == 0 &&
                   ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  const bool held = ceil_div(ceil_div(D, N), lanes) <= kHeld;
  if (held) {
    rc = vec ? launch_bwd_rows<T, true, kRoundBeforeGain>(x, g, dy, r, dx, partial, rows, D, lanes,
                                                          chunk, blocks, st)
             : launch_bwd_rows<T, false, kRoundBeforeGain>(x, g, dy, r, dx, partial, rows, D,
                                                           lanes, chunk, blocks, st);
  } else {
    rc = vec ? launch_bwd_wide<T, true, kRoundBeforeGain>(x, g, dy, r, dx, partial, rows, D, chunk,
                                                          blocks, st)
             : launch_bwd_wide<T, false, kRoundBeforeGain>(x, g, dy, r, dx, partial, rows, D,
                                                           chunk, blocks, st);
  }
  if (rc) return rc;
  rmsnorm_bwd_dg_kernel<T><<<(unsigned)ceil_div(D, kDgCols), kDgThreads, 0, st>>>(
      partial, (T*)dg, blocks, D);
  return (int)cudaGetLastError();
}
}  // namespace repro_torch

// y = rmsnorm(x, g); r, when not null, gets each row's r (float32 [rows])
// for the backward. lanes (32, 64, 128 or 256) is kernels/rmsnorm.py's
// _fwd_layout: lanes that hold the row in at most kHeld 16-byte chunks
// each, or 256 for rows wider than that (the wide kernel).
extern "C" int repro_rmsnorm(const void* x, const void* g, void* y, void* r, long long rows,
                             long long D, int lanes, float eps, int dtype, int round_before_gain,
                             void* stream) {
  using namespace repro_torch;
  const int n = dtype == kFloat32 ? 4 : 8;
  const bool lanes_ok = lanes == 32 || lanes == 64 || lanes == 128 || lanes == 256;
  if (rows < 1 || rows > 2147483647LL || D < 1 || y == nullptr || !lanes_ok ||
      (lanes < 256 && ceil_div(ceil_div(D, n), lanes) > kHeld))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  float* rr = (float*)r;
  if (dtype == kFloat32) {
    return round_before_gain ? launch_rmsnorm<float, true>(x, g, y, rr, rows, D, lanes, eps, st)
                             : launch_rmsnorm<float, false>(x, g, y, rr, rows, D, lanes, eps, st);
  }
  if (dtype == kBFloat16) {
    return round_before_gain
               ? launch_rmsnorm<__nv_bfloat16, true>(x, g, y, rr, rows, D, lanes, eps, st)
               : launch_rmsnorm<__nv_bfloat16, false>(x, g, y, rr, rows, D, lanes, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: dx [rows, D] and dg [D] (x's and g's dtype) from x, g, dy
// and r (float32 [rows], the forward's; null: formed here in the
// forward's chain). work is float32 scratch of ceil(rows / chunk) · D
// elements, plus rows more when r is null. lanes (32, 64, 128 or 256) and
// chunk (rows a block, a multiple of 256 / lanes) are
// kernels/rmsnorm.py's _bwd_layout, which the plain version follows; D up
// to 12,288 (the wide kernel's float32 dg sums: 48 KB of shared memory).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* g, const void* dy, const void* r,
                                 void* dx, void* dg, void* work, long long rows, long long D,
                                 int lanes, long long chunk, float eps, int dtype,
                                 int round_before_gain, void* stream) {
  using namespace repro_torch;
  const int n = dtype == kFloat32 ? 4 : 8;
  const bool lanes_ok = lanes == 32 || lanes == 64 || lanes == 128 || lanes == 256;
  if (rows < 1 || D < 1 || D > 12288 || chunk < 1 || !lanes_ok ||
      chunk % (kBwdThreads / lanes) != 0 || rows > 2147483647LL ||
      (lanes < 256 && ceil_div(ceil_div(D, n), lanes) > kHeld))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const float* rr = (const float*)r;
  float* w = (float*)work;
  if (dtype == kFloat32) {
    return round_before_gain
               ? launch_rmsnorm_bwd<float, true>(x, g, dy, rr, dx, dg, w, rows, D, lanes, chunk,
                                                 eps, st)
               : launch_rmsnorm_bwd<float, false>(x, g, dy, rr, dx, dg, w, rows, D, lanes, chunk,
                                                  eps, st);
  }
  if (dtype == kBFloat16) {
    return round_before_gain
               ? launch_rmsnorm_bwd<__nv_bfloat16, true>(x, g, dy, rr, dx, dg, w, rows, D, lanes,
                                                         chunk, eps, st)
               : launch_rmsnorm_bwd<__nv_bfloat16, false>(x, g, dy, rr, dx, dg, w, rows, D, lanes,
                                                          chunk, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
