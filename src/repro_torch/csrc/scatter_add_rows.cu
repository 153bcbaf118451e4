// K2 — sorted result aggregation: C[p, tgt[s], :] += partials[p, perm[s], :], in place.
//
// Replaces: src/repro/kernels/scatter_add_rows.py::scatter_add_rows_sorted_pallas
// (stage ④ of every flat executor body, and the fold of the coo backend).
//
// Inputs per rank, prepared on the host by prepare_sorted_scatter: perm
// sorts the receive slots by target row (stable, pads last), and meta =
// [tgt_sorted..., n_valid], with the pads re-pointed at the last real
// target. Slots at or beyond n_valid add nothing. meta[0 : n_valid] is
// ascending, so each target's slots form one segment.
//
// The chain (the one the plain version and the reference repeat): each touched C element is seeded from C, folded
// ((C + p[perm[s0]]) + p[perm[s1]]) + ... in slot order with __fadd_rn in
// float32, and written once (bfloat16 rounds once, at the write). A
// target outside [0, M) leaves C alone; a perm entry outside [0, S) adds
// nothing. No atomics: the result repeats bit for bit, and a fold resumed
// segment by segment (the overlapped coo executor) gives the staged bits.
// Because the chain is fixed, a hub row cannot be split into partial sums:
// its additions stay one dependent chain per element.
//
// What bounds it on the card: memory bytes (each valid partial row read
// once, each touched C row read and written once, one add per element) —
// and, for a hub row, memory latency. On the power-law cell the largest
// row has 14,880 slots: folded with one load in flight, each slot waits
// out a full memory latency (for meta, perm and the row in turn), so the
// design's job is to keep many rows in flight inside the fixed chain.
//
// Design: a thread block of 8 warps takes 256 slots x 128 columns; each
// warp owns the segments that START in its 32 slots (ballot over meta).
//  * Short segments (at most kLong slots): the warp streams the slots of
//    its segments in order, kBatch at a time: perm comes in one coalesced
//    load per 32 slots, then the kBatch partial rows and the C rows of the
//    segments starting among them are all loaded before any add (one
//    16-byte float32 or 8-byte bfloat16 access per lane, 4 columns a
//    lane), and the adds follow in slot order; a segment's end writes C.
//  * A longer segment (a hub) is handed to the whole block after the short
//    work: the 8 warps load the next 8 x kStage partial rows into
//    registers while warp 0 folds the previous 8 x kStage rows from shared
//    memory, in slot order; the rows then move to shared memory. So a
//    block keeps ~64 KB of one hub's rows in flight instead of one row.
// Segment bounds are known before a fold starts: within the warp's 32
// slots from the ballot, past them by a coalesced scan of at most kLong
// slots, and for a hub by a binary search over the sorted meta.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

constexpr int kScatterWarps = 8;
constexpr int kLong = 64;    // longest segment one warp folds alone
constexpr int kBatch = 8;    // slots whose loads are in flight together (short path)
constexpr int kStage = 16;   // rows each warp loads per hub stage
constexpr int kHubRows = kScatterWarps * kStage;
constexpr int kTileCols = 128;  // 32 lanes x 4 columns
constexpr size_t kHubSmem = (size_t)kHubRows * kTileCols * sizeof(float);

// Fold slots [first, end) of one rank in slot order; every slot in the
// range belongs to a segment that starts in it. One warp; lane owns 4 columns.
template <typename T, bool kVec>
__device__ void fold_short(T* __restrict__ c_rank, const T* __restrict__ p_rank,
                           const int32_t* __restrict__ pr, const int32_t* __restrict__ m,
                           long long first, long long end, long long n_valid, long long M,
                           long long S, long long n, long long j, int lane) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int tgt_cur = -1;
  for (long long base = first; base < end; base += 32) {
    const long long s = base + lane;
    const bool in = s < end;
    const int src = in ? pr[s] : -1;
    const int tg = in ? m[s] : -1;
    const bool start = in && (s == first || m[s - 1] != tg);
    const bool last = in && (s + 1 >= n_valid || m[s + 1] != tg);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned ends = __ballot_sync(0xffffffffu, last);
    const int cnt = (int)min(32LL, end - base);
    for (int u0 = 0; u0 < cnt; u0 += kBatch) {
      float rows[kBatch][4], seeds[kBatch][4];
      int srcs[kBatch], tgts[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int sl = u0 + u;
        srcs[u] = __shfl_sync(0xffffffffu, src, sl & 31);
        tgts[u] = __shfl_sync(0xffffffffu, tg, sl & 31);
        if (sl < cnt && srcs[u] >= 0 && srcs[u] < S) {
          load4<T, kVec>(p_rank + (long long)srcs[u] * n, j, n, rows[u]);
        }
        if (sl < cnt && ((starts >> sl) & 1u) && tgts[u] >= 0 && tgts[u] < M) {
          load4<T, kVec>(c_rank + (long long)tgts[u] * n, j, n, seeds[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int sl = u0 + u;
        if (sl >= cnt) break;
        if ((starts >> sl) & 1u) {
          tgt_cur = tgts[u];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = seeds[u][q];
        }
        if (srcs[u] >= 0 && srcs[u] < S) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], rows[u][q]);
        }
        if (((ends >> sl) & 1u) && tgt_cur >= 0 && tgt_cur < M) {
          store4<T, kVec>(c_rank + (long long)tgt_cur * n, j, n, acc);
        }
      }
    }
  }
}

// Fold the segment [s0, end) with the whole block (end < 0: not known yet).
template <typename T, bool kVec>
__device__ void fold_hub(T* __restrict__ c_rank, const T* __restrict__ p_rank,
                         const int32_t* __restrict__ pr, const int32_t* __restrict__ m,
                         long long s0, long long end, long long n_valid, long long M,
                         long long S, long long n, long long j, float* rows_smem,
                         int* valid_smem, long long* end_smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tgt = m[s0];
  if (tgt < 0 || tgt >= M) return;  // block-uniform
  if (threadIdx.x == 0) {
    if (end < 0) {  // first slot past s0 whose target differs: meta is sorted
      long long lo = s0 + 1, hi = n_valid;
      while (lo < hi) {
        const long long mid = (lo + hi) / 2;
        if (m[mid] != tgt) hi = mid; else lo = mid + 1;
      }
      end = lo;
    }
    *end_smem = end;
  }
  __syncthreads();
  end = *end_smem;
  float acc[4];
  if (warp == 0) load4<T, kVec>(c_rank + (long long)tgt * n, j, n, acc);
  // this warp's kStage rows of the stage starting at base, into registers
  float rows[kStage][4];
  int valid = 0;  // bit u: slot u of this warp's share adds a row
  auto load_stage = [&](long long base) {
    const long long s = base + warp * kStage + (lane & (kStage - 1));
    const int src = s < end ? pr[s] : -1;
    valid = (int)(__ballot_sync(0xffffffffu, lane < kStage && src >= 0 && src < S));
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int su = __shfl_sync(0xffffffffu, src, u);
      if ((valid >> u) & 1) load4<T, kVec>(p_rank + (long long)su * n, j, n, rows[u]);
    }
  };
  auto store_stage = [&]() {
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      float* dst = rows_smem + (long long)(warp * kStage + u) * kTileCols + 4 * lane;
      if ((valid >> u) & 1) *reinterpret_cast<float4*>(dst) =
          make_float4(rows[u][0], rows[u][1], rows[u][2], rows[u][3]);
    }
    if (lane == 0) valid_smem[warp] = valid;
  };
  load_stage(s0);
  store_stage();
  __syncthreads();
  for (long long base = s0; base < end; base += kHubRows) {
    const long long next = base + kHubRows;
    if (next < end) load_stage(next);  // in flight while warp 0 folds
    if (warp == 0) {
      const int cnt = (int)min((long long)kHubRows, end - base);
      for (int u = 0; u < cnt; ++u) {
        if ((valid_smem[u / kStage] >> (u % kStage)) & 1) {
          const float4 v =
              *reinterpret_cast<const float4*>(rows_smem + (long long)u * kTileCols + 4 * lane);
          acc[0] = __fadd_rn(acc[0], v.x);
          acc[1] = __fadd_rn(acc[1], v.y);
          acc[2] = __fadd_rn(acc[2], v.z);
          acc[3] = __fadd_rn(acc[3], v.w);
        }
      }
    }
    __syncthreads();
    if (next < end) {
      store_stage();
      __syncthreads();
    }
  }
  if (warp == 0) store4<T, kVec>(c_rank + (long long)tgt * n, j, n, acc);
  __syncthreads();  // the shared rows are free for the next hub
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kScatterWarps)
    scatter_add_rows_kernel(T* __restrict__ c, const T* __restrict__ partials,
                            const int32_t* __restrict__ perm, const int32_t* __restrict__ meta,
                            long long M, long long S, long long n) {
  extern __shared__ float rows_smem[];
  __shared__ long long hub_start[kScatterWarps], hub_end[kScatterWarps];
  __shared__ int valid_smem[kScatterWarps];
  __shared__ int n_hubs;
  __shared__ long long end_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = blockIdx.z;
  const long long j = (long long)blockIdx.y * kTileCols + 4 * lane;
  const int32_t* m = meta + p * (S + 1);
  const int32_t* pr = perm + p * S;
  const long long n_valid = max(0LL, min((long long)m[S], S));
  T* c_rank = c + p * M * n;
  const T* p_rank = partials + p * S * n;
  if (threadIdx.x == 0) n_hubs = 0;
  __syncthreads();

  const long long c0 = ((long long)blockIdx.x * kScatterWarps + warp) * 32;
  if (c0 < n_valid) {
    const long long s = c0 + lane;
    const bool in = s < n_valid;
    const int tg = in ? m[s] : 0;
    const unsigned starts = __ballot_sync(0xffffffffu, in && (s == 0 || m[s - 1] != tg));
    if (starts) {
      const long long first = c0 + __ffs(starts) - 1;
      const long long last = c0 + 31 - __clz(starts);  // the chunk's last segment start
      const int tg_last = __shfl_sync(0xffffffffu, tg, (int)(last - c0));
      // its end: the chunk's slots after it share its target; scan on
      long long end = -1;
      long long q = min(c0 + 32, n_valid);
      for (; q < n_valid && q <= last + kLong; q += 32) {
        const bool past = q + lane >= n_valid || m[q + lane] != tg_last;
        const unsigned ne = __ballot_sync(0xffffffffu, past);
        if (ne) {
          end = q + __ffs(ne) - 1;
          break;
        }
      }
      if (end < 0 && q >= n_valid) end = n_valid;
      const bool hub = end < 0 || end - last > kLong;
      fold_short<T, kVec>(c_rank, p_rank, pr, m, first, hub ? last : end, n_valid, M, S, n, j,
                          lane);
      if (hub && lane == 0) {
        const int h = atomicAdd(&n_hubs, 1);
        hub_start[h] = last;
        hub_end[h] = end;
      }
    }
  }
  __syncthreads();
  const int hubs = n_hubs;
  for (int h = 0; h < hubs; ++h) {
    fold_hub<T, kVec>(c_rank, p_rank, pr, m, hub_start[h], hub_end[h], n_valid, M, S, n, j,
                      rows_smem, valid_smem, &end_smem);
  }
}

template <typename T>
int launch_scatter(void* c, const void* partials, const void* perm, const void* meta,
                   long long P, long long M, long long S, long long n, cudaStream_t st) {
  const long long gx = ceil_div(S, 32 * kScatterWarps), gy = ceil_div(n, kTileCols);
  if (!grid_fits(gx, gy, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)P);
  const bool vec = vec4_ok(c, n, sizeof(T)) && vec4_ok(partials, n, sizeof(T));
  auto run = [&](auto vec_tag) {
    auto kernel = scatter_add_rows_kernel<T, decltype(vec_tag)::value>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHubSmem);
    if (attr != cudaSuccess) return (int)attr;
    kernel<<<grid, 32 * kScatterWarps, kHubSmem, st>>>(
        (T*)c, (const T*)partials, (const int32_t*)perm, (const int32_t*)meta, M, S, n);
    return (int)cudaGetLastError();
  };
  return vec ? run(std::true_type{}) : run(std::false_type{});
}

}  // namespace repro_torch

extern "C" int repro_scatter_add_rows(void* c, const void* partials, const void* perm,
                                      const void* meta, long long P, long long M, long long S,
                                      long long n, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch_scatter<float>(c, partials, perm, meta, P, M, S, n, st);
  if (dtype == kBFloat16) {
    return launch_scatter<__nv_bfloat16>(c, partials, perm, meta, P, M, S, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
