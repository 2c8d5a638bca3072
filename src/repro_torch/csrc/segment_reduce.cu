// Deterministic segment reduction over sorted segment ids, for Hopper.
//
// Replaces: repro/kernels/segment_reduce.py::segment_reduce (Pallas
// `_seg_kernel`), and serves the engine's Combine stage
// (Combiner.segment), which the JAX engine does with an XLA scatter.
// vals (E, D) with ascending seg_ids (E,) -> out (num, D) under min, max or
// sum. Ids outside [0, num) are dropped; an empty segment holds `fill`
// (the TPU kernel's +-f32max/4 or 0, or JAX segment_min/max's +-inf).
//
// Bound on the H100: bytes — each value and id is read once, each output
// written once; the per-segment binary searches add log2(E) reads of ids
// that mostly hit L2.
//
// Design: no float atomics, so a sum is the same from run to run. Each
// output item (segment, column) finds its rows [start, end) by two lower
// bounds over the sorted ids and reduces them in a fixed order that depends
// only on the segment's length:
//   tier 1, one warp per item (length <= 2048): lane l folds rows
//           start + l, start + l + 32, ... in order, then a shuffle tree
//           16 .. 1;
//   tier 2, one 256-thread block per long item (power-law hubs): thread t
//           folds rows start + t + 256k in order, then a shuffle tree in
//           each warp and a halving tree over the 8 warp results.
// Tier 1 appends long items to a list (the order of the list does not
// matter: each item is reduced by one block alone); tier 2 runs a fixed grid
// over that list.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LONG_SEG = 2048;
constexpr int WARP_THREADS = 256;
constexpr int BLOCK_THREADS = 256;
constexpr int LONG_GRID = 528;  // 4 blocks on each of the 132 SMs

enum Combine { MIN = 0, MAX = 1, SUM = 2 };

template <int K>
__device__ __forceinline__ float ident() {
  if (K == MIN) return FLT_MAX / 4.0f;
  if (K == MAX) return -FLT_MAX / 4.0f;
  return 0.0f;
}

template <int K>
__device__ __forceinline__ float pair(float a, float b) {
  if (K == MIN) return fminf(a, b);
  if (K == MAX) return fmaxf(a, b);
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ ids, int E,
                                           int key) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ids[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int K>
__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc = pair<K>(acc, __shfl_down_sync(FULL, acc, off));
  return acc;
}

template <int K>
__global__ void __launch_bounds__(WARP_THREADS)
seg_warp(const float* __restrict__ vals, const int* __restrict__ ids, int E,
         int D, long long items, float fill, float* __restrict__ out,
         int* __restrict__ long_list, int* __restrict__ long_count) {
  const long long item =
      (long long)blockIdx.x * (WARP_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const bool live = item < items;
  const int s = live ? (int)(item / D) : 0;
  const int d = live ? (int)(item % D) : 0;
  // lane 0 finds start, lane 1 finds end
  int bound = 0;
  if (live && lane < 2) bound = lower_bound(ids, E, s + lane);
  const int start = __shfl_sync(FULL, bound, 0);
  const int end = __shfl_sync(FULL, bound, 1);
  const bool is_long = end - start > LONG_SEG;
  float acc = ident<K>();
  if (live && !is_long)
    for (int e = start + lane; e < end; e += 32)
      acc = pair<K>(acc, vals[(long long)e * D + d]);
  acc = warp_tree<K>(acc);
  if (live && lane == 0) {
    if (is_long) long_list[atomicAdd(long_count, 1)] = (int)item;
    else out[item] = (start == end) ? fill : acc;
  }
}

template <int K>
__global__ void __launch_bounds__(BLOCK_THREADS)
seg_block(const float* __restrict__ vals, const int* __restrict__ ids, int E,
          int D, float* __restrict__ out, const int* __restrict__ long_list,
          const int* __restrict__ long_count) {
  __shared__ float part[BLOCK_THREADS / 32];
  __shared__ int bounds[2];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int count = *long_count;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    const int item = long_list[idx];
    const int s = item / D, d = item % D;
    if (t < 2) bounds[t] = lower_bound(ids, E, s + t);
    __syncthreads();
    const int start = bounds[0], end = bounds[1];
    float acc = ident<K>();
    for (int e = start + t; e < end; e += BLOCK_THREADS)
      acc = pair<K>(acc, vals[(long long)e * D + d]);
    acc = warp_tree<K>(acc);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int h = BLOCK_THREADS / 64; h >= 1; h >>= 1)
        for (int k = 0; k < h; ++k) part[k] = pair<K>(part[k], part[k + h]);
      out[item] = part[0];
    }
    __syncthreads();
  }
}

template <int K>
cudaError_t go(const float* vals, const int* ids, int E, int D, int num,
               float fill, float* out, int* long_list, int* long_count,
               cudaStream_t s) {
  const long long items = (long long)num * D;
  if (items == 0) return cudaGetLastError();
  cudaMemsetAsync(long_count, 0, sizeof(int), s);
  const int per_block = WARP_THREADS / 32;
  const long long grid = (items + per_block - 1) / per_block;
  seg_warp<K><<<(unsigned)grid, WARP_THREADS, 0, s>>>(
      vals, ids, E, D, items, fill, out, long_list, long_count);
  if (E > LONG_SEG)
    seg_block<K><<<LONG_GRID, BLOCK_THREADS, 0, s>>>(vals, ids, E, D, out,
                                                     long_list, long_count);
  return cudaGetLastError();
}

}  // namespace

// vals (E, D) f32 row-major, ids (E,) int32 ascending, out (num, D) f32.
// Scratch: long_list (E / 2048 + 1,) int32, long_count (1,) int32.
// Returns cudaGetLastError() (0 on success).
extern "C" int segment_reduce_launch(const float* vals, const int* ids, int E,
                                     int D, int num, int combine_op,
                                     float fill, float* out, int* long_list,
                                     int* long_count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (combine_op) {
    case MIN: return (int)go<MIN>(vals, ids, E, D, num, fill, out, long_list, long_count, s);
    case MAX: return (int)go<MAX>(vals, ids, E, D, num, fill, out, long_list, long_count, s);
    case SUM: return (int)go<SUM>(vals, ids, E, D, num, fill, out, long_list, long_count, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
