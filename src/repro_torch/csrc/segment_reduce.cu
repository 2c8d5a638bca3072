// Deterministic segment reduction over sorted segment ids, for Hopper.
//
// Replaces: repro/kernels/segment_reduce.py::segment_reduce (Pallas
// `_seg_kernel`), and serves the engine's Combine stage
// (Combiner.segment), which the JAX engine does with an XLA scatter.
// vals (E, D) with ascending seg_ids (E,) -> out (num, D) under min, max or
// sum. Ids outside [0, num) are dropped; an empty segment holds `fill`
// (the TPU kernel's +-f32max/4 or 0, or JAX segment_min/max's +-inf).
//
// Bound on the H100: bytes. With [lo, hi) the rows whose ids lie in
// [0, num), the kernel must read (hi - lo) * (4 + 4D) bytes of ids and
// values and write num * D * 4 bytes of output. What it moves beyond that:
// the fill pass writes every output once and the segments overwrite the
// non-empty ones (the output is 16.8 MB at RMAT scale 22, so the second
// write mostly lands in the 50 MB L2); each 128-row chunk reads one id 2049
// rows back, and the segment that runs past the chunk reads its next ids
// again to find its end (and one id 2048 rows on where that takes more
// than one step): mostly L2 hits.
//
// Design: work in E + num, not num * log E. No float atomics, so a sum is
// the same from run to run; the fold order inside a segment depends only on
// its length (and D), and `segment_reduce_ordered` in
// kernels/segment_reduce.py repeats it in PyTorch.
//   1. seg_fill_range: a coalesced pass writes `fill` to all of `out`; two
//      warps find [lo, hi) with one 32-ary lower bound each (after a check
//      of the end rows, so ids that are all in range cost no search). These
//      are the call's only two searches.
//   2. seg_tiles: a persistent grid (as many blocks as are resident at
//      once) walks [lo, hi) in chunks of four 32-row sub-tiles, one chunk a
//      warp at a time, its ids and values loaded up front. A row is a head
//      where its id differs from the row before it; a ballot a sub-tile
//      finds the heads and __ffs the next one, so every head knows its end
//      from registers except the chunk's last (the warp reads on for it,
//      32 ids a step; where the first step finds no end, the id 2048 rows
//      on says whether it is long). The sub-tile that holds a segment's
//      head reduces all of it:
//        thread tier (length <= THREAD_SEG): the head's lane folds its rows
//          left to right, from registers (shuffles) where they lie in the
//          sub-tile;
//        warp tier (THREAD_SEG < length <= LONG_SEG): lane l folds rows
//          l, l + 32, ... in order, then a shuffle tree 16 .. 1;
//        block tier (length > LONG_SEG, the power-law hubs): appended to a
//          list. The chunk whose first head is the row after the segment
//          (one id read 2049 rows back tells it the segment is long)
//          writes that end into the segment's own output slot, which the
//          block tier overwrites with the result.
//      D > 1 (seg_tiles_cols, chunks of one sub-tile): lanes run over
//      columns (a warp reads whole rows, coalesced) and every segment up to
//      LONG_SEG rows is a left fold over its rows, one warp a segment.
//   3. seg_block, one 256-thread block per listed segment: D = 1, thread t
//      folds rows t + 256k in order, then a shuffle tree in each warp and a
//      halving tree over the 8 warp results; D > 1, warp w folds rows
//      w + 8k in order (lanes over columns), then a halving tree over the 8
//      warps.
// Empty segments keep the fill of pass 1: no warp is started for them, and
// no scratch of E entries is written (the long list holds at most
// E / 2049 + 1 row numbers).
//
// THREAD_SEG = 8 and four sub-tiles a chunk, from `scripts/
// port_kernel_probe.py tiers` on an H100 80GB HBM3 at 700 W, RMAT scale 22:
// thread-tier limits 4, 8 and 16 were within 1 % of one another at the push
// shape (8 the fastest in both rounds, 1.00 ms) and within 2 % at the
// largest merge; two sub-tiles a chunk were 10 % slower, eight 46 % slower
// (64 registers, fewer resident warps). The pull merges' segments are nearly all one row;
// the push Combine's average 31 rows.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

// The thread-tier limit and a chunk's sub-tiles; scripts/port_kernel_probe.py
// (`tiers`) builds other values with -D to time them.
#ifndef SEG_THREAD_SEG
#define SEG_THREAD_SEG 8
#endif
#ifndef SEG_UNROLL
#define SEG_UNROLL 4
#endif

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREAD_SEG = SEG_THREAD_SEG;
constexpr int LONG_SEG = 2048;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = SEG_UNROLL;      // sub-tiles a warp loads at once (D = 1)
constexpr int FILL_GRID = 132 * 8;
constexpr int LONG_GRID = 132 * 4;

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

template <int K>
__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc = pair<K>(acc, __shfl_down_sync(FULL, acc, off));
  return acc;
}

// First i in [a, b) with ids[i] >= key (b if none), by the whole warp: each
// round tests 32 evenly spaced rows and keeps the step between the last
// row below `key` and the first one not below it.
__device__ int warp_lower_bound(const int* __restrict__ ids, int a, int b,
                                int key) {
  const int lane = threadIdx.x & 31;
  while (a < b) {
    const int step = (b - a + 31) / 32;
    const long long q = a + (long long)lane * step;
    const bool below = q < b && ids[q] < key;
    const int c = __popc(__ballot_sync(FULL, below));
    const int na = c ? a + (c - 1) * step + 1 : a;
    const long long nb = a + (long long)c * step;
    a = na;
    b = nb < b ? (int)nb : b;
  }
  return a;
}

// state: [0] lo, [1] hi, [2] long-list length.
__global__ void __launch_bounds__(THREADS)
seg_fill_range(const int* __restrict__ ids, int E, int num, float fill,
               float* __restrict__ out, long long total,
               int* __restrict__ state) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && warp < 2) {
    int r;
    if (warp == 0)
      r = (E == 0 || ids[0] >= 0) ? 0 : warp_lower_bound(ids, 0, E, 0);
    else
      r = (E == 0 || ids[E - 1] < num) ? E : warp_lower_bound(ids, 0, E, num);
    if (lane == 0) state[warp] = r;
    if (warp == 0 && lane == 0) state[2] = 0;
  }
  const long long start = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if ((reinterpret_cast<size_t>(out) & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(out);
    const float4 f4 = make_float4(fill, fill, fill, fill);
    for (long long i = start; i < total / 4; i += stride) o4[i] = f4;
    for (long long i = total / 4 * 4 + start; i < total; i += stride) out[i] = fill;
  } else {
    for (long long i = start; i < total; i += stride) out[i] = fill;
  }
}

// The heads and ends of one chunk of U sub-tiles of 32 rows (a warp's
// rows; idv[u] holds row base + 32u + lane, prev_chunk the id of row
// base - 1, or -1 at lo). heads[u] is sub-tile u's ballot of heads; end[u]
// the row after the head lane's segment, or -1 for a segment listed as
// long. Only the chunk's last head may end past the chunk: the warp reads
// on for it, 32 ids a step; where the first step finds no end, the id
// LONG_SEG rows on says whether it is long. Only the segment that ends at
// the chunk's first head p (or at hi, in a chunk without heads) may have
// started before the chunk: it is long if the id 2049 rows before p is its
// id, and then p goes into its output slot for the block tier.
template <int U>
__device__ __forceinline__ void scan_chunk(
    const int* __restrict__ ids, int lo, int hi, int base, const int (&idv)[U],
    int prev_chunk, int D, float* __restrict__ out, int* __restrict__ long_list,
    int* __restrict__ state, unsigned (&heads)[U], int (&end)[U]) {
  const int lane = threadIdx.x & 31;
  int prev_last = prev_chunk;
  unsigned any = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int prev = __shfl_up_sync(FULL, idv[u], 1);
    if (lane == 0) prev = prev_last;
    prev_last = __shfl_sync(FULL, idv[u], 31);
    heads[u] = __ballot_sync(FULL, base + 32 * u + lane < hi && idv[u] != prev);
    any |= heads[u];
  }
  const bool past = base + 32 * U < hi;       // rows follow the chunk
  int next = past ? INT_MIN : hi;             // first head at or after here
#pragma unroll
  for (int u = U - 1; u >= 0; --u) {
    const unsigned after = lane == 31 ? 0u : heads[u] >> (lane + 1);
    end[u] = after ? base + 32 * u + lane + __ffs(after) : next;
    if (heads[u]) next = base + 32 * u + __ffs(heads[u]) - 1;
  }
  // the back read is issued here and compared last, so that its latency
  // overlaps the crossing scan's
  const int p = any ? next : (past ? -1 : hi);
  const int q = p - 1 - LONG_SEG;
  const bool check_back = p > lo && q >= lo;
  const int back = check_back ? ids[q] : -1;
  if (past && any) {
    // the chunk's last head: its sub-tile, lane, row and id
    int ul = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (heads[u]) ul = u;
    unsigned last_heads = 0;
    int s = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u == ul) {
        last_heads = heads[u];
        s = __shfl_sync(FULL, idv[u], 31 - __clz(heads[u]));
      }
    const int cl = 31 - __clz(last_heads);
    const int start = base + 32 * ul + cl;
    int j = base + 32 * U + lane;
    unsigned diff = __ballot_sync(FULL, j >= hi || ids[j] != s);
    int e = -1;
    if (diff) {                  // ends within 32 rows of the chunk: short
      e = j - lane + __ffs(diff) - 1;
    } else if (start + LONG_SEG < hi && ids[start + LONG_SEG] == s) {
      if (lane == 0) long_list[atomicAdd(state + 2, 1)] = start;
    } else {
      do {
        j += 32;
        diff = __ballot_sync(FULL, j >= hi || ids[j] != s);
      } while (!diff);
      e = j - lane + __ffs(diff) - 1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u == ul && lane == cl) end[u] = e;
  }
  // the segment that ends at p is long: leave p in its output slot
  if (lane == 0 && check_back && back == prev_chunk)
    out[(long long)prev_chunk * D] = __int_as_float(p);
}

// D = 1: each warp takes a chunk of UNROLL sub-tiles of 32 rows at a time,
// its ids and values loaded up front.
template <int K>
__global__ void __launch_bounds__(THREADS)
seg_tiles(const float* __restrict__ vals, const int* __restrict__ ids,
          float* __restrict__ out, int* __restrict__ long_list,
          int* __restrict__ state) {
  const int lo = state[0], hi = state[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int CHUNK = 32 * UNROLL;
  for (long long b = lo + ((long long)blockIdx.x * WARPS + warp) * CHUNK;
       b < hi; b += (long long)gridDim.x * WARPS * CHUNK) {
    const int base = (int)b;
    int idv[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + 32 * u + lane;
      idv[u] = r < hi ? ids[r] : INT_MAX;
      v[u] = r < hi ? vals[r] : 0.0f;
    }
    // ids in [lo, hi) are >= 0, so -1 makes row lo a head
    const int prev_chunk = base > lo ? ids[base - 1] : -1;
    unsigned heads[UNROLL];
    int end[UNROLL];
    scan_chunk<UNROLL>(ids, lo, hi, base, idv, prev_chunk, 1, out, long_list,
                       state, heads, end);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int a = base + 32 * u;
      if (a >= hi) break;
      const int row = a + lane;
      const bool live = ((heads[u] >> lane) & 1) && end[u] >= 0;
      const int len = live ? end[u] - row : 0;
      const bool thread = live && len <= THREAD_SEG;
      const bool inside = end[u] <= a + 32;
      // thread tier: rows from the sub-tile's registers, or past it from
      // memory (L1: this warp just read them)
      float acc = ident<K>();
      const int steps = __reduce_max_sync(FULL, thread && inside ? len : 0);
      for (int k = 0; k < steps; ++k) {
        const float x = __shfl_down_sync(FULL, v[u], k);
        if (inside && k < len) acc = pair<K>(acc, x);
      }
      if (thread) {
        if (!inside)
          for (int r = row; r < end[u]; ++r) acc = pair<K>(acc, vals[r]);
        out[idv[u]] = acc;
      }
      // warp tier, one segment at a time
      unsigned wide = __ballot_sync(FULL, live && len > THREAD_SEG);
      while (wide) {
        const int hl = __ffs(wide) - 1;
        wide &= wide - 1;
        const int st = a + hl;
        const int en = __shfl_sync(FULL, end[u], hl);
        const int s = __shfl_sync(FULL, idv[u], hl);
        float w = ident<K>();
        if (en <= a + 32) {
          const float x = __shfl_sync(FULL, v[u], (hl + lane) & 31);
          if (lane < en - st) w = pair<K>(w, x);
        } else {
          for (int r = st + lane; r < en; r += 32) w = pair<K>(w, vals[r]);
        }
        w = warp_tree<K>(w);
        if (lane == 0) out[s] = w;
      }
    }
  }
}

// D > 1: one sub-tile of 32 rows a warp; each segment up to LONG_SEG rows
// is a left fold over its rows, lanes over columns.
template <int K>
__global__ void __launch_bounds__(THREADS)
seg_tiles_cols(const float* __restrict__ vals, const int* __restrict__ ids,
               int D, float* __restrict__ out, int* __restrict__ long_list,
               int* __restrict__ state) {
  const int lo = state[0], hi = state[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long base = lo + ((long long)blockIdx.x * WARPS + warp) * 32;
       base < hi; base += (long long)gridDim.x * WARPS * 32) {
    const int a = (int)base;
    const int row = a + lane;
    const int idv[1] = {row < hi ? ids[row] : INT_MAX};
    unsigned heads[1];
    int end[1];
    scan_chunk<1>(ids, lo, hi, a, idv, a > lo ? ids[a - 1] : -1, D, out, long_list,
                  state, heads, end);
    unsigned todo = __ballot_sync(FULL, ((heads[0] >> lane) & 1) && end[0] >= 0);
    while (todo) {
      const int hl = __ffs(todo) - 1;
      todo &= todo - 1;
      const int st = a + hl;
      const int en = __shfl_sync(FULL, end[0], hl);
      const long long s = __shfl_sync(FULL, idv[0], hl);
      for (int c = lane; c < D; c += 32) {
        float acc = ident<K>();
        for (int r = st; r < en; ++r) acc = pair<K>(acc, vals[(long long)r * D + c]);
        out[s * D + c] = acc;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
seg_block(const float* __restrict__ vals, const int* __restrict__ ids, int D,
          float* __restrict__ out, const int* __restrict__ long_list,
          const int* __restrict__ state) {
  __shared__ float part[WARPS][32];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int count = state[2];
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    const int start = long_list[idx];
    const long long s = ids[start];
    const int end = __float_as_int(out[s * D]);   // left by the tile pass
    __syncthreads();                                // read before it is overwritten
    if (D == 1) {
      constexpr int DEPTH = 8;
      float acc = ident<K>();
      for (int r0 = start + t; r0 < end; r0 += THREADS * DEPTH) {
        float x[DEPTH];
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
          const int r = r0 + k * THREADS;
          x[k] = r < end ? vals[r] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < DEPTH; ++k)
          if (r0 + k * THREADS < end) acc = pair<K>(acc, x[k]);
      }
      acc = warp_tree<K>(acc);
      if (lane == 0) part[warp][0] = acc;
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int h = WARPS / 2; h >= 1; h >>= 1)
          for (int k = 0; k < h; ++k) part[k][0] = pair<K>(part[k][0], part[k + h][0]);
        out[s] = part[0][0];
      }
      __syncthreads();
    } else {
      for (int c0 = 0; c0 < D; c0 += 32) {
        const int c = c0 + lane;
        float acc = ident<K>();
        if (c < D)
          for (int r = start + warp; r < end; r += WARPS)
            acc = pair<K>(acc, vals[(long long)r * D + c]);
        part[warp][lane] = acc;
        __syncthreads();
        if (warp == 0 && c < D) {
          float p[WARPS];
#pragma unroll
          for (int k = 0; k < WARPS; ++k) p[k] = part[k][lane];
#pragma unroll
          for (int h = WARPS / 2; h >= 1; h >>= 1)
#pragma unroll
            for (int k = 0; k < h; ++k) p[k] = pair<K>(p[k], p[k + h]);
          out[s * D + c] = p[0];
        }
        __syncthreads();
      }
    }
  }
}

// A persistent grid: as many blocks of `kernel` as are resident at once on
// the current device (a grid-stride loop over more would run in a second,
// equally long wave), counted once per device.
template <typename Kernel>
unsigned resident_grid(Kernel kernel) {
  static int cached[16];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && cached[dev] > 0) return (unsigned)cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 16) cached[dev] = grid;
  return (unsigned)grid;
}

template <int K>
cudaError_t go(const float* vals, const int* ids, int E, int D, int num,
               float fill, float* out, int* long_list, int* state,
               cudaStream_t s) {
  const long long total = (long long)num * D;
  if (total == 0) return cudaGetLastError();
  long long fill_blocks = (total / 4 + THREADS - 1) / THREADS;
  if (fill_blocks < 1) fill_blocks = 1;
  seg_fill_range<<<(unsigned)(fill_blocks < FILL_GRID ? fill_blocks : FILL_GRID), THREADS,
                   0, s>>>(ids, E, num, fill, out, total, state);
  if (E == 0) return cudaGetLastError();
  const int rows = D == 1 ? THREADS / 32 * 32 * UNROLL : THREADS;
  const long long want = ((long long)E + rows - 1) / rows;
  if (D == 1) {
    const unsigned most = resident_grid(seg_tiles<K>);
    seg_tiles<K><<<(unsigned)(want < most ? want : most), THREADS, 0, s>>>(
        vals, ids, out, long_list, state);
  } else {
    const unsigned most = resident_grid(seg_tiles_cols<K>);
    seg_tiles_cols<K><<<(unsigned)(want < most ? want : most), THREADS, 0, s>>>(
        vals, ids, D, out, long_list, state);
  }
  if (E > LONG_SEG)
    seg_block<K><<<LONG_GRID, THREADS, 0, s>>>(vals, ids, D, out, long_list, state);
  return cudaGetLastError();
}

}  // namespace

// vals (E, D) f32 row-major, ids (E,) int32 ascending, out (num, D) f32.
// Scratch: long_list (E / 2049 + 1,) int32; state (3,) int32.
// Returns cudaGetLastError() (0 on success).
extern "C" int segment_reduce_launch(const float* vals, const int* ids, int E,
                                     int D, int num, int combine_op,
                                     float fill, float* out, int* long_list,
                                     int* state, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (combine_op) {
    case MIN: return (int)go<MIN>(vals, ids, E, D, num, fill, out, long_list, state, s);
    case MAX: return (int)go<MAX>(vals, ids, E, D, num, fill, out, long_list, state, s);
    case SUM: return (int)go<SUM>(vals, ids, E, D, num, fill, out, long_list, state, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
