// Ballot-filter stream compaction (paper Fig. 6b), for Hopper: one pass,
// a scan with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016).
//
// Replaces: repro/kernels/frontier_pack.py::frontier_pack (Pallas
// `_pack_kernel`) together with its XLA epilogue `concat_blocks`. From a
// dense (n,) bool mask it produces the sorted, unique frontier: the ids of the
// set lanes in a (cap,) buffer padded with the sentinel n, the count
// min(total, cap) and the overflow flag total > cap — bit-equal to
// core.frontier.compact_mask.
//
// Bound on the H100: bytes. The pass reads the n mask bytes once and writes
// at most cap ids (4 bytes each); the work per lane is a ballot share and a
// popcount. Nothing else goes through device memory: no per-block id
// scratch, no scan of block counts in a second kernel — only one 8-byte
// status word per tile of 4,096 lanes.
//
// Design:
//   tile    — a block takes the next tile index from a global ticket
//             (atomicAdd), not from blockIdx: CUDA does not schedule blocks
//             in order, and a look-back that waited on a block that is not
//             resident would never end. A tile's predecessors all took their
//             tickets earlier, so they are running or done.
//   rank    — each thread loads 16 mask bytes (one 16-byte load where the
//             mask is aligned), and each warp ranks its 512 lanes with 16
//             __ballot_sync words and __popc of the lanes below; warp 0 scans
//             the 8 warp counts. The tile's ids land in shared memory at
//             their ranks.
//   publish — the tile's status word (flag << 32 | value) is written as soon
//             as its count is known: flag 1 = aggregate; tile 0 writes flag 2
//             = inclusive prefix at once.
//   look-back — warp 0 reads the 32 preceding status words together, waits
//             while any is still 0, adds the aggregates down to the nearest
//             inclusive prefix (or all 32, then the next 32), and publishes
//             its own inclusive prefix.
//   write   — the block copies its ids from shared memory to out[offset + i]
//             where that is < cap, coalesced. The last tile writes the total,
//             count = min(total, cap) and overflow = total > cap.
//   tail    — a second small launch writes the sentinel n into [total, cap),
//             reading the total on the device.
// The status words and the ticket are zeroed on the stream (cudaMemsetAsync)
// before every call, so two calls in a row on one stream never see each
// other's words. Count and overflow never go to the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;              // mask bytes per thread
constexpr int TILE = THREADS * PER_THREAD;  // 4,096 lanes
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;
constexpr int TAIL_BLOCKS = 1024;           // about one wave on 132 SMs

// aux layout (int64 words): [0] ticket, [1] total, [2 ...] one status word
// per tile.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(THREADS)
pack_tiles(const unsigned char* __restrict__ mask, int n, int cap,
           int aligned, unsigned long long* __restrict__ aux,
           int* __restrict__ out, int* __restrict__ out_count,
           unsigned char* __restrict__ out_ovf) {
  __shared__ int ids_s[TILE];
  __shared__ int warp_cnt[WARPS];
  __shared__ int warp_off[WARPS];
  __shared__ int tile_s, excl_s;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  unsigned long long* status = aux + 2;

  if (t == 0) tile_s = (int)atomicAdd(reinterpret_cast<unsigned*>(aux), 1u);
  __syncthreads();
  const int tile = tile_s;
  const long long base = (long long)tile * TILE + (long long)t * PER_THREAD;

  // this thread's 16 lanes as a 16-bit mask
  unsigned bits = 0;
  if (aligned && base + PER_THREAD <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + base);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      bits |= (((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0u ? 1u : 0u) << j;
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (base + j < n && mask[base + j] != 0) bits |= 1u << j;
  }

  // warp ranks: ballot j holds bit j of every thread's mask
  const unsigned below = (1u << lane) - 1u;
  int before = 0, wsum = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const unsigned b = __ballot_sync(FULL, (bits >> j) & 1u);
    before += __popc(b & below);
    wsum += __popc(b);
  }
  if (lane == 0) warp_cnt[warp] = wsum;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < WARPS ? warp_cnt[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane < WARPS) warp_off[lane] = incl - c;
    if (lane == WARPS - 1)
      store_status(status + tile, (tile == 0 ? INCLUSIVE : AGGREGATE) | (unsigned)incl);
  }
  __syncthreads();
  // the tile's ids at their ranks, in shared memory
  int r = warp_off[warp] + before;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if ((bits >> j) & 1u) ids_s[r++] = (int)(base + j);
  const int count = warp_off[WARPS - 1] + warp_cnt[WARPS - 1];
  if (warp == 0) {  // look-back over the predecessors, 32 at a time
    int excl = 0;
    if (tile > 0) {
      int window = tile - 1;  // lane i reads tile window - i
      while (true) {
        const int p = window - lane;
        unsigned long long s;
        do {
          s = p >= 0 ? load_status(status + p) : INCLUSIVE;
        } while (__any_sync(FULL, (s >> 32) == 0));
        const unsigned incl_lanes = __ballot_sync(FULL, (s >> 32) == 2);
        const int stop = incl_lanes ? __ffs(incl_lanes) - 1 : 31;
        int v = lane <= stop ? (int)(unsigned)(s & 0xffffffffu) : 0;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        excl += v;
        if (incl_lanes) break;
        window -= 32;
      }
      if (lane == 0)
        store_status(status + tile, INCLUSIVE | (unsigned)(excl + count));
    }
    if (lane == 0) {
      excl_s = excl;
      if ((long long)(tile + 1) * TILE >= n) {  // the last tile: the totals
        const int total = excl + count;
        aux[1] = (unsigned long long)total;
        *out_count = total < cap ? total : cap;
        *out_ovf = total > cap ? 1 : 0;
      }
    }
  }
  __syncthreads();
  const long long off = excl_s;
  for (int i = t; i < count; i += THREADS)
    if (off + i < cap) out[off + i] = ids_s[i];
}

// grid-stride from the total: one wave of blocks, each store coalesced
__global__ void fill_tail(const unsigned long long* __restrict__ aux, int cap,
                          int n, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)aux[1] + blockIdx.x * blockDim.x + threadIdx.x; p < cap;
       p += stride)
    out[p] = n;
}

}  // namespace

// mask: (n,) bytes (0/1). aux: (tiles + 2,) int64 scratch with
// tiles = max(ceil(n / 4096), 1), zeroed here on the stream. Outputs:
// out_ids (cap,) int32, out_count (1,) int32, out_ovf (1,) byte. Two kernel
// launches. Returns cudaGetLastError().
extern "C" int frontier_pack_launch(const unsigned char* mask, int n, int cap,
                                    void* aux, int* out_ids, int* out_count,
                                    unsigned char* out_ovf, void* stream) {
  if (n < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = n > 0 ? (int)(((long long)n + TILE - 1) / TILE) : 1;
  cudaError_t err = cudaMemsetAsync(aux, 0, sizeof(unsigned long long) * (tiles + 2), s);
  if (err != cudaSuccess) return (int)err;
  const int aligned = ((uintptr_t)mask % 16) == 0;
  repro::occ::note(pack_tiles, THREADS, 0);
  pack_tiles<<<tiles, THREADS, 0, s>>>(mask, n, cap, aligned,
                                       (unsigned long long*)aux, out_ids,
                                       out_count, out_ovf);
  if (cap > 0) {
    const int blocks = (cap + 255) / 256;
    repro::occ::note(fill_tail, 256, 0);
    fill_tail<<<blocks < TAIL_BLOCKS ? blocks : TAIL_BLOCKS, 256, 0, s>>>(
        (const unsigned long long*)aux, cap, n, out_ids);
  }
  return (int)cudaGetLastError();
}

REPRO_OCCUPANCY(frontier_pack)
