// Ballot-filter stream compaction (paper Fig. 6b), for Hopper.
//
// Replaces: repro/kernels/frontier_pack.py::frontier_pack (Pallas
// `_pack_kernel`) together with its XLA epilogue `concat_blocks`. From a
// dense (n,) bool mask it produces the sorted, unique frontier: the ids of the
// set lanes in a (cap,) buffer padded with the sentinel n, the count
// min(total, cap) and the overflow flag total > cap — bit-equal to
// core.frontier.compact_mask.
//
// Bound on the H100: bytes. The pass reads the n mask bytes once and writes
// at most cap ids; the block ids are a 4n-byte round trip through L2 /
// device memory. Work per lane is one ballot share and one popcount.
//
// Design: what the TPU imitated with a prefix sum is native here.
//   pass 1: blocks of 1024 lanes; each warp takes __ballot_sync of its 32
//           lanes and ranks a set lane by __popc of the lanes below it; warp 0
//           scans the 32 warp counts in shared memory; each block writes its
//           compacted global ids (sentinel-padded) and its count.
//   pass 2: one block scans the per-block counts (exclusive), writes the
//           total, the count and the overflow flag — they stay on the device.
//   pass 3: each block copies its ids to offset + rank when that is < cap;
//           positions >= total are filled with the sentinel.
// A ragged last block (n % 1024 != 0) reads its missing lanes as unset.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(BLOCK)
pack_blocks(const unsigned char* __restrict__ mask, int n,
            int* __restrict__ block_ids, int* __restrict__ block_cnt) {
  __shared__ int warp_cnt[32];
  __shared__ int warp_off[32];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long i = (long long)blockIdx.x * BLOCK + t;
  const bool m = i < n && mask[i] != 0;
  const unsigned ballot = __ballot_sync(FULL, m);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = warp_cnt[lane];
    const int incl = warp_incl_scan(c, lane);
    warp_off[lane] = incl - c;
    if (lane == 31) block_cnt[blockIdx.x] = incl;
  }
  __syncthreads();
  const int total = warp_off[31] + warp_cnt[31];
  int* row = block_ids + (long long)blockIdx.x * BLOCK;
  if (m) row[warp_off[warp] + rank] = (int)i;
  if (t >= total) row[t] = n;
}

// One block: exclusive scan of nb block counts into off[0..nb), total in
// off[nb]; count = min(total, cap), overflow = total > cap.
__global__ void __launch_bounds__(BLOCK)
scan_blocks(const int* __restrict__ cnt, int nb, int* __restrict__ off,
            int cap, int* __restrict__ out_count,
            unsigned char* __restrict__ out_ovf) {
  __shared__ int warp_sum[32];
  __shared__ int carry_s;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int carry = 0;
  for (int base = 0; base < nb; base += BLOCK) {
    const int i = base + t;
    const int c = i < nb ? cnt[i] : 0;
    const int incl = warp_incl_scan(c, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int s = warp_sum[lane];
      warp_sum[lane] = warp_incl_scan(s, lane) - s;
    }
    __syncthreads();
    if (i < nb) off[i] = carry + warp_sum[warp] + incl - c;
    if (t == BLOCK - 1) carry_s = carry + warp_sum[31] + incl;
    __syncthreads();
    carry = carry_s;
    __syncthreads();
  }
  if (t == 0) {
    off[nb] = carry;
    *out_count = carry < cap ? carry : cap;
    *out_ovf = carry > cap ? 1 : 0;
  }
}

__global__ void __launch_bounds__(BLOCK)
scatter_ids(const int* __restrict__ block_ids, const int* __restrict__ cnt,
            const int* __restrict__ off, int cap, int* __restrict__ out) {
  const int b = blockIdx.x, t = threadIdx.x;
  const int dst = off[b] + t;
  if (t < cnt[b] && dst < cap) out[dst] = block_ids[(long long)b * BLOCK + t];
}

__global__ void fill_tail(const int* __restrict__ total, int cap, int n,
                          int* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < cap && p >= *total) out[p] = n;
}

}  // namespace

// mask: (n,) bytes (0/1). Scratch: block_ids (nb*1024,), block_cnt (nb,),
// block_off (nb+1,) int32 with nb = ceil(n / 1024). Outputs: out_ids (cap,)
// int32, out_count (1,) int32, out_ovf (1,) byte. Returns cudaGetLastError().
extern "C" int frontier_pack_launch(const unsigned char* mask, int n, int cap,
                                    int* block_ids, int* block_cnt,
                                    int* block_off, int* out_ids,
                                    int* out_count, unsigned char* out_ovf,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (n + BLOCK - 1) / BLOCK;
  if (nb > 0) pack_blocks<<<nb, BLOCK, 0, s>>>(mask, n, block_ids, block_cnt);
  scan_blocks<<<1, BLOCK, 0, s>>>(block_cnt, nb, block_off, cap, out_count,
                                  out_ovf);
  if (nb > 0 && cap > 0)
    scatter_ids<<<nb, BLOCK, 0, s>>>(block_ids, block_cnt, block_off, cap,
                                     out_ids);
  if (cap > 0)
    fill_tail<<<(cap + 255) / 256, 256, 0, s>>>(block_off + nb, cap, n,
                                                 out_ids);
  return (int)cudaGetLastError();
}
