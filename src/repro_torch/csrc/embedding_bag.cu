// EmbeddingBag (multi-hot gather + reduce), for Hopper.
//
// Replaces: repro/kernels/embedding_bag.py::embedding_bag (Pallas
// `_bag_kernel`). For a float32 table T (V, D) and bags idx (B, K) int32,
//     out[b, :] = SUM_k T[idx[b, k], :]      (mode sum)
//               = that sum / K               (mode mean)
//               = MAX_k T[idx[b, k], :]      (mode max)
// as `repro.kernels.ref.embedding_bag_ref` (torch.nn.EmbeddingBag) defines
// them; the Pallas kernel returned the sum for mode max. Indices are
// clamped to [0, V), as a JAX gather clamps.
//
// Bound on the H100: bytes. Each (b, k) gathers one D-wide row and does D
// adds on it; the least traffic reads each distinct row once, plus idx and
// out. DeepFM's table (3.9 M rows x 10 floats, 156 MB) does not fit the
// 50 MB L2, and its rows are 40 B, so each gather pulls a 32 B sector or
// two for 40 useful bytes.
//
// Design: the TPU version DMA'd one table row per (b, k) grid step, chosen
// by a scalar-prefetched index. Here a group of G lanes reduces one bag,
// lanes over D, as `repro::by_lane_group` (lane_group.cuh) maps them: 16
// lanes for DeepFM's D = 10, so 10 of 16 lanes work instead of 10 of 32.
// The G lanes load G of the bag's indices at once (coalesced) and broadcast
// each with __shfl_sync; the bag's rows are folded in order k = 0..K-1.

#include <math.h>

#include "lane_group.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

enum Mode { SUM = 0, MEAN = 1, MAX = 2 };

template <int M, int G, int CH>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const float* __restrict__ table, const int* __restrict__ idx,
           float* __restrict__ out, int B, int K, int D, int V) {
  const int lane = threadIdx.x % G;
  const long long bag =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool live = bag < B;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = (M == MAX) ? -INFINITY : 0.0f;
  for (int k0 = 0; k0 < K; k0 += G) {
    int i_l = 0;
    if (live && k0 + lane < K) {
      i_l = idx[bag * K + k0 + lane];
      i_l = min(max(i_l, 0), V - 1);
    }
    const int cnt = min(G, K - k0);
    for (int t = 0; t < cnt; ++t) {
      const int i = __shfl_sync(FULL, i_l, t, G);
      if (live) {
        const float* row = table + (long long)i * D;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int col = lane + G * c;
          if (col < D) {
            const float x = row[col];
            acc[c] = (M == MAX) ? fmaxf(acc[c], x) : __fadd_rn(acc[c], x);
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = lane + G * c;
    if (col < D)
      out[bag * D + col] = (M == MEAN) ? __fdiv_rn(acc[c], (float)K) : acc[c];
  }
}

template <int M, int G, int CH>
cudaError_t go(const float* table, const int* idx, float* out, int B, int K,
               int D, int V, cudaStream_t s) {
  const int per_block = THREADS / G;
  const long long grid = ((long long)B + per_block - 1) / per_block;
  bag_kernel<M, G, CH><<<(unsigned)grid, THREADS, 0, s>>>(table, idx, out, B,
                                                          K, D, V);
  return cudaGetLastError();
}

template <int M>
cudaError_t by_width(const float* table, const int* idx, float* out, int B,
                     int K, int D, int V, cudaStream_t s) {
  return repro::by_lane_group(D, [&](auto g, auto ch) {
    return go<M, decltype(g)::value, decltype(ch)::value>(table, idx, out, B,
                                                          K, D, V, s);
  });
}

}  // namespace

// table (V, D) f32, idx (B, K) int32, out (B, D) f32; mode 0 = sum,
// 1 = mean, 2 = max. 1 <= D <= 256, K >= 1, V >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    float* out, int B, int K, int D, int V,
                                    int mode, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || V < 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SUM: return (int)by_width<SUM>(table, idx, out, B, K, D, V, s);
    case MEAN: return (int)by_width<MEAN>(table, idx, out, B, K, D, V, s);
    case MAX: return (int)by_width<MAX>(table, idx, out, B, K, D, V, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
