// EmbeddingBag (multi-hot gather + reduce), for Hopper.
//
// Replaces: repro/kernels/embedding_bag.py::embedding_bag (Pallas
// `_bag_kernel`). For a float32 table T (V, D) and bags idx (B, K) int32,
//     out[b, :] = SUM_k T[idx[b, k], :]      (mode sum)
//               = that sum / K               (mode mean)
//               = MAX_k T[idx[b, k], :]      (mode max; NaN propagates)
// as `repro.kernels.ref.embedding_bag_ref` (torch.nn.EmbeddingBag) defines
// them; the Pallas kernel returned the sum for mode max. An index in
// [-V, -1] wraps to idx + V, then every index is clamped to [0, V - 1], as
// a JAX gather clamps (`table[idx]` in ref.py).
//
// Bound on the H100: bytes. Each (b, k) gathers one D-wide row and does D
// adds on it; the least traffic reads each distinct row once, plus idx and
// out. DeepFM's table (3.9 M rows x 10 floats, 156 MB) does not fit the
// 50 MB L2, and its rows are 40 B starting at 40 i: every row touches two
// 32-byte sectors, 64 B moved for 40 used. Measured (PERF.md): at large
// batches device memory's rate for such random rows sets the time, for
// every layout tried; at small ones, the latency of a bag's dependent
// loads, which this design cuts to one trip for ids and one for rows.
//
// Design: the TPU version DMA'd one table row per (b, k) grid step, chosen
// by a scalar-prefetched index. Here a warp takes one bag (or several, when
// K rows need fewer lanes than a warp has) and spreads its K x D values over
// the lanes: lanes over a row in 16-byte pieces where D % 4 == 0 (and the
// table is 16-byte aligned), 8-byte ones where D is even, else 4-byte ones;
// min(pieces, 32) lanes a row, so G = min(32 / lanes, K) rows at once (D =
// 10: 5 lanes a row, 6 rows a warp-wide load, 7 loads a lane for K = 39).
// Each lane reads its rows' ids, then issues up to 8 gathers before the
// first add. Group g folds rows g, g + G, ... left to right from the
// identity; a halving tree of shuffles over the G groups (padded with the
// identity to a power of two) finishes the bag. That order is fixed, so a
// sum is the same from run to run and bit-equal to
// `kernels/embedding_bag.py::embedding_bag_ordered`, which models it.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int THREADS = 128;
constexpr int LOADS = 8;      // gathers in flight a lane: rows x pieces a row

enum Mode { SUM = 0, MEAN = 1, MAX = 2 };

template <int VW>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// acc (op) x; the identity leaves acc's bits as they are (a sum from +0
// never holds -0), and max keeps a NaN once it has one, as amax does.
template <int M>
__device__ __forceinline__ float fold(float acc, float x) {
  if constexpr (M == MAX) return (x > acc || x != x) ? x : acc;
  else return __fadd_rn(acc, x);
}

// VW floats a load, CH loads a row a lane (lanes over the row: L), G rows
// at once, WARP / (G * L) bags a warp.
template <int M, int VW, int CH>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const float* __restrict__ table, const int* __restrict__ idx,
           float* __restrict__ out, int B, int K, int D, int V, int L, int G) {
  constexpr int U = LOADS / CH > 0 ? LOADS / CH : 1;     // rows a round, >= 1
  const float ident = (M == MAX) ? -INFINITY : 0.0f;
  const int lane = threadIdx.x % WARP;
  const int span = G * L;
  const int per_warp = WARP / span;
  const int slot = lane / span;
  const int g = (lane - slot * span) / L;
  const int c = lane - slot * span - g * L;
  const long long bag =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / WARP * per_warp + slot;
  const bool live = slot < per_warp && bag < B;
  const int pieces = D / VW;
  const int* bag_idx = idx + (live ? bag : 0) * K;
  const int n = live ? (K - g + G - 1) / G : 0;          // rows g, g + G, ...
  float acc[CH][VW];
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[h][e] = ident;
  for (int j0 = 0; j0 < n; j0 += U) {
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = -1;
      if (j0 + u < n) {
        int i = __ldg(bag_idx + g + G * (j0 + u));
        i = i < 0 ? i + V : i;
        row[u] = min(max(i, 0), V - 1);
      }
    }
    float x[U][CH][VW];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int p = c + L * h;
#pragma unroll
        for (int e = 0; e < VW; ++e) x[u][h][e] = ident;
        if (row[u] >= 0 && p < pieces)
          load<VW>(table + (long long)row[u] * D + p * VW, x[u][h]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[h][e] = fold<M>(acc[h][e], x[u][h][e]);
  }
  int width = 1;
  while (width < G) width <<= 1;
  for (int s = width >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float o = __shfl_down_sync(FULL, acc[h][e], s * L);
        acc[h][e] = fold<M>(acc[h][e], g + s < G ? o : ident);
      }
  }
  if (!live || g != 0) return;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int p = c + L * h;
    if (p < pieces) {
      if constexpr (M == MEAN) {
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[h][e] = __fdiv_rn(acc[h][e], (float)K);
      }
      store<VW>(out + bag * D + p * VW, acc[h]);
    }
  }
}

template <int M, int VW, int CH>
cudaError_t go(const float* table, const int* idx, float* out, int B, int K,
               int D, int V, cudaStream_t s) {
  const int lanes = D / VW < WARP ? D / VW : WARP;
  const int groups = WARP / lanes < K ? WARP / lanes : K;
  const int per_warp = WARP / (groups * lanes);
  const long long warps = ((long long)B + per_warp - 1) / per_warp;
  const long long grid = (warps * WARP + THREADS - 1) / THREADS;
  repro::occ::note(bag_kernel<M, VW, CH>, THREADS, 0);
  bag_kernel<M, VW, CH><<<(unsigned)grid, THREADS, 0, s>>>(
      table, idx, out, B, K, D, V, lanes, groups);
  return cudaGetLastError();
}

// CH = loads a row a lane, rounded up to 1, 2, 4 or 8.
template <int M, int VW>
cudaError_t by_pieces(const float* table, const int* idx, float* out, int B,
                      int K, int D, int V, cudaStream_t s) {
  const int ch = (D / VW + WARP - 1) / WARP;
  if (ch <= 1) return go<M, VW, 1>(table, idx, out, B, K, D, V, s);
  if (ch <= 2) return go<M, VW, 2>(table, idx, out, B, K, D, V, s);
  if constexpr (VW <= 2) {
    if (ch <= 4) return go<M, VW, 4>(table, idx, out, B, K, D, V, s);
  }
  if constexpr (VW == 1) {
    if (ch <= 8) return go<M, VW, 8>(table, idx, out, B, K, D, V, s);
  }
  return cudaErrorInvalidValue;
}

// The widest load that D and the alignment of table and out allow (the
// wrapper allocates out, so the table decides; `bag_layout` models this).
template <int M>
cudaError_t by_width(const float* table, const int* idx, float* out, int B,
                     int K, int D, int V, cudaStream_t s) {
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out;
  if (D % 4 == 0 && a % 16 == 0) return by_pieces<M, 4>(table, idx, out, B, K, D, V, s);
  if (D % 2 == 0 && a % 8 == 0) return by_pieces<M, 2>(table, idx, out, B, K, D, V, s);
  return by_pieces<M, 1>(table, idx, out, B, K, D, V, s);
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

REPRO_OCCUPANCY(embedding_bag)
