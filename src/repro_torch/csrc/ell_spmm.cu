// ELL SpMM (GNN aggregation) over one degree bucket, for Hopper.
//
// Replaces: repro/kernels/ell_spmv.py::ell_spmm (Pallas `_spmm_kernel`).
// For one ELL slice (nbr, wgt of shape (R, W)) and features F (n+1, D),
//     out[r, :] = SUM_j w'[r, j] * F[nbr[r, j], :]
// where w' is 0 on sentinel slots (nbr == n). Accumulation is in float32;
// the output has F's type (float32 or bfloat16, rounded to nearest even).
//
// Bound on the H100: bytes. Each live slot gathers one D-wide feature row
// (256 B at D = 64 in float32) and does 2*D flops on it — a quarter of a
// flop per byte, far below the float32 rate. The features (1 GB at RMAT
// scale 22 and D = 64) do not fit the 50 MB L2, so the row gathers from
// device memory are the floor; the least traffic reads each needed row once.
//
// Design: a group of G lanes per row, lanes over D (`repro::by_lane_group`
// in lane_group.cuh: G = 32 for D > 16, else the next power of two >= D;
// lane l holds columns l + G*c, c < CH <= 8, so gatedgcn's D = 70 works
// too). The G lanes load G slots of nbr/wgt at
// once (coalesced) and broadcast each slot with __shfl_sync; slots are
// summed in order j = 0..W-1 with fmaf. Sentinel slots are skipped instead
// of multiplied by 0, which is the same sum as long as F's row n is finite
// (the reference keeps it zero). No R % 8 tiling: the ragged end is masked.

#include "lane_group.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

template <typename T, int G, int CH>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
            const T* __restrict__ feats, T* __restrict__ out, int R, int W,
            int D, int n) {
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool live = row < R;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  // every lane runs the same trip counts (W is the slice's), so the
  // shuffles below see the whole warp even on masked rows
  for (int j0 = 0; j0 < W; j0 += G) {
    int nb_l = n;
    float w_l = 0.0f;
    if (live && j0 + lane < W) {
      nb_l = nbr[row * W + j0 + lane];
      w_l = wgt[row * W + j0 + lane];
    }
    const int cnt = min(G, W - j0);
    for (int t = 0; t < cnt; ++t) {
      const int nb = __shfl_sync(FULL, nb_l, t, G);
      const float w = __shfl_sync(FULL, w_l, t, G);
      if (nb >= 0 && nb < n) {
        const T* f = feats + (long long)nb * D;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int col = lane + G * c;
          if (col < D) acc[c] = fmaf(w, to_f32(f[col]), acc[c]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = lane + G * c;
    if (col < D) out[row * D + col] = from_f32<T>(acc[c]);
  }
}

template <typename T, int G, int CH>
cudaError_t go(const int* nbr, const float* wgt, const void* feats, void* out,
               int R, int W, int D, int n, cudaStream_t s) {
  const int rows_per_block = THREADS / G;
  const long long grid = ((long long)R + rows_per_block - 1) / rows_per_block;
  spmm_kernel<T, G, CH><<<(unsigned)grid, THREADS, 0, s>>>(
      nbr, wgt, (const T*)feats, (T*)out, R, W, D, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const int* nbr, const float* wgt, const void* feats,
                     void* out, int R, int W, int D, int n, cudaStream_t s) {
  return repro::by_lane_group(D, [&](auto g, auto ch) {
    return go<T, decltype(g)::value, decltype(ch)::value>(nbr, wgt, feats, out,
                                                          R, W, D, n, s);
  });
}

}  // namespace

// nbr (R, W) int32, wgt (R, W) f32, feats (n+1, D) and out (R, D) of one
// type: dtype 0 = float32, 1 = bfloat16. 1 <= W <= 256, 1 <= D <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ell_spmm_launch(const int* nbr, const float* wgt,
                               const void* feats, void* out, int R, int W,
                               int D, int n, int dtype, void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || W > 256 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)by_width<float>(nbr, wgt, feats, out, R, W, D, n, s);
    case 1: return (int)by_width<__nv_bfloat16>(nbr, wgt, feats, out, R, W, D, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
