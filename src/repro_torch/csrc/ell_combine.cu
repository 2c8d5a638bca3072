// ELL gather -> Compute -> Combine over one degree bucket, for Hopper.
//
// Replaces: repro/kernels/ell_spmv.py::ell_combine (Pallas `_ell_kernel`).
// For one ELL slice (nbr, wgt of shape (R, W)) and vertex metadata vals
// (n+1,), computes
//     out[r] = COMBINE_j COMPUTE(vals[nbr[r, j]], wgt[r, j])
// where a sentinel slot (nbr == n) contributes the combine identity.
//
// Bound on the H100: bytes. Each slot reads a 4-byte neighbour id (and a
// 4-byte weight for the ops that read it) once, gathers one 4-byte value and
// does one or two float operations, far below the card's float32 rate. The
// metadata vector is 16.8 MB at RMAT scale 22 and stays in the H100's 50 MB
// L2, so the gathers hit L2 (read through __ldg); the streams of nbr/wgt
// from device memory are the floor.
//
// Design: the paper's thread/warp/CTA trio, keyed by the slice width.
// A width <= 4 row is reduced by one thread (G = 1 lane per row); a row of
// width 8..32 by G = W lanes of a warp; a row of width 64..256 by a full warp
// whose lane l holds slots l + 32k. Neighbouring lanes read neighbouring
// slots, so the nbr/wgt streams are coalesced. The row reduction follows
// EXACTLY the power-of-two halving tree of Combiner.reduce_axis_tree (pad
// to p = next power of two with the identity, then pair slot k with slot
// k + p/2, ...): in-lane pairs k <-> k + S/2 first, then __shfl_down_sync
// with offsets G/2 .. 1. With explicit __fadd_rn/__fmul_rn (no FMA
// contraction) the result is bit-equal to the PyTorch version for sums too.
// No R % 8 tiling: a block covers 256/G rows and the ragged end is masked.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr float BIG = FLT_MAX / 4.0f;  // the ACC identity magnitude f32max/4
constexpr int THREADS = 256;

enum Compute { HOP = 0, ADD_W = 1, COPY = 2, MUL_W = 3 };
enum Combine { MIN = 0, MAX = 1, SUM = 2 };

template <int C>
__device__ __forceinline__ float compute(float v, float w) {
  if (C == HOP) return v < BIG ? __fadd_rn(v, 1.0f) : BIG;
  if (C == ADD_W) return v < BIG ? __fadd_rn(v, w) : BIG;
  if (C == COPY) return v;
  return __fmul_rn(v, w);  // MUL_W
}

template <int K>
__device__ __forceinline__ float ident() {
  if (K == MIN) return BIG;
  if (K == MAX) return -BIG;
  return 0.0f;
}

template <int K>
__device__ __forceinline__ float pair(float a, float b) {
  if (K == MIN) return fminf(a, b);
  if (K == MAX) return fmaxf(a, b);
  return __fadd_rn(a, b);
}

// G lanes per row, S slots per lane; G * S = next power of two >= W.
template <int C, int K, int G, int S>
__global__ void __launch_bounds__(THREADS)
ell_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
           const float* __restrict__ vals, float* __restrict__ out,
           int R, int W, int n) {
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool live = row < R;
  float a[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + G * k;
    float v = ident<K>();
    if (live && j < W) {
      const long long o = row * W + j;
      const int nb = nbr[o];
      const float x = __ldg(&vals[nb < n ? nb : n]);
      const float u = compute<C>(x, (C == ADD_W || C == MUL_W) ? wgt[o] : 0.0f);
      v = (nb == n) ? ident<K>() : u;
    }
    a[k] = v;
  }
#pragma unroll
  for (int h = S / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int k = 0; k < h; ++k) a[k] = pair<K>(a[k], a[k + h]);
  }
  float r = a[0];
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
    r = pair<K>(r, __shfl_down_sync(0xffffffffu, r, off, G));
  if (live && lane == 0) out[row] = r;
}

template <int C, int K, int G, int S>
cudaError_t go(const int* nbr, const float* wgt, const float* vals, float* out,
               int R, int W, int n, cudaStream_t stream) {
  const int rows_per_block = THREADS / G;
  const int grid = (R + rows_per_block - 1) / rows_per_block;
  ell_kernel<C, K, G, S><<<grid, THREADS, 0, stream>>>(nbr, wgt, vals, out, R,
                                                       W, n);
  return cudaGetLastError();
}

template <int C, int K>
cudaError_t by_width(const int* nbr, const float* wgt, const float* vals,
                     float* out, int R, int W, int n, cudaStream_t s) {
  int p = 1;
  while (p < W) p <<= 1;
  switch (p) {
    case 1: return go<C, K, 1, 1>(nbr, wgt, vals, out, R, W, n, s);
    case 2: return go<C, K, 1, 2>(nbr, wgt, vals, out, R, W, n, s);
    case 4: return go<C, K, 1, 4>(nbr, wgt, vals, out, R, W, n, s);
    case 8: return go<C, K, 8, 1>(nbr, wgt, vals, out, R, W, n, s);
    case 16: return go<C, K, 16, 1>(nbr, wgt, vals, out, R, W, n, s);
    case 32: return go<C, K, 32, 1>(nbr, wgt, vals, out, R, W, n, s);
    case 64: return go<C, K, 32, 2>(nbr, wgt, vals, out, R, W, n, s);
    case 128: return go<C, K, 32, 4>(nbr, wgt, vals, out, R, W, n, s);
    case 256: return go<C, K, 32, 8>(nbr, wgt, vals, out, R, W, n, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t by_combine(int combine, const int* nbr, const float* wgt,
                       const float* vals, float* out, int R, int W, int n,
                       cudaStream_t s) {
  switch (combine) {
    case MIN: return by_width<C, MIN>(nbr, wgt, vals, out, R, W, n, s);
    case MAX: return by_width<C, MAX>(nbr, wgt, vals, out, R, W, n, s);
    case SUM: return by_width<C, SUM>(nbr, wgt, vals, out, R, W, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ell_combine_launch(const int* nbr, const float* wgt,
                                  const float* vals, float* out, int R, int W,
                                  int n, int compute_op, int combine_op,
                                  void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || W > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (compute_op) {
    case HOP: return (int)by_combine<HOP>(combine_op, nbr, wgt, vals, out, R, W, n, s);
    case ADD_W: return (int)by_combine<ADD_W>(combine_op, nbr, wgt, vals, out, R, W, n, s);
    case COPY: return (int)by_combine<COPY>(combine_op, nbr, wgt, vals, out, R, W, n, s);
    case MUL_W: return (int)by_combine<MUL_W>(combine_op, nbr, wgt, vals, out, R, W, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
