// ELL gather -> Compute -> Combine over one degree bucket, for Hopper.
//
// Replaces: repro/kernels/ell_spmv.py::ell_combine (Pallas `_ell_kernel`).
// For one ELL slice (nbr, wgt of shape (R, W)) and vertex metadata vals
// (n+1,), computes
//     out[r] = COMBINE_j COMPUTE(vals[nbr[r, j]], wgt[r, j])
// where a sentinel slot (nbr == n) contributes the combine identity.
// With the deletion overlay (Pallas `_ell_kernel_overlay`, the `dead=`
// argument) a slot whose int8 mask dead[r, j] is non-zero contributes the
// identity too: the same value, bit for bit, as running without the mask on
// a copy whose dead slots hold the sentinel n.
//
// Bound on the H100: bytes. Each slot holds a 4-byte neighbour id and a
// 4-byte weight; each real slot gathers one 4-byte value and does one or two
// float operations, far below the card's float32 rate. Two bounds:
//   - every slot's id and weight read once, plus vals and out: the
//     yardstick of the first kernels (337.4 M slots x 8 B at RMAT scale 22);
//   - what these inputs need once padding weights are skipped: every id,
//     the weights of the real slots only (130.5 M of the 337.4 M at RMAT
//     scale 22), plus vals and out (about 0.57 ms at 3.35 TB/s).
// The metadata vector vals is 16.8 MB at RMAT scale 22 and stays in the
// H100's 50 MB L2, so the gathers hit L2 (through __ldg); the sectors they
// move are in neither bound.
//
// Design: the paper's thread/warp/CTA trio, keyed by the slice width, with
// 16-byte loads. Where W % 4 == 0 and nbr and wgt are 16-byte aligned (dead
// 4-byte aligned) -- every slice pack_ell makes (W = 4, 32, 256) -- the
// vector variant runs: lane l of the G lanes of a row holds the four slots
// 4l .. 4l + 3 in one int4 of ids and one float4 of weights (G = p / 4 for
// a padded width p <= 128, one thread a row at p = 4, 8 lanes a row and four
// rows a warp at p = 32); at p = 256 a lane holds two vectors, slots
// 4l .. 4l + 3 and 128 + 4l .. 128 + 4l + 3. A thread issues all its id
// (and overlay) loads, then its weight loads, then its gathers. A weight is
// loaded only for a slot whose id is not the sentinel n (nor flagged dead):
// a float4 where all four slots are real, single floats where some are
// (pack_ell puts the real slots of a row first, so a row has at most one
// such vector), nothing where none is. A padding slot still enters the tree
// as the identity, so the arithmetic is that of the scalar variant.
// Other widths and unaligned views take the scalar variant of the same
// kernel: G lanes a row, lane l holding slots l + G k, one 4-byte load a
// slot.
//
// The row reduction follows EXACTLY the power-of-two halving tree of
// Combiner.reduce_axis_tree (pad to p with the identity, then pair slot k
// with slot k + p/2, k + p/4, ...):
//   vector variant: at p = 256 the first level (k, k + 128) pairs the
//     lane's two vectors; then __shfl_down_sync by G/2 .. 1 pairs slot k
//     with k + 4G/2 .. k + 4; then in-lane (k, k + 2) and (k, k + 1);
//   scalar variant: in-lane pairs k <-> k + S/2 first, then
//     __shfl_down_sync by G/2 .. 1.
// With explicit __fadd_rn/__fmul_rn (no FMA contraction) the result is
// bit-equal to the PyTorch version for sums too; `ell_combine_lanes_model`
// in kernels/ell_spmv.py folds in the vector variant's order.
// No R % 8 tiling: a block covers 256/G rows and the ragged end is masked.
// The overlay is a template flag: the kernel without it reads no mask.

#include <cuda_runtime.h>
#include <cfloat>

#include "occupancy.cuh"

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

template <int C>
constexpr bool READS_WEIGHT = C == ADD_W || C == MUL_W;

// The value a slot contributes: the identity for the sentinel (and a dead
// slot), else Compute on the gathered value.
template <int C, int K>
__device__ __forceinline__ float slot_value(int nb, bool drop, float w,
                                            const float* __restrict__ vals,
                                            int n) {
  if (nb == n || drop) return ident<K>();
  return compute<C>(__ldg(&vals[nb < n ? nb : n]), w);
}

// Scalar variant. G lanes per row, S slots per lane; G * S = next power of
// two >= W. DEAD: read the (R, W) int8 deletion mask.
template <int C, int K, int G, int S, bool DEAD>
__global__ void __launch_bounds__(THREADS)
ell_scalar(const int* __restrict__ nbr, const float* __restrict__ wgt,
           const signed char* __restrict__ dead,
           const float* __restrict__ vals, float* __restrict__ out,
           int R, int W, int n) {
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool live = row < R;
  int nb[S];
  bool drop[S];
  float w[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + G * k;
    const bool in = live && j < W;
    nb[k] = in ? __ldg(&nbr[row * W + j]) : n;
    drop[k] = DEAD && in && __ldg(&dead[row * W + j]) != 0;
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
    w[k] = READS_WEIGHT<C> && nb[k] != n && !drop[k]
               ? __ldg(&wgt[row * W + lane + G * k]) : 0.0f;
  float a[S];
#pragma unroll
  for (int k = 0; k < S; ++k) a[k] = slot_value<C, K>(nb[k], drop[k], w[k], vals, n);
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

// Vector variant (W % 4 == 0, aligned). G lanes per row, V 16-byte vectors
// per lane (V = 2 only at p = 256); 4 * G * V = p.
template <int C, int K, int G, int V, bool DEAD>
__global__ void __launch_bounds__(THREADS)
ell_vector(const int* __restrict__ nbr, const float* __restrict__ wgt,
           const signed char* __restrict__ dead,
           const float* __restrict__ vals, float* __restrict__ out,
           int R, int W, int n) {
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool live = row < R;
  int4 nb[V];
  int flags[V];
  float4 w[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {            // ids and overlay first
    const int j = v * 4 * G + 4 * lane;
    const bool in = live && j < W;
    const long long o = row * W + j;
    nb[v] = in ? __ldg(reinterpret_cast<const int4*>(nbr + o)) : make_int4(n, n, n, n);
    flags[v] = DEAD && in ? __ldg(reinterpret_cast<const int*>(dead + o)) : 0;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {            // then the real slots' weights
    w[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (READS_WEIGHT<C>) {
      const int j = v * 4 * G + 4 * lane;
      const float* p = wgt + row * W + j;
      const bool r0 = nb[v].x != n && (flags[v] & 0xff) == 0;
      const bool r1 = nb[v].y != n && (flags[v] & 0xff00) == 0;
      const bool r2 = nb[v].z != n && (flags[v] & 0xff0000) == 0;
      const bool r3 = nb[v].w != n && (flags[v] & 0xff000000) == 0;
      if (r0 && r1 && r2 && r3) {
        w[v] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        if (r0) w[v].x = __ldg(p);
        if (r1) w[v].y = __ldg(p + 1);
        if (r2) w[v].z = __ldg(p + 2);
        if (r3) w[v].w = __ldg(p + 3);
      }
    }
  }
  float a[V][4];                           // then the gathers
#pragma unroll
  for (int v = 0; v < V; ++v) {
    a[v][0] = slot_value<C, K>(nb[v].x, (flags[v] & 0xff) != 0, w[v].x, vals, n);
    a[v][1] = slot_value<C, K>(nb[v].y, (flags[v] & 0xff00) != 0, w[v].y, vals, n);
    a[v][2] = slot_value<C, K>(nb[v].z, (flags[v] & 0xff0000) != 0, w[v].z, vals, n);
    a[v][3] = slot_value<C, K>(nb[v].w, (flags[v] & 0xff000000) != 0, w[v].w, vals, n);
  }
  if (V == 2) {                            // level p/2 = 128: in-lane
#pragma unroll
    for (int i = 0; i < 4; ++i) a[0][i] = pair<K>(a[0][i], a[V - 1][i]);
  }
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2) {   // slot k with k + 4 off
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[0][i] = pair<K>(a[0][i], __shfl_down_sync(0xffffffffu, a[0][i], off, G));
  }
  const float r = pair<K>(pair<K>(a[0][0], a[0][2]), pair<K>(a[0][1], a[0][3]));
  if (live && lane == 0) out[row] = r;
}

struct Args {
  const int* nbr;
  const float* wgt;
  const signed char* dead;  // nullptr: no overlay
  const float* vals;
  float* out;
  int R, W, n;
  cudaStream_t stream;
};

template <int G>
unsigned grid_of(int R) {
  constexpr int rows_per_block = THREADS / G;
  return (unsigned)((R + rows_per_block - 1) / rows_per_block);
}

template <int C, int K, int G, int S>
cudaError_t launch_scalar(const Args& a) {
  auto kern = a.dead ? ell_scalar<C, K, G, S, true> : ell_scalar<C, K, G, S, false>;
  repro::occ::note(kern, THREADS, 0);
  kern<<<grid_of<G>(a.R), THREADS, 0, a.stream>>>(a.nbr, a.wgt, a.dead, a.vals, a.out, a.R,
                                                   a.W, a.n);
  return cudaGetLastError();
}

template <int C, int K, int G, int V>
cudaError_t launch_vector(const Args& a) {
  auto kern = a.dead ? ell_vector<C, K, G, V, true> : ell_vector<C, K, G, V, false>;
  repro::occ::note(kern, THREADS, 0);
  kern<<<grid_of<G>(a.R), THREADS, 0, a.stream>>>(a.nbr, a.wgt, a.dead, a.vals, a.out, a.R,
                                                   a.W, a.n);
  return cudaGetLastError();
}

template <int C, int K>
cudaError_t by_width(const Args& a, bool vec) {
  int p = 1;
  while (p < a.W) p <<= 1;
  if (vec) {
    switch (p) {
      case 4: return launch_vector<C, K, 1, 1>(a);
      case 8: return launch_vector<C, K, 2, 1>(a);
      case 16: return launch_vector<C, K, 4, 1>(a);
      case 32: return launch_vector<C, K, 8, 1>(a);
      case 64: return launch_vector<C, K, 16, 1>(a);
      case 128: return launch_vector<C, K, 32, 1>(a);
      case 256: return launch_vector<C, K, 32, 2>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (p) {
    case 1: return launch_scalar<C, K, 1, 1>(a);
    case 2: return launch_scalar<C, K, 1, 2>(a);
    case 4: return launch_scalar<C, K, 1, 4>(a);
    case 8: return launch_scalar<C, K, 8, 1>(a);
    case 16: return launch_scalar<C, K, 16, 1>(a);
    case 32: return launch_scalar<C, K, 32, 1>(a);
    case 64: return launch_scalar<C, K, 32, 2>(a);
    case 128: return launch_scalar<C, K, 32, 4>(a);
    case 256: return launch_scalar<C, K, 32, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t by_combine(int combine, const Args& a, bool vec) {
  switch (combine) {
    case MIN: return by_width<C, MIN>(a, vec);
    case MAX: return by_width<C, MAX>(a, vec);
    case SUM: return by_width<C, SUM>(a, vec);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `dead` is the (R, W) int8 deletion overlay, or null for none. `vector`
// asks for the 16-byte variant (the wrapper's `vector_layout` decides); it
// is refused unless W % 4 == 0 and the pointers are aligned for it.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ell_combine_launch(const int* nbr, const float* wgt,
                                  const signed char* dead, const float* vals,
                                  float* out, int R, int W, int n,
                                  int compute_op, int combine_op, int vector,
                                  void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || W > 256) return (int)cudaErrorInvalidValue;
  const bool vec = vector != 0;
  if (vec && (W % 4 != 0 || reinterpret_cast<size_t>(nbr) % 16 != 0 ||
              reinterpret_cast<size_t>(wgt) % 16 != 0 ||
              reinterpret_cast<size_t>(dead) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{nbr, wgt, dead, vals, out, R, W, n, (cudaStream_t)stream};
  switch (compute_op) {
    case HOP: return (int)by_combine<HOP>(combine_op, a, vec);
    case ADD_W: return (int)by_combine<ADD_W>(combine_op, a, vec);
    case COPY: return (int)by_combine<COPY>(combine_op, a, vec);
    case MUL_W: return (int)by_combine<MUL_W>(combine_op, a, vec);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_OCCUPANCY(ell_combine)
