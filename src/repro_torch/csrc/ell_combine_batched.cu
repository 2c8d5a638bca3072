// Q-wide ELL gather -> Compute -> Combine over one degree bucket, for Hopper.
//
// Replaces: the XLA expression of the batched engine's dense pull,
// repro/serving/batch_engine.py:222 (`_slice_partial_dense`), which has no
// Pallas kernel: it builds an (R, W, Q) gather and reduces it with
// `reduce_axis_tree`. For one ELL slice (nbr, wgt of shape (R, W)) and
// vertex-major metadata vals (n+1, Q), float32 row-major, computes
//     out[r, q] = TREE_j COMPUTE(vals[nbr[r, j], q], wgt[r, j])
// where a sentinel slot (nbr == n) enters the tree as the combine identity
// and TREE is exactly `halving_tree` over W (pad to p, a power of two, with
// the identity, then pair slot k with k + p/2, k + p/4, ...). At Q = 1 it
// is the 1-D `ell_combine`, bit for bit.
//
// Bound on the H100: bytes. Every id is read once, a weight only for a
// real slot, then one contiguous Q-vector of vals (4Q bytes) for each real
// slot, and the (R, Q) output is written: at RMAT scale 22 and Q = 64 that
// is 130.5 M x 256 bytes of gathers, about 10 ms at 3.35 TB/s. At Q = 64
// vals is 1.07 GB, far beyond the 50 MB L2, so the gathers come from
// device memory; at Q = 8, 134 MB, L2 holds a part of it.
//
// Design: one index stream serves the Q queries. G lanes a row run over
// the columns, each lane holding V = 4 of them (a float4 load a gathered
// row, 16 bytes, where Q % 4 == 0 and vals and out are 16-byte aligned) or
// one (the scalar variant for other Q and unaligned views); G is the
// power of two >= ceil(Q / V), at most 32, and a lane folds columns c,
// c + 4G, ... in turn where Q > 128. Each lane folds its columns over the
// row's W slots itself, so no shuffle and no (W,) buffer is needed: it
// visits the padded slots in bit-reversed order (p = 8: 0, 4, 2, 6, 1, 5,
// 3, 7) and merges like a binary counter, which builds exactly the halving
// tree, left operand the lower slot, with log2(p) live partials. Slots
// come 8 at a time: their ids first, then the real slots' weights, then 8
// gathers in flight, then a tree over the 8 and one step of the counter.
// A padding slot (j >= W or nbr == n) loads nothing and enters the tree as
// the identity, as in the 1-D kernel; with explicit __fadd_rn/__fmul_rn no
// FMA is contracted, so sums are bit-equal to the PyTorch version.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr float BIG = FLT_MAX / 4.0f;  // the ACC identity magnitude f32max/4
constexpr int THREADS = 256;
constexpr int MAX_UP = 5;              // counter levels above a chunk (p = 256)

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

// V columns of one lane.
template <int V>
struct Cols {
  float x[V];
};

template <int K, int V>
__device__ __forceinline__ Cols<V> pair_cols(const Cols<V>& a, const Cols<V>& b) {
  Cols<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = pair<K>(a.x[i], b.x[i]);
  return r;
}

template <int K, int V>
__device__ __forceinline__ Cols<V> ident_cols() {
  Cols<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = ident<K>();
  return r;
}

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* __restrict__ p) {
  Cols<V> r;
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x[0] = v.x;
    r.x[1] = v.y;
    r.x[2] = v.z;
    r.x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.x[i] = __ldg(p + i);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ p, const Cols<V>& c) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(c.x[0], c.x[1], c.x[2], c.x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = c.x[i];
  }
}

// Slot of position t in the bit-reversed visiting order of p = 2^logp.
__device__ __forceinline__ int slot_of(int t, int logp) {
  return logp == 0 ? 0 : (int)(__brev((unsigned)t) >> (32 - logp));
}

// CH = 2^LOGCH positions a chunk (8, or p where p < 8); `logp` >= LOGCH.
template <int C, int K, int V, int LOGCH>
__global__ void __launch_bounds__(THREADS)
ell_batched(const int* __restrict__ nbr, const float* __restrict__ wgt,
            const float* __restrict__ vals, float* __restrict__ out,
            int R, int W, int n, int Q, int G, int logp) {
  constexpr int CH = 1 << LOGCH;
  const int lane = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  if (row >= R) return;
  const int* nrow = nbr + row * W;
  const float* wrow = wgt + row * W;
  const int up = logp - LOGCH;             // counter levels above a chunk
  const int chunks = 1 << up;
  for (int c = lane * V; c < Q; c += G * V) {
    Cols<V> st[MAX_UP + 1];
#pragma unroll
    for (int l = 0; l <= MAX_UP; ++l) st[l] = ident_cols<K, V>();
    for (int h = 0; h < chunks; ++h) {
      int nb[CH], slot[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {       // ids first
        slot[i] = slot_of(h * CH + i, logp);
        nb[i] = slot[i] < W ? __ldg(nrow + slot[i]) : n;
      }
      float w[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)         // then the real slots' weights
        w[i] = READS_WEIGHT<C> && nb[i] != n ? __ldg(wrow + slot[i]) : 0.0f;
      Cols<V> x[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {       // then the gathers
        if (nb[i] == n) {
          x[i] = ident_cols<K, V>();
        } else {
          const long long v = nb[i] < n ? nb[i] : n;
          x[i] = load_cols<V>(vals + v * Q + c);
        }
      }
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (nb[i] != n) {
#pragma unroll
          for (int k = 0; k < V; ++k) x[i].x[k] = compute<C>(x[i].x[k], w[i]);
        }
      // the chunk's subtree: positions (0, 1), (0, 2), (0, 4)
#pragma unroll
      for (int s = 1; s < CH; s <<= 1)
#pragma unroll
        for (int i = 0; i < CH; i += 2 * s) x[i] = pair_cols<K, V>(x[i], x[i + s]);
      // one step of the counter: merge with the stored partial of each level
      // whose bit of h is set, store at the first level whose bit is clear
      Cols<V> y = x[0];
      bool carry = true;
#pragma unroll
      for (int l = 0; l < MAX_UP; ++l) {
        if (carry && l < up) {
          if ((h >> l) & 1) {
            y = pair_cols<K, V>(st[l], y);
          } else {
            st[l] = y;
            carry = false;
          }
        }
      }
      if (carry) st[MAX_UP] = y;
    }
    store_cols<V>(out + row * Q + c, st[MAX_UP]);
  }
}

struct Args {
  const int* nbr;
  const float* wgt;
  const float* vals;
  float* out;
  int R, W, n, Q, G, logp;
  cudaStream_t stream;
};

template <int C, int K, int V, int LOGCH>
cudaError_t launch(const Args& a) {
  const int rows_per_block = THREADS / a.G;
  const unsigned grid = (unsigned)((a.R + rows_per_block - 1) / rows_per_block);
  ell_batched<C, K, V, LOGCH><<<grid, THREADS, 0, a.stream>>>(
      a.nbr, a.wgt, a.vals, a.out, a.R, a.W, a.n, a.Q, a.G, a.logp);
  return cudaGetLastError();
}

template <int C, int K, int V>
cudaError_t by_width(const Args& a) {
  switch (a.logp < 3 ? a.logp : 3) {
    case 0: return launch<C, K, V, 0>(a);
    case 1: return launch<C, K, V, 1>(a);
    case 2: return launch<C, K, V, 2>(a);
    default: return launch<C, K, V, 3>(a);
  }
}

template <int C, int K>
cudaError_t by_vector(const Args& a, bool vec) {
  return vec ? by_width<C, K, 4>(a) : by_width<C, K, 1>(a);
}

template <int C>
cudaError_t by_combine(int combine, const Args& a, bool vec) {
  switch (combine) {
    case MIN: return by_vector<C, MIN>(a, vec);
    case MAX: return by_vector<C, MAX>(a, vec);
    case SUM: return by_vector<C, SUM>(a, vec);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// nbr int32 (R, W), wgt float32 (R, W), vals float32 (n+1, Q), out float32
// (R, Q), all row-major. `lanes` is G, the lanes a row (a power of two <=
// 32); `vector` asks for the float4 variant, refused unless Q % 4 == 0 and
// vals and out are 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ell_combine_batched_launch(const int* nbr, const float* wgt,
                                          const float* vals, float* out, int R,
                                          int W, int n, int Q, int lanes,
                                          int compute_op, int combine_op,
                                          int vector, void* stream) {
  if (R <= 0 || Q <= 0) return 0;
  if (W < 1 || W > 256) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector != 0;
  if (vec && (Q % 4 != 0 || reinterpret_cast<size_t>(vals) % 16 != 0 ||
              reinterpret_cast<size_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  int logp = 0;
  while ((1 << logp) < W) ++logp;
  const Args a{nbr, wgt, vals, out, R, W, n, Q, lanes, logp, (cudaStream_t)stream};
  switch (compute_op) {
    case HOP: return (int)by_combine<HOP>(combine_op, a, vec);
    case ADD_W: return (int)by_combine<ADD_W>(combine_op, a, vec);
    case COPY: return (int)by_combine<COPY>(combine_op, a, vec);
    case MUL_W: return (int)by_combine<MUL_W>(combine_op, a, vec);
    default: return (int)cudaErrorInvalidValue;
  }
}
