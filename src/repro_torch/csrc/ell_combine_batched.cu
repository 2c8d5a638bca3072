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
// the identity, then pair slot k with k + p/2, k + p/4, ..., the lower slot
// on the left). At Q = 1 it is the 1-D `ell_combine`, bit for bit.
//
// Bound on the H100: bytes. Every id is read once, a weight only for a
// real slot, then one Q-vector of vals (4Q bytes) for each real slot, and
// the (R, Q) output is written: at RMAT scale 22 and Q = 64 that is 130.5 M
// x 256 bytes of gathers, about 10 ms at 3.35 TB/s unless L2 serves hub
// rows again; at Q = 8, 1.35 GB of ids beside 4.2 GB of 32-byte gathers,
// from a vals of 134 MB of which the 50 MB L2 holds the hubs.
//
// Design. A row is spread over T = G x S lanes (a power of two <= 32, so a
// row never straddles a warp): S slot groups, group s holding the slots
// s, s + S, s + 2S, ..., and G column lanes in each group. The halving
// tree's subtree over the slots = s (mod S) is the node a[s] after
// log2(p/S) levels, so each group folds its own slots in tree order and
// __shfl_down_sync by T/2 .. G then pairs groups s and s + S/2 .. s + 1,
// lower group on the left: exactly `halving_tree`. Two routes, chosen by
// `batched_layout` in kernels/ell_spmv.py from Q (slot lanes up to Q = 8),
// each laid out by the slice width as measured on the RMAT-22 slices
// (PERF.md §6):
//
//   slot lanes (narrow Q): G = 1 and L = S lanes a row, about p / 4 (at
//     least min(p, 2), at most 32; p / L <= 8). Lane l reads its p / L ids
//     and its real slots' weights straight into registers, slot l + L i at
//     step i, so a warp instruction reads neighbouring slots (coalesced);
//     then gathers each slot's whole Q-vector in passes of 8 columns (two
//     16-byte loads, one 32-byte sector at Q = 8) or 1 column (scalar
//     variant); folds its slots in-lane (pairs i, i + p/2L, ...: slots
//     k, k + p/2, ...; 8 slots in two chunks of 4 to bound registers), then
//     the shuffles. `ell_combine_slot_lanes_model` writes this order out.
//   column lanes (wide Q): G column lanes of 4 columns (16-byte loads; one
//     gather of a row's slot is G x 16 contiguous bytes) or 1 column, and
//     S = p / 64 slot groups (at least 1, at most 32 / G). The row's T
//     lanes first stage its ids and real slots' weights in shared memory,
//     in slot order (int4 loads where W % 4 == 0 and nbr, wgt are aligned;
//     rows padded to an odd stride, so rows of a warp read distinct banks).
//     Each group then walks its p/S slots in bit-reversed order (p/S = 8:
//     0, 4, 2, 6, 1, 5, 3, 7) from shared memory, 8 gathers in flight, a
//     tree over the 8 and one step of a binary counter of partials (log2 of
//     the chunks a group has, a template bound), which builds the halving
//     tree over the group's slots. At most 64 registers (four blocks of 256
//     a multiprocessor): a few bytes spill where the weights' instances need
//     more, which measured faster than 77-88 registers without spill.
//     `ell_combine_column_lanes_model` writes this order out.
//
// Cache policy: ids and weights are read once, with the streaming hint
// (ld.global.cs: evict first), and the output is stored with it; gathers
// of vals carry an L2 evict-last policy (createpolicy + L2::cache_hint), so
// the streams do not push hub rows' Q-vectors out of the 50 MB L2.
// A padding slot (j >= W or nbr == n) loads nothing and enters the tree as
// the identity; Compute runs on every position without a branch, so that
// a chunk's gathers all issue before the first use, and a select keeps
// the identity only where Compute would move it (`KEEPS_IDENT`). With
// explicit __fadd_rn/__fmul_rn no FMA is contracted, so sums are bit-equal
// to the PyTorch version. Q % 4 != 0 and unaligned views take the scalar
// variants of either route.

#include <cuda_runtime.h>
#include <cfloat>

#include "occupancy.cuh"

namespace {

constexpr float BIG = FLT_MAX / 4.0f;  // the ACC identity magnitude f32max/4
constexpr int THREADS = 256;
constexpr int LOG_CH = 3;              // column lanes: log2 of the gathers in flight a lane
constexpr int CH = 1 << LOG_CH;
constexpr int MAX_LEVELS = 8 - LOG_CH;  // counter levels above a chunk at p = 256, S = 1
constexpr size_t MAX_STAGE = 48 * 1024;  // column lanes: staged ids and weights a block
                                         // (rows a block shrink below THREADS / T to fit)

enum Compute { HOP = 0, ADD_W = 1, COPY = 2, MUL_W = 3 };
enum Combine { MIN = 0, MAX = 1, SUM = 2 };
enum Route { SLOTS = 0, COLUMNS = 1 };

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

// Whether Compute maps the combine identity to itself, bit for bit, with
// the weight 0 that a padding slot gets: hop and add_w keep BIG (v < BIG
// fails) and -BIG (-BIG + 1 rounds to -BIG), add_w and mul_w keep 0 for a
// sum; hop on 0 gives 1, mul_w turns +-BIG into 0.
template <int C, int K>
constexpr bool KEEPS_IDENT = C == COPY || C == ADD_W || (C == HOP && K != SUM) ||
                             (C == MUL_W && K == SUM);

// Compute on a real slot's columns, the identity kept on a padding slot
// (whose weight is 0): computed everywhere with no branch, so that the
// chunk stays one basic block and ptxas issues all its gathers before the
// first use; selected only where Compute would move the identity.
template <int C, int K, int V>
__device__ __forceinline__ void compute_cols(Cols<V>& a, float w, bool real) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float y = compute<C>(a.x[i], w);
    a.x[i] = KEEPS_IDENT<C, K> || real ? y : a.x[i];
  }
}

template <int K, int V>
__device__ __forceinline__ Cols<V> shfl_down_cols(const Cols<V>& a, int off, int width,
                                                  unsigned mask = 0xffffffffu) {
  Cols<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = __shfl_down_sync(mask, a.x[i], off, width);
  return r;
}

// An L2 policy that keeps what it loads (vals' rows are gathered again
// wherever a hub is the neighbour of many rows).
__device__ __forceinline__ unsigned long long keep_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Gathers of vals under `pol`, predicated on `on`; where it is off the
// destination keeps what it held (the identity).
__device__ __forceinline__ void gather4(float* d, const float* a, bool on,
                                        unsigned long long pol) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %4, 0;\n\t"
      "@p ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%5], %6;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"((int)on), "l"(a), "l"(pol));
}

__device__ __forceinline__ void gather1(float* d, const float* a, bool on,
                                        unsigned long long pol) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "@p ld.global.nc.L2::cache_hint.f32 %0, [%2], %3;\n\t}"
      : "+f"(d[0])
      : "r"((int)on), "l"(a), "l"(pol));
}

// ---------------------------------------------------------------------------
// slot lanes: L = S lanes a row, NS = p / L <= 8 slots a lane.
// V = 4: passes of 8 columns (two float4, the second only where c + 4 < Q);
// V = 1: passes of one column.
// ---------------------------------------------------------------------------

template <int C, int K, int V, int NS>
__global__ void __launch_bounds__(THREADS)
slot_lanes(const int* __restrict__ nbr, const float* __restrict__ wgt,
           const float* __restrict__ vals, float* __restrict__ out,
           int R, int W, int n, int Q, int L) {
  constexpr int CW = V == 4 ? 8 : 1;          // columns a pass
  constexpr int CS = NS < 4 ? NS : 4;         // slots a chunk
  constexpr int NCH = NS / CS;                // chunks: 1, or 2 at NS = 8
  const unsigned long long pol = keep_policy();
  const int t = threadIdx.x % L;
  const long long row = (long long)blockIdx.x * (THREADS / L) + threadIdx.x / L;
  const bool live = row < R;                  // every lane reaches the shuffles
  int nb[NS];
  float w[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {              // ids in slot order
    const int j = t + i * L;
    nb[i] = live && j < W ? __ldcs(nbr + row * W + j) : n;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i)                // then the real slots' weights
    w[i] = READS_WEIGHT<C> && nb[i] != n ? __ldcs(wgt + row * W + t + i * L) : 0.0f;
  for (int c = 0; c < Q; c += CW) {
    Cols<CW> acc;
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      Cols<CW> x[CS];
#pragma unroll
      for (int j = 0; j < CS; ++j) {          // the chunk's gathers
        const int i = h + NCH * j;
        const bool on = nb[i] != n;
        const float* src = vals + (long long)(on ? nb[i] : n) * Q + c;
        x[j] = ident_cols<K, CW>();
        if constexpr (V == 4) {
          gather4(x[j].x, src, on, pol);
          gather4(x[j].x + 4, src + 4, on && c + 4 < Q, pol);
        } else {
          gather1(x[j].x, src, on, pol);
        }
      }
#pragma unroll
      for (int j = 0; j < CS; ++j)
        compute_cols<C, K, CW>(x[j], w[h + NCH * j], nb[h + NCH * j] != n);
      // in-lane halving over the chunk: local slots i, i + NS/2, ...
#pragma unroll
      for (int s = CS / 2; s >= 1; s /= 2)
#pragma unroll
        for (int j = 0; j < s; ++j) x[j] = pair_cols<K, CW>(x[j], x[j + s]);
      if (h == 0) acc = x[0];
      else acc = pair_cols<K, CW>(acc, x[0]);
    }
    for (int off = L / 2; off >= 1; off /= 2)
      acc = pair_cols<K, CW>(acc, shfl_down_cols<K, CW>(acc, off, L));
    if (live && t == 0) {
      float* o = out + row * Q + c;
      if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(o),
               make_float4(acc.x[0], acc.x[1], acc.x[2], acc.x[3]));
        if (c + 4 < Q)
          __stcs(reinterpret_cast<float4*>(o + 4),
                 make_float4(acc.x[4], acc.x[5], acc.x[6], acc.x[7]));
      } else {
        __stcs(o, acc.x[0]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// column lanes: G column lanes x S slot groups a row; ids and weights
// staged in shared memory; MAX_UP bounds the counter's levels above a chunk.
// ---------------------------------------------------------------------------

// Position t of a group's visiting order -> its local slot (bit-reversed
// over log2 of the group's slots).
__device__ __forceinline__ int local_slot(int t, int logps) {
  return logps == 0 ? 0 : (int)(__brev((unsigned)t) >> (32 - logps));
}

template <int C, int K, int V, int MAX_UP>
__global__ void __launch_bounds__(THREADS, 4)
column_lanes(const int* __restrict__ nbr, const float* __restrict__ wgt,
             const float* __restrict__ vals, float* __restrict__ out,
             int R, int W, int n, int Q, int G, int S, int logp, int vec_ids) {
  extern __shared__ int smem[];
  const unsigned long long pol = keep_policy();
  const int T = G * S;                        // lanes a row
  const int rows = blockDim.x / T;            // rows a block
  // the lanes of this warp: a block whose rows were cut to fit their
  // staging may end in a part of a warp (whole rows, as T divides 32)
  const int wbase = threadIdx.x & ~31;
  const unsigned wmask = (int)blockDim.x - wbase >= 32
                             ? 0xffffffffu : (1u << ((int)blockDim.x - wbase)) - 1u;
  const int stride = W | 1;                   // odd: rows of a warp on other banks
  const int t = threadIdx.x % T;
  const int rl = threadIdx.x / T;
  const long long row = (long long)blockIdx.x * rows + rl;
  const bool live = row < R;
  int* sid = smem + rl * stride;
  float* swt = reinterpret_cast<float*>(smem + rows * stride) + rl * stride;
  if (live) {                                 // stage the row, in slot order
    const int* nrow = nbr + row * W;
    const float* wrow = wgt + row * W;
    if (vec_ids) {
      for (int j = 4 * t; j < W; j += 4 * T) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(nrow + j));
        sid[j] = v.x;
        sid[j + 1] = v.y;
        sid[j + 2] = v.z;
        sid[j + 3] = v.w;
        if (READS_WEIGHT<C> && (v.x != n || v.y != n || v.z != n || v.w != n)) {
          const float4 u = __ldcs(reinterpret_cast<const float4*>(wrow + j));
          swt[j] = u.x;
          swt[j + 1] = u.y;
          swt[j + 2] = u.z;
          swt[j + 3] = u.w;
        }
      }
    } else {
      for (int j = t; j < W; j += T) {
        const int v = __ldcs(nrow + j);
        sid[j] = v;
        if (READS_WEIGHT<C> && v != n) swt[j] = __ldcs(wrow + j);
      }
    }
  }
  __syncwarp(wmask);
  const int g = t % G;
  const int s = t / G;
  int ls = 0;
  while ((1 << ls) < S) ++ls;
  const int logps = logp - ls;                // log2 of a group's slots
  const int logch = logps < LOG_CH ? logps : LOG_CH;
  const int ch = 1 << logch;
  const int up = logps - logch;               // counter levels above a chunk
  const int chunks = 1 << up;
  for (int c0 = 0; c0 < Q; c0 += G * V) {     // uniform: every lane shuffles
    const int c = c0 + g * V;
    const bool col = c < Q;
    Cols<V> st[MAX_UP > 0 ? MAX_UP : 1];
    Cols<V> y;
    for (int h = 0; h < chunks; ++h) {
      Cols<V> x[CH];
      unsigned real = 0;                      // bit i: position i is a real slot
#pragma unroll
      for (int i = 0; i < CH; ++i) {          // the chunk's gathers
        x[i] = ident_cols<K, V>();
        const int slot = s + S * local_slot(h * ch + i, logps);
        const int v = i < ch && slot < W ? sid[slot] : n;
        const bool on = live && col && v != n;
        real |= (unsigned)on << i;
        const float* src = vals + (long long)(on ? v : n) * Q + (col ? c : 0);
        if constexpr (V == 4) gather4(x[i].x, src, on, pol);
        else gather1(x[i].x, src, on, pol);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int slot = s + S * local_slot(h * ch + i, logps);
        const bool on = (real >> i) & 1u;
        compute_cols<C, K, V>(x[i], READS_WEIGHT<C> && on ? swt[slot] : 0.0f, on);
      }
      // the chunk's subtree: positions (0, 1), (0, 2), (0, 4)
#pragma unroll
      for (int d = 1; d < CH; d <<= 1)
        if (d < ch)
#pragma unroll
          for (int i = 0; i < CH; i += 2 * d) x[i] = pair_cols<K, V>(x[i], x[i + d]);
      // one step of the counter: merge with the stored partial of each level
      // whose bit of h is set, store at the first level whose bit is clear
      y = x[0];
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
    }
    // the last chunk carries through every level: y is the group's subtree
    for (int off = T / 2; off >= G; off /= 2)
      y = pair_cols<K, V>(y, shfl_down_cols<K, V>(y, off, T, wmask));
    if (live && col && s == 0) {
      float* o = out + row * Q + c;
      if constexpr (V == 4)
        __stcs(reinterpret_cast<float4*>(o), make_float4(y.x[0], y.x[1], y.x[2], y.x[3]));
      else
        __stcs(o, y.x[0]);
    }
  }
}

struct Args {
  const int* nbr;
  const float* wgt;
  const float* vals;
  float* out;
  int R, W, n, Q, G, S, logp, vec_ids;
  cudaStream_t stream;
};

template <int C, int K, int V, int NS>
cudaError_t launch_slots(const Args& a) {
  const int rows = THREADS / a.S;
  const unsigned grid = (unsigned)((a.R + rows - 1) / rows);
  repro::occ::note(slot_lanes<C, K, V, NS>, THREADS, 0);
  slot_lanes<C, K, V, NS><<<grid, THREADS, 0, a.stream>>>(
      a.nbr, a.wgt, a.vals, a.out, a.R, a.W, a.n, a.Q, a.S);
  return cudaGetLastError();
}

template <int C, int K, int V, int MAX_UP>
cudaError_t launch_columns(const Args& a) {
  const int T = a.G * a.S;
  const size_t per_row = (size_t)(a.W | 1) * 2 * sizeof(int);
  int rows = THREADS / T;                     // fewer where their staging would not fit
  if ((size_t)rows * per_row > MAX_STAGE) rows = (int)(MAX_STAGE / per_row);
  const unsigned grid = (unsigned)((a.R + rows - 1) / rows);
  repro::occ::note(column_lanes<C, K, V, MAX_UP>, rows * T, rows * per_row);
  column_lanes<C, K, V, MAX_UP><<<grid, rows * T, rows * per_row, a.stream>>>(
      a.nbr, a.wgt, a.vals, a.out, a.R, a.W, a.n, a.Q, a.G, a.S, a.logp, a.vec_ids);
  return cudaGetLastError();
}

template <int C, int K, int V>
cudaError_t by_slots(const Args& a) {
  switch ((1 << a.logp) / a.S) {              // slots a lane
    case 1: return launch_slots<C, K, V, 1>(a);
    case 2: return launch_slots<C, K, V, 2>(a);
    case 4: return launch_slots<C, K, V, 4>(a);
    case 8: return launch_slots<C, K, V, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int C, int K>
cudaError_t by_route(int route, const Args& a, bool vec) {
  if (route == SLOTS) return vec ? by_slots<C, K, 4>(a) : by_slots<C, K, 1>(a);
  if (!vec) return launch_columns<C, K, 1, MAX_LEVELS>(a);
  int ls = 0;
  while ((1 << ls) < a.S) ++ls;
  const int up = a.logp - ls - LOG_CH;        // counter levels a group needs
  if (up <= 2) return launch_columns<C, K, 4, 2>(a);
  if (up == 3) return launch_columns<C, K, 4, 3>(a);
  if (up == 4) return launch_columns<C, K, 4, 4>(a);
  return launch_columns<C, K, 4, MAX_LEVELS>(a);
}

template <int C>
cudaError_t by_combine(int combine, int route, const Args& a, bool vec) {
  switch (combine) {
    case MIN: return by_route<C, MIN>(route, a, vec);
    case MAX: return by_route<C, MAX>(route, a, vec);
    case SUM: return by_route<C, SUM>(route, a, vec);
    default: return cudaErrorInvalidValue;
  }
}

bool pow2(int x) { return x >= 1 && (x & (x - 1)) == 0; }

}  // namespace

// nbr int32 (R, W), wgt float32 (R, W), vals float32 (n+1, Q), out float32
// (R, Q), all row-major. `route` 0 (slot lanes) takes column_lanes = 1 and
// slot_groups L, a power of two <= 32 with p / 8 <= L <= p for the padded
// width p (L lanes a row, p / L slots a lane); route 1 (column lanes)
// takes powers of two with column_lanes x slot_groups <= 32 and slot_groups
// <= p. `vector` asks for 16-byte column loads, refused unless Q % 4 == 0
// and vals and out are 16-byte aligned; the column route reads ids and
// weights 16 bytes at a time where W % 4 == 0 and both are aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ell_combine_batched_launch(const int* nbr, const float* wgt,
                                          const float* vals, float* out, int R,
                                          int W, int n, int Q, int route,
                                          int column_lanes, int slot_groups,
                                          int compute_op, int combine_op,
                                          int vector, void* stream) {
  if (R <= 0 || Q <= 0) return 0;
  if (W < 1 || W > 256) return (int)cudaErrorInvalidValue;
  int logp = 0;
  while ((1 << logp) < W) ++logp;
  const int p = 1 << logp;
  const int G = column_lanes, S = slot_groups;
  if (route == SLOTS) {
    if (G != 1 || !pow2(S) || S > 32 || S > p || p / S > 8) return (int)cudaErrorInvalidValue;
  } else if (route == COLUMNS) {
    if (!pow2(G) || !pow2(S) || G * S > 32 || S > p) return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = vector != 0;
  if (vec && (Q % 4 != 0 || reinterpret_cast<size_t>(vals) % 16 != 0 ||
              reinterpret_cast<size_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int vec_ids = W % 4 == 0 && reinterpret_cast<size_t>(nbr) % 16 == 0 &&
                      reinterpret_cast<size_t>(wgt) % 16 == 0;
  const Args a{nbr, wgt, vals, out, R, W, n, Q, G, S, logp, vec_ids, (cudaStream_t)stream};
  switch (compute_op) {
    case HOP: return (int)by_combine<HOP>(combine_op, route, a, vec);
    case ADD_W: return (int)by_combine<ADD_W>(combine_op, route, a, vec);
    case COPY: return (int)by_combine<COPY>(combine_op, route, a, vec);
    case MUL_W: return (int)by_combine<MUL_W>(combine_op, route, a, vec);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_OCCUPANCY(ell_combine_batched)
