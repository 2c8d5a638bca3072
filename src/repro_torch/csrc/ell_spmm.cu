// ELL SpMM (GNN aggregation) over one degree bucket, for Hopper.
//
// Replaces: repro/kernels/ell_spmv.py::ell_spmm (Pallas `_spmm_kernel`).
// For one ELL slice (nbr, wgt of shape (R, W)) and features F (n+1, D),
//     out[r, :] = SUM_j w'[r, j] * F[nbr[r, j], :]
// where w' is 0 on sentinel slots (nbr == n). Accumulation is in float32;
// the output has F's type (float32 or bfloat16, rounded to nearest even).
//
// Bound on the H100: bytes. Each live slot gathers one D-wide feature row
// (256 B at D = 64 in float32) and does 2*D flops on it, a quarter of a flop
// per byte, far below the float32 rate. Two bounds: every slot's id and
// weight, each distinct used feature row once, and the output (the
// yardstick of the first kernel); and the same with the weights of the live
// slots only, which is what this kernel reads. The feature rows that the
// slots request (130.5 M x 256 B = 33.4 GB at RMAT scale 22, D = 64) are in
// neither: a hub's row is requested many times and may hit the 50 MB L2,
// the rest come from device memory. Requests served above 3.35 TB/s are
// L2's share; past a few rows in flight a warp (Little's law: ~2 MB in
// flight on the card at ~650 ns a request), more in flight did not help.
//
// Design: one warp a row. The warp reads the row's ids in chunks of 128
// slots, lane l holding slots 4l .. 4l + 3: one 16-byte load where W % 4 == 0
// and nbr and wgt are 16-byte aligned (`ell_spmv.spmm_layout`; every
// pack_ell slice), else four 4-byte loads. A ballot of the live slots (id in
// [0, n): sentinels may sit anywhere in a row) gives each live slot its rank;
// its weight is read (a float4 where a lane's four slots are all live, else
// one float a live slot, none for padding) and (id, weight) go to the warp's
// list in shared memory in ascending slot order. Padding costs no shuffle,
// no weight read and no gather. Ids, weights and the output are read and
// written evict-first (they pass once), leaving L2 to the feature rows.
// The warp then works through the list in groups of L lanes, 32 / L groups
// side by side, each lane of a group holding V consecutive columns (16-byte
// loads: V = 4 in float32, 8 in bfloat16, where D % V == 0 and F is
// aligned; 8-, 4- or 2-byte loads otherwise) in C chunks of L * V columns
// (`by_lanes`: L = 16, C = 1 at D = 64 in float32; L = 16, C = 3 of 8-byte
// loads at D = 70). Group s takes list entries s, s + 32/L, ...; each lane
// issues the loads of U = 2 slots before their FMAs, and the registers are
// capped at 32 (8 blocks, the full 64 warps of an SM): at D = 64, 4 rows in
// flight a warp, 256 an SM. (More slots a lane cost registers, and so
// resident warps: slower at D = 64 and 70; PERF.md §6.) At the end
// the groups' sums are added by a fixed xor-shuffle tree: the fold order
// depends only on the row's live slots, so the output is the same bit for
// bit from run to run, without atomics.

#include <cstdint>

#include "lane_group.cuh"
#include "occupancy.cuh"

namespace {

using repro::from_f32;
using repro::Int;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;  // slots whose ids a warp reads at once
constexpr int U = 2;        // slots a lane has in flight
// blocks an SM that the registers must allow where a lane holds at most 6
// columns: 32 registers, the full 64 warps of an SM (wider lanes get 4)
constexpr int MIN_BLOCKS = 8;

// ids, weights and the output pass once: they are read and written with the
// evict-first ("streaming") policy, so that they do not push the feature
// rows out of L2
template <typename X>
__device__ __forceinline__ X stream_load(const X* p) {
  return __ldcs(p);
}
template <typename X>
__device__ __forceinline__ void stream_store(X* p, X x) {
  __stcs(p, x);
}

// V consecutive elements of T, loaded as one access of V * sizeof(T) bytes
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      const float4 a = __ldg((const float4*)p);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    } else if constexpr (V == 2) {
      const float2 a = __ldg((const float2*)p);
      x[0] = a.x; x[1] = a.y;
    } else {
      x[0] = __ldg(p);
    }
  } else {
    uint32_t w[(V + 1) / 2];
    if constexpr (V == 8) {
      const uint4 a = __ldg((const uint4*)p);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else if constexpr (V == 4) {
      const uint2 a = __ldg((const uint2*)p);
      w[0] = a.x; w[1] = a.y;
    } else if constexpr (V == 2) {
      w[0] = __ldg((const unsigned int*)p);
    } else {
      w[0] = __ldg((const unsigned short*)p);
    }
#pragma unroll
    for (int i = 0; i < V; ++i)   // a bfloat16's bits are a float32's top half
      x[i] = __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xffffu) << 16);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) stream_store((float4*)p, make_float4(x[0], x[1], x[2], x[3]));
    else if constexpr (V == 2) stream_store((float2*)p, make_float2(x[0], x[1]));
    else stream_store(p, x[0]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(x[i]);
  }
}

// T: float or bfloat16; V columns a lane a load; L lanes a group; C chunks
// of L * V columns (the last one ragged).
template <typename T, int V, int L, int C>
__global__ void __launch_bounds__(THREADS, C * V <= 6 ? MIN_BLOCKS : 4)
spmm_kernel(const int* __restrict__ nbr, const float* __restrict__ wgt,
            const T* __restrict__ feats, T* __restrict__ out, int R, int W,
            int D, int n, bool vec_ids) {
  constexpr int NG = 32 / L;                          // groups a warp
  constexpr int CM = C;
  __shared__ int s_nb[WARPS][CHUNK];
  __shared__ float s_w[WARPS][CHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= R) return;                               // the whole warp
  const int gs = lane / L, li = lane % L;
  const int nvec = D / V;
  const int* nrow = nbr + row * W;
  const float* wrow = wgt + row * W;
  int* lnb = s_nb[warp];
  float* lw = s_w[warp];

  float acc[CM][V];
#pragma unroll
  for (int c = 0; c < CM; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.0f;

  for (int j0 = 0; j0 < W; j0 += CHUNK) {
    // this lane's four slots, their live flags and their ranks
    const int j = j0 + 4 * lane;
    int id[4] = {n, n, n, n};
    if (vec_ids) {
      if (j < W) {
        const int4 a = stream_load((const int4*)(nrow + j));
        id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < W) id[e] = stream_load(nrow + j + e);
    }
    bool live[4];
    int pos = 0, total = 0;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      live[e] = (unsigned)id[e] < (unsigned)n;
      const unsigned b = __ballot_sync(FULL, live[e]);
      pos += __popc(b & below);
      total += __popc(b);
    }
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec_ids && live[0] && live[1] && live[2] && live[3]) {
      const float4 a = stream_load((const float4*)(wrow + j));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (live[e]) w[e] = stream_load(wrow + j + e);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (live[e]) {
        lnb[pos] = id[e];
        lw[pos] = w[e];
        ++pos;
      }
    __syncwarp();

    // the live slots, U a lane in flight, each group its own entries
    for (int base = gs; base < total; base += NG * U) {
      int nb[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + NG * u;
        nb[u] = idx < total ? lnb[idx] : -1;
        wu[u] = idx < total ? lw[idx] : 0.0f;
      }
      float x[U][CM][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const int col = c * L + li;
          if (nb[u] >= 0 && col < nvec)
            load_vec<T, V>(feats + (long long)nb[u] * D + col * V, x[u][c]);
          else
#pragma unroll
            for (int v = 0; v < V; ++v) x[u][c][v] = 0.0f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CM; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[c][v] = fmaf(wu[u], x[u][c][v], acc[c][v]);
    }
    __syncwarp();   // the list is written again for the next chunk
  }

  // the groups' sums, by a fixed tree (every group ends with the total)
#pragma unroll
  for (int off = 16; off >= L; off /= 2)
#pragma unroll
    for (int c = 0; c < CM; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] += __shfl_xor_sync(FULL, acc[c][v], off);
  if (gs != 0) return;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    const int col = c * L + li;
    if (col < nvec) store_vec<T, V>(out + row * D + col * V, acc[c]);
  }
}

// (L, C) for D / V = nvec vectors a row: one chunk of the smallest L in
// {4, 8, 16, 32} that covers the row up to 32 vectors, then (16, 3) up to 48
// (D = 70 in float32: 35 8-byte vectors, two groups a warp), (32, 2), (32, 4)
// and (32, 8) (D = 256 in 4-byte loads).
template <typename T, int V>
cudaError_t by_lanes(const int* nbr, const float* wgt, const void* feats,
                     void* out, int R, int W, int D, int n, bool vec_ids,
                     cudaStream_t s) {
  const int nvec = D / V;
  const long long grid = ((long long)R + WARPS - 1) / WARPS;
  auto run = [&](auto l, auto c) {
    auto kern = spmm_kernel<T, V, decltype(l)::value, decltype(c)::value>;
    repro::occ::note(kern, THREADS, 0);
    kern<<<(unsigned)grid, THREADS, 0, s>>>(nbr, wgt, (const T*)feats, (T*)out, R, W, D, n,
                                            vec_ids);
    return cudaGetLastError();
  };
  if (nvec <= 4) return run(Int<4>{}, Int<1>{});
  if (nvec <= 8) return run(Int<8>{}, Int<1>{});
  if (nvec <= 16) return run(Int<16>{}, Int<1>{});
  if (nvec <= 32) return run(Int<32>{}, Int<1>{});
  // D <= 256: nvec <= 256 / V, so only the narrower loads need the rest
  if constexpr (V < 8) {
    if (nvec <= 48) return run(Int<16>{}, Int<3>{});
    if (nvec <= 64) return run(Int<32>{}, Int<2>{});
  }
  if constexpr (V < 4) {
    if (nvec <= 128) return run(Int<32>{}, Int<4>{});
  }
  if constexpr (V == 1) return run(Int<32>{}, Int<8>{});
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_vec(int fvec, const int* nbr, const float* wgt,
                   const void* feats, void* out, int R, int W, int D, int n,
                   bool vec_ids, cudaStream_t s) {
  switch (fvec) {
    case 1: return by_lanes<T, 1>(nbr, wgt, feats, out, R, W, D, n, vec_ids, s);
    case 2: return by_lanes<T, 2>(nbr, wgt, feats, out, R, W, D, n, vec_ids, s);
    case 4: return by_lanes<T, 4>(nbr, wgt, feats, out, R, W, D, n, vec_ids, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return by_lanes<T, 8>(nbr, wgt, feats, out, R, W, D, n, vec_ids, s);
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// nbr (R, W) int32, wgt (R, W) f32, feats (n+1, D) and out (R, D) of one
// type: dtype 0 = float32, 1 = bfloat16. 1 <= W <= 256, 1 <= D <= 256.
// vec_ids: read ids and weights 16 bytes at a time (W % 4 == 0, nbr and wgt
// 16-byte aligned); fvec: feature columns a load (1, 2, 4, or 8 for
// bfloat16), D % fvec == 0, feats and out aligned to fvec elements.
// Returns cudaErrorInvalidValue for a layout the pointers do not allow,
// else cudaGetLastError() after the launch (0 on success).
extern "C" int ell_spmm_launch(const int* nbr, const float* wgt,
                               const void* feats, void* out, int R, int W,
                               int D, int n, int dtype, int vec_ids, int fvec,
                               void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || W > 256 || D < 1 || D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const uintptr_t esize = dtype == 0 ? 4 : 2;
  if (fvec < 1 || fvec * esize > 16 || D % fvec != 0 ||
      ((uintptr_t)feats | (uintptr_t)out) % (fvec * esize) != 0)
    return (int)cudaErrorInvalidValue;
  if (vec_ids && (W % 4 != 0 || ((uintptr_t)nbr | (uintptr_t)wgt) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)by_vec<float>(fvec, nbr, wgt, feats, out, R, W, D, n, vec_ids != 0, s);
  return (int)by_vec<__nv_bfloat16>(fvec, nbr, wgt, feats, out, R, W, D, n, vec_ids != 0, s);
}

REPRO_OCCUPANCY(ell_spmm)
