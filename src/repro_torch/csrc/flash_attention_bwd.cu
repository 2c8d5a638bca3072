// Backward of causal GQA attention (FlashAttention-2's backward schedule),
// for Hopper, in float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference trains through XLA's attention
// (`repro/nn/layers.py:97`, use_flash=False) and differentiates it with
// jax.grad, so it has no Pallas backward. The port's forward is always the
// flash kernel (`csrc/flash_attention.cu`, `csrc/flash_attention_wgmma.cu`),
// whose output carries no gradient, so this kernel gives it one.
//
// q, out, dout (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all float32 or all
// bfloat16; dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in the same type.
// Query head h reads kv head h % Hkv (the reference's group-major map). With
// `causal`, query i sees kv positions <= i + Skv - Sq, as the forward does.
// A query row that sees no kv position gets a zero gradient.
//
// Numerics: everything in float32 from the inputs as given (a bfloat16
// value is read exactly). P = exp(s * scale - lse) with the row's
// log-sum-exp recomputed here, so the two forward kernels stay untouched;
// Delta = rowsum(dO o O) from the forward's output; dS = P o (dP - Delta);
// dQ = scale dS K, dK = scale dS^T Q (summed over the heads that read the
// kv head), dV = P^T dO. This is the exact derivative of attention at the
// given inputs; the bfloat16 forward rounds P before P.V, which the
// backward does not model. `kernels/flash_attention.py::attention_bwd_plain`
// is the plain version.
//
// Bound on the H100: operations (five products of Sq x Skv x D a head, half
// of them under the causal mask). Here they run on the CUDA cores at
// float32; the tensor-core version is later work (ROADMAP, second designs).
//
// Design: three launches, no float atomics, so every sum is taken in one
// fixed order and a call is bit-for-bit repeatable.
//   1. `row_stats`: one block per (q tile of 64, q head, batch) walks the
//      visible k tiles with an online max and sum: lse = m + log(l) per
//      row (+inf for a row that sees nothing, so its P is 0), and
//      Delta = rowsum(dO o O).
//   2. `dkdv`: one block per (k tile of 64, kv head j, batch) keeps K, V and
//      its dK, dV accumulators resident, and loops over the q heads
//      h = j, j + Hkv, ... and, within each, over the q tiles the mask lets
//      in: S and dP (64 x 64) into shared memory as P and dS, then
//      dV += P^T dO and dK += dS^T Q.
//   3. `dq`: one block per (q tile, q head, batch) keeps Q, dO and its dQ
//      accumulator resident and loops over the visible k tiles.
// 256 threads a block. A 64 x 64 score tile gives each thread rows
// ty + 16 i and columns tx + 16 j (i, j < 4, tx = tid % 16); the
// accumulators give warp w rows w + 8 i (i < 8) and lane l columns
// l + 32 j (j < NJ = ceil(D / 32)). Tiles are float32 rows of 32 NJ + 1
// floats (zero past D), so a warp's column reads fall on distinct banks.
// Shared memory is up to 166 KB (D = 128), so it is dynamic and each kernel
// raises its limit with cudaFuncSetAttribute.

#include <cmath>
#include <cstdint>

#include "lane_group.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;
constexpr int TILE = 64;      // q rows and k rows of a tile
constexpr int SP = TILE + 1;  // row stride of the P and dS tiles

template <int NJ>
__host__ __device__ constexpr int stride() { return 32 * NJ + 1; }

// rows [0, TILE) of a (rows, D) matrix into a float32 tile; rows past
// `avail` and columns past D are zero
template <typename T, int NJ>
__device__ void load_tile(float* dst, const T* src, int avail, int D) {
  constexpr int W = 32 * NJ;
  for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
    const int r = i / W, d = i - r * W;
    dst[r * stride<NJ>() + d] =
        (r < avail && d < D) ? to_f32(src[(size_t)r * D + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two tiles
template <int NJ>
__device__ void tile_dot(float acc[4][4], const float* A, const float* Bt) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < 32 * NJ; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * stride<NJ>() + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * stride<NJ>() + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

struct Shape {
  int Hq, Hkv, Sq, Skv, D;
  float scale;
  int causal;
  __device__ int off() const { return Skv - Sq; }
  // is kv position kp visible to query row qp (both inside their ranges)?
  __device__ bool visible(int qp, int kp) const {
    return qp < Sq && kp < Skv && (!causal || kp <= qp + Skv - Sq);
  }
  // one past the last kv position any row of [q0, q0 + TILE) sees
  __device__ int k_end(int q0) const {
    if (!causal) return Skv;
    const int last = min(q0 + TILE, Sq) - 1 + off() + 1;
    return max(0, min(Skv, last));
  }
  // the first q tile start any key of [k0, k0 + TILE) is visible to
  __device__ int q_begin(int k0) const {
    if (!causal) return 0;
    const int first = max(0, k0 - off());
    return first / TILE * TILE;
  }
};

__device__ __forceinline__ float half_max(float x) {   // over 16 lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int NJ>
constexpr size_t stats_smem() { return sizeof(float) * 2 * TILE * stride<NJ>(); }
template <int NJ>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * TILE * stride<NJ>() + 2 * TILE * SP + 2 * TILE);
}
template <int NJ>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TILE * stride<NJ>() + TILE * SP + 2 * TILE);
}

// lse and Delta of each query row: stats[0 .. B Hq Sq) = lse,
// stats[B Hq Sq ..) = Delta
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
row_stats(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
          const T* __restrict__ dout, float* __restrict__ stats, Shape sh) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * stride<NJ>();
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int hkv = h % sh.Hkv;
  const int D = sh.D;
  const size_t qrow = ((size_t)b * sh.Hq + h) * sh.Sq;
  const T* kbase = k + ((size_t)b * sh.Hkv + hkv) * sh.Skv * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, NJ>(Qs, q + (qrow + q0) * D, sh.Sq - q0, D);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  const int kend = sh.k_end(q0);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();
    load_tile<T, NJ>(Ks, kbase + (size_t)k0 * D, sh.Skv - k0, D);
    __syncthreads();
    float s[4][4];
    tile_dot<NJ>(s, Qs, Ks);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = sh.visible(qp, k0 + tx + 16 * j) ? s[i][j] * sh.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const bool any = mn != -INFINITY;   // something visible to this row yet
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) part += any ? expf(s[i][j] - mn) : 0.f;
      const float tot = half_sum(part);   // every lane shuffles
      if (any) {
        l[i] = l[i] * expf(m[i] - mn) + tot;
        m[i] = mn;
      }
    }
  }
  const size_t n = (size_t)gridDim.z * sh.Hq * sh.Sq;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < sh.Sq) stats[qrow + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
  // Delta: warp w takes rows w, w + 8, ...; lanes over D
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE && q0 + r < sh.Sq; r += THREADS / 32) {
    const size_t at = (qrow + q0 + r) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dout[at + d]), to_f32(o[at + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) stats[n + qrow + q0 + r] = acc;
  }
}

// S and dP of a (q tile, k tile) pair into P and dS (scaled by nothing:
// dS is the gradient of the unscaled scores divided by `scale`)
template <int NJ>
__device__ void p_and_ds(float* Ps, float* dSs, const float* Qs, const float* dOs,
                         const float* Ks, const float* Vs, const float* lse,
                         const float* delta, int q0, int k0, const Shape& sh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
  tile_dot<NJ>(s, Qs, Ks);
  tile_dot<NJ>(dp, dOs, Vs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = sh.visible(q0 + r, k0 + c) ? expf(s[i][j] * sh.scale - lse[r]) : 0.f;
      if (Ps) Ps[r * SP + c] = p;
      dSs[r * SP + c] = p * (dp[i][j] - delta[r]);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
     const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
     T* __restrict__ dv, Shape sh) {
  extern __shared__ float smem[];
  constexpr int ST = stride<NJ>();
  float* Ks = smem;
  float* Vs = Ks + TILE * ST;
  float* Qs = Vs + TILE * ST;
  float* dOs = Qs + TILE * ST;
  float* Ps = dOs + TILE * ST;
  float* dSs = Ps + TILE * SP;
  float* lse = dSs + TILE * SP;
  float* delta = lse + TILE;
  const int k0 = blockIdx.x * TILE, j = blockIdx.y, b = blockIdx.z;
  const int D = sh.D;
  const size_t kvrow = ((size_t)b * sh.Hkv + j) * sh.Skv + k0;
  const size_t n = (size_t)gridDim.z * sh.Hq * sh.Sq;
  load_tile<T, NJ>(Ks, k + kvrow * D, sh.Skv - k0, D);
  load_tile<T, NJ>(Vs, v + kvrow * D, sh.Skv - k0, D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ak[8][NJ], av[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NJ; ++c) { ak[i][c] = 0.f; av[i][c] = 0.f; }
  const int qb = sh.q_begin(k0);
  for (int h = j; h < sh.Hq; h += sh.Hkv) {
    const size_t qrow = ((size_t)b * sh.Hq + h) * sh.Sq;
    for (int q0 = qb; q0 < sh.Sq; q0 += TILE) {
      __syncthreads();   // the previous tile's P and dS are consumed
      load_tile<T, NJ>(Qs, q + (qrow + q0) * D, sh.Sq - q0, D);
      load_tile<T, NJ>(dOs, dout + (qrow + q0) * D, sh.Sq - q0, D);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < sh.Sq;
        lse[r] = in ? stats[qrow + q0 + r] : INFINITY;
        delta[r] = in ? stats[n + qrow + q0 + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<NJ>(Ps, dSs, Qs, dOs, Ks, Vs, lse, delta, q0, k0, sh);
      __syncthreads();
      for (int r = 0; r < TILE; ++r) {
        float o[NJ], x[NJ];
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          o[c] = dOs[r * ST + lane + 32 * c];
          x[c] = Qs[r * ST + lane + 32 * c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = Ps[r * SP + warp + 8 * i];
          const float ds = dSs[r * SP + warp + 8 * i];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            av[i][c] = fmaf(p, o[c], av[i][c]);
            ak[i][c] = fmaf(ds, x[c], ak[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (k0 + r >= sh.Skv) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[(kvrow + r) * D + d] = from_f32<T>(ak[i][c] * sh.scale);
        dv[(kvrow + r) * D + d] = from_f32<T>(av[i][c]);
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ stats,
          T* __restrict__ dq, Shape sh) {
  extern __shared__ float smem[];
  constexpr int ST = stride<NJ>();
  float* Qs = smem;
  float* dOs = Qs + TILE * ST;
  float* Ks = dOs + TILE * ST;
  float* Vs = Ks + TILE * ST;
  float* dSs = Vs + TILE * ST;
  float* lse = dSs + TILE * SP;
  float* delta = lse + TILE;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int D = sh.D;
  const size_t qrow = ((size_t)b * sh.Hq + h) * sh.Sq;
  const size_t n = (size_t)gridDim.z * sh.Hq * sh.Sq;
  const size_t kvbase = ((size_t)b * sh.Hkv + h % sh.Hkv) * sh.Skv;
  load_tile<T, NJ>(Qs, q + (qrow + q0) * D, sh.Sq - q0, D);
  load_tile<T, NJ>(dOs, dout + (qrow + q0) * D, sh.Sq - q0, D);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const bool in = q0 + r < sh.Sq;
    lse[r] = in ? stats[qrow + q0 + r] : INFINITY;
    delta[r] = in ? stats[n + qrow + q0 + r] : 0.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  const int kend = sh.k_end(q0);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();   // the previous tile's dS is consumed
    load_tile<T, NJ>(Ks, k + (kvbase + k0) * D, sh.Skv - k0, D);
    load_tile<T, NJ>(Vs, v + (kvbase + k0) * D, sh.Skv - k0, D);
    __syncthreads();
    p_and_ds<NJ>(nullptr, dSs, Qs, dOs, Ks, Vs, lse, delta, q0, k0, sh);
    __syncthreads();
    for (int c0 = 0; c0 < TILE; ++c0) {
      float x[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) x[c] = Ks[c0 * ST + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ds = dSs[(warp + 8 * i) * SP + c0];
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(ds, x[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (q0 + r >= sh.Sq) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[(qrow + q0 + r) * D + d] = from_f32<T>(acc[i][c] * sh.scale);
    }
  }
}

template <typename K>
cudaError_t raise_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NJ>
cudaError_t go(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int B, const Shape& sh,
               cudaStream_t s) {
  const T *Q = (const T*)q, *K = (const T*)k, *V = (const T*)v, *O = (const T*)o,
          *DO = (const T*)dout;
  const int qt = (sh.Sq + TILE - 1) / TILE, kt = (sh.Skv + TILE - 1) / TILE;
  cudaError_t err = raise_smem(row_stats<T, NJ>, stats_smem<NJ>());
  if (err != cudaSuccess) return err;
  row_stats<T, NJ><<<dim3(qt, sh.Hq, B), THREADS, stats_smem<NJ>(), s>>>(Q, K, O, DO, stats, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = raise_smem(dkdv<T, NJ>, dkdv_smem<NJ>())) != cudaSuccess) return err;
  dkdv<T, NJ><<<dim3(kt, sh.Hkv, B), THREADS, dkdv_smem<NJ>(), s>>>(
      Q, K, V, DO, stats, (T*)dk, (T*)dv, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = raise_smem(dq_kernel<T, NJ>, dq_smem<NJ>())) != cudaSuccess) return err;
  dq_kernel<T, NJ><<<dim3(qt, sh.Hq, B), THREADS, dq_smem<NJ>(), s>>>(
      Q, K, V, DO, stats, (T*)dq, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
                     const Shape& sh, cudaStream_t s) {
  switch ((sh.D + 31) / 32) {
    case 1: return go<T, 1>(q, k, v, o, dout, dq, dk, dv, stats, B, sh, s);
    case 2: return go<T, 2>(q, k, v, o, dout, dq, dk, dv, stats, B, sh, s);
    case 3: return go<T, 3>(q, k, v, o, dout, dq, dk, dv, stats, B, sh, s);
    default: return go<T, 4>(q, k, v, o, dout, dq, dk, dv, stats, B, sh, s);
  }
}

}  // namespace

// q, out, dout, dq (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D), contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16. Hq % Hkv == 0, 1 <= D <= 128.
// stats: float32 room for 2 B Hq Sq values (each row's lse, then its Delta).
// Launches the three kernels on `stream`; returns the first CUDA error of
// the launches or attribute calls (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, void* dq,
                                          void* dk, void* dv, void* stats, int B, int Hq,
                                          int Hkv, int Sq, int Skv, int D, float scale,
                                          int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 128 || Skv < 1 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{Hq, Hkv, Sq, Skv, D, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  switch (dtype) {
    case 0: return (int)by_width<float>(q, k, v, out, dout, dq, dk, dv, st, B, sh, s);
    case 1: return (int)by_width<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, st, B, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
