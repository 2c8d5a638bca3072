// Causal GQA attention with an online softmax (FlashAttention-2 schedule),
// for Hopper, on the tensor cores in TF32 with the 3xTF32 split.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (Pallas
// `_flash_kernel`). q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all float32
// or all bfloat16; out (B, Hq, Sq, D) in q's type. Query head h reads kv
// head h % Hkv (group-major, as the Pallas index map and ref.attention_ref
// do; the Pallas module docstring's "h // group" is stale). With `causal`,
// query i sees kv positions <= i + Skv - Sq (the decode offset).
//
// Numerics follow `_flash_kernel`: scores q.k in float32 times 1/sqrt(D);
// masked scores are -1e30 (not -inf); running max m, sum l and the output
// accumulator in float32; for bfloat16 inputs the probabilities P are
// rounded to bfloat16 before P.V (l sums them unrounded); the output is
// acc / max(l, 1e-30), cast to q's type. A row that sees no kv position
// (Sq > Skv under causal) is not defined (the reference gives NaN).
// Given an `lse` pointer (training: the backward takes it), each row's
// natural log-sum-exp m ln 2 + ln l is written too, +inf for a row that
// sees nothing (its m stays at the mask value, and l counts its masked
// keys); the output is the same bits either way.
//
// Bound on the H100: operations. At granite-3-8b's layer (B = 4, S = 1024,
// D = 128, causal) attention does ~410 flops per byte of q, k, v and out.
// On the CUDA cores (67 TFLOP/s float32) that is 0.51 ms; on the tensor
// cores a float32 product costs three TF32 products (below), 3 x 34.4 GFLOP
// at 495 TFLOP/s = 0.21 ms. This kernel takes the tensor cores.
//
// The 3xTF32 split (`mma_tf32.cuh`, shared with the backward): each float32
// operand is split into a big and a small TF32 half and a product is
// small*big + big*small + big*big in float32. A single TF32 pass would miss
// the 2e-4 this kernel is held to (~1e-3 at D = 128). bfloat16 values are
// exact in TF32, so the bfloat16 route runs only big*big, and P, rounded
// to bfloat16, likewise. `kernels/flash_attention.py::split_tf32` and
// `attention_3xtf32` are the plain versions of the split and of the kernel.
//
// Route: mma.sync.m16n8k8 (tf32 in, float32 accumulate) rather than wgmma.
// wgmma takes tf32 operands only K-major from shared memory, so V would
// need a transposed copy; mma.sync takes its operands from registers, so P
// goes from the scores' accumulator into P.V without leaving them.
//
// Design: two kernels a call.
//   1. `split_kv`, a pre-pass over K and V (read once, 2 x their size
//      written: 67 MB at the granite layer): each kv head's K rows become a
//      plane whose 16 bytes at d pair p hold (big 2p, big 2p+1, small 2p,
//      small 2p+1), its V rows a plane of row pairs whose 16 bytes at d hold
//      (big, big, small, small) of rows 2q and 2q+1. The split is done once
//      per kv element, not once per warp that reads it.
//   2. `flash_kernel`: one 256-thread block (8 warps) per (q tile of 128
//      rows, q head, batch), heaviest causal tiles first; each warp owns 16
//      q rows. Q stays in shared memory as float32 and is split per k-step
//      as it is read (two halves in registers would cost 128 registers at
//      D = 128). kv tiles of 32 positions of both planes go through a
//      2-stage cp.async ring (zero past Skv). Per kv tile a warp computes
//      S = Q K^T (16 x 32) in m16n8k8 tiles, each K fragment (both halves
//      of d = 8s + 2t and 8s + 2t + 1) one 16-byte read; masks and scales
//      S; updates m and l for its rows with two quad shuffles; and feeds P
//      to P.V from registers: the C fragment of S holds columns (2t, 2t+1)
//      of rows (g, g+8), so A's column t is read as kv 2t and column t+4 as
//      kv 2t+1, and V's B fragment is the pair-row's 16 bytes at d. Row
//      strides (D padded to DP, a multiple of 16; Q rows DP + 8 floats, K
//      plane rows 2 DP + 16, V pair-rows 4 DP + 8) put a warp's reads on
//      distinct banks. Any Sq and Skv: the ragged tiles are masked. Shared
//      memory is 206 KB at D = 128 (one block, 8 warps an SM), so it is
//      dynamic and the kernel raises its limit with cudaFuncSetAttribute.
// The wrapper allocates the planes (`tf32_scratch_floats`).

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "lane_group.cuh"
#include "mma_tf32.cuh"
#include "occupancy.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;
using namespace repro::tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int BQ = 128;       // 16 q rows a warp
constexpr int BKV = 32;
constexpr int STAGES = 2;
constexpr int NT = BKV / 8;   // n-tiles of S, k-steps of P.V
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row strides in shared memory, in floats: Q rows; K plane rows (2 DP
// floats: big and small of each d pair); V plane pair-rows (4 DP floats:
// big and small of each d for two kv rows). Each puts a warp's fragment
// reads (8-byte for Q, 16-byte for K and V) on distinct banks.
template <int DP> constexpr int QS = DP + 8;
template <int DP> constexpr int KPS = 2 * DP + 16;
template <int DP> constexpr int VPS = 4 * DP + 8;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * QS<DP> +
                          STAGES * ((size_t)BKV * KPS<DP> + (size_t)BKV / 2 * VPS<DP>));
}

// floats of the K and V planes for (B * Hkv) heads of Skv positions
template <int DP>
long long plane_floats(int BH, int Skv) {
  return (long long)BH * ((long long)Skv * 2 * DP + (long long)(Skv + 1) / 2 * 4 * DP);
}

// rows [r0, r0 + ROWS) of Q (rows, D) into shared memory with row stride
// QS, zero past `rows` and past D. ASYNC: 16-byte cp.async (float32,
// D % 4 == 0, a 16-byte aligned base).
template <typename T, int DP, bool ASYNC>
__device__ __forceinline__ void load_q(float* dst, const T* __restrict__ src,
                                       int r0, int rows, int D) {
  if (ASYNC) {
    constexpr int VECS = DP / 4;
    for (int e = threadIdx.x; e < BQ * VECS; e += THREADS) {
      const int i = e / VECS, d = (e % VECS) * 4;
      const bool in = r0 + i < rows && d < D;
      const float* p = in ? (const float*)src + (long long)(r0 + i) * D + d
                          : (const float*)src;
      cp_async16(dst + i * QS<DP> + d, p, in);
    }
  } else {
    for (int e = threadIdx.x; e < BQ * DP; e += THREADS) {
      const int i = e / DP, d = e % DP;
      dst[i * QS<DP> + d] = (r0 + i < rows && d < D)
                                ? to_f32(src[(long long)(r0 + i) * D + d])
                                : 0.0f;
    }
  }
}

// ROWS rows of WIDTH floats from a plane into shared memory with row
// stride S, 16 bytes a copy, zero from row `valid` on.
template <int ROWS, int WIDTH, int S>
__device__ __forceinline__ void load_plane(float* dst, const float* __restrict__ src,
                                           int valid) {
  constexpr int VECS = WIDTH / 4;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * VECS; e += THREADS) {
    const int i = e / VECS, c = (e % VECS) * 4;
    const bool in = i < valid;
    cp_async16(dst + i * S + c, in ? src + (long long)i * WIDTH + c : src, in);
  }
}

// The pre-pass: K and V of every kv head split once into the planes the
// main kernel reads. K row r: for each d pair p, the float4 (big 2p,
// big 2p+1, small 2p, small 2p+1); V pair-row q (kv rows 2q, 2q+1): for
// each d, (big 2q, big 2q+1, small 2q, small 2q+1). Zero past D and past Skv.
template <typename T, int DP>
__global__ void __launch_bounds__(256)
split_kv(const T* __restrict__ k, const T* __restrict__ v, float4* __restrict__ kpl,
         float4* __restrict__ vpl, int BH, int Skv, int D) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int pairs = (Skv + 1) / 2;
  const long long nk = (long long)BH * Skv * (DP / 2);
  const long long nv = (long long)BH * pairs * DP;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < nk + nv;
       e += (long long)gridDim.x * blockDim.x) {
    float x0 = 0.0f, x1 = 0.0f;
    if (e < nk) {                       // (head, row, d pair): d = 2p, 2p + 1
      const long long row = e / (DP / 2);
      const int d = 2 * (int)(e % (DP / 2));
      if (d < D) x0 = to_f32(k[row * D + d]);
      if (d + 1 < D) x1 = to_f32(k[row * D + d + 1]);
    } else {                            // (head, pair-row, d): rows 2q, 2q + 1
      const long long f = e - nk;
      const long long bhq = f / DP;
      const int d = (int)(f % DP);
      const long long bh = bhq / pairs;
      const int r = 2 * (int)(bhq % pairs);
      const T* vh = v + bh * Skv * D;
      if (d < D) {
        x0 = to_f32(vh[(long long)r * D + d]);
        if (r + 1 < Skv) x1 = to_f32(vh[(long long)(r + 1) * D + d]);
      }
    }
    uint32_t b0, s0 = 0, b1, s1 = 0;
    split<SPLIT>(x0, b0, s0);
    split<SPLIT>(x1, b1, s1);
    const float4 out = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                                   __uint_as_float(s0), __uint_as_float(s1));
    if (e < nk) kpl[e] = out; else vpl[e - nk] = out;
  }
}

// DP: D padded to 16, 32, 64, 96 or 128 (the padding holds zeros).
template <typename T, int DP, bool CAUSAL, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const T* __restrict__ q, const float* __restrict__ kpl,
             const float* __restrict__ vpl, T* __restrict__ o, float* __restrict__ lse,
             int Hq, int Hkv, int Sq, int Skv, int D, float scale2, int kv_offset) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int KS = DP / 8;   // k-steps of Q.K^T, n-tiles of the output
  extern __shared__ float smem[];
  float* Qs = smem;                              // BQ x QS
  float* Ks = Qs + BQ * QS<DP>;                  // STAGES of BKV x KPS
  float* Vs = Ks + STAGES * BKV * KPS<DP>;       // STAGES of BKV/2 x VPS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * Hkv + h % Hkv;
  const int pairs = (Skv + 1) / 2;
  const T* qp = q + ((long long)b * Hq + h) * Sq * D;
  const float* kp = kpl + bh * Skv * 2 * DP;
  const float* vp = vpl + bh * pairs * 4 * DP;
  T* op = o + ((long long)b * Hq + h) * Sq * D;

  int n_kv = (Skv + BKV - 1) / BKV;
  if (CAUSAL) {  // the last kv position any real row of this tile sees
    const long long last = (long long)min(q0 + BQ, Sq) - 1 + kv_offset;
    n_kv = last < 0 ? 0 : (int)min((long long)n_kv, last / BKV + 1);
  }
  auto load_kv = [&](int kt, int stage) {
    load_plane<BKV, 2 * DP, KPS<DP>>(Ks + stage * BKV * KPS<DP>,
                                     kp + (long long)kt * BKV * 2 * DP, Skv - kt * BKV);
    load_plane<BKV / 2, 4 * DP, VPS<DP>>(Vs + stage * BKV / 2 * VPS<DP>,
                                         vp + (long long)kt * BKV / 2 * 4 * DP,
                                         pairs - kt * BKV / 2);
  };

  load_q<T, DP, ASYNC>(Qs, qp, q0, Sq, D);
  if (n_kv > 0) load_kv(0, 0);
  cp_commit();

  const int r_lo = warp * 16 + g;                 // this lane's rows r_lo, r_lo + 8
  const int qpos0 = q0 + r_lo + kv_offset;        // their last visible kv positions
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;  // in log2 units (m)
  const float* qa = Qs + r_lo * QS<DP> + 2 * t;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt % STAGES;
    if (kt + 1 < n_kv) {
      load_kv(kt + 1, (kt + 1) % STAGES);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kb = Ks + st * BKV * KPS<DP> + g * KPS<DP> + 4 * t;
    const float* vb = Vs + st * BKV / 2 * VPS<DP> + t * VPS<DP> + 4 * g;

    // S = Q K^T: k-step s reads d = 8s + 2t (A col t, B row t) and
    // 8s + 2t + 1 (A col t + 4, B row t + 4); K's halves of both in one
    // 16-byte read of its plane
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x0 = *(const float2*)(qa + 8 * ks);
      const float2 x1 = *(const float2*)(qa + 8 * QS<DP> + 8 * ks);
      uint32_t ab[4], as[4];
      split<SPLIT>(x0.x, ab[0], as[0]);
      split<SPLIT>(x1.x, ab[1], as[1]);
      split<SPLIT>(x0.y, ab[2], as[2]);
      split<SPLIT>(x1.y, ab[3], as[3]);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const uint4 y = *(const uint4*)(kb + 8 * i * KPS<DP> + 16 * ks);
        mma3<SPLIT>(s[i], ab, as, y.x, y.y, y.z, y.w);
      }
    }
    // scale (to log2 units), mask, online softmax over rows r_lo, r_lo + 8
    const int k0 = kt * BKV;
    const bool edge = k0 + BKV > Skv || (CAUSAL && k0 + BKV - 1 > q0 + kv_offset);
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale2;
        if (edge) {
          const int kpos = k0 + 8 * i + 2 * t + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          if (!(kpos < Skv && (!CAUSAL || kpos <= qpos))) x = NEG;
        }
        s[i][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[i][e] - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p; else sum1 += p;
        if (!SPLIT) p = __bfloat162float(__float2bfloat16_rn(p));  // P in V's type
        s[i][e] = p;
      }
    l0 = l0 * c0 + sum0;   // a lane's share of its rows' sums: summed at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V: k-step i takes P's n-tile i as its A fragment (col t = kv
    // 8i + 2t, col t + 4 = kv 8i + 2t + 1) and V's pair-row 4i + t, whose
    // 16 bytes at d hold both rows' halves
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t ab[4], as[4];
      split<SPLIT>(s[i][0], ab[0], as[0]);
      split<SPLIT>(s[i][2], ab[1], as[1]);
      split<SPLIT>(s[i][1], ab[2], as[2]);
      split<SPLIT>(s[i][3], ab[3], as[3]);
      const float* vr = vb + 4 * i * VPS<DP>;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint4 y = *(const uint4*)(vr + 32 * j);
        mma3<SPLIT>(acc[j], ab, as, y.x, y.y, y.z, y.w);
      }
    }
    __syncthreads();  // this stage is loaded again two tiles on
  }
  cp_wait<0>();       // no copy outlives the block (n_kv = 0 loads only Q)

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r_lo, row1 = row0 + 8;
  if (lse != nullptr && t == 0) {   // m stays NEG where no kv position is seen
    float* lp = lse + ((long long)b * Hq + h) * Sq;
    if (row0 < Sq) lp[row0] = m0 == NEG ? INFINITY : m0 * LN2 + logf(l0);
    if (row1 < Sq) lp[row1] = m1 == NEG ? INFINITY : m1 * LN2 + logf(l1);
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1;
      const int d = 8 * j + 2 * t + (e & 1);
      if (row < Sq && d < D)
        op[(long long)row * D + d] = from_f32<T>(acc[j][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t go(const void* q, const void* k, const void* v, void* o, float* lse,
               float* scratch,
               long long scratch_floats, int B, int Hq, int Hkv, int Sq, int Skv,
               int D, float scale, cudaStream_t s) {
  const int BH = B * Hkv;
  if (scratch_floats < plane_floats<DP>(BH, Skv)) return cudaErrorInvalidValue;
  float* kpl = scratch;
  float* vpl = scratch + (long long)BH * Skv * 2 * DP;
  const long long items = (long long)BH * (Skv * (DP / 2) + (long long)(Skv + 1) / 2 * DP);
  const long long blocks = std::min<long long>((items + 255) / 256, 132 * 16);
  repro::occ::note(split_kv<T, DP>, 256, 0);
  split_kv<T, DP><<<(unsigned)blocks, 256, 0, s>>>((const T*)k, (const T*)v,
                                                   (float4*)kpl, (float4*)vpl, BH, Skv, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool async = std::is_same<T, float>::value && D % 4 == 0 && (uintptr_t)q % 16 == 0;
  auto kern = async ? flash_kernel<T, DP, CAUSAL, true>
                    : flash_kernel<T, DP, CAUSAL, false>;
  constexpr size_t bytes = smem_bytes<DP>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  repro::occ::note(kern, THREADS, bytes);
  kern<<<grid, THREADS, bytes, s>>>((const T*)q, kpl, vpl, (T*)o, lse, Hq, Hkv, Sq, Skv, D,
                                    scale * LOG2E, Skv - Sq);
  return cudaGetLastError();
}

#define ARGS q, k, v, o, lse, scratch, scratch_floats, B, Hq, Hkv, Sq, Skv, D, scale, s
template <typename T, bool CAUSAL>
cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     float* lse, float* scratch, long long scratch_floats, int B, int Hq,
                     int Hkv, int Sq, int Skv, int D, float scale, cudaStream_t s) {
  if (D <= 16) return go<T, 16, CAUSAL>(ARGS);
  if (D <= 32) return go<T, 32, CAUSAL>(ARGS);
  if (D <= 64) return go<T, 64, CAUSAL>(ARGS);
  if (D <= 96) return go<T, 96, CAUSAL>(ARGS);
  return go<T, 128, CAUSAL>(ARGS);
}

template <typename T>
cudaError_t by_causal(int causal, const void* q, const void* k, const void* v,
                      void* o, float* lse, float* scratch, long long scratch_floats, int B,
                      int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                      cudaStream_t s) {
  return causal ? by_width<T, true>(ARGS) : by_width<T, false>(ARGS);
}
#undef ARGS

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D), contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16. Hq % Hkv == 0, 1 <= D <= 128.
// lse: null, or float32 room for B Hq Sq values (each row's natural
// log-sum-exp, +inf where a row sees no kv position). scratch: 16-byte
// aligned float32 room for the split K and V planes, B * Hkv * (Skv * 2 DP + ceil(Skv / 2) * 4 DP) floats, DP = D padded to 16,
// 32, 64, 96 or 128 (`flash_attention.tf32_scratch_floats`). Launches the
// split pre-pass and the attention kernel on `stream`. Returns the first
// CUDA error of the launches or the attribute call (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse, void* scratch,
                                      int scratch_floats, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int D, float scale,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 128 || Skv < 1 || B > 65535 ||
      Hq > 65535 || (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  float* ls = (float*)lse;
  switch (dtype) {
    case 0: return (int)by_causal<float>(causal, q, k, v, out, ls, sc, scratch_floats, B, Hq, Hkv, Sq, Skv, D, scale, s);
    case 1: return (int)by_causal<__nv_bfloat16>(causal, q, k, v, out, ls, sc, scratch_floats, B, Hq, Hkv, Sq, Skv, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_OCCUPANCY(flash_attention)
