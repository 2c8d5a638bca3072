// Backward of causal GQA attention (FlashAttention-2's backward schedule),
// for Hopper, on the tensor cores in TF32 with the 3xTF32 split.
//
// Replaces no TPU kernel: the reference trains through XLA's attention
// (`repro/nn/layers.py:97`, use_flash=False) and differentiates it with
// jax.grad, so it has no Pallas backward. It is the float32 route of the
// port's flash backward, and the bfloat16 one for D % 8 != 0 (TMA, which the
// wgmma backward in flash_attention_bwd_wgmma.cu is fed by, needs 16-byte row
// strides).
//
// q, out, dout (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all float32 or all
// bfloat16, contiguous; lse (B, Hq, Sq) float32, each row's natural
// log-sum-exp as the TF32 forward (flash_attention.cu) writes it, +inf for a
// row that sees nothing. dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in
// q's type. Query head h reads kv head h % Hkv (the reference's group-major
// map). With `causal`, query i sees kv positions <= i + Skv - Sq. A query
// row that sees no kv position gets a zero gradient.
//
// Numerics: scores in the log2 domain as the forward has them (x = s *
// scale * log2 e); P = exp2(x - lse * log2 e) against the forward's
// log-sum-exp, not recomputed; Delta = rowsum(dO o O) in float32 from the
// forward's output; dS = P o (dP - Delta); dQ = scale dS K, dK = scale
// dS^T Q (summed over the q heads that read the kv head), dV = P^T dO, each
// rounded to q's type once. Every product runs on mma.sync.m16n8k8 in TF32
// with the 3xTF32 split (`mma_tf32.cuh`): small*big + big*small + big*big,
// accumulated in float32. bfloat16 inputs are exact in TF32 (small halves
// zero, those terms skipped); P and dS are float32 values and keep their
// split on both types, so this is the exact derivative at the given inputs
// that `kernels/flash_attention.py::attention_bwd_plain` describes; the
// plain version at this kernel's rounding points is `attention_bwd_3xtf32`.
//
// Bound on the H100: at granite-moe-1b-a400m's layer in float32 (B = 8,
// 16 q / 8 kv heads, S = 1024, D = 64, causal) operations: five products
// over the causal pairs, 43 GFLOP, are 129 GFLOP as TF32 passes, 0.26 ms at
// 495 TFLOP/s (on the CUDA cores, 67 TFLOP/s float32, 0.64 ms). At the 100m
// preset's layer (B = 8, 12 / 6 heads, S = 128, D = 64) bytes: 0.8 GFLOP of
// TF32 passes against 18.9 MB, 5.6 us; there the kernel is three launches
// and the latency of a short chain of tiles, so the design keeps the grids
// full at S = 128 too.
//
// Route: mma.sync rather than wgmma. wgmma takes TF32 operands only K-major
// from shared memory; dV += P^T dO and dK += dS^T Q read dO and Q N-major,
// and dQ += dS K reads K N-major, so wgmma would need transposed copies.
// mma.sync takes its operands from registers: P^T and dS^T go from the
// C fragments of S^T and dP^T into the A fragments of dV and dK without
// leaving them, as the forward feeds P into P.V.
//
// Design: three launches, no float atomics, so every sum is taken in one
// fixed order and two calls are bit-equal.
//   1. `prep_kernel`: Delta = rowsum(dO o O) and lse * log2 e into a
//      float32 scratch of two (B Hq, SqP) planes (SqP = Sq rounded up to
//      128; padding rows hold +inf and 0, so their P and dS are 0). Memory
//      bound, one warp a row.
//   2. `dkdv_kernel`: a block of WARPS warps owns ROWS = 16 WARPS kv rows of
//      one (batch, kv head j), each warp 16 of them (mma's M); K and V are
//      split once into shared memory. The dK and dV accumulators stay in
//      registers while the block walks h = j, j + Hkv, ... and, within
//      each, the q tiles of STEP rows the mask lets in, so the head sum
//      needs no atomics. Per q tile: S^T = K Q^T and dP^T = V dO^T (kv rows
//      as M), P^T = exp2(S^T x - lse2) and dS^T = P^T o (dP^T - Delta) in
//      the C fragments, which are the A fragments of dV += P^T dO and
//      dK += dS^T Q.
//   3. `dq_kernel`: a block owns ROWS q rows of one (batch, q head);
//      Q and dO are split once, lse2 and Delta sit in registers, and kv
//      tiles of STEP rows stream through: S = Q K^T, dP = dO V^T, then
//      dQ += dS K. This recomputes S and dP (seven products a head against
//      the bound's five) so that dQ needs no atomics.
//   Blocks take the heaviest causal tiles first (dK/dV the first kv tiles,
//   dQ the last q tiles). Only tiles on the causal diagonal compare
//   positions; a warp skips a tile none of its rows sees. The products of a
//   tile (STEP rows of dV, dK or dQ's sum) start from zero and are added to
//   the running dK, dV and dQ in float32: the tensor cores round each
//   accumulation toward zero, and one chain over the 2,048 q rows of a
//   granite-moe dK/dV block read 1.9e-5 of the largest entry from float64
//   (limit 2e-5; 2.5e-5 from `attention_bwd_plain`), per tile 1.8e-6.
//
// Where the split happens. The products read each operand in two layouts:
// a row plane whose 16 bytes at d pair p hold (big 2p, big 2p+1, small 2p,
// small 2p+1) of a row (the A fragment of K, V, Q, dO and the B fragment of
// S's and dP's other side), and, for the B operand of dV, dK and dQ (dO, Q,
// K read along their rows), a plane of row pairs whose 16 bytes at d hold
// (big, big, small, small) of rows 2r and 2r + 1: four times the float32
// tile, each fragment one 16-byte read. A split pre-pass into device memory
// (the forward's `split_kv`) would write those planes for Q, dO and K
// (4 x 84 MB at granite-moe's float32 layer, 2 x for V) and the tile loops
// would read them back four times as wide: dK/dV reads each Q and dO row
// once per kv block of its head, Skv / ROWS = 16 times at S = 1024.
// Splitting as each warp reads (the forward's Q) would split every element
// once per warp of the block. Here the tile is split once per block: the
// raw float32 rows come in by 16-byte cp.async (a two-stage ring, zero past
// Sq, Skv and D), and all the block's threads split them into the two
// planes in shared memory, 8 values a thread. The block reads float32 at its source width
// and does the split's arithmetic once per element it loads.
//   Rows that are not float32 with D % 4 == 0 at 16-byte aligned addresses
// (bfloat16, odd widths) are loaded and split in place, without the ring.
//
// Tiles (`Tiles`): shared memory carries each streamed row four times over
// (two layouts, two halves), and every B fragment read feeds one warp's 16
// rows, so by count a tile moves about as many shared-memory bytes a cycle
// as the tensor cores could consume (an estimate, not measured); more warps
// a block share each split tile. At D <= 64 a block has 4 warps (64 rows)
// and steps of 32 rows: dK/dV 178 KB, dQ 159 KB, one block an SM. Timed in turns at granite-moe's
// float32 layer, 4 x 32 took 2.71-2.78 ms against 2 warps x 16 rows
// (3.07-3.10), 4 x 16 (2.92) and 2 x 32 (5.56), and 0.098-0.100 ms at the
// 100m layer against 0.096-0.115 (H100 80GB HBM3, 700 W;
// `scripts/port_kernel_probe.py flashbwd`). At D = 96 and 128 that would not
// fit: 2 warps and 16-row steps, 129 / 115 KB and 169 / 151 KB.
// Registers: dK and dV of 16 kv rows take DP float32 registers a thread,
// S^T and dP^T STEP / 2 more. dV's and dK's n-tiles are phased together,
// two of each at a time, over half the tile's q rows at a time: with the
// whole tile's A fragments live, ptxas takes 255 registers and spills 8
// bytes at D = 64, and that build ran 2.09 ms (dK/dV 1.09 against 1.74);
// with one product's at a time (179 registers) 2.63-2.68, one n-tile of
// each (171) 2.75. chip_smoke.py's phase 2 prints every instance's
// registers and spill bytes and fails if the main path's (float32, D = 64,
// causal) spill.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "lane_group.cuh"
#include "mma_tf32.cuh"
#include "occupancy.cuh"

#ifndef FLASH_BWD_WARPS
#define FLASH_BWD_WARPS 4   // warps a block at D <= 64 (2 above)
#endif
#ifndef FLASH_BWD_STEP
#define FLASH_BWD_STEP 32   // rows of the streamed tile at D <= 64 (16 above)
#endif

namespace {

using repro::from_f32;
using repro::to_f32;
using namespace repro::tf32;

constexpr int SQ_ALIGN = 128;      // the scratch planes' row stride is a multiple
constexpr int PREP_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The tiles at padded width DP: WARPS warps a block, each owning 16 kv rows
// (dK/dV) or q rows (dQ), so ROWS = 16 WARPS rows a block; STEP rows of the
// streamed tile (q rows for dK/dV, kv rows for dQ), NT = STEP / 8 n-tiles of
// S. Four warps and 32-row steps at D <= 64 (the main path); at D = 96 and
// 128 they would not fit in shared memory, and two warps and 16-row steps do.
template <int DP>
struct Tiles {
  static constexpr int WARPS = DP <= 64 ? FLASH_BWD_WARPS : 2;
  static constexpr int STEP = DP <= 64 ? FLASH_BWD_STEP : 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int NT = STEP / 8;
  static_assert(STEP % 8 == 0 && SQ_ALIGN % STEP == 0 && SQ_ALIGN % ROWS == 0,
                "tiles must divide the scratch's row padding");
};

// Shared-memory strides, in floats. Row planes: 2 DP floats a row, stride
// KPS (as the forward's K plane). Pair planes: a pair of rows is four runs of
// ES floats, run e holding d = 4 c + e at 4 c (so the split pass writes
// each run with consecutive 16-byte stores), stride VPS. Both put a warp's
// 16-byte fragment reads on distinct banks (VPS / 4 = 2 mod 8, ES / 4 odd).
template <int DP> constexpr int KPS = 2 * DP + 16;
template <int DP> constexpr int ES = DP + 4;
template <int DP> constexpr int VPS = 4 * DP + 40;
// n-tiles of D a B-fragment batch of dV, dK and dQ (fewer at wide D, where
// the accumulators take most registers)
template <int KS> constexpr int CH = KS >= 12 ? 2 : (KS < 4 ? KS : 4);

// dK/dV: K and V row planes (ROWS rows), Q and dO row planes and pair planes
// (STEP rows), lse2 and Delta (STEP each), and a two-stage ring of raw
// float32 Q and dO rows with their lse2 and Delta
template <int DP>
__host__ __device__ constexpr int dkdv_raw() {
  return 2 * Tiles<DP>::STEP * DP + 2 * Tiles<DP>::STEP;
}
template <int DP>
constexpr size_t dkdv_smem() {
  constexpr int ROWS = Tiles<DP>::ROWS, STEP = Tiles<DP>::STEP;
  return sizeof(float) * (2 * ROWS * KPS<DP> + 2 * STEP * KPS<DP> + STEP * VPS<DP> +
                          2 * STEP + 2 * dkdv_raw<DP>());
}
// dQ: Q and dO row planes (ROWS rows), K and V row planes and K's pair plane
// (STEP rows), and a two-stage ring of raw float32 K and V rows
template <int DP>
__host__ __device__ constexpr int dq_raw() { return 2 * Tiles<DP>::STEP * DP; }
template <int DP>
constexpr size_t dq_smem() {
  constexpr int ROWS = Tiles<DP>::ROWS, STEP = Tiles<DP>::STEP;
  return sizeof(float) * (2 * ROWS * KPS<DP> + 2 * STEP * KPS<DP> + STEP / 2 * VPS<DP> +
                          2 * dq_raw<DP>());
}

// (1) lse2 and Delta of row r = bh SqP + i: stats[r] = lse * log2 e,
// stats[rows + r] = rowsum(dO o O); padding rows (i >= Sq) get +inf and 0.
// One warp a row, lanes over D, a fixed shuffle order.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
            float* __restrict__ stats, long long rows, int Sq, int SqP, int D) {
  const int lane = threadIdx.x % 32;
  const long long first = ((long long)blockIdx.x * PREP_THREADS + threadIdx.x) / 32;
  const long long stride = (long long)gridDim.x * (PREP_THREADS / 32);
  for (long long r = first; r < rows; r += stride) {
    const long long bh = r / SqP;
    const int i = (int)(r - bh * SqP);
    const bool real = i < Sq;
    float acc = 0.0f;
    if (real) {
      const long long at = (bh * Sq + i) * D;
      for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dout[at + d]), to_f32(o[at + d]), acc);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
    if (lane == 0) {
      stats[r] = real ? lse[bh * Sq + i] * LOG2E : INFINITY;
      stats[rows + r] = real ? acc : 0.0f;
    }
  }
}

// Two rows' values at d .. d + 3 (x of row 2r, y of row 2r + 1) split into
// their row plane (at rp, row 2r; rp + KPS, row 2r + 1: the d pairs d / 2
// and d / 2 + 1) and, with PAIR, their pair plane (at pp: d + e in run e).
template <bool SPLIT, bool PAIR, int DP>
__device__ __forceinline__ void put_split(float* rp, float* pp, const float (&x)[4],
                                          const float (&y)[4]) {
  uint32_t bx[4], sx[4] = {0u, 0u, 0u, 0u}, by[4], sy[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    split<SPLIT>(x[e], bx[e], sx[e]);
    split<SPLIT>(y[e], by[e], sy[e]);
  }
  *reinterpret_cast<uint4*>(rp) = make_uint4(bx[0], bx[1], sx[0], sx[1]);
  *reinterpret_cast<uint4*>(rp + 4) = make_uint4(bx[2], bx[3], sx[2], sx[3]);
  *reinterpret_cast<uint4*>(rp + KPS<DP>) = make_uint4(by[0], by[1], sy[0], sy[1]);
  *reinterpret_cast<uint4*>(rp + KPS<DP> + 4) = make_uint4(by[2], by[3], sy[2], sy[3]);
  if constexpr (PAIR) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint4*>(pp + e * ES<DP>) = make_uint4(bx[e], by[e], sx[e], sy[e]);
  }
}

// row `row` of src (rows, D) at d .. d + 3 as float32, zero past `valid`
// rows and past D; VEC: one 16-byte load (float32, D % 4 == 0, aligned)
template <typename T>
__device__ __forceinline__ void load4(float (&x)[4], const T* __restrict__ src, int row,
                                      int valid, int d, int D, bool vec) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = 0.0f;
  if (row >= valid) return;
  const T* p = src + (long long)row * D + d;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      if (d < D) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        x[0] = f.x;
        x[1] = f.y;
        x[2] = f.z;
        x[3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d + e < D) x[e] = to_f32(p[e]);
}

// N rows of src (rows, D), zero from row `valid` on, split into a row plane
// and, with PAIR, a pair plane: each thread takes two rows x 4 values
template <typename T, int DP, int N, bool PAIR>
__device__ __forceinline__ void split_global(float* rows, float* pairs, const T* __restrict__ src,
                                             int valid, int D, bool vec) {
  constexpr int Q4 = DP / 4;
  for (int e = threadIdx.x; e < N / 2 * Q4; e += Tiles<DP>::THREADS) {
    const int r2 = e / Q4, d = (e % Q4) * 4;
    float x[4], y[4];
    load4<T>(x, src, 2 * r2, valid, d, D, vec);
    load4<T>(y, src, 2 * r2 + 1, valid, d, D, vec);
    put_split<std::is_same<T, float>::value, PAIR, DP>(rows + 2 * r2 * KPS<DP> + 2 * d,
                                                       pairs + r2 * VPS<DP> + d, x, y);
  }
}

// The same from N raw float32 rows in shared memory (row stride DP, zero
// past the valid rows and D: cp.async's fill)
template <int DP, int N, bool PAIR>
__device__ __forceinline__ void split_raw(float* rows, float* pairs, const float* raw) {
  constexpr int Q4 = DP / 4;
  for (int e = threadIdx.x; e < N / 2 * Q4; e += Tiles<DP>::THREADS) {
    const int r2 = e / Q4, d = (e % Q4) * 4;
    const float4 a = *reinterpret_cast<const float4*>(raw + 2 * r2 * DP + d);
    const float4 c = *reinterpret_cast<const float4*>(raw + (2 * r2 + 1) * DP + d);
    const float x[4] = {a.x, a.y, a.z, a.w}, y[4] = {c.x, c.y, c.z, c.w};
    put_split<true, PAIR, DP>(rows + 2 * r2 * KPS<DP> + 2 * d, pairs + r2 * VPS<DP> + d, x, y);
  }
}

// N rows of float32 src (rows, D, D % 4 == 0) into raw rows of stride DP by
// 16-byte cp.async, zero from row `valid` on and past D
template <int DP, int N>
__device__ __forceinline__ void load_raw(float* dst, const float* __restrict__ src, int valid,
                                         int D) {
  constexpr int Q4 = DP / 4;
  for (int e = threadIdx.x; e < N * Q4; e += Tiles<DP>::THREADS) {
    const int r = e / Q4, d = (e % Q4) * 4;
    const bool in = r < valid && d < D;
    cp_async16(dst + r * DP + d, in ? src + (long long)r * D + d : src, in);
  }
}

// s[i] += a_s * b[i] and dp[i] += a_d * c[i] over the NT n-tiles, the
// 3xTF32 terms phased across the tiles of both products so that their
// chains overlap: A from a row plane (rows g and g + 8), B from a row plane
// (row 8 i + g), k-step ks
template <bool SPLIT, int DP, int NT = Tiles<DP>::NT>
__device__ __forceinline__ void two_products(float (&s)[NT][4], float (&dp)[NT][4],
                                             const float* as_, const float* ad,
                                             const float* bs, const float* bd, int ks) {
  const uint4 a0 = *reinterpret_cast<const uint4*>(as_ + 16 * ks);
  const uint4 a1 = *reinterpret_cast<const uint4*>(as_ + 8 * KPS<DP> + 16 * ks);
  const uint4 c0 = *reinterpret_cast<const uint4*>(ad + 16 * ks);
  const uint4 c1 = *reinterpret_cast<const uint4*>(ad + 8 * KPS<DP> + 16 * ks);
  const uint32_t sb[4] = {a0.x, a1.x, a0.y, a1.y}, ss[4] = {a0.z, a1.z, a0.w, a1.w};
  const uint32_t db[4] = {c0.x, c1.x, c0.y, c1.y}, ds[4] = {c0.z, c1.z, c0.w, c1.w};
  uint4 ys[NT], yd[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    ys[i] = *reinterpret_cast<const uint4*>(bs + 8 * i * KPS<DP> + 16 * ks);
    yd[i] = *reinterpret_cast<const uint4*>(bd + 8 * i * KPS<DP> + 16 * ks);
  }
  if (SPLIT) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mma(s[i], ss, ys[i].x, ys[i].y);
      mma(dp[i], ds, yd[i].x, yd[i].y);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mma(s[i], sb, ys[i].z, ys[i].w);
      mma(dp[i], db, yd[i].z, yd[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    mma(s[i], sb, ys[i].x, ys[i].y);
    mma(dp[i], db, yd[i].x, yd[i].y);
  }
}

// A fragment of a C fragment (rows g, g + 8; columns 2t, 2t + 1 of the
// n-tile), split: column t is read as 2t and column t + 4 as 2t + 1
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split<true>(c[0], ab[0], as[0]);
  split<true>(c[2], ab[1], as[1]);
  split<true>(c[1], ab[2], as[2]);
  split<true>(c[3], ab[3], as[3]);
}

// acc[j] += sum over the tile's NT k-steps i of A_i B_i[j], j over the KS =
// DP / 8 n-tiles of D. A_i is float32 (split: ab, as); B_i is a pair plane's
// pair-row 4 i + t (b: at pair-row t, d = g), 16 bytes at d = 8 j + g; SB: B
// has small halves. CH n-tiles at a time, the three terms phased across them.
// The tile's sum starts from zero and is added to acc in float32, rounded to
// nearest: the tensor cores truncate each accumulation, and one chain over
// the 2,048 q rows of a granite-moe dK/dV block drifted past BWD_F32_ERR.
template <bool SB, int DP, int NT = Tiles<DP>::NT>
__device__ __forceinline__ void tile_product(float (&acc)[DP / 8][4],
                                             const uint32_t (&ab)[NT][4],
                                             const uint32_t (&as)[NT][4], const float* b) {
  constexpr int KS = DP / 8, W = CH<KS>;
#pragma unroll
  for (int j0 = 0; j0 < KS; j0 += W) {
    float part[W][4];
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint4 y[W];
#pragma unroll
      for (int c = 0; c < W; ++c)
        y[c] = *reinterpret_cast<const uint4*>(b + 4 * i * VPS<DP> + 8 * (j0 + c));
#pragma unroll
      for (int c = 0; c < W; ++c) mma(part[c], as[i], y[c].x, y[c].y);
      if (SB) {
#pragma unroll
        for (int c = 0; c < W; ++c) mma(part[c], ab[i], y[c].z, y[c].w);
      }
#pragma unroll
      for (int c = 0; c < W; ++c) mma(part[c], ab[i], y[c].x, y[c].y);
    }
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + c][e] += part[c][e];
  }
}

// tile_product for two products at once (dV and dK of a dK/dV block) over
// NT k-steps, their n-tiles phased together, CH / 2 of each at a time
template <bool SB, int DP, int NT = Tiles<DP>::NT>
__device__ __forceinline__ void tile_products(float (&acc0)[DP / 8][4],
                                              const uint32_t (&a0b)[NT][4],
                                              const uint32_t (&a0s)[NT][4], const float* b0,
                                              float (&acc1)[DP / 8][4],
                                              const uint32_t (&a1b)[NT][4],
                                              const uint32_t (&a1s)[NT][4], const float* b1) {
  constexpr int KS = DP / 8, W = CH<KS> / 2 > 0 ? CH<KS> / 2 : 1;
#pragma unroll
  for (int j0 = 0; j0 < KS; j0 += W) {
    float p0[W][4], p1[W][4];
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p0[c][e] = 0.0f;
        p1[c][e] = 0.0f;
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint4 y0[W], y1[W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        y0[c] = *reinterpret_cast<const uint4*>(b0 + 4 * i * VPS<DP> + 8 * (j0 + c));
        y1[c] = *reinterpret_cast<const uint4*>(b1 + 4 * i * VPS<DP> + 8 * (j0 + c));
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
        mma(p0[c], a0s[i], y0[c].x, y0[c].y);
        mma(p1[c], a1s[i], y1[c].x, y1[c].y);
      }
      if (SB) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          mma(p0[c], a0b[i], y0[c].z, y0[c].w);
          mma(p1[c], a1b[i], y1[c].z, y1[c].w);
        }
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
        mma(p0[c], a0b[i], y0[c].x, y0[c].y);
        mma(p1[c], a1b[i], y1[c].x, y1[c].y);
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[j0 + c][e] += p0[c][e];
        acc1[j0 + c][e] += p1[c][e];
      }
  }
}

// where a lane's B fragments of a pair plane start: pair-row t, d = g
template <int DP>
__device__ __forceinline__ const float* pair_frag(const float* plane, int g, int t) {
  return plane + t * VPS<DP> + (g & 3) * ES<DP> + 4 * (g >> 2);
}

// (2) dK and dV of ROWS kv rows of one (batch, kv head)
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles<DP>::THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv, int SqP, int D, float scale,
            float scale_log2, bool vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int KS = DP / 8;                 // k-steps of S^T, n-tiles of dK and dV
  constexpr int RAW = dkdv_raw<DP>();
  constexpr int THREADS = Tiles<DP>::THREADS, ROWS = Tiles<DP>::ROWS;
  constexpr int STEP = Tiles<DP>::STEP, NT = Tiles<DP>::NT;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // ROWS x KPS: K row plane
  float* Vs = Ks + ROWS * KPS<DP>;
  float* Qr = Vs + ROWS * KPS<DP>;           // STEP x KPS: Q row plane
  float* Or = Qr + STEP * KPS<DP>;           // dO row plane
  float* Qp = Or + STEP * KPS<DP>;           // STEP / 2 x VPS: Q pair plane
  float* Op = Qp + STEP / 2 * VPS<DP>;       // dO pair plane
  float* Ls = Op + STEP / 2 * VPS<DP>;       // lse2 of the tile's q rows
  float* Ds = Ls + STEP;                     // Delta
  float* raw = Ds + STEP;                    // 2 stages: Q, dO (STEP x DP each), lse2, Delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bkv = blockIdx.x;                // b * Hkv + j
  const int b = bkv / Hkv, j = bkv % Hkv;
  const int k0 = blockIdx.y * ROWS;          // heavy tiles first: the first keys
  const int off = Skv - Sq;
  const long long plane = (long long)(gridDim.x / Hkv) * Hq * SqP;   // B Hq SqP
  const int n_qt = (Sq + STEP - 1) / STEP;
  int qt0 = 0;                               // the first q tile that sees k0
  if (CAUSAL && k0 - off > 0) qt0 = min(n_qt, (k0 - off) / STEP);
  const int per_head = n_qt - qt0;
  const int n_items = (Hq / Hkv) * per_head;
  auto head_of = [&](int it) { return b * Hq + j + (it / per_head) * Hkv; };
  auto q0_of = [&](int it) { return (qt0 + it % per_head) * STEP; };

  // raw Q and dO rows of item `it`, with their lse2 and Delta, by cp.async
  auto fetch = [&](int it, int stage) {
    if constexpr (SPLIT) {
      const int bh = head_of(it), q0 = q0_of(it);
      float* r = raw + stage * RAW;
      const long long at = ((long long)bh * Sq + q0) * D;
      load_raw<DP, STEP>(r, q + at, Sq - q0, D);
      load_raw<DP, STEP>(r + STEP * DP, dout + at, Sq - q0, D);
      const float* st = stats + (long long)bh * SqP + q0;   // padded: SqP >= q0 + STEP
      for (int e = threadIdx.x; e < STEP / 2; e += THREADS) {
        const int which = e / (STEP / 4), c = (e % (STEP / 4)) * 4;
        cp_async16(r + 2 * STEP * DP + which * STEP + c, st + which * plane + c, true);
      }
      cp_commit();
    }
  };

  if (vec && n_items > 0) fetch(0, 0);
  const long long kvrow = (long long)bkv * Skv + k0;
  split_global<T, DP, ROWS, false>(Ks, nullptr, k + kvrow * D, Skv - k0, D, vec);
  split_global<T, DP, ROWS, false>(Vs, nullptr, v + kvrow * D, Skv - k0, D, vec);

  const int kw = warp * 16;                  // this warp's first kv row in the tile
  const bool idle = k0 + kw >= Skv;          // its rows are all past Skv
  const float* ka = Ks + (kw + g) * KPS<DP> + 4 * t;
  const float* va = Vs + (kw + g) * KPS<DP> + 4 * t;
  const float* qb = Qr + g * KPS<DP> + 4 * t;
  const float* ob = Or + g * KPS<DP> + 4 * t;
  float ak[KS][4], av[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ak[i][e] = 0.0f;
      av[i][e] = 0.0f;
    }

  for (int it = 0; it < n_items; ++it) {
    const int q0 = q0_of(it);
    if (vec) {
      if (it + 1 < n_items) {
        fetch(it + 1, (it + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    __syncthreads();   // this item's raw rows have landed; the split tile is free
    if (vec) {
      const float* r = raw + (it & 1) * RAW;
      split_raw<DP, STEP, true>(Qr, Qp, r);
      split_raw<DP, STEP, true>(Or, Op, r + STEP * DP);
      for (int e = threadIdx.x; e < 2 * STEP; e += THREADS) Ls[e] = r[2 * STEP * DP + e];
    } else {
      const long long at = ((long long)head_of(it) * Sq + q0) * D;
      split_global<T, DP, STEP, true>(Qr, Qp, q + at, Sq - q0, D, false);
      split_global<T, DP, STEP, true>(Or, Op, dout + at, Sq - q0, D, false);
      const float* st = stats + (long long)head_of(it) * SqP + q0;
      for (int e = threadIdx.x; e < 2 * STEP; e += THREADS)
        Ls[e] = st[(e / STEP) * plane + e % STEP];
    }
    __syncthreads();
    // else no q row of the tile sees a kv row of this warp
    if (idle || (CAUSAL && k0 + kw > q0 + STEP - 1 + off)) continue;

    // S^T = K Q^T and dP^T = V dO^T (16 kv rows x STEP q columns)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = 0.0f;
        dp[i][e] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) two_products<SPLIT, DP>(s, dp, ka, va, qb, ob, ks);

    // P^T and dS^T; s[i][e]: kv row kw + g + 8 (e / 2), q column 8 i + 2 t + e % 2
    const bool diagonal = CAUSAL && k0 + kw + 15 > q0 + off;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * i + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(Ds + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[i][e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (diagonal && k0 + kw + g + 8 * (e >> 1) > q0 + 8 * i + 2 * t + (e & 1) + off) p = 0.0f;
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: k-step i takes n-tile i of P^T and dS^T
    // and the pair-row 4 i + t (q rows 8 i + 2 t, 8 i + 2 t + 1) of dO and Q
    // in halves of up to 16 q rows, so that half the A fragments are live
    constexpr int HALF = NT < 2 ? NT : 2;
#pragma unroll
    for (int h0 = 0; h0 < NT; h0 += HALF) {
      uint32_t pb[HALF][4], ps[HALF][4], db[HALF][4], ds[HALF][4];
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        c_to_a(s[h0 + i], pb[i], ps[i]);
        c_to_a(dp[h0 + i], db[i], ds[i]);
      }
      tile_products<SPLIT, DP, HALF>(av, pb, ps, pair_frag<DP>(Op, g, t) + 4 * h0 * VPS<DP>,
                                     ak, db, ds, pair_frag<DP>(Qp, g, t) + 4 * h0 * VPS<DP>);
    }
  }

  // dK scaled; both rounded to T once; C fragment (g, 2t), (g, 2t+1), (g+8, ...)
#pragma unroll
  for (int jt = 0; jt < KS; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + kw + g + 8 * (e >> 1);
      const int d = 8 * jt + 2 * t + (e & 1);
      if (row < Skv && d < D) {
        const long long at = ((long long)bkv * Skv + row) * D + d;
        dk[at] = from_f32<T>(ak[jt][e] * scale);
        dv[at] = from_f32<T>(av[jt][e]);
      }
    }
}

// (3) dQ of ROWS q rows of one (batch, q head)
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles<DP>::THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dq,
          int Hq, int Hkv, int Sq, int Skv, int SqP, int D, float scale, float scale_log2,
          bool vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int KS = DP / 8;
  constexpr int RAW = dq_raw<DP>();
  constexpr int THREADS = Tiles<DP>::THREADS, ROWS = Tiles<DP>::ROWS;
  constexpr int STEP = Tiles<DP>::STEP, NT = Tiles<DP>::NT;
  extern __shared__ __align__(16) float smem[];
  float* Qr = smem;                          // ROWS x KPS: Q row plane
  float* Or = Qr + ROWS * KPS<DP>;           // dO row plane
  float* Kr = Or + ROWS * KPS<DP>;           // STEP x KPS: K row plane
  float* Vr = Kr + STEP * KPS<DP>;           // V row plane
  float* Kp = Vr + STEP * KPS<DP>;           // STEP / 2 x VPS: K pair plane
  float* raw = Kp + STEP / 2 * VPS<DP>;      // 2 stages: K, V (STEP x DP each)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;                 // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const long long kvh = (long long)b * Hkv + h % Hkv;   // group-major
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heavy tiles first
  const int off = Skv - Sq;
  int n_kv = (Skv + STEP - 1) / STEP;
  if (CAUSAL) {  // the last kv position any real row of this block sees
    const long long last = (long long)min(q0 + ROWS, Sq) - 1 + off;
    n_kv = last < 0 ? 0 : (int)min((long long)n_kv, last / STEP + 1);
  }
  const T* kh = k + kvh * Skv * D;
  const T* vh = v + kvh * Skv * D;

  auto fetch = [&](int jt, int stage) {     // raw K and V rows of kv tile jt
    if constexpr (SPLIT) {
      float* r = raw + stage * RAW;
      const long long at = (long long)jt * STEP * D;
      load_raw<DP, STEP>(r, kh + at, Skv - jt * STEP, D);
      load_raw<DP, STEP>(r + STEP * DP, vh + at, Skv - jt * STEP, D);
      cp_commit();
    }
  };

  if (vec && n_kv > 0) fetch(0, 0);
  const long long qrow = (long long)bh * Sq + q0;
  split_global<T, DP, ROWS, false>(Qr, nullptr, q + qrow * D, Sq - q0, D, vec);
  split_global<T, DP, ROWS, false>(Or, nullptr, dout + qrow * D, Sq - q0, D, vec);

  const int qw = warp * 16;                  // this warp's first q row in the block
  const bool idle = q0 + qw >= Sq;           // its rows are all past Sq
  const long long plane = (long long)gridDim.x * SqP;
  float lse2[2], delta[2];
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {           // padded: SqP >= q0 + ROWS
    const long long r = (long long)bh * SqP + q0 + qw + g + 8 * hh;
    lse2[hh] = stats[r];
    delta[hh] = stats[plane + r];
    qpos[hh] = q0 + qw + g + 8 * hh + off;
  }
  const float* qa = Qr + (qw + g) * KPS<DP> + 4 * t;
  const float* oa = Or + (qw + g) * KPS<DP> + 4 * t;
  const float* kb = Kr + g * KPS<DP> + 4 * t;
  const float* vb = Vr + g * KPS<DP> + 4 * t;
  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * STEP;
    if (vec) {
      if (jt + 1 < n_kv) {
        fetch(jt + 1, (jt + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    __syncthreads();   // this tile's raw rows have landed; the split tile is free
    if (vec) {
      const float* r = raw + (jt & 1) * RAW;
      split_raw<DP, STEP, true>(Kr, Kp, r);
      split_raw<DP, STEP, false>(Vr, nullptr, r + STEP * DP);
    } else {
      const long long at = (long long)k0 * D;
      split_global<T, DP, STEP, true>(Kr, Kp, kh + at, Skv - k0, D, false);
      split_global<T, DP, STEP, false>(Vr, nullptr, vh + at, Skv - k0, D, false);
    }
    __syncthreads();
    // else no row of this warp sees the tile
    if (idle || (CAUSAL && k0 > q0 + qw + 15 + off)) continue;

    // S = Q K^T and dP = dO V^T (16 q rows x STEP kv columns)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = 0.0f;
        dp[i][e] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) two_products<SPLIT, DP>(s, dp, qa, oa, kb, vb, ks);

    // dS; s[i][e]: q row qw + g + 8 (e / 2), kv column k0 + 8 i + 2 t + e % 2
    const bool ragged = k0 + STEP > Skv;
    const bool diagonal = CAUSAL && k0 + STEP - 1 > q0 + qw + off;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[i][e] * scale_log2 - lse2[e >> 1]);
        if (ragged || diagonal) {
          const int kpos = k0 + 8 * i + 2 * t + (e & 1);
          if (!(kpos < Skv && (!CAUSAL || kpos <= qpos[e >> 1]))) p = 0.0f;
        }
        dp[i][e] = p * (dp[i][e] - delta[e >> 1]);
      }

    // dQ += dS K: k-step i takes n-tile i of dS and K's pair-row 4 i + t
    uint32_t db[NT][4], ds[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) c_to_a(dp[i], db[i], ds[i]);
    tile_product<SPLIT, DP>(acc, db, ds, pair_frag<DP>(Kp, g, t));
  }

#pragma unroll
  for (int jt = 0; jt < KS; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + qw + g + 8 * (e >> 1);
      const int d = 8 * jt + 2 * t + (e & 1);
      if (row < Sq && d < D)
        dq[((long long)bh * Sq + row) * D + d] = from_f32<T>(acc[jt][e] * scale);
    }
}

template <typename K>
cudaError_t raise_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t go(const void* q, const void* k, const void* v, const void* dout, const float* stats,
               void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int SqP,
               int D, float scale, bool vec, cudaStream_t s) {
  const float scale_log2 = scale * LOG2E;   // as the forward scales
  auto dkdv = dkdv_kernel<T, DP, CAUSAL>;
  cudaError_t err = raise_smem(dkdv, dkdv_smem<DP>());
  if (err != cudaSuccess) return err;
  constexpr int ROWS = Tiles<DP>::ROWS, THREADS = Tiles<DP>::THREADS;
  repro::occ::note(dkdv, THREADS, dkdv_smem<DP>());
  dkdv<<<dim3(B * Hkv, (Skv + ROWS - 1) / ROWS), THREADS, dkdv_smem<DP>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dk, (T*)dv, Hq, Hkv, Sq,
      Skv, SqP, D, scale, scale_log2, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = dq_kernel<T, DP, CAUSAL>;
  if ((err = raise_smem(dqk, dq_smem<DP>())) != cudaSuccess) return err;
  repro::occ::note(dqk, THREADS, dq_smem<DP>());
  dqk<<<dim3(B * Hq, (Sq + ROWS - 1) / ROWS), THREADS, dq_smem<DP>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dq, Hq, Hkv, Sq, Skv,
      SqP, D, scale, scale_log2, vec);
  return cudaGetLastError();
}

#define ARGS q, k, v, dout, stats, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP, D, scale, vec, s
template <typename T, bool CAUSAL>
cudaError_t by_width(const void* q, const void* k, const void* v, const void* dout,
                     const float* stats, void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                     int Sq, int Skv, int SqP, int D, float scale, bool vec, cudaStream_t s) {
  if (D <= 16) return go<T, 16, CAUSAL>(ARGS);
  if (D <= 32) return go<T, 32, CAUSAL>(ARGS);
  if (D <= 64) return go<T, 64, CAUSAL>(ARGS);
  if (D <= 96) return go<T, 96, CAUSAL>(ARGS);
  return go<T, 128, CAUSAL>(ARGS);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* stats, void* dq, void* dk,
                   void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int SqP, int D,
                   float scale, int causal, cudaStream_t s) {
  const long long rows = (long long)B * Hq * SqP;
  const long long blocks =
      std::min<long long>((rows + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32), 132 * 16);
  repro::occ::note(prep_kernel<T>, PREP_THREADS, 0);
  prep_kernel<T><<<(unsigned)blocks, PREP_THREADS, 0, s>>>((const T*)out, (const T*)dout, lse,
                                                           stats, rows, Sq, SqP, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte rows: float32 with D % 4 == 0 at aligned addresses take the ring
  const bool vec = std::is_same<T, float>::value && D % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
  return causal ? by_width<T, true>(ARGS) : by_width<T, false>(ARGS);
}
#undef ARGS

}  // namespace

// q, out, dout, dq (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D), contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16. lse (B, Hq, Sq) float32 from
// the TF32 forward. Hq % Hkv == 0, 1 <= D <= 128. stats: 16-byte aligned
// float32 room for 2 B Hq SqP values, SqP = Sq rounded up to a multiple of
// 128 (`flash_attention.bwd_stats_floats`). Launches the three kernels on
// `stream`; returns the first CUDA error of the launches or attribute calls
// (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* stats, int B,
                                          int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                          int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 128 || Skv < 1 ||
      (Sq + 31) / 32 > 65535 || (Skv + 31) / 32 > 65535 ||
      (long long)B * Hq > 0x7fffffff || Sq > 0x7fffffff - SQ_ALIGN ||
      (uintptr_t)stats % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int SqP = (Sq + SQ_ALIGN - 1) / SQ_ALIGN * SQ_ALIGN;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ls = (const float*)lse;
  float* st = (float*)stats;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, out, dout, ls, st, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP,
                                D, scale, causal, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, out, dout, ls, st, dq, dk, dv, B, Hq, Hkv, Sq,
                                        Skv, SqP, D, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_OCCUPANCY(flash_attention_bwd)
