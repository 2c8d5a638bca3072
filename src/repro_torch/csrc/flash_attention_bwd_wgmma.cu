// Backward of causal GQA attention for Hopper's tensor cores: bf16 `wgmma`
// fed by TMA, FlashAttention-2's schedule, no float atomics.
//
// Replaces no TPU kernel: the reference trains through XLA's attention
// (`repro/nn/layers.py:97`, use_flash=False) and differentiates it with
// jax.grad, so it has no Pallas backward. It is the bfloat16 route of the
// port's flash backward (D % 8 == 0, D <= 128: TMA needs 16-byte row
// strides); float32, and bf16 with D % 8 != 0, keep the CUDA-core kernel in
// flash_attention_bwd.cu.
//
// q, out, dout (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all bfloat16 and
// contiguous; lse (B, Hq, Sq) float32, each row's natural log-sum-exp as the
// wgmma forward (flash_attention_wgmma.cu) writes it, +inf for a row that
// sees nothing. dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in bfloat16.
// Query head h reads kv head h % Hkv (the reference's group-major map). With
// `causal`, query i sees kv positions <= i + Skv - Sq. A query row that sees
// no kv position gets a zero gradient.
//
// Numerics: scores q.k in float32 (the tensor cores accumulate bf16
// products in f32), in the log2 domain as the forward has them (x = s *
// scale * log2 e); P = exp2(x - lse * log2 e) against the forward's
// log-sum-exp, not recomputed; Delta = rowsum(dO o O) in float32 from the
// forward's output; dS = P o (dP - Delta) from the float32 P and dP. P and dS
// are rounded to bf16 before they enter a product (as the forward rounds P
// before P.V); every sum is float32 in the wgmma accumulators; dQ = scale
// dS K, dK = scale dS^T Q (summed over the q heads that read the kv head),
// dV = P^T dO, each rounded to bf16 once. The plain version that rounds at
// the same points is `kernels/flash_attention.py::attention_bwd_rounded`.
//
// Bound on the H100: operations. The backward needs five products of Sq x
// Skv x D a head (S, dP, dV, dK, dQ), half of them under the causal mask: at
// granite-moe-1b-a400m's layer (B = 8, 16 q / 8 kv heads, S = 1024, D = 64)
// 43 GFLOP on 50 MB of inputs and gradients, ~860 flops per byte, far above
// the card's ~295 bf16 (989 TFLOP/s over 3.35 TB/s). So the design keeps
// the work on the tensor cores and out of device memory:
//
//   launches — three, so that every sum is taken in one fixed order and a
//              call is bit-for-bit repeatable (no float atomics):
//              (i) `delta`: Delta = rowsum(dO o O), and lse converted to the
//              log2 domain, into a float32 scratch of two (B Hq, SqP) planes
//              (SqP = Sq rounded up to 128; padding rows hold +inf and 0, so
//              their P and dS are 0); bound by memory, a few microseconds.
//              (ii) `dkdv`: a block owns 128 kv rows of one (batch, kv
//              head); two consumer warpgroups own 64 rows each (wgmma's M).
//              K and V are loaded once by TMA; the dK and dV accumulators
//              stay in registers while the block walks the group's q heads
//              (h = j, j + Hkv, ...) and, within each, the q tiles of 64 rows
//              the mask lets in, so the head sum needs no atomics. Per q
//              tile: S^T = K Q^T and dP^T = V dO^T (kv rows as M, both
//              operands K-major in shared memory), P^T and dS^T in the
//              accumulator fragments, rounded to bf16, then serve directly as
//              the register A operand of dV += P^T dO and dK += dS^T Q (B is
//              dO or Q, (q, D) with D contiguous: N-major, wgmma's transpose
//              bit, as the forward's P.V reads V).
//              (iii) `dq`: a block owns 128 q rows of one (batch, q head),
//              two warpgroups of 64; Q, dO and each row's lse and Delta stay
//              resident while kv tiles of 64 stream through the ring:
//              S = Q K^T, dP = dO V^T, then dQ += dS K with dS from
//              registers. This recomputes S and dP (seven products a head
//              against the bound's five) so that dQ needs no atomics.
//   loads    — in (ii) and (iii) one producer thread issues every TMA load
//              on an mbarrier ring (a full and an empty barrier per stage):
//              in (ii) Q, dO and the tile's lse and Delta rows, in (iii) K
//              and V. bf16 tiles are 64-column panels with the 128-byte swizzle;
//              the tensor maps are 3-D (D, S, B * H), so a tile that runs past
//              Sq or Skv, or a D below the panel width, is zero-filled per
//              head. A 64-row box that would lie wholly past the end is not
//              issued; the rows it would fill are never stored.
//   masks    — only tiles on the causal diagonal compare positions; tiles
//              wholly beyond the causal edge are not loaded, and a warpgroup
//              skips a loaded tile none of its rows sees. A masked P is 0.
//   schedule — heavy tiles first: (ii) takes kv tiles from the front (the
//              first keys are seen by every query), (iii) q tiles from the
//              back, as the forward does.
//   registers — at D = 128 the dK and dV accumulators of 64 kv rows take 128
//              float32 registers a thread, S^T and dP^T another 64. A block
//              that issues wgmma gets registers by the warpgroup, so (ii)'s
//              producer is a whole warpgroup that gives its registers back
//              (setmaxnreg: 24 a thread) and the consumers take 240; with a
//              producer warp alone ptxas caps every thread at 168 and the
//              D = 128 instances spill. (iii) needs about 160 and keeps one
//              producer warp. chip_smoke.py's phase 2 prints the registers and
//              spill bytes of every instance.
//
// Not done here (ROADMAP, second designs): ping-pong of the two consumer
// warpgroups, persistent blocks, dQ without the recompute pass.

#include <math.h>

#include "occupancy.cuh"
#include "wgmma_tma.cuh"

namespace {

using namespace repro::hopper;

constexpr int WG_ROWS = 64;                // rows a consumer warpgroup owns (wgmma's M)
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp ((iii))
constexpr int DKDV_THREADS = CONSUMERS + 128;   // and a producer warpgroup ((ii))
constexpr int PRODUCER_REGS = 24;          // (ii)'s registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 240;         // 128 x 24 + 256 x 240 <= 65,536
constexpr int BLOCK_ROWS = 2 * WG_ROWS;    // kv rows of a (ii) block, q rows of a (iii) block
constexpr int TILE = 64;                   // q rows of a (ii) stage, kv rows of a (iii) stage
constexpr int BOX = 64;                    // rows of every bf16 TMA box
constexpr int SQ_ALIGN = 128;              // the scratch planes' row stride is a multiple
constexpr int DKDV_STAGES = 3;
constexpr int DQ_STAGES = 2;
constexpr int DELTA_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int DP>
struct DkdvLayout {
  static constexpr int PANELS = DP / PANEL;
  static constexpr int KV_BYTES = BLOCK_ROWS * DP * 2;    // one of K, V
  static constexpr int TILE_BYTES = TILE * DP * 2;        // one of Q, dO
  static constexpr int STATS_OFF = 2 * TILE_BYTES;        // lse2 then Delta, TILE floats each
  static constexpr int STAGE_TX = 2 * TILE_BYTES + 2 * TILE * 4;
  static constexpr int STAGE_BYTES = (STAGE_TX + 1023) / 1024 * 1024;
  // the shared-memory base is aligned up to 1024 bytes (the swizzle atom)
  static constexpr int SMEM = 2 * KV_BYTES + DKDV_STAGES * STAGE_BYTES + 1024;
};

template <int DP>
struct DqLayout {
  static constexpr int PANELS = DP / PANEL;
  static constexpr int Q_BYTES = BLOCK_ROWS * DP * 2;     // one of Q, dO
  static constexpr int KV_BYTES = TILE * DP * 2;          // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = 2 * Q_BYTES + DQ_STAGES * STAGE_BYTES + 1024;
};

// (i) one row per 16 lanes, 8 columns a lane (D <= 128, D % 8 == 0):
// stats[r] = lse * log2 e, stats[rows + r] = rowsum(dO o O) for r = bh SqP + i;
// padding rows (i >= Sq) get +inf and 0
__global__ void __launch_bounds__(DELTA_THREADS)
delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats, long long rows, int Sq,
             int SqP, int D) {
  const long long r = ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) / 16;
  const int c = (threadIdx.x % 16) * 8;
  const bool in = r < rows;
  const long long bh = in ? r / SqP : 0;
  const int i = in ? (int)(r - bh * SqP) : 0;
  const bool real = in && i < Sq;
  float acc = 0.0f;
  if (real && c < D) {
    const long long at = (bh * Sq + i) * D + c;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]), y = __bfloat1622float2(pg[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  if (in && c == 0) {
    stats[r] = real ? lse[bh * Sq + i] * LOG2E : INFINITY;
    stats[rows + r] = real ? acc : 0.0f;
  }
}

// (ii) dK and dV of BLOCK_ROWS kv rows of one (batch, kv head)
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tstats, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv, int D,
            float scale, float scale_log2) {
  using L = DkdvLayout<DP>;
  constexpr int STAGES = DKDV_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // kv, full[], empty[]

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_addr = base;                           // K: PANELS x (128 x 128 B)
  const uint32_t v_addr = base + L::KV_BYTES;
  const uint32_t ring = base + 2 * L::KV_BYTES;           // stage s: Q, dO, lse2, Delta
  const uint32_t kv_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);              // full[s] = full0 + 8 s
  const uint32_t empty0 = smem_u32(&bars[1 + STAGES]);

  const int bkv = blockIdx.x;                             // b * Hkv + j
  const int b = bkv / Hkv, j = bkv % Hkv;
  const int k0 = blockIdx.y * BLOCK_ROWS;                 // heavy tiles first
  const int off = Skv - Sq;
  const int bhs = (gridDim.x / Hkv) * Hq;                 // B * Hq
  const int n_qt = (Sq + TILE - 1) / TILE;
  int qt0 = 0;                                            // the first q tile that sees k0
  if (CAUSAL && k0 - off > 0) qt0 = min(n_qt, (k0 - off) / TILE);
  const int per_head = n_qt - qt0;
  const int n_items = (Hq / Hkv) * per_head;
  const int halves = k0 + BOX < Skv ? 2 : 1;              // 64-row boxes of K and V in range

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kv_bar, 2 * halves * L::PANELS * BOX * ROW_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        for (int hf = 0; hf < halves; ++hf) {
          const uint32_t at = p * BLOCK_ROWS * ROW_BYTES + hf * BOX * ROW_BYTES;
          tma_load_3d(k_addr + at, &tk, kv_bar, p * PANEL, k0 + hf * BOX, bkv);
          tma_load_3d(v_addr + at, &tv, kv_bar, p * PANEL, k0 + hf * BOX, bkv);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % STAGES;
        const uint32_t use = it / STAGES;
        mbar_wait(empty0 + 8 * s, (use & 1u) ^ 1u);       // released by item it - STAGES
        const int bh = b * Hq + j + (it / per_head) * Hkv;
        const int q0 = (qt0 + it % per_head) * TILE;
        const uint32_t st = ring + s * L::STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, L::STAGE_TX);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_3d(st + p * TILE * ROW_BYTES, &tq, full0 + 8 * s, p * PANEL, q0, bh);
          tma_load_3d(st + L::TILE_BYTES + p * TILE * ROW_BYTES, &tdo, full0 + 8 * s,
                      p * PANEL, q0, bh);
        }
        tma_load_2d(st + L::STATS_OFF, &tstats, full0 + 8 * s, q0, bh);
        tma_load_2d(st + L::STATS_OFF + TILE * 4, &tstats, full0 + 8 * s, q0, bhs + bh);
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 kv rows -------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row0 = wg * WG_ROWS + warp * 16 + lane / 4;  // kv rows row0, row0 + 8
    const int wg_first = k0 + wg * WG_ROWS;               // kv position of its first row
    const int wg_last = wg_first + WG_ROWS - 1;
    const bool idle = wg_first >= Skv;                    // its rows were not loaded
    const uint32_t k_wg = k_addr + wg * WG_ROWS * ROW_BYTES;
    const uint32_t v_wg = v_addr + wg * WG_ROWS * ROW_BYTES;

    float ak[DP / 2], av[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      ak[i] = 0.0f;
      av[i] = 0.0f;
    }
    mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_items; ++it) {
      const int s = it % STAGES;
      const uint32_t use = it / STAGES;
      const int q0 = (qt0 + it % per_head) * TILE;
      mbar_wait(full0 + 8 * s, use & 1u);
      const uint32_t q_addr = ring + s * L::STAGE_BYTES;
      const uint32_t do_addr = q_addr + L::TILE_BYTES;
      const float* lse2 =
          reinterpret_cast<const float*>(base_ptr + (q_addr - base) + L::STATS_OFF);
      const float* delta = lse2 + TILE;

      // else no kv row of this warpgroup is seen by a row of the tile
      if (!idle && !(CAUSAL && wg_first > q0 + TILE - 1 + off)) {
        // S^T = K Q^T and dP^T = V dO^T
        float sc[TILE / 2], dp[TILE / 2];
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) {
          sc[i] = 0.0f;
          dp[i] = 0.0f;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t at = (kk % 4) * 32;               // k-step within the panel
          const uint64_t da = sw128_desc(k_wg + (kk / 4) * BLOCK_ROWS * ROW_BYTES + at, 16, 1024);
          const uint64_t db = sw128_desc(q_addr + (kk / 4) * TILE * ROW_BYTES + at, 16, 1024);
          wgmma_ss<TILE>(sc, da, db, kk > 0 ? 1 : 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t at = (kk % 4) * 32;
          const uint64_t da = sw128_desc(v_wg + (kk / 4) * BLOCK_ROWS * ROW_BYTES + at, 16, 1024);
          const uint64_t db = sw128_desc(do_addr + (kk / 4) * TILE * ROW_BYTES + at, 16, 1024);
          wgmma_ss<TILE>(dp, da, db, kk > 0 ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // P^T and dS^T; sc[4i + e]: kv row row0 + 8 (e / 2), q column
        // q0 + 8 i + 2 quad + e % 2
        const bool diagonal = CAUSAL && wg_last > q0 + off;
#pragma unroll
        for (int i = 0; i < TILE / 8; ++i) {
          const int c = 8 * i + 2 * quad;
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
          const float2 dl = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(sc[4 * i + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (diagonal && k0 + row0 + 8 * (e >> 1) > q0 + c + (e & 1) + off) p = 0.0f;
            sc[4 * i + e] = p;
            dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
        // rounded to bf16: k-step kk of the products takes n8 blocks 2 kk, 2 kk + 1
        uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }

        // dV += P^T dO, dK += dS^T Q
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint32_t at = kk * 16 * ROW_BYTES;
          wgmma_rs<DP>(av, pa[kk], sw128_desc(do_addr + at, TILE * ROW_BYTES, 1024));
          wgmma_rs<DP>(ak, dsa[kk], sw128_desc(q_addr + at, TILE * ROW_BYTES, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(av);
        fence_regs(ak);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: dK scaled, both rounded to bf16, masked stores
    const long long at = (long long)bkv * Skv * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = k0 + row0 + 8 * hh;
      if (row >= Skv) continue;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        if (col < D) {
          const long long x = at + (long long)row * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + x) =
              __floats2bfloat162_rn(ak[4 * i + 2 * hh] * scale, ak[4 * i + 2 * hh + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + x) =
              __floats2bfloat162_rn(av[4 * i + 2 * hh], av[4 * i + 2 * hh + 1]);
        }
      }
    }
  }
}

// (iii) dQ of BLOCK_ROWS q rows of one (batch, q head)
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
          int Sq, int Skv, int SqP, int D, float scale, float scale_log2) {
  using L = DqLayout<DP>;
  constexpr int STAGES = DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[], empty[]

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_addr = base;                           // Q: PANELS x (128 x 128 B)
  const uint32_t do_addr = base + L::Q_BYTES;
  const uint32_t ring = base + 2 * L::Q_BYTES;            // stage s: K then V
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);
  const uint32_t empty0 = smem_u32(&bars[1 + STAGES]);

  const int bh = blockIdx.x;                              // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h % Hkv;                      // group-major
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_ROWS;   // heavy tiles first
  const int off = Skv - Sq;
  const int halves = q0 + BOX < Sq ? 2 : 1;               // 64-row boxes of Q and dO in range

  int n_kv = (Skv + TILE - 1) / TILE;
  if (CAUSAL) {  // the last kv position any real row of this block sees
    const long long last = (long long)min(q0 + BLOCK_ROWS, Sq) - 1 + off;
    n_kv = last < 0 ? 0 : (int)min((long long)n_kv, last / TILE + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer ----------------------------------------------------------
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_bar, 2 * halves * L::PANELS * BOX * ROW_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        for (int hf = 0; hf < halves; ++hf) {
          const uint32_t at = p * BLOCK_ROWS * ROW_BYTES + hf * BOX * ROW_BYTES;
          tma_load_3d(q_addr + at, &tq, q_bar, p * PANEL, q0 + hf * BOX, bh);
          tma_load_3d(do_addr + at, &tdo, q_bar, p * PANEL, q0 + hf * BOX, bh);
        }
      }
      for (int jt = 0; jt < n_kv; ++jt) {
        const int s = jt % STAGES;
        const uint32_t use = jt / STAGES;
        mbar_wait(empty0 + 8 * s, (use & 1u) ^ 1u);
        const uint32_t k_st = ring + s * L::STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, L::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_3d(k_st + p * TILE * ROW_BYTES, &tk, full0 + 8 * s, p * PANEL, jt * TILE, kvh);
          tma_load_3d(k_st + L::KV_BYTES + p * TILE * ROW_BYTES, &tv, full0 + 8 * s, p * PANEL,
                      jt * TILE, kvh);
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 q rows --------------------------
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row0 = wg * WG_ROWS + warp * 16 + lane / 4;  // q rows q0 + row0, + 8
    const int wg_first = q0 + wg * WG_ROWS + off;         // qpos of its first row
    const int wg_last = wg_first + WG_ROWS - 1;
    const bool idle = q0 + wg * WG_ROWS >= Sq;             // its rows were not loaded
    const long long srow = (long long)bh * SqP + q0 + row0;   // padded: SqP >= q0 + 128
    const long long plane = (long long)(gridDim.x) * SqP;
    float lse2[2], delta[2];
    int qpos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lse2[hh] = stats[srow + 8 * hh];
      delta[hh] = stats[plane + srow + 8 * hh];
      qpos[hh] = q0 + row0 + 8 * hh + off;
    }
    const uint32_t q_wg = q_addr + wg * WG_ROWS * ROW_BYTES;
    const uint32_t do_wg = do_addr + wg * WG_ROWS * ROW_BYTES;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    mbar_wait(q_bar, 0);

    for (int jt = 0; jt < n_kv; ++jt) {
      const int s = jt % STAGES;
      const uint32_t use = jt / STAGES;
      const int k0 = jt * TILE;
      mbar_wait(full0 + 8 * s, use & 1u);
      const uint32_t k_st = ring + s * L::STAGE_BYTES;
      const uint32_t v_st = k_st + L::KV_BYTES;

      if (!idle && !(CAUSAL && k0 > wg_last)) {   // else no row of this warpgroup sees the tile
        // S = Q K^T and dP = dO V^T
        float sc[TILE / 2], dp[TILE / 2];
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) {
          sc[i] = 0.0f;
          dp[i] = 0.0f;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t at = (kk % 4) * 32;
          const uint64_t da = sw128_desc(q_wg + (kk / 4) * BLOCK_ROWS * ROW_BYTES + at, 16, 1024);
          const uint64_t db = sw128_desc(k_st + (kk / 4) * TILE * ROW_BYTES + at, 16, 1024);
          wgmma_ss<TILE>(sc, da, db, kk > 0 ? 1 : 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t at = (kk % 4) * 32;
          const uint64_t da = sw128_desc(do_wg + (kk / 4) * BLOCK_ROWS * ROW_BYTES + at, 16, 1024);
          const uint64_t db = sw128_desc(v_st + (kk / 4) * TILE * ROW_BYTES + at, 16, 1024);
          wgmma_ss<TILE>(dp, da, db, kk > 0 ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // dS; sc[4i + e]: q row row0 + 8 (e / 2), kv column k0 + 8 i + 2 quad + e % 2
        const bool ragged = k0 + TILE > Skv;
        const bool diagonal = CAUSAL && k0 + TILE - 1 > wg_first;
        uint32_t dsa[TILE / 16][4];
#pragma unroll
        for (int i = 0; i < TILE / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(sc[4 * i + e] * scale_log2 - lse2[e >> 1]);
            if (ragged || diagonal) {
              const int kpos = k0 + 8 * i + 2 * quad + (e & 1);
              if (!(kpos < Skv && (!CAUSAL || kpos <= qpos[e >> 1]))) p = 0.0f;
            }
            dp[4 * i + e] = p * (dp[4 * i + e] - delta[e >> 1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

        // dQ += dS K (K is N-major here: (kv, D) with D contiguous)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint64_t db = sw128_desc(k_st + kk * 16 * ROW_BYTES, TILE * ROW_BYTES, 1024);
          wgmma_rs<DP>(acc, dsa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: scaled, rounded to bf16, masked stores
    __nv_bfloat16* qp = dq + (long long)bh * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + row0 + 8 * hh;
      if (row >= Sq) continue;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(qp + (long long)row * D + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * hh] * scale, acc[4 * i + 2 * hh + 1] * scale);
      }
    }
  }
}

struct Maps {
  CUtensorMap q, dout, k, v, stats;
};

template <int DP, bool CAUSAL>
cudaError_t go(const Maps& m, const float* stats, void* dq, void* dk, void* dv, int B, int Hq,
               int Hkv, int Sq, int Skv, int SqP, int D, float scale, cudaStream_t s) {
  const float scale_log2 = scale * LOG2E;                 // as the forward scales
  auto dkdv = dkdv_kernel<DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DkdvLayout<DP>::SMEM);
  if (err != cudaSuccess) return err;
  repro::occ::note(dkdv, DKDV_THREADS, DkdvLayout<DP>::SMEM);
  dkdv<<<dim3(B * Hkv, (Skv + BLOCK_ROWS - 1) / BLOCK_ROWS), DKDV_THREADS, DkdvLayout<DP>::SMEM,
         s>>>(
      m.q, m.dout, m.k, m.v, m.stats, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Hq, Hkv, Sq, Skv,
      D, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = dq_kernel<DP, CAUSAL>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqLayout<DP>::SMEM);
  if (err != cudaSuccess) return err;
  repro::occ::note(dqk, THREADS, DqLayout<DP>::SMEM);
  dqk<<<dim3(B * Hq, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS), THREADS, DqLayout<DP>::SMEM, s>>>(
      m.q, m.dout, m.k, m.v, stats, (__nv_bfloat16*)dq, Hq, Hkv, Sq, Skv, SqP, D, scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D): contiguous
// bfloat16, 16-byte aligned; lse (B, Hq, Sq) float32 from the wgmma forward.
// Hq % Hkv == 0, D % 8 == 0, 8 <= D <= 128. stats: float32 room for
// 2 B Hq SqP values, SqP = Sq rounded up to a multiple of 128. Launches the
// three kernels on `stream`; returns the first CUDA error of the tensor-map
// encoding (as cudaErrorInvalidValue), the attribute calls or the launches
// (0 on success).
extern "C" int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v,
                                                const void* out, const void* dout,
                                                const void* lse, void* dq, void* dk, void* dv,
                                                void* stats, int B, int Hq, int Hkv, int Sq,
                                                int Skv, int D, float scale, int causal,
                                                void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0 || Skv < 1 ||
      (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS > 65535 || (Skv + BLOCK_ROWS - 1) / BLOCK_ROWS > 65535 ||
      (long long)B * Hq > 0x3fffffff || Sq > 0x7fffffff - SQ_ALIGN)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)dout |
       (uintptr_t)stats) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int SqP = (Sq + SQ_ALIGN - 1) / SQ_ALIGN * SQ_ALIGN;
  const long long rows = (long long)B * Hq * SqP;
  Maps m;
  if (!tensor_map(&m.q, q, D, Sq, B * Hq, BOX) || !tensor_map(&m.dout, dout, D, Sq, B * Hq, BOX) ||
      !tensor_map(&m.k, k, D, Skv, B * Hkv, BOX) || !tensor_map(&m.v, v, D, Skv, B * Hkv, BOX) ||
      !tensor_map_f32(&m.stats, stats, SqP, 2 * B * Hq, TILE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (rows * 16 + DELTA_THREADS - 1) / DELTA_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  repro::occ::note(delta_kernel, DELTA_THREADS, 0);
  delta_kernel<<<(unsigned)blocks, DELTA_THREADS, 0, s>>>(
      (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, (const float*)lse, (float*)stats,
      rows, Sq, SqP, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* st = (const float*)stats;
  if (D <= 64)
    return causal ? (int)go<64, true>(m, st, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP, D, scale, s)
                  : (int)go<64, false>(m, st, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP, D, scale, s);
  return causal ? (int)go<128, true>(m, st, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP, D, scale, s)
                : (int)go<128, false>(m, st, dq, dk, dv, B, Hq, Hkv, Sq, Skv, SqP, D, scale, s);
}

REPRO_OCCUPANCY(flash_attention_bwd_wgmma)
