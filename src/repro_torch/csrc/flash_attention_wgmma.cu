// Causal GQA attention with an online softmax, for Hopper's tensor cores:
// bf16 `wgmma` fed by TMA, warp-specialised.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (Pallas
// `_flash_kernel`, :28-76) for bfloat16 inputs with D % 8 == 0 and D <= 128
// (every bf16 configuration of the repo: head_dim 64 or 128). q (B, Hq, Sq,
// D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D), all bfloat16 and
// contiguous. Query head h reads kv head h % Hkv (group-major, as the Pallas
// index map :119 and ref.attention_ref do). With `causal`, query i sees kv
// positions <= i + Skv - Sq (the decode offset). float32, and bf16 with
// D % 8 != 0 (TMA needs 16-byte row strides), take the TF32 mma.sync kernel
// in flash_attention.cu.
//
// Numerics follow `_flash_kernel`: scores q.k in float32 (the tensor cores
// accumulate bf16 products in f32), scaled by 1/sqrt(D) after the product;
// masked scores are -1e30, not -inf; the running max m, the sum l and the
// output accumulator are f32; l sums the unrounded P; P is rounded to bf16
// before P.V; the output is acc / max(l, 1e-30), rounded to bf16. The
// exponentials are exp2f with log2(e) folded into the scale: the scores,
// their max and the mask value live in the log2 domain, exp2(x - m) equals
// exp(x' - m') there, and exp2(-1e30 - m) is still exactly 0.
//
// Bound on the H100: operations. At granite-3-8b's layer (B = 4, 32 q / 8
// kv heads, S = 1024, D = 128, causal) attention does 34.4 GFLOP on 84 MB
// of q, k, v and out: ~410 flops per byte, above the card's ~295 bf16
// (989 TFLOP/s over 3.35 TB/s). So the design keeps the tensor cores fed:
//
//   tiles    — a block owns 128 q rows of one (batch, q head); two consumer
//              warpgroups own 64 rows each (wgmma's M). kv tiles of 64
//              positions go through a 2-stage ring in shared memory (64
//              rather than 128: the score fragment and P hold 48 fewer
//              values per thread, ptxas gives 145 registers rather than 167,
//              and the kernel runs faster on the H100).
//              The tile width and the ring depth are template parameters:
//              built with -DFLASH_WGMMA_PROBE, the library also exports
//              flash_attention_wgmma_probe, which takes them at run time
//              (BKV 64 or 128, 2 or 3 stages), and
//              scripts/port_kernel_probe.py times those variants; PERF.md
//              has its numbers. Q, K and V stay bf16 in shared memory (96 KB at
//              D = 128, 48 KB at D = 64), in 64-column panels of 128 bytes
//              per row with the 128-byte swizzle that TMA writes and wgmma
//              reads.
//   loads    — one producer warp issues TMA loads on mbarriers (a full and an
//              empty barrier per stage). The tensor maps are 3-D (D, S,
//              B * H), so a tile that runs past Sq or Skv, or a D below the
//              panel width, is zero-filled per head and never reads the next
//              head's rows.
//   S = Q K^T — wgmma m64nBKVk16, both operands from shared memory
//              (K-major), D / 16 k-steps, f32 accumulators in registers.
//   softmax  — on the accumulator fragment: a thread holds parts of two
//              rows, reduced over the 4 lanes of a quad by __shfl_xor_sync.
//              Only the diagonal tiles (causal) and a ragged last tile are
//              masked; tiles wholly beyond the causal edge are not loaded,
//              and a warpgroup skips a loaded tile that none of its rows
//              sees.
//   O += P V — wgmma with A = P from registers (the S accumulator fragment,
//              repacked to bf16 pairs, is the A fragment) and B = V from
//              shared memory; V is (kv, D) with D contiguous, so B is
//              N-major and takes wgmma's transpose bit.
//   schedule — the q-tile index is the grid's slow dimension, reversed, so
//              the heavy causal tiles start first and the light ones fill
//              the tail.
//   epilogue — divide by l, round to bf16, store with row and column masks.
//              Given an `lse` pointer, also write each row's natural
//              log-sum-exp, m ln 2 + ln l (+inf for a row that sees no kv
//              position), which the backward (flash_attention_bwd_wgmma.cu)
//              reads instead of recomputing it; the output is the same
//              bits with or without it.
//
// Not done here (PERF.md §7): ping-pong of one warpgroup's softmax against
// the other's products, overlap of the next Q K^T with this tile's softmax,
// persistent blocks.
//
// The mbarrier, TMA and wgmma helpers and the tensor-map encoding are in
// wgmma_tma.cuh.

#include <math.h>

#include "occupancy.cuh"
#include "wgmma_tma.cuh"

namespace {

using namespace repro::hopper;

constexpr int BQ = 128;                    // q rows per block
constexpr int SHIP_BKV = 64;               // kv positions per tile, as shipped
constexpr int SHIP_STAGES = 2;             // kv ring depth, as shipped
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

template <int DP, int BKV, int STAGES>
struct Layout {
  static constexpr int PANELS = DP / PANEL;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // the shared-memory base is aligned up to 1024 bytes (the swizzle atom)
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

// DP: D padded to a whole number of 64-column panels (64 or 128); TMA fills
// the padding with zeros. BKV: kv positions per tile (64 or 128); STAGES:
// the depth of the kv ring.
template <int DP, int BKV, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
            float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D,
            float scale_log2) {
  using L = Layout<DP, BKV, STAGES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[], empty[]

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_addr = base;                          // Q: PANELS x (BQ x 128 B)
  const uint32_t kv_addr = base + L::Q_BYTES;             // stage s: K then V
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);              // full[s] = full0 + 8 s
  const uint32_t empty0 = smem_u32(&bars[1 + STAGES]);

  const int bh = blockIdx.x;                              // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h % Hkv;                      // group-major
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;       // heavy tiles first
  const int kv_offset = Skv - Sq;

  int n_kv = (Skv + BKV - 1) / BKV;
  if (CAUSAL) {  // the last kv position any real row of this block sees
    const long long last = (long long)min(q0 + BQ, Sq) - 1 + kv_offset;
    n_kv = last < 0 ? 0 : (int)min((long long)n_kv, last / BKV + 1);
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
    // ---- producer: one thread issues every TMA load ----------------------
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_load_3d(sq_addr + p * BQ * ROW_BYTES, &tq, q_bar, p * PANEL, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const uint32_t use = j / STAGES;
        mbar_wait(empty0 + 8 * s, (use & 1u) ^ 1u);  // released by tile j - STAGES
        const uint32_t k_addr = kv_addr + s * L::STAGE_BYTES;
        const uint32_t v_addr = k_addr + L::KV_BYTES;
        mbar_expect_tx(full0 + 8 * s, L::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_3d(k_addr + p * BKV * ROW_BYTES, &tk, full0 + 8 * s, p * PANEL, j * BKV, kvh);
          tma_load_3d(v_addr + p * BKV * ROW_BYTES, &tv, full0 + 8 * s, p * PANEL, j * BKV, kvh);
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 rows ----------------------------
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row0 = wg * 64 + warp * 16 + lane / 4;      // rows row0, row0 + 8
    int qpos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) qpos[hh] = q0 + row0 + 8 * hh + kv_offset;
    const int wg_first = q0 + wg * 64 + kv_offset;        // qpos of its first row
    const int wg_last = wg_first + 63;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};

    const uint32_t q_wg = sq_addr + wg * 64 * ROW_BYTES;
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const uint32_t use = j / STAGES;
      const int k0 = j * BKV;
      mbar_wait(full0 + 8 * s, use & 1u);
      const uint32_t k_addr = kv_addr + s * L::STAGE_BYTES;
      const uint32_t v_addr = k_addr + L::KV_BYTES;

      if (!(CAUSAL && k0 > wg_last)) {   // else no row of this warpgroup sees the tile
        // S = Q K^T
        float sc[BKV / 2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;      // k-step within the panel
          const uint64_t da = sw128_desc(q_wg + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024);
          const uint64_t db = sw128_desc(k_addr + (kk / 4) * BKV * ROW_BYTES + off, 16, 1024);
          wgmma_ss<BKV>(sc, da, db, kk > 0 ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale (log2 domain) and mask; sc[4i + e]: row row0 + 8 (e / 2),
        // column k0 + 8 i + 2 quad + e % 2
        const bool ragged = k0 + BKV > Skv;
        const bool diagonal = CAUSAL && k0 + BKV - 1 > wg_first;
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * i + e] * scale_log2;
            if (ragged || diagonal) {
              const int kpos = k0 + 8 * i + 2 * quad + (e & 1);
              const bool ok = kpos < Skv && (!CAUSAL || kpos <= qpos[e >> 1]);
              x = ok ? x : NEG;
            }
            sc[4 * i + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          corr[hh] = exp2f(m[hh] - m_new);
          m[hh] = m_new;
        }
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[4 * i + e] - m[e >> 1]);
            sc[4 * i + e] = p;
            sum[e >> 1] += p;        // l sums the unrounded P
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + sum[hh];
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e >> 1];
        }
        // P rounded to bf16: k-step kk of P V takes n8 blocks 2 kk, 2 kk + 1
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }

        // O += P V
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t dv = sw128_desc(v_addr + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 1024);
          wgmma_rs<DP>(o, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: acc / max(l, 1e-30), rounded to bf16, masked stores
    __nv_bfloat16* op = out + (long long)bh * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
      l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
      const int row = q0 + row0 + 8 * hh;
      if (row >= Sq) continue;
      if (lse != nullptr && quad == 0)   // m stays NEG where no kv position is seen
        lse[(long long)bh * Sq + row] = m[hh] == NEG ? INFINITY : m[hh] * LN2 + logf(l[hh]);
      const float inv = 1.0f / fmaxf(l[hh], 1e-30f);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * D + col) =
              __floats2bfloat162_rn(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
      }
    }
  }
}

// -- host ----------------------------------------------------------------------

template <int DP, int BKV, int STAGES, bool CAUSAL>
cudaError_t go(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
               cudaStream_t s) {
  auto kern = flash_wgmma<DP, BKV, STAGES, CAUSAL>;
  constexpr int bytes = Layout<DP, BKV, STAGES>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  repro::occ::note(kern, THREADS, bytes);
  kern<<<grid, THREADS, bytes, s>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, Hq, Hkv, Sq, Skv, D,
                                    scale * LOG2E);
  return cudaGetLastError();
}

template <int BKV, int STAGES>
int launch(const void* q, const void* k, const void* v, void* out, void* lse_out, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0 || Skv < 1 ||
      (Sq + BQ - 1) / BQ > 65535 || (long long)B * Hq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, Sq, B * Hq, BQ) || !tensor_map(&tk, k, D, Skv, B * Hkv, BKV) ||
      !tensor_map(&tv, v, D, Skv, B * Hkv, BKV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* lse = (float*)lse_out;
  if (D <= 64)
    return causal ? (int)go<64, BKV, STAGES, true>(tq, tk, tv, out, lse, B, Hq, Hkv, Sq, Skv,
                                                   D, scale, s)
                  : (int)go<64, BKV, STAGES, false>(tq, tk, tv, out, lse, B, Hq, Hkv, Sq, Skv,
                                                    D, scale, s);
  return causal ? (int)go<128, BKV, STAGES, true>(tq, tk, tv, out, lse, B, Hq, Hkv, Sq, Skv,
                                                  D, scale, s)
                : (int)go<128, BKV, STAGES, false>(tq, tk, tv, out, lse, B, Hq, Hkv, Sq, Skv,
                                                   D, scale, s);
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D): contiguous
// bfloat16, 16-byte aligned. Hq % Hkv == 0, D % 8 == 0, 8 <= D <= 128.
// lse: null, or float32 room for B Hq Sq values (each row's natural
// log-sum-exp, +inf for a row that sees nothing).
// Returns the first CUDA error of the tensor-map encoding (as
// cudaErrorInvalidValue), the attribute call or the launch (0 on success).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int B, int Hq, int Hkv,
                                            int Sq, int Skv, int D, float scale, int causal,
                                            void* stream) {
  return launch<SHIP_BKV, SHIP_STAGES>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, scale,
                                       causal, stream);
}

#ifdef FLASH_WGMMA_PROBE
// The same kernel with the kv tile width `bkv` (64 or 128) and ring depth
// `stages` (2 or 3) chosen at run time, for design probes; otherwise as
// flash_attention_wgmma_launch.
extern "C" int flash_attention_wgmma_probe(const void* q, const void* k, const void* v,
                                           void* out, void* lse, int B, int Hq, int Hkv,
                                           int Sq, int Skv, int D, float scale, int causal,
                                           int bkv, int stages, void* stream) {
  if (bkv == 64 && stages == 2)
    return launch<64, 2>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, scale, causal, stream);
  if (bkv == 64 && stages == 3)
    return launch<64, 3>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, scale, causal, stream);
  if (bkv == 128 && stages == 2)
    return launch<128, 2>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, scale, causal, stream);
  if (bkv == 128 && stages == 3)
    return launch<128, 3>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}
#endif

REPRO_OCCUPANCY(flash_attention_wgmma)
