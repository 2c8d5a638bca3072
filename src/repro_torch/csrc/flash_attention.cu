// Causal GQA attention with an online softmax (FlashAttention-2 schedule),
// for Hopper, on the CUDA cores.
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
//
// Bound on the H100: operations. At granite-3-8b's layer (B = 4, S = 1024,
// D = 128, causal) attention does ~410 flops per byte of q, k, v and out,
// above the card's ~20 float32 (CUDA-core) and ~295 bf16 (tensor-core)
// flops per byte.
// This first kernel uses the CUDA cores only; wgmma and TMA come later, so
// it stays far from the bf16 tensor-core bound.
//
// Design: one 256-thread block per (q tile of 64 rows, q head, batch). The
// block keeps its Q tile in shared memory as float32 and walks the kv tiles
// of 64 positions in order, each staged in shared memory (k and v converted
// to float32); tiles wholly beyond the causal edge are not visited. Per kv
// tile: S = Q K^T, each thread a 4x4 register tile (rows ty + 16a, columns
// tx + 16b); the masked scores go to shared memory; each warp updates 8 rows'
// m and l with shuffle reductions and writes P in place of S; then each
// thread rescales and accumulates its 4 x D/16 slice of the output (rows
// ty + 16a, columns tx + 16c) in registers. Row strides of Q, K and S are
// padded by one float so that the column walks hit distinct banks. Any Sq
// and Skv: the ragged tiles are masked (the TPU kernel asserted
// divisibility). Shared memory is up to 114 KB at D = 128, so it is dynamic
// and the kernel raises its limit with cudaFuncSetAttribute.

#include "lane_group.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr float NEG = -1e30f;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (DP + 1) + (size_t)BKV * (DP + 1) +
                          (size_t)BKV * DP + (size_t)BQ * (BKV + 1) + 3 * BQ);
}

// DP: D padded to 16, 32, 64 or 128 (the padding holds zeros).
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Skv, int D, float scale, int kv_offset) {
  constexpr int QS = DP + 1;   // padded row strides
  constexpr int SS = BKV + 1;
  constexpr int NC = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x QS
  float* Ks = Qs + BQ * QS;         // BKV x QS
  float* Vs = Ks + BKV * QS;        // BKV x DP
  float* Ss = Vs + BKV * DP;        // BQ x SS: scores, then P
  float* m_s = Ss + BQ * SS;        // running max
  float* l_s = m_s + BQ;            // running sum
  float* c_s = l_s + BQ;            // this tile's rescale exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h % Hkv;
  const T* qp = q + ((long long)b * Hq + h) * Sq * D;
  const T* kp = k + ((long long)b * Hkv + hk) * Skv * D;
  const T* vp = v + ((long long)b * Hkv + hk) * Skv * D;
  T* op = o + ((long long)b * Hq + h) * Sq * D;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int i = e / DP, d = e % DP;
    Qs[i * QS + d] =
        (q0 + i < Sq && d < D) ? to_f32(qp[(long long)(q0 + i) * D + d]) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  int n_kv = (Skv + BKV - 1) / BKV;
  if (CAUSAL) {  // the last kv position any real row of this tile sees
    const long long last = (long long)min(q0 + BQ, Sq) - 1 + kv_offset;
    n_kv = last < 0 ? 0 : (int)min((long long)n_kv, last / BKV + 1);
  }

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BKV * DP; e += THREADS) {
      const int j = e / DP, d = e % DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + j < Skv && d < D) {
        const long long off = (long long)(k0 + j) * D + d;
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
      }
      Ks[j * QS + d] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = Ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const int qpos = q0 + i + kv_offset;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kpos = k0 + j;
        const bool ok = kpos < Skv && (!CAUSAL || kpos <= qpos);
        Ss[i * SS + j] = ok ? s[a][c] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two columns each
#pragma unroll 1
    for (int r = 0; r < BQ / 8; ++r) {
      const int i = warp * (BQ / 8) + r;
      const float x0 = Ss[i * SS + lane], x1 = Ss[i * SS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (std::is_same<T, __nv_bfloat16>::value) {  // P cast to V's type
        p0 = __bfloat162float(__float2bfloat16_rn(p0));
        p1 = __bfloat162float(__float2bfloat16_rn(p1));
      }
      Ss[i * SS + lane] = p0;
      Ss[i * SS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
        c_s[i] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = c_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pa[4], vb[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ss[(ty + 16 * a) * SS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vb[c] = Vs[j * DP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i >= Sq) continue;
    const float l = fmaxf(l_s[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) op[(long long)(q0 + i) * D + d] = from_f32<T>(acc[a][c] / l);
    }
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t go(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int D, float scale,
               cudaStream_t s) {
  auto kern = flash_kernel<T, DP, CAUSAL>;
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, bytes, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (T*)o, Hq, Hkv, Sq, Skv, D, scale,
                                    Skv - Sq);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Skv, int D,
                     float scale, cudaStream_t s) {
  if (D <= 16) return go<T, 16, CAUSAL>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s);
  if (D <= 32) return go<T, 32, CAUSAL>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s);
  if (D <= 64) return go<T, 64, CAUSAL>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s);
  return go<T, 128, CAUSAL>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s);
}

template <typename T>
cudaError_t by_causal(int causal, const void* q, const void* k, const void* v,
                      void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                      float scale, cudaStream_t s) {
  return causal ? by_width<T, true>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s)
                : by_width<T, false>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, s);
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D), contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16. Hq % Hkv == 0, 1 <= D <= 128.
// Returns the first CUDA error of the attribute call or the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 128 || Skv < 1 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)by_causal<float>(causal, q, k, v, out, B, Hq, Hkv, Sq, Skv, D, scale, s);
    case 1: return (int)by_causal<__nv_bfloat16>(causal, q, k, v, out, B, Hq, Hkv, Sq, Skv, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
