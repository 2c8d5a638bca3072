// Helpers of the two TF32 tensor-core sources, the float32 flash forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): the 3xTF32
// split, `mma.sync.m16n8k8` in TF32, and 16-byte `cp.async`.
// `kernels/_build.py` hashes every header here together with each .cu file.
//
// The 3xTF32 split: each float32 operand x becomes big = x rounded to TF32
// (10 mantissa bits, to nearest, ties away from zero: cvt.rna's rounding,
// done on the bits) and small = (x - big) rounded the same way (x - big is
// exact in float32), and a product is accumulated as small*big + big*small
// + big*big in float32; the dropped small*small term is below 2^-22 of the
// product. A bfloat16 value is exact in TF32: its small half is zero, and the
// terms that would multiply it are skipped.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace tf32 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), done on the bits: the same values for finite x, without the
// instructions cvt.rna spends on NaN and infinity.
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as (big, small) TF32 halves; without SPLIT, x is exact in TF32 already
// (a bfloat16 value) and small is not used.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (SPLIT) {
    big = rna_bits(x);
    small = rna_bits(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
  }
}

// c += a * b on the tensor cores: A 16 x 8 (row), B 8 x 8 (col), TF32 in,
// float32 accumulate. Lane l = 4 g + t holds A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g); C (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, with the 3xTF32 terms small*big + big*small + big*big.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t b0b,
                                     uint32_t b1b, uint32_t b0s, uint32_t b1s) {
  if (SPLIT) {
    mma(c, as, b0b, b1b);
    mma(c, ab, b0s, b1s);
  }
  mma(c, ab, b0b, b1b);
}

// 16 bytes global -> shared, asynchronously; `fill` false writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

}  // namespace tf32
}  // namespace repro
