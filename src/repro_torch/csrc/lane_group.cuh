// Helpers shared by the kernels of this directory: float32 <-> bfloat16
// conversions and `Int` (ell_spmm.cu's width dispatch). `kernels/_build.py`
// hashes every header here together with each .cu file, so an edit here
// rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int N> using Int = std::integral_constant<int, N>;

}  // namespace repro
