// Helpers shared by the kernels of this directory: float32 <-> bfloat16
// conversions and the lane-group dispatch of embedding_bag.cu (`Int` is
// ell_spmm.cu's too). `kernels/_build.py` hashes every header
// here together with each .cu file, so an edit here rebuilds every kernel.

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

// A group of G lanes works on one D-wide row, lanes over D: G = 32 (a warp)
// for D > 16, else the next power of two >= D, so narrow rows keep most lanes
// busy; lane l holds columns l + G*c for c < CH = ceil(D / G) <= 8, so any
// D up to 256 works and a group's row read is contiguous. Calls
// `launch(Int<G>{}, Int<CH>{})` for D's pair and returns what it returns;
// D outside [1, 256] gives cudaErrorInvalidValue.
template <typename Launch>
cudaError_t by_lane_group(int D, Launch&& launch) {
  if (D < 1) return cudaErrorInvalidValue;
  if (D <= 1) return launch(Int<1>{}, Int<1>{});
  if (D <= 2) return launch(Int<2>{}, Int<1>{});
  if (D <= 4) return launch(Int<4>{}, Int<1>{});
  if (D <= 8) return launch(Int<8>{}, Int<1>{});
  if (D <= 16) return launch(Int<16>{}, Int<1>{});
  switch ((D + 31) / 32) {
    case 1: return launch(Int<32>{}, Int<1>{});
    case 2: return launch(Int<32>{}, Int<2>{});
    case 3: return launch(Int<32>{}, Int<3>{});
    case 4: return launch(Int<32>{}, Int<4>{});
    case 5: return launch(Int<32>{}, Int<5>{});
    case 6: return launch(Int<32>{}, Int<6>{});
    case 7: return launch(Int<32>{}, Int<7>{});
    case 8: return launch(Int<32>{}, Int<8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
