// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace ssc {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Selection order of every top-k here (lax.top_k's): larger value first,
// equal values by lower index. (v, i) comes before (w, j).
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Warp-wide first (value, index) in selection order.
__device__ __forceinline__ void warp_first(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(kFullMask, v, o);
    int j = __shfl_xor_sync(kFullMask, i, o);
    if (before(w, j, v, i)) { v = w; i = j; }
  }
}

// logsumexp from a row max and the sum of exp(x - max); a row whose max is
// not finite (all -inf) keeps the max, as the reference does.
__device__ __forceinline__ float finish_lse(float m, float s) {
  return isfinite(m) ? m + logf(s) : m;
}

}  // namespace ssc
