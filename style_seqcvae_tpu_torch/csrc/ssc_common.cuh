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

// 16 bytes of T held as one uint4 (one 16-byte load or store): kN elements,
// element e read as the f32 it converts to exactly
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float get(const uint4& q, int e) {
    return __uint_as_float(e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the upper half of its f32
  static __device__ __forceinline__ float get(const uint4& q, int e) {
    const unsigned w = (e >> 1) == 0 ? q.x : (e >> 1) == 1 ? q.y : (e >> 1) == 2 ? q.z : q.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

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

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special function unit (relative error ~2^-22; subnormal
// results flush to 0, far below what a logsumexp term can move)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Streaming logsumexp: folds (om, os), a max and the sum of exp(x - om),
// into (m, s). Symmetric, so every lane of a butterfly ends alike.
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float mn = fmaxf(m, om);
  if (mn != -INFINITY)
    s = s * exp2_approx((m - mn) * kLog2e) + os * exp2_approx((om - mn) * kLog2e);
  m = mn;
}

}  // namespace ssc
