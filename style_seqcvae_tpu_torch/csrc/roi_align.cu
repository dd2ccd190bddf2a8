// RoIAlign forward and backward, for Hopper (sm_90a). The backward is
// described at roi_align_backward_kernel below.
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/roi_align.py::
// roi_align_pallas (body `_kernel`, :27-89): NHWC features (B, H, W, C) in
// f32 or bf16 and rois (R, 5) f32 [batch_idx, x1, y1, x2, y2] in image
// coordinates -> (R, P, P, C) in the features' dtype. Each of the P x P bins
// is the mean of S x S bilinear samples, computed in f32, with the boundary
// rules of the classic CUDA RoIAlign: a sample outside [-1, H] x [-1, W] is
// empty, negative coordinates clamp to 0, the low corner clamps to H-1 / W-1.
// A batch index outside [0, B) is clamped into it.
//
// Bound on an H100 SXM: memory. At full width (features (16, 38, 58, 1024),
// R = 4,800) the function must read the 144 MB f32 map once and write the
// 963 MB pooled output, about 0.33 ms at 3.35 TB/s (half in bf16); its
// ~8 GFLOP of f32 arithmetic are well below that.
//
// Design: one block per RoI covers all its channels, each thread a vector
// of 16 bytes (4 f32 or 8 bf16 channels: 256 threads in f32 and 128 in bf16
// at C = 1,024), read and written with 16-byte accesses. The bilinear
// weights are separable: a sample's corner weight is (its row weight) x
// (its column weight), and emptiness is a row or a column property. So the
// block first builds, once per RoI, two small tables: for each output row
// ph the feature rows its S sample rows touch, with their summed weights,
// and the same for each output column pw. Samples that share a feature row
// or column (a RoI under ~14 feature pixels wide has them 1 px apart or
// less) share one entry, so a bin reads each feature pixel it touches once:
// at most 2S x 2S pixels, 9 rather than 16 at the usual S = 2, and a 12-px
// RoI reads ~440 pixels for its 49 bins instead of 784. Four bins of an
// output row are computed together, one 16-byte load in flight for each.
// The means are written with streaming stores (__stcs), so that the 963 MB
// output does not push out of L2 the 9 MB per-image map that the image's
// other RoIs read. Nothing stages the footprint in shared memory, so a RoI
// of any size, up to the whole map, takes the same path. The coordinate
// arithmetic is the plain version's f32 expressions, rounded step by step
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs), so both
// place every sample and corner alike; the sums run in another order (f32:
// a few 1e-7 apart; bf16: the mean may round to the neighbouring bf16
// value). When C is not a multiple of the vector, or a pointer is not
// 16-byte aligned, each thread reads and writes its channels one by one.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W) at full width: 0.875 ms in
// f32 and 0.642 ms in bf16 (chip_smoke.py, medians of 5 timings of 10
// launches); the old design (a block per (RoI, 256 channels), one channel
// per thread, 16 scalar corner reads per bin) took 2.191 and 2.379 ms.
// Reading every sample's own four corners instead costs 1.50 ms in f32
// (ops/kernels/ablate_topk_roi.py).
#include <cstdint>

#include "ssc_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroup = 4;     // bins of an output row computed together
constexpr int kMaxTaps = 64;  // P * 2S; the wrapper keeps P * S <= 32

// A 16-byte piece of the map, and one of the output, which is written once
// and read by the next layer much later: streamed past the caches, evict-first
// (ops/kernels/ablate_topk_roi.py times plain stores and other L2 policies)
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void store16(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// kN f32 values as the 16 bytes of T that hold them
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&x)[ssc::Vec16<T>::kN]);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    // round to nearest even, as torch's .to(bfloat16)
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * t], x[2 * t + 1]);
    w[t] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of channels, loaded and stored as one vector (kVec) or one by one
// (the first `valid` of them)
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_vec(const T* p, int valid) {
  if (kVec) return load16(p);
  uint4 q{0u, 0u, 0u, 0u};
  T* e = reinterpret_cast<T*>(&q);
  for (int j = 0; j < valid; ++j) e[j] = p[j];
  return q;
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[ssc::Vec16<T>::kN],
                                          int valid) {
  const uint4 q = pack16<T>(x);
  if (kVec) {
    store16(p, q);
  } else {
    const T* e = reinterpret_cast<const T*>(&q);
    for (int j = 0; j < valid; ++j) p[j] = e[j];
  }
}

// The feature rows (or columns) that the S samples of output row (column) p
// touch, with their summed bilinear weights; returns how many. lo is the
// RoI's first coordinate on the map, bin its bin size, size the map's H (W).
__device__ int sample_taps(float lo, float bin, int p, int S, int size, int* pos, float* w) {
  int n = 0;
  auto add = [&](int at, float weight) {
    if (weight == 0.0f) return;  // the sample lies on the other corner's line
    for (int t = 0; t < n; ++t)
      if (pos[t] == at) { w[t] += weight; return; }
    pos[n] = at;
    w[n++] = weight;
  };
  const float fs = static_cast<float>(S);
  for (int i = 0; i < S; ++i) {
    const float o = __fdiv_rn(static_cast<float>(i) + 0.5f, fs);
    float c = __fadd_rn(lo, __fmul_rn(__fadd_rn(static_cast<float>(p), o), bin));
    if (c < -1.0f || c > static_cast<float>(size)) continue;  // empty
    c = fmaxf(c, 0.0f);
    const int c0 = min(static_cast<int>(floorf(c)), size - 1);
    const int c1 = min(c0 + 1, size - 1);
    const float l = fminf(fmaxf(__fsub_rn(c, static_cast<float>(c0)), 0.0f), 1.0f);
    add(c0, __fsub_rn(1.0f, l));
    add(c1, l);
  }
  return n;
}

// Every output row's and column's taps (sample_taps) for one RoI, the
// block's threads sharing the 2P entries: the taps of output row ph are
// row_pos / row_w [ph * 2S, ph * 2S + row_n[ph]), of column pw likewise.
// The caller synchronises the block after.
__device__ void tap_tables(const float* roi, float spatial_scale, int P, int S, int H, int W,
                           int* row_pos, int* col_pos, int* row_n, int* col_n, float* row_w,
                           float* col_w) {
  const int S2 = 2 * S;
  for (int t = threadIdx.x; t < 2 * P; t += blockDim.x) {
    const bool is_row = t < P;
    const int p = is_row ? t : t - P;
    const float lo = __fmul_rn(roi[is_row ? 2 : 1], spatial_scale);
    const float hi = __fmul_rn(roi[is_row ? 4 : 3], spatial_scale);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), static_cast<float>(P));
    int* pos = (is_row ? row_pos : col_pos) + p * S2;
    float* w = (is_row ? row_w : col_w) + p * S2;
    (is_row ? row_n : col_n)[p] = sample_taps(lo, bin, p, S, is_row ? H : W, pos, w);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                 T* __restrict__ out, int B, int H, int W, int C, float spatial_scale,
                 int P, int S) {
  using Vec = ssc::Vec16<T>;
  constexpr int N = Vec::kN;
  // taps of output row ph: row_pos / row_w [ph * 2S, ph * 2S + row_n[ph])
  __shared__ int row_pos[kMaxTaps], col_pos[kMaxTaps], row_n[kMaxTaps / 2],
      col_n[kMaxTaps / 2];
  __shared__ float row_w[kMaxTaps], col_w[kMaxTaps];

  const int r = blockIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int b = min(max(static_cast<int>(roi[0]), 0), B - 1);
  const int S2 = 2 * S;
  tap_tables(roi, spatial_scale, P, S, H, W, row_pos, col_pos, row_n, col_n, row_w, col_w);
  __syncthreads();
  int col_taps = 0;  // the most column taps of any output column
  for (int p = 0; p < P; ++p) col_taps = max(col_taps, col_n[p]);

  // the mean of S * S samples: a product where 1 / S^2 is exact
  const float denom = static_cast<float>(S * S);
  const bool exact_inverse = ((S * S) & (S * S - 1)) == 0;
  const float inv = 1.0f / denom;
  for (int cv = threadIdx.x; cv * N < C; cv += blockDim.x) {
    const int c0 = cv * N, valid = min(N, C - c0);
    const T* img = feat + static_cast<size_t>(b) * H * W * C + c0;
    T* dst = out + static_cast<size_t>(r) * P * P * C + c0;
    for (int ph = 0; ph < P; ++ph) {
      for (int pw0 = 0; pw0 < P; pw0 += kGroup) {
        float acc[kGroup][N];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int e = 0; e < N; ++e) acc[g][e] = 0.0f;
        for (int a = 0; a < row_n[ph]; ++a) {
          const T* line = img + static_cast<size_t>(row_pos[ph * S2 + a]) * W * C;
          const float wy = row_w[ph * S2 + a];
          for (int t = 0; t < col_taps; ++t) {
            uint4 q[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const int pw = pw0 + g;
              if (pw < P && t < col_n[pw])
                q[g] = load_vec<T, kVec>(line + static_cast<size_t>(col_pos[pw * S2 + t]) * C,
                                         valid);
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const int pw = pw0 + g;
              if (pw < P && t < col_n[pw]) {
                const float w = wy * col_w[pw * S2 + t];
#pragma unroll
                for (int e = 0; e < N; ++e) acc[g][e] = fmaf(w, Vec::get(q[g], e), acc[g][e]);
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int pw = pw0 + g;
          if (pw < P) {
#pragma unroll
            for (int e = 0; e < N; ++e)
              acc[g][e] = exact_inverse ? acc[g][e] * inv : __fdiv_rn(acc[g][e], denom);
            store_vec<T, kVec>(dst + static_cast<size_t>(ph * P + pw) * C, acc[g], valid);
          }
        }
      }
    }
  }
}

template <typename T>
void launch(const void* feat, const void* rois, void* out, int B, int H, int W, int C, int R,
            float spatial_scale, int P, int S, cudaStream_t st) {
  constexpr int N = ssc::Vec16<T>::kN;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(out);
  const bool vec = C % N == 0 && (ends & 15) == 0;
  const int vectors = (C + N - 1) / N;
  const int threads = min(kMaxThreads, (vectors + 31) / 32 * 32);
  if (vec)
    roi_align_kernel<T, true><<<R, threads, 0, st>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois), static_cast<T*>(out), B,
        H, W, C, spatial_scale, P, S);
  else
    roi_align_kernel<T, false><<<R, threads, 0, st>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois), static_cast<T*>(out), B,
        H, W, C, spatial_scale, P, S);
}

// RoIAlign backward: the adjoint of the forward above, with no TPU kernel
// behind it. The JAX package trains through autodiff of its XLA gather
// (style_seqcvae_tpu/ops/roi_align.py:51, reached from
// models/detector/faster_rcnn.py:143), whose transpose is a scatter-add;
// the port's training path needs it as a kernel on the card.
//
// grad_out (R, P, P, C) in f32 or bf16 -> grad_features (B, H, W, C): each
// output bin's gradient, times 1 / S^2 as the forward's mean, is added to
// every feature pixel the bin's samples touch, with the forward's own taps
// and weights (tap_tables: the same coordinates, clamps, empty samples and
// merged row / column weights), so it is the adjoint of the forward and of
// the plain version's gather. Sums run in f32 with atomicAdd into a zeroed
// f32 buffer (the output itself in f32, a scratch buffer in bf16, then cast
// with round-to-nearest-even).
//
// Bound on an H100 SXM: memory. At the training path's (4, 40, 64, 1024)
// with 512 RoIs in f32 it must read 103 MB of grad_out and zero and write
// 42 MB of grad_features, about 0.06 ms at 3.35 TB/s.
//
// Design (simple first): a block per RoI, a thread per channel (strided
// over C), so that a warp's 32 atomics hit 32 consecutive floats of one
// pixel: one coalesced 128-byte reduction in L2. Overlapping RoIs of one
// image contend on the same pixels; the atomics add in another order on
// every run.
template <typename G>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_backward_kernel(const G* __restrict__ grad_out, const float* __restrict__ rois,
                          float* __restrict__ grad_feat, int B, int H, int W, int C,
                          float spatial_scale, int P, int S) {
  __shared__ int row_pos[kMaxTaps], col_pos[kMaxTaps], row_n[kMaxTaps / 2],
      col_n[kMaxTaps / 2];
  __shared__ float row_w[kMaxTaps], col_w[kMaxTaps];

  const int r = blockIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int b = min(max(static_cast<int>(roi[0]), 0), B - 1);
  const int S2 = 2 * S;
  tap_tables(roi, spatial_scale, P, S, H, W, row_pos, col_pos, row_n, col_n, row_w, col_w);
  __syncthreads();

  const float denom = static_cast<float>(S * S);
  const bool exact_inverse = ((S * S) & (S * S - 1)) == 0;
  const float inv = 1.0f / denom;
  const G* src = grad_out + static_cast<size_t>(r) * P * P * C;
  float* img = grad_feat + static_cast<size_t>(b) * H * W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int ph = 0; ph < P; ++ph) {
      for (int pw = 0; pw < P; ++pw) {
        const float go = ssc::to_float(src[static_cast<size_t>(ph * P + pw) * C + c]);
        const float g = exact_inverse ? go * inv : __fdiv_rn(go, denom);
        if (g == 0.0f) continue;
        for (int a = 0; a < row_n[ph]; ++a) {
          float* line = img + static_cast<size_t>(row_pos[ph * S2 + a]) * W * C + c;
          const float gy = row_w[ph * S2 + a] * g;
          for (int t = 0; t < col_n[pw]; ++t)
            atomicAdd(line + static_cast<size_t>(col_pos[pw * S2 + t]) * C,
                      gy * col_w[pw * S2 + t]);
        }
      }
    }
  }
}

// f32 -> bf16, round to nearest even
__global__ void cast_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                    size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

}  // namespace

// features (B, H, W, C), rois (R, 5) -> out (R, P, P, C). Needs P * S <= 32.
// Returns cudaGetLastError().
extern "C" int ssc_roi_align(const void* feat, const void* rois, void* out, int B, int H,
                             int W, int C, int R, float spatial_scale, int pooled,
                             int sampling, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(feat, rois, out, B, H, W, C, R, spatial_scale, pooled, sampling, st);
  else
    launch<float>(feat, rois, out, B, H, W, C, R, spatial_scale, pooled, sampling, st);
  return static_cast<int>(cudaGetLastError());
}

// grad_out (R, P, P, C) -> grad_feat (B, H, W, C), both f32 or both bf16;
// acc is a (B, H, W, C) f32 buffer for the sums when they are bf16 (else
// null: the sums go to grad_feat). Zeroes the sums, accumulates, and casts
// for bf16. Needs P * S <= 32. Returns cudaGetLastError().
extern "C" int ssc_roi_align_backward(const void* grad_out, const void* rois, void* grad_feat,
                                      void* acc, int B, int H, int W, int C, int R,
                                      float spatial_scale, int pooled, int sampling, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(B) * H * W * C;
  float* sums = is_bf16 ? static_cast<float*>(acc) : static_cast<float*>(grad_feat);
  cudaError_t err = cudaMemsetAsync(sums, 0, n * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = min(kMaxThreads, (C + 31) / 32 * 32);
  if (R > 0) {
    if (is_bf16)
      roi_align_backward_kernel<__nv_bfloat16><<<R, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(grad_out), static_cast<const float*>(rois), sums, B,
          H, W, C, spatial_scale, pooled, sampling);
    else
      roi_align_backward_kernel<float><<<R, threads, 0, st>>>(
          static_cast<const float*>(grad_out), static_cast<const float*>(rois), sums, B, H, W,
          C, spatial_scale, pooled, sampling);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16 && n > 0) {
    const size_t want = (n + 255) / 256;
    const int blocks = static_cast<int>(want < 2112 ? want : 2112);  // 16 per SM
    cast_to_bf16_kernel<<<blocks, 256, 0, st>>>(sums, static_cast<__nv_bfloat16*>(grad_feat), n);
  }
  return static_cast<int>(cudaGetLastError());
}
