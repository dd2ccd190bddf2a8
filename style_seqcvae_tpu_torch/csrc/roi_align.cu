// RoIAlign forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/roi_align.py::
// roi_align_pallas (body `_kernel`, :27-89): NHWC features (B, H, W, C) in
// f32 or bf16 and rois (R, 5) f32 [batch_idx, x1, y1, x2, y2] in image
// coordinates -> (R, P, P, C) in the features' dtype. Each of the P x P bins
// is the mean of S x S bilinear samples, computed in f32, with the boundary
// rules of the classic CUDA RoIAlign: a sample outside [-1, H] x [-1, W] is
// empty, negative coordinates clamp to 0, the low corner clamps to H-1 / W-1.
//
// Design: one block per (RoI, slice of 256 channels). The block reads its
// RoI's batch index and box itself, computes bin_h and bin_w once, and puts
// the corner offsets and bilinear weights of all P*P*S*S samples into
// shared memory; then each thread owns one channel and walks the bins, so
// every corner read is a coalesced read of an NHWC row and every output
// bin a coalesced write. The coordinate arithmetic is the plain version's
// f32 expressions, rounded step by step (__fmul_rn / __fadd_rn keep nvcc
// from contracting them into FMAs), so both place every sample alike.
//
// Bound on an H100 SXM: memory. At full width (features (16, 38, 58, 1024),
// R = 4,800) the function must read the 144 MB f32 map once and write the
// 963 MB pooled output, about 0.33 ms at 3.35 TB/s (half in bf16); its
// ~8 GFLOP of f32 arithmetic are well below that. The TPU kernel copied each
// image's map, split by channels, into VMEM; there is no counterpart here:
// an image's 9 MB map stays in the 50 MB L2 while the blocks of its RoIs,
// which come in batch order, read it, so the repeated corner reads are L2
// hits and device memory sees the map about once.
#include "ssc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                 T* __restrict__ out, int B, int H, int W, int C, float spatial_scale,
                 int pooled, int sampling) {
  __shared__ int s_off[kMaxSamples][4];
  __shared__ float s_w[kMaxSamples][4];

  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int b = min(max(static_cast<int>(roi[0]), 0), B - 1);
  const float x1 = __fmul_rn(roi[1], spatial_scale);
  const float y1 = __fmul_rn(roi[2], spatial_scale);
  const float x2 = __fmul_rn(roi[3], spatial_scale);
  const float y2 = __fmul_rn(roi[4], spatial_scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), static_cast<float>(pooled));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), static_cast<float>(pooled));

  const int S2 = sampling * sampling;
  const int n_samples = pooled * pooled * S2;
  // sample s = ((ph * P + pw) * S + iy) * S + ix
  for (int s = threadIdx.x; s < n_samples; s += kThreads) {
    const int ix = s % sampling;
    const int iy = (s / sampling) % sampling;
    const int pw = (s / S2) % pooled;
    const int ph = s / (S2 * pooled);
    const float fs = static_cast<float>(sampling);
    const float oy = __fdiv_rn(static_cast<float>(iy) + 0.5f, fs);
    const float ox = __fdiv_rn(static_cast<float>(ix) + 0.5f, fs);
    float y = __fadd_rn(y1, __fmul_rn(__fadd_rn(static_cast<float>(ph), oy), bin_h));
    float x = __fadd_rn(x1, __fmul_rn(__fadd_rn(static_cast<float>(pw), ox), bin_w));
    const bool empty = y < -1.0f || y > static_cast<float>(H) || x < -1.0f ||
                       x > static_cast<float>(W);
    y = fmaxf(y, 0.0f);
    x = fmaxf(x, 0.0f);
    const int y0 = min(static_cast<int>(floorf(y)), H - 1);
    const int x0 = min(static_cast<int>(floorf(x)), W - 1);
    const int y1i = min(y0 + 1, H - 1);
    const int x1i = min(x0 + 1, W - 1);
    const float ly = fminf(fmaxf(__fsub_rn(y, static_cast<float>(y0)), 0.0f), 1.0f);
    const float lx = fminf(fmaxf(__fsub_rn(x, static_cast<float>(x0)), 0.0f), 1.0f);
    const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
    s_off[s][0] = y0 * W + x0;
    s_off[s][1] = y0 * W + x1i;
    s_off[s][2] = y1i * W + x0;
    s_off[s][3] = y1i * W + x1i;
    s_w[s][0] = empty ? 0.0f : __fmul_rn(hy, hx);
    s_w[s][1] = empty ? 0.0f : __fmul_rn(hy, lx);
    s_w[s][2] = empty ? 0.0f : __fmul_rn(ly, hx);
    s_w[s][3] = empty ? 0.0f : __fmul_rn(ly, lx);
  }
  __syncthreads();
  if (c >= C) return;

  const T* img = feat + static_cast<size_t>(b) * H * W * C + c;
  T* dst = out + static_cast<size_t>(r) * pooled * pooled * C + c;
  const float denom = static_cast<float>(S2);
  for (int bin = 0; bin < pooled * pooled; ++bin) {
    float acc = 0.0f;
    for (int k = 0; k < S2; ++k) {
      const int s = bin * S2 + k;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v += s_w[s][q] * ssc::to_float(img[static_cast<size_t>(s_off[s][q]) * C]);
      acc += v;
    }
    dst[static_cast<size_t>(bin) * C] = ssc::from_float<T>(__fdiv_rn(acc, denom));
  }
}

}  // namespace

// features (B, H, W, C), rois (R, 5) -> out (R, P, P, C). Returns
// cudaGetLastError().
extern "C" int ssc_roi_align(const void* feat, const void* rois, void* out, int B, int H,
                             int W, int C, int R, float spatial_scale, int pooled,
                             int sampling, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(rois),
        static_cast<__nv_bfloat16*>(out), B, H, W, C, spatial_scale, pooled, sampling);
  } else {
    roi_align_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(feat), static_cast<const float*>(rois),
        static_cast<float*>(out), B, H, W, C, spatial_scale, pooled, sampling);
  }
  return static_cast<int>(cudaGetLastError());
}
