// RoIAlign forward and backward, for Hopper (sm_90a). The backward is
// described further below, before its plan pass.
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
// grad_out (R, P, P, C) in f32 or bf16 -> grad_features (B, H, W, C) in the
// same dtype: each output bin's gradient, times 1 / S^2 as the forward's
// mean, goes to every feature pixel the bin's samples touch, with the
// forward's own taps and weights (tap_tables: the same coordinates, clamps,
// empty samples and merged row and column weights), so it is the adjoint of
// the forward and of the plain version's gather. Sums run in f32; bf16 is
// rounded once, to nearest even.
//
// Bound on an H100 SXM: memory. At the training path's (4, 40, 64, 1024)
// with 512 RoIs it must read 103 MB of grad_out and write 42 MB of
// grad_features in f32, 0.0432 ms at 3.35 TB/s (0.0216 ms in bf16); its
// ~0.2 G multiply-adds are far below that.
//
// Design: a gather, so that no two threads add into one pixel. A plan pass
// (a warp per RoI) writes each RoI's clamped batch index, its tap tables and
// the first and last map row and column its taps touch into a small buffer
// (plan_words ints a RoI), so that the gather reads them instead of
// recomputing them in every block. The gather runs a block per (image, tile
// of kTileRows x kTileCols map pixels, slab of channels): warp i owns the
// tile's row i, lane l eight 16-byte channel vectors 32 apart in f32 (four
// in bf16), and each thread its row's kTileCols pixels x 32 channels as 64
// f32 sums in registers. The block keeps, 128 RoIs at a time, those of its
// image whose taps meet the tile, in ascending order (a ballot and a prefix
// over the warps). For each kept RoI a warp writes, a lane a bin, the bin's
// merged weight on every tile row and column into shared memory (0 where
// its taps miss the line) and ballots the bins that meet the tile's rows
// and its columns. Each thread then takes the kept RoIs in order, the row
// bins with a weight on its row in order, and for each the column bins in
// order: it reads the bin's grad_out vectors (16-byte loads) once and adds
// w_y * w_x * g to both columns' sums (a zero weight adds nothing). Each
// pixel's sum therefore runs over RoIs, row bins and column bins in a fixed
// order, so two launches are equal to the bit. Every pixel is written once,
// in the output dtype, with 16-byte stores; a tile no RoI touches writes
// zeros. So nothing zeroes the map first, no f32 buffer stands in for a bf16
// output, and no cast pass follows. When C is not a multiple of the vector,
// or a pointer is not 16-byte aligned, each thread reads and writes its
// channels one by one. Narrow tiles keep 32 channels a thread, over which
// the per-bin work of a sum spreads; the price is that a bin's vectors are
// read again by the neighbouring tiles' blocks and by the rows of its own
// (ops/kernels/ablate_roi_backward.py times the parts and the other shapes).
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W), a CUDA graph of 10
// launches (scripts/time_detector.py): 0.115 ms in f32 and 0.098 ms in bf16
// at the training shapes (2.7x and 4.5x the bound), 0.148 ms in bf16 on the
// workflow's (8, 24, 32, 1024) with 1,024 RoIs; the old design (a block per
// RoI, f32 atomics into a zeroed map, a cast pass for bf16) took 0.400,
// 0.425 and 0.702 ms. In f32, 0.050 ms of it is grad_out read again from
// L2 rather than L1, 0.019 ms the plan pass and the map's writes.
constexpr int kPlanHeader = 8;    // batch index, row span, column span, padding
constexpr int kTileRows = 4;      // a gather block's map rows, a warp each
constexpr int kTileCols = 2;      // its map columns, in each thread's registers
constexpr int kSums = 64;         // f32 sums a thread: kTileCols x 32 channels
constexpr int kGatherThreads = 32 * kTileRows;
constexpr int kWarpsPerSM = 16;   // resident gather warps an SM: 128 registers a thread
constexpr int kListBytes = 32 * 1024;  // shared memory for a batch of RoIs' tap weights

// int32 words of one RoI's plan: the header, row_n and col_n [P], then
// row_pos, col_pos, row_w and col_w [P * 2S] (tap_tables' layout); a
// multiple of 4, so that every header is 16-byte aligned
__host__ __device__ __forceinline__ int plan_words(int P, int S) {
  return (kPlanHeader + 2 * P + 8 * P * S + 3) / 4 * 4;
}

// Plan pass, a warp per RoI: [0] the batch index clamped into [0, B),
// [1], [2] the first and last map row its taps touch, [3], [4] the same for
// columns (INT_MAX and -1 when it touches none), then its tap tables.
__global__ void __launch_bounds__(32)
roi_backward_plan_kernel(const float* __restrict__ rois, int* __restrict__ plan, int B, int H,
                         int W, float spatial_scale, int P, int S) {
  const int r = blockIdx.x, L = 2 * P * S, S2 = 2 * S;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  int* pl = plan + static_cast<size_t>(r) * plan_words(P, S);
  int* n = pl + kPlanHeader;
  int* pos = n + 2 * P;
  float* w = reinterpret_cast<float*>(pos + 2 * L);
  tap_tables(roi, spatial_scale, P, S, H, W, pos, pos + L, n, n + P, w, w + L);
  // each thread reads back the tables it wrote (tap_tables strides by blockDim)
  int lo[2] = {INT_MAX, INT_MAX}, hi[2] = {-1, -1};
  for (int t = threadIdx.x; t < 2 * P; t += blockDim.x) {
    const int d = t < P ? 0 : 1;
    const int* at = pos + d * L + (t - d * P) * S2;
    for (int a = 0; a < n[t]; ++a) {
      lo[d] = min(lo[d], at[a]);
      hi[d] = max(hi[d], at[a]);
    }
  }
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[d] = min(lo[d], __shfl_xor_sync(ssc::kFullMask, lo[d], o));
      hi[d] = max(hi[d], __shfl_xor_sync(ssc::kFullMask, hi[d], o));
    }
  if (threadIdx.x == 0) {
    pl[0] = min(max(static_cast<int>(roi[0]), 0), B - 1);
    pl[1] = lo[0];
    pl[2] = hi[0];
    pl[3] = lo[1];
    pl[4] = hi[1];
  }
}

// Gather pass (see the design above). batch: the kept RoIs whose tap
// weights the dynamic shared memory holds at once.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGatherThreads, kWarpsPerSM * 32 / kGatherThreads)
roi_align_backward_kernel(const T* __restrict__ grad_out, const int* __restrict__ plan,
                          T* __restrict__ grad_feat, int R, int H, int W, int C, int P, int S,
                          int batch) {
  using Vec = ssc::Vec16<T>;
  constexpr int N = Vec::kN;
  constexpr int TW = kTileCols;
  constexpr int V = kSums / (TW * N);  // 16-byte channel vectors a thread: 8 f32, 4 bf16
  constexpr int kLines = kTileRows + TW;
  extern __shared__ int4 smem[];
  int* kept = reinterpret_cast<int*>(smem);  // [kGatherThreads] RoI indices, ascending
  int* warp_kept = kept + kGatherThreads;     // [kTileRows]
  // [batch][2]: the bins whose taps meet the tile's rows, and its columns
  unsigned* masks = reinterpret_cast<unsigned*>(warp_kept + kTileRows);
  // [batch][kLines][P]: each bin's merged weight on each tile row, then
  // column; 0 where its taps miss the line
  float* wts = reinterpret_cast<float*>(masks + 2 * batch);

  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = blockIdx.x / tiles_x * kTileRows, x0 = blockIdx.x % tiles_x * TW;
  const int b = blockIdx.y, row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the lane's vectors: 32 apart, so that a warp's loads of each are coalesced
  const int c0 = (blockIdx.z * 32 * V + lane) * N;
  // channels of vector v in the map (<= 0: past the last one)
  auto valid = [&](int v) { return min(N, C - c0 - 32 * N * v); };
  const int words = plan_words(P, S), L = 2 * P * S, S2 = 2 * S;

  float acc[TW][V][N];
#pragma unroll
  for (int j = 0; j < TW; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[j][v][e] = 0.0f;

  for (int base = 0; base < R; base += kGatherThreads) {
    // keep the RoIs of this image whose taps meet the tile, in ascending order
    const int r = base + threadIdx.x;
    bool keep = false;
    if (r < R) {
      const int* h = plan + static_cast<size_t>(r) * words;
      const int4 f = *reinterpret_cast<const int4*>(h);  // batch, row span, column start
      keep = f.x == b && f.y < y0 + kTileRows && f.z >= y0 && f.w < x0 + TW && h[4] >= x0;
    }
    const unsigned ballot = __ballot_sync(ssc::kFullMask, keep);
    if (lane == 0) warp_kept[row] = __popc(ballot);
    __syncthreads();
    int first = 0, total = 0;
    for (int i = 0; i < kTileRows; ++i) {
      first += i < row ? warp_kept[i] : 0;
      total += warp_kept[i];
    }
    if (keep) kept[first + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();

    for (int k0 = 0; k0 < total; k0 += batch) {
      const int nk = min(batch, total - k0);
      // warp w lists the kept RoIs w, w + kTileRows, ...: lane t < 2P takes
      // bin t (rows, then columns), writes its weight on each tile line and
      // ballots whether its taps meet the tile at all
      for (int k = row; k < nk; k += kTileRows) {
        const int* pl = plan + static_cast<size_t>(kept[k0 + k]) * words;
        float* wk = wts + static_cast<size_t>(k) * kLines * P;
        unsigned long long hits = 0;
        for (int t0 = 0; t0 < 2 * P; t0 += 32) {
          const int t = t0 + lane;
          bool hit = false;
          if (t < 2 * P) {
            const int d = t < P ? 0 : 1, n = pl[kPlanHeader + t];
            const int* pos = pl + kPlanHeader + 2 * P + d * L + (t - d * P) * S2;
            const float* wt = reinterpret_cast<const float*>(pos + 2 * L);
            const int start = d ? x0 : y0, lines = d ? TW : kTileRows;
            float* line = wk + (d ? kTileRows * P : 0) + t - d * P;  // line l at line[l * P]
            for (int l = 0; l < lines; ++l) line[l * P] = 0.0f;
            for (int a = 0; a < n; ++a) {
              const int l = pos[a] - start;
              if (l >= 0 && l < lines) {  // a bin's taps are merged: one a line at most
                line[l * P] = wt[a];
                hit = true;
              }
            }
          }
          hits |= static_cast<unsigned long long>(__ballot_sync(ssc::kFullMask, hit)) << t0;
        }
        if (lane == 0) {
          const unsigned long long bins = (1ull << P) - 1;
          masks[2 * k] = static_cast<unsigned>(hits & bins);
          masks[2 * k + 1] = static_cast<unsigned>((hits >> P) & bins);
        }
      }
      __syncthreads();

      if (valid(0) > 0) {
        for (int k = 0; k < nk; ++k) {
          unsigned row_bins = masks[2 * k];
          const unsigned col_bins = masks[2 * k + 1];
          if (col_bins == 0) continue;
          const float* wk = wts + static_cast<size_t>(k) * kLines * P;
          const float* wrow = wk + row * P;
          const float* wcol = wk + kTileRows * P;
          const T* g_roi = grad_out + static_cast<size_t>(kept[k0 + k]) * P * P * C + c0;
          while (row_bins) {  // in ascending order
            const int ph = __ffs(row_bins) - 1;
            row_bins &= row_bins - 1;
            const float wy = wrow[ph];
            if (wy == 0.0f) continue;
            const T* g_row = g_roi + static_cast<size_t>(ph) * P * C;
            for (unsigned m = col_bins; m; m &= m - 1) {  // in ascending order
              const int pw = __ffs(m) - 1;
              const T* g = g_row + static_cast<size_t>(pw) * C;
              uint4 q[V];
#pragma unroll
              for (int v = 0; v < V; ++v)
                q[v] = valid(v) > 0 ? load_vec<T, kVec>(g + 32 * N * v, valid(v))
                                    : make_uint4(0u, 0u, 0u, 0u);
              float w[TW];
#pragma unroll
              for (int j = 0; j < TW; ++j) w[j] = wy * wcol[j * P + pw];
#pragma unroll
              for (int v = 0; v < V; ++v)
#pragma unroll
                for (int i = 0; i < N; ++i) {
                  const float x = Vec::get(q[v], i);
#pragma unroll
                  for (int j = 0; j < TW; ++j) acc[j][v][i] = fmaf(w[j], x, acc[j][v][i]);
                }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  const int y = y0 + row;
  if (valid(0) <= 0 || y >= H) return;
  // the forward's mean: a product where 1 / S^2 is exact
  const float denom = static_cast<float>(S * S);
  const bool exact_inverse = ((S * S) & (S * S - 1)) == 0;
  const float inv = 1.0f / denom;
  T* dst = grad_feat + (static_cast<size_t>(b) * H + y) * W * C + c0;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    if (x0 + j >= W) break;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (valid(v) <= 0) break;
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[j][v][e] = exact_inverse ? acc[j][v][e] * inv : __fdiv_rn(acc[j][v][e], denom);
      T* px = dst + static_cast<size_t>(x0 + j) * C + 32 * N * v;
      const uint4 q = pack16<T>(acc[j][v]);
      if (kVec) {
        *reinterpret_cast<uint4*>(px) = q;
      } else {
        const T* e = reinterpret_cast<const T*>(&q);
        for (int i = 0; i < valid(v); ++i) px[i] = e[i];
      }
    }
  }
}

template <typename T>
void launch_backward(const void* grad_out, const int* plan, void* grad_feat, int B, int H, int W,
                     int C, int R, int P, int S, cudaStream_t st) {
  constexpr int N = ssc::Vec16<T>::kN;
  constexpr int V = kSums / (kTileCols * N);
  constexpr int kLines = kTileRows + kTileCols;
  const uintptr_t ends =
      reinterpret_cast<uintptr_t>(grad_out) | reinterpret_cast<uintptr_t>(grad_feat);
  const bool vec = C % N == 0 && (ends & 15) == 0;
  const int batch = max(1, min(kGatherThreads, kListBytes / ((kLines * P + 2) * 4)));
  const size_t smem = (kGatherThreads + kTileRows + 2 * batch) * sizeof(int) +
                      static_cast<size_t>(batch) * kLines * P * sizeof(float);
  const dim3 grid(((H + kTileRows - 1) / kTileRows) * ((W + kTileCols - 1) / kTileCols), B,
                  ((C + N - 1) / N + 32 * V - 1) / (32 * V));
  if (vec)
    roi_align_backward_kernel<T, true><<<grid, kGatherThreads, smem, st>>>(
        static_cast<const T*>(grad_out), plan, static_cast<T*>(grad_feat), R, H, W, C, P, S,
        batch);
  else
    roi_align_backward_kernel<T, false><<<grid, kGatherThreads, smem, st>>>(
        static_cast<const T*>(grad_out), plan, static_cast<T*>(grad_feat), R, H, W, C, P, S,
        batch);
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

// int32 words of one RoI's plan (the backward's plan buffer holds R of them)
extern "C" int ssc_roi_align_backward_plan_words(int pooled, int sampling) {
  return plan_words(pooled, sampling);
}

// grad_out (R, P, P, C) -> grad_feat (B, H, W, C), both f32 or both bf16;
// plan: R * ssc_roi_align_backward_plan_words(P, S) int32 words, written by
// the plan pass and read by the gather. Writes every element of grad_feat
// once. Needs P * S <= 32. Returns cudaGetLastError().
extern "C" int ssc_roi_align_backward(const void* grad_out, const void* rois, void* grad_feat,
                                      void* plan, int B, int H, int W, int C, int R,
                                      float spatial_scale, int pooled, int sampling, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  int* pl = static_cast<int*>(plan);
  if (R > 0) {
    roi_backward_plan_kernel<<<R, 32, 0, st>>>(static_cast<const float*>(rois), pl, B, H, W,
                                               spatial_scale, pooled, sampling);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16)
    launch_backward<__nv_bfloat16>(grad_out, pl, grad_feat, B, H, W, C, R, pooled, sampling, st);
  else
    launch_backward<float>(grad_out, pl, grad_feat, B, H, W, C, R, pooled, sampling, st);
  return static_cast<int>(cudaGetLastError());
}
