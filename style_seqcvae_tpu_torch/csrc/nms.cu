// Greedy non-maximum suppression, batched over groups, for Hopper (sm_90a).
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/nms.py::
// suppression_bitmask (body `_bitmask_kernel`, :29-55) and the greedy scan
// `_greedy_reduce` (:88-108) under `nms_pallas` (:111-146): for each group
// of N score-sorted boxes (f32, x1 y1 x2 y2 with +1-pixel widths), box j is
// suppressed by an earlier kept box i when IoU(i, j) > threshold. Outputs
// keep_idx (G, out_len) int32, the kept boxes in score order, padded with -1,
// and keep_mask (G, N) in the boxes' original order.
//
// Two kernels, launched back to back by one wrapper call:
//  1. The bitmask. One block of 64 threads covers 64 rows x 64 columns of
//     one group: it stages the 64 column boxes in shared memory, and each
//     thread writes one 64-bit word for its row, with bit k set when column
//     64 * blockIdx.x + k lies after the row and overlaps it above the
//     threshold. Blocks below the diagonal hold no such bit and exit at
//     once; the scan never reads their words. The IoU is the plain
//     version's f32 expression in the same order, rounded step by step with
//     a true division (the source is built without fast math), so every
//     decision equals the plain version's bit for bit.
//  2. The greedy scan. One block per group keeps the `removed` words in
//     shared memory and walks the boxes 64 at a time: it stages the 64 rows'
//     words from the diagonal on, one thread resolves the 64 in-word
//     decisions in order (a kept box ORs its diagonal word into the current
//     one) and writes keep_idx, then all threads OR the kept rows into the
//     later words and write keep_mask.
// The 64-bit word layout is this port's own (the TPU kernel packs 16 bits
// per int32 word); only keep_idx and keep_mask leave the wrapper.
//
// Bound on an H100 SXM: operations. At full width (RPN: 16 groups x 6,000
// boxes) the function reads 384 KB of boxes and writes 96 KB of keep_idx
// and keep_mask, while the upper triangle holds 16 * 6,000^2 / 2 = 288 M
// IoUs of about 15 f32 operations each, ~4.3 GFLOP, ~0.065 ms at 67 TFLOP/s.
// The mask (the upper triangle's 36 MB, written once) is this design's
// intermediate. The scan is a chain of N dependent decisions per group; its
// byte bound is the mask words of the kept rows, from the diagonal on, plus
// its outputs. chip_smoke.py times and bounds each kernel on its own.
#include "ssc_common.cuh"

namespace {

constexpr int kBox = 64;          // boxes per word
constexpr int kScanThreads = 256;

__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__global__ void __launch_bounds__(kBox)
nms_bitmask_kernel(const float* __restrict__ boxes, unsigned long long* __restrict__ mask,
                   int N, int words, float threshold) {
  const int col_blk = blockIdx.x, row_blk = blockIdx.y;
  if (col_blk < row_blk) return;
  const size_t g = blockIdx.z;
  const float* gb = boxes + g * N * 4;
  __shared__ float cb[kBox][4];
  __shared__ float ca[kBox];
  const int t = threadIdx.x;
  const int j = col_blk * kBox + t;
  if (j < N) {
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[t][q] = gb[static_cast<size_t>(j) * 4 + q];
    ca[t] = area(cb[t][0], cb[t][1], cb[t][2], cb[t][3]);
  }
  __syncthreads();
  const int i = row_blk * kBox + t;
  if (i >= N) return;
  const float rx1 = gb[static_cast<size_t>(i) * 4 + 0], ry1 = gb[static_cast<size_t>(i) * 4 + 1];
  const float rx2 = gb[static_cast<size_t>(i) * 4 + 2], ry2 = gb[static_cast<size_t>(i) * 4 + 3];
  const float ra = area(rx1, ry1, rx2, ry2);
  const int n_cols = min(kBox, N - col_blk * kBox);
  unsigned long long bits = 0ull;
  for (int k = col_blk == row_blk ? t + 1 : 0; k < n_cols; ++k) {
    const float w = __fadd_rn(__fsub_rn(fminf(rx2, cb[k][2]), fmaxf(rx1, cb[k][0])), 1.0f);
    const float h = __fadd_rn(__fsub_rn(fminf(ry2, cb[k][3]), fmaxf(ry1, cb[k][1])), 1.0f);
    const float inter = __fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f));
    const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(ra, ca[k]), inter));
    if (iou > threshold) bits |= 1ull << k;
  }
  mask[(g * N + i) * words + col_blk] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask, const int* __restrict__ order,
                int N, int words, int out_len, int* __restrict__ keep_idx,
                unsigned char* __restrict__ keep_mask) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;          // (words,)
  unsigned long long* rows = smem + words;     // (64, words): the current 64 rows
  __shared__ unsigned long long s_keep;
  __shared__ int s_count;

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned long long* gm = mask + g * N * words;
  const int* gorder = order ? order + g * N : nullptr;
  int* gkeep = keep_idx + g * out_len;
  for (int w = tid; w < words; w += kScanThreads) removed[w] = 0ull;
  if (tid == 0) s_count = 0;
  __syncthreads();

  for (int b = 0; b < words; ++b) {
    const int n_rows = min(kBox, N - b * kBox);
    const int span = words - b;
    for (int e = tid; e < n_rows * span; e += kScanThreads) {
      const int t = e / span, w = b + e % span;
      rows[t * words + w] = gm[static_cast<size_t>(b * kBox + t) * words + w];
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long cur = removed[b], keep = 0ull;
      int count = s_count;
      for (int t = 0; t < n_rows; ++t) {
        if (!((cur >> t) & 1ull)) {
          keep |= 1ull << t;
          cur |= rows[t * words + b];
          const int i = b * kBox + t;
          if (count < out_len) gkeep[count] = gorder ? gorder[i] : i;
          ++count;
        }
      }
      s_keep = keep;
      s_count = count;
    }
    __syncthreads();
    const unsigned long long keep = s_keep;
    for (int w = b + 1 + tid; w < words; w += kScanThreads) {
      unsigned long long acc = removed[w];
      for (int t = 0; t < n_rows; ++t)
        if ((keep >> t) & 1ull) acc |= rows[t * words + w];
      removed[w] = acc;
    }
    if (tid < n_rows) {
      const int i = b * kBox + tid;
      keep_mask[g * N + (gorder ? gorder[i] : i)] = static_cast<unsigned char>((keep >> tid) & 1ull);
    }
    __syncthreads();
  }
  for (int e = s_count + tid; e < out_len; e += kScanThreads) gkeep[e] = -1;
}

}  // namespace

// Shared memory of the scan for `words` words per row.
extern "C" int ssc_nms_scan_smem_bytes(int words) {
  return (kBox + 1) * words * static_cast<int>(sizeof(unsigned long long));
}

// boxes (G, N, 4) score-sorted -> mask (G, N, ceil(N / 64)) words. Returns
// cudaGetLastError().
extern "C" int ssc_nms_bitmask(const void* boxes, void* mask, int G, int N, float threshold,
                               void* stream) {
  const int words = (N + kBox - 1) / kBox;
  const dim3 grid(words, words, G);
  nms_bitmask_kernel<<<grid, kBox, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<unsigned long long*>(mask), N, words,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

// mask (G, N, words), order (G, N) int32 or null (identity) -> keep_idx
// (G, out_len) int32, keep_mask (G, N) uint8. Returns cudaGetLastError().
extern "C" int ssc_nms_scan(const void* mask, const void* order, void* keep_idx,
                            void* keep_mask, int G, int N, int out_len, void* stream) {
  const int words = (N + kBox - 1) / kBox;
  const int smem = ssc_nms_scan_smem_bytes(words);
  cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  nms_scan_kernel<<<G, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const int*>(order), N, words,
      out_len, static_cast<int*>(keep_idx), static_cast<unsigned char*>(keep_mask));
  return static_cast<int>(cudaGetLastError());
}
