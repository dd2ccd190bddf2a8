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
//     shared memory and walks the boxes 64 at a time, with two barriers a
//     word. Warp 0 decides the word from registers: it holds the 64 rows'
//     diagonal words (two a lane). First up to kRounds warp-wide rounds,
//     each two OR reductions (redux.sync): every available box that no
//     available box marks is kept, and the boxes those mark are dropped;
//     at the RPN's shapes one round settles nearly every word. Then the
//     chain takes what is left: the lowest box still available (__ffsll)
//     is kept and drops the later boxes of its diagonal word, which comes
//     by shuffle from the lane that holds it. The lanes then write
//     keep_idx (the rank by __popcll), keep_mask and the list of kept rows,
//     and load the next word's diagonal words and indices, which arrive
//     while the whole block ORs the kept rows' later words, read from
//     global memory (L2), into `removed`. Rows that were suppressed are
//     never read, nor words below the diagonal, nor rows at or past N; a
//     diagonal word's bits at or below its row are ignored.
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
// its outputs. Its time is latency, on one SM per group: per word, warp
// 0's decisions, the update's L2 round trip and the two barriers.
// chip_smoke.py times and bounds each kernel on its own.
#include "ssc_common.cuh"

namespace {

constexpr int kBox = 64;          // boxes per word
// Threads of a scan block: 32 warps share the update of long rows (one
// block per group, so the RPN's 16 groups hold 16 SMs, and the update's
// loads are one L2 round trip a word); two warps when a row has at most
// kNarrowWords words (the per-class call's 1,280 groups of 5 words), so
// that all groups' blocks are resident at once.
constexpr int kScanThreadsWide = 1024;
constexpr int kScanThreadsNarrow = 64;
constexpr int kNarrowWords = 16;
// words of a row that one lane ORs in a pass of the update
constexpr int kLaneWords = 4;
// warp-wide rounds of a word's decisions before the chain takes the rest
constexpr int kRounds = 2;

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

// Shared memory of the scan: `removed` (words), the current word's keep
// bits, and its kept rows in order.
__host__ __device__ constexpr int scan_smem_bytes(int words) {
  return (words + 1) * static_cast<int>(sizeof(unsigned long long)) +
         kBox * static_cast<int>(sizeof(int));
}

// Warp-wide OR of a 64-bit value: two 32-bit redux.sync.
__device__ __forceinline__ unsigned long long warp_or(unsigned long long x) {
  const unsigned lo = __reduce_or_sync(ssc::kFullMask, static_cast<unsigned>(x));
  const unsigned hi = __reduce_or_sync(ssc::kFullMask, static_cast<unsigned>(x >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask, const int* __restrict__ order,
                int N, int words, int out_len, int* __restrict__ keep_idx,
                unsigned char* __restrict__ keep_mask) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                       // (words,)
  unsigned long long& s_keep = smem[words];
  int* s_rows = reinterpret_cast<int*>(smem + words + 1);   // (64,)

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long* gm = mask + g * N * words;
  const int* gorder = order ? order + g * N : nullptr;
  int* gkeep = keep_idx + g * out_len;
  unsigned char* gmask = keep_mask + g * N;
  for (int w = tid; w < words; w += kThreads) removed[w] = 0ull;

  // Warp 0's registers for word b: the diagonal words of rows 64 b + lane
  // (lo) and 64 b + 32 + lane (hi), and the rows' original indices.
  unsigned long long d_lo = 0ull, d_hi = 0ull;
  int o_lo = 0, o_hi = 0;
  auto fetch = [&](int b) {
    const int r_lo = b * kBox + lane, r_hi = r_lo + 32;
    d_lo = r_lo < N ? gm[static_cast<size_t>(r_lo) * words + b] : 0ull;
    d_hi = r_hi < N ? gm[static_cast<size_t>(r_hi) * words + b] : 0ull;
    o_lo = gorder && r_lo < N ? gorder[r_lo] : r_lo;
    o_hi = gorder && r_hi < N ? gorder[r_hi] : r_hi;
  };
  int count = 0;  // boxes kept so far (warp 0)
  if (warp == 0) fetch(0);
  __syncthreads();

  for (int b = 0; b < words; ++b) {
    if (warp == 0) {
      // Decide. A row marks only later boxes: bits after it.
      const unsigned long long m_lo = d_lo & (~1ull << lane);
      const unsigned long long m_hi = d_hi & (~1ull << (lane + 32));
      // the marks of this lane's rows among the boxes `of`
      auto marks = [&](unsigned long long of) {
        return (((of >> lane) & 1ull) ? m_lo : 0ull) |
               (((of >> (lane + 32)) & 1ull) ? m_hi : 0ull);
      };
      const int n_rows = min(kBox, N - b * kBox);
      unsigned long long avail = ~removed[b] & (n_rows == kBox ? ~0ull : (1ull << n_rows) - 1ull);
      unsigned long long keep = 0ull;
      // First up to kRounds warp-wide rounds: a box that no available box
      // marks is kept, and the boxes it marks are dropped.
      for (int r = 0; r < kRounds && avail; ++r) {
        const unsigned long long k = avail & ~warp_or(marks(avail));
        keep |= k;
        avail &= ~k & ~warp_or(marks(k));
      }
      // Then the chain over the boxes left: take the lowest, keep it, and
      // drop the later boxes of its diagonal word, which comes by shuffle
      // from the lane that holds it. `avail` is alike in every lane.
      while (avail) {
        const int t = __ffsll(static_cast<long long>(avail)) - 1;
        keep |= 1ull << t;
        const unsigned long long d = __shfl_sync(ssc::kFullMask, t < 32 ? m_lo : m_hi, t & 31);
        avail &= (avail - 1ull) & ~d;
      }
      // Write: each lane its two rows' keep_mask entries, and each kept row
      // its keep_idx entry and its place in the list of kept rows.
      const unsigned long long below_lo = (1ull << lane) - 1ull;
      const unsigned long long below_hi = (below_lo << 32) | 0xffffffffull;
      const int r_lo = b * kBox + lane, r_hi = r_lo + 32;
      const bool k_lo = (keep >> lane) & 1ull, k_hi = (keep >> (lane + 32)) & 1ull;
      if (k_lo) {
        const int p = __popcll(keep & below_lo);
        s_rows[p] = lane;
        if (count + p < out_len) gkeep[count + p] = o_lo;
      }
      if (k_hi) {
        const int p = __popcll(keep & below_hi);
        s_rows[p] = lane + 32;
        if (count + p < out_len) gkeep[count + p] = o_hi;
      }
      if (r_lo < N) gmask[o_lo] = k_lo;
      if (r_hi < N) gmask[o_hi] = k_hi;
      count += __popcll(keep);
      if (lane == 0) s_keep = keep;
      if (b + 1 < words) fetch(b + 1);  // in flight during the update
    }
    __syncthreads();

    // Update: OR the kept rows' words w > b into `removed`. A warp's lanes
    // are 2^lg word slots (consecutive words of a row) times 32 / 2^lg row
    // slots; the block's row slots take the kept rows in turn, and each
    // lane ORs up to kLaneWords words a pass. A warp folds its row slots by
    // shuffles, and the warps meet in shared-memory atomics.
    const unsigned long long keep = s_keep;
    const int n_kept = __popcll(keep);
    const int span = words - 1 - b;
    if (n_kept > 0 && span > 0) {
      const int lg = span >= 32 ? 5 : 32 - __clz(span - 1);
      const int slots = 1 << lg;
      const int wslot = lane & (slots - 1);
      const int rslot = (warp << (5 - lg)) | (lane >> lg);
      const int rstride = kWarps << (5 - lg);
      const unsigned long long* rows = gm + static_cast<size_t>(b) * kBox * words;
      for (int base = b + 1 + wslot; base - wslot < words; base += kLaneWords * slots) {
        unsigned long long acc[kLaneWords] = {};
#pragma unroll 2
        for (int k = rslot; k < n_kept; k += rstride) {
          const unsigned long long* row = rows + static_cast<size_t>(s_rows[k]) * words + base;
#pragma unroll
          for (int j = 0; j < kLaneWords; ++j)
            if (base + j * slots < words) acc[j] |= row[j * slots];
        }
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) {
          for (int o = slots; o < 32; o <<= 1)
            acc[j] |= __shfl_xor_sync(ssc::kFullMask, acc[j], o);
          if (lane < slots && base + j * slots < words && acc[j])
            atomicOr(&removed[base + j * slots], acc[j]);
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0)
    for (int e = count + lane; e < out_len; e += 32) gkeep[e] = -1;
}

template <int kThreads>
int launch_scan(const void* mask, const void* order, void* keep_idx, void* keep_mask, int G,
                int N, int words, int out_len, cudaStream_t stream) {
  const int smem = scan_smem_bytes(words);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(nms_scan_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  nms_scan_kernel<kThreads><<<G, kThreads, smem, stream>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const int*>(order), N, words,
      out_len, static_cast<int*>(keep_idx), static_cast<unsigned char*>(keep_mask));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the scan for `words` words per row.
extern "C" int ssc_nms_scan_smem_bytes(int words) { return scan_smem_bytes(words); }

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return words <= kNarrowWords
             ? launch_scan<kScanThreadsNarrow>(mask, order, keep_idx, keep_mask, G, N, words,
                                               out_len, s)
             : launch_scan<kScanThreadsWide>(mask, order, keep_idx, keep_mask, G, N, words,
                                             out_len, s);
}
