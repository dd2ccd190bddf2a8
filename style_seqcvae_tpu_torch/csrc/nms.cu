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
//  1. The bitmask. Only the upper triangle is launched: a 1-D grid over
//     units of 32 rows x kChunk column words (64 boxes a word), one warp
//     each, listed group by group and row block by row block, the chunks of
//     a row block starting at its diagonal word. A lane holds the column
//     boxes of the unit's live (word, half) sets, compacted, with their
//     areas and test constants, in registers; the row loop is instantiated
//     for their count, so it branches on none. The warp's 32 row boxes and
//     areas are staged once in shared memory and come one at a time as
//     broadcast loads. For each row every lane tests its columns, a ballot
//     per set gives the row's bits, and lane 0 writes them to shared memory
//     in one 16-byte store. At the end lane r assembles row r's 64-bit
//     words and stores them, 16 bytes at a time where aligned, with
//     streaming stores. A row's diagonal word is cut to the bits after the
//     row, and bits at or past N are 0; words below the diagonal are never
//     written.
//     The test is exact without a division on the common path: fl(q) > t,
//     q = inter / u, holds iff q lies above the midpoint m = t + h between t
//     and the next f32 (h = half that ulp, a power of two); q = m exactly
//     cannot happen for f32 inter and u (m has 25 significant bits). For
//     u > 0 that is inter - t u > h u. e = fma(-t, u, inter) is that
//     difference rounded once, and h u is exact, so by the rounding's
//     monotony e > h u proves q > m and e < h u proves q < m; only e == h u
//     (or NaN) is unsure. There, and for boxes whose areas leave the range
//     where u > 0 and h u is a normal f32 (or for a threshold outside
//     [2^-60, 2^20], t < 0 and NaN included), the warp recomputes the row
//     with the plain version's f32 division. inter and u are rounded step by
//     step with __fadd_rn / __fmul_rn as the plain version rounds them (the
//     source is built without fast math), so every decision equals the
//     plain version's bit for bit.
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
// IoUs of about 15 f32 operations each, ~4.3 GFLOP, ~0.065 ms at 67 TFLOP/s
// (a rate that counts an FMA as two operations: the IoU's min, max, add,
// sub and mul are not FMAs, so the card issues them at about half that).
// The bitmask issues ~18 instructions a pair (the IoU, the test, a ballot)
// and ~10 more a row; its 36 MB of triangle words (this design's
// intermediate) go out under the arithmetic. The scan is a chain of N
// dependent decisions per group; its byte bound is the mask words of the
// kept rows, from the diagonal on, plus its outputs. Its time is latency,
// on one SM per group: per word, warp 0's decisions, the update's L2 round
// trip and the two barriers.
// chip_smoke.py times and bounds each kernel on its own.
#include <cfloat>

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

// Bitmask units: 32 rows x kChunk column words, one warp each.
constexpr int kRows = 32;
constexpr int kChunk = 2;
constexpr int kMaskWarps = 4;      // warps (units) of a bitmask block
constexpr int kMaskMinBlocks = 8;  // resident blocks an SM must fit: <= 64 registers
constexpr bool kTriangle = true;   // false: every chunk of every row block
constexpr int kSets = 2 * kChunk;  // column sets of a unit: (word, half) pairs
constexpr int kBitWords = (kSets + 3) / 4;  // uint4s of a row's ballots

// The constants of the division-free test for one threshold t (see the
// header): h = half the ulp above t, and the range of box areas inside
// which every pair's union u is positive and h u a normal f32. h is NaN
// where the test is not sound, which sends every pair to the division.
struct FastTest {
  float t, neg_t, h, amin, amax;
};

FastTest fast_test(float t) {
  FastTest f{t, -t, NAN, 0.0f, 0.0f};
  if (t >= 0x1p-60f && t <= 0x1p20f) {
    f.h = (nextafterf(t, INFINITY) - t) * 0.5f;
    // u >= (1 - 2^-22) max(a_i, a_j) for overlapping boxes, u = a_i + a_j
    // otherwise, so areas of at least 2 FLT_MIN / h keep h u normal; areas
    // of at most FLT_MAX / 4 keep a_i + a_j finite.
    f.amin = 2.0f * FLT_MIN / f.h;
    f.amax = FLT_MAX / 4.0f;
  }
  return f;
}

// Width and height of the intersection of boxes a and b (+1-pixel widths),
// rounded as the plain version rounds them; <= 0 where they do not overlap.
__device__ __forceinline__ float2 overlap(const float4& a, const float4& b) {
  return make_float2(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f),
                     __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f));
}

__device__ __forceinline__ bool in_range(float a, const FastTest& f) {
  return a >= f.amin && a <= f.amax;
}

// fl(inter / u) > t where e = inter - t u (rounded once) and h u differ;
// where they are equal or unordered, `unsure` is set and the result is moot.
__device__ __forceinline__ bool above_threshold(float inter, float u, float hb,
                                                const FastTest& f, bool& unsure) {
  const float e = __fmaf_rn(f.neg_t, u, inter);
  const float hu = __fmul_rn(hb, u);
  const bool above = e > hu;
  unsure |= !(e < hu) && !above;
  return above;
}

// sum over m = 1 .. n of ceil(m / kChunk)
__host__ __device__ __forceinline__ long long ceil_sum(int n) {
  const long long a = n / kChunk, b = n % kChunk;
  return kChunk * a * (a + 1) / 2 + b * (a + 1);
}

// Units of a group before its row block q (32 rows): row block q (in row
// tile rt = q / 2) has ceil((words - rt) / kChunk) chunks, the first
// starting at its diagonal word (the full grid: `chunks` from word 0).
__host__ __device__ __forceinline__ long long units_before(int q, int words, int chunks) {
  if (!kTriangle) return static_cast<long long>(q) * chunks;
  const int r = q >> 1;
  long long n = 2 * (ceil_sum(words) - ceil_sum(words - r));
  if (q & 1) n += (words - r + kChunk - 1) / kChunk;
  return n;
}

// A unit of the grid: group g, row block q (32 rows from row 32 q), column
// words c0 .. c0 + kChunk - 1, and its live (word, half) column sets, bit c
// for set c = (c0 + c / 2, c % 2): w in [rt, words), and not the first half
// of the diagonal word for rows 32-63, which lie after all of it.
struct Unit {
  int g, q, c0;
  unsigned live;
};

__device__ __forceinline__ Unit decode_unit(int unit, int units_per_group, int row_blocks,
                                            int chunks, int words) {
  Unit u;
  u.g = unit / units_per_group;
  const int rem = unit - u.g * units_per_group;
  // the row block: the last q with units_before(q) <= rem
  int q = 0;
  for (int hi = row_blocks - 1; q < hi;) {
    const int mid = (q + hi + 1) >> 1;
    if (units_before(mid, words, chunks) <= rem) q = mid; else hi = mid - 1;
  }
  u.q = q;
  const int rt = q >> 1;
  u.c0 = (kTriangle ? rt : 0) + static_cast<int>(rem - units_before(q, words, chunks)) * kChunk;
  u.live = 0u;
#pragma unroll
  for (int c = 0; c < kSets; ++c) {
    const int w = u.c0 + c / 2;
    if (w >= rt && w < words && !(w == rt && (q & 1) && c % 2 == 0)) u.live |= 1u << c;
  }
  return u;
}

// The first column of the s-th live set (live sets compacted in order).
__device__ __forceinline__ int set_col0(const Unit& u, int s) {
  unsigned m = u.live;
  for (int k = 0; k < s; ++k) m &= m - 1u;
  const int c = __ffs(m) - 1;
  return (u.c0 + c / 2) * kBox + (c % 2) * 32;
}

// A bitmask warp's shared memory (indexed by warp): its 32 row boxes; their
// areas for the test (NaN outside the range) and as they are; and each
// row's ballots, one 32-bit word per live set.
__shared__ float4 s_box[kMaskWarps][kRows];
__shared__ float2 s_area[kMaskWarps][kRows];
__shared__ uint4 s_bits[kMaskWarps][kRows * kBitWords];

// A unit's live column sets, compacted: set s < kN holds, in lane l, the
// column box of the s-th live (w, half), its area and its test constant
// (h, or NaN outside the range).
template <int kN>
struct Cols {
  float4 b[kN];
  float a[kN], h[kN];
};

// The unit's 32 rows against its kN live column sets: for each row, a
// ballot per set, written by lane 0 to s_bits.
//
// The test's intersection clamps only w: where w > 0 >= h the product is
// <= 0 and u >= a_i + a_j > 0, so e < 0 < h u says "below", which is right
// (the true intersection is 0); with w <= 0 it is 0 or NaN (unsure). The
// division's path recomputes the row with both clamps, as the plain
// version computes it.
template <int kN>
__device__ __forceinline__ void unit_rows(const Unit& unit, int n_rows, const float4* gb, int N,
                                          const FastTest& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Cols<kN> col;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    const int j = set_col0(unit, s) + lane;
    // past N: a box that overlaps nothing (x2 < x1), area 0; its bits are cut
    col.b[s] = j < N ? gb[j] : make_float4(1.0f, 1.0f, 0.0f, 0.0f);
    col.a[s] = area(col.b[s].x, col.b[s].y, col.b[s].z, col.b[s].w);
    col.h[s] = j >= N || in_range(col.a[s], f) ? f.h : __int_as_float(0x7fffffff);
  }
#pragma unroll 2
  for (int r = 0; r < n_rows; ++r) {
    const float4 rb = s_box[warp][r];
    const float ra = s_area[warp][r].x;
    bool unsure = false;
    unsigned bits[kBitWords * 4] = {};
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const float2 wh = overlap(rb, col.b[s]);
      const float inter = __fmul_rn(fmaxf(wh.x, 0.0f), wh.y);
      const float u = __fsub_rn(__fadd_rn(ra, col.a[s]), inter);
      bits[s] = __ballot_sync(ssc::kFullMask, above_threshold(inter, u, col.h[s], f, unsure));
    }
    if (__any_sync(ssc::kFullMask, unsure)) {
      const float ra_exact = s_area[warp][r].y;
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const float2 wh = overlap(rb, col.b[s]);
        const float inter = __fmul_rn(fmaxf(wh.x, 0.0f), fmaxf(wh.y, 0.0f));
        const float u = __fsub_rn(__fadd_rn(ra_exact, col.a[s]), inter);
        bits[s] = __ballot_sync(ssc::kFullMask, __fdiv_rn(inter, u) > f.t);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kBitWords; ++k)
        s_bits[warp][r * kBitWords + k] = make_uint4(bits[4 * k], bits[4 * k + 1],
                                                     bits[4 * k + 2], bits[4 * k + 3]);
    }
  }
}

// unit_rows for n live sets, 1 <= n <= kN
template <int kN>
__device__ __forceinline__ void unit_rows_n(int n, const Unit& unit, int n_rows,
                                            const float4* gb, int N, const FastTest& f) {
  if (n == kN) {
    unit_rows<kN>(unit, n_rows, gb, N, f);
  } else if constexpr (kN > 1) {
    unit_rows_n<kN - 1>(n, unit, n_rows, gb, N, f);
  }
}

__device__ __forceinline__ void store_words(unsigned long long* p, unsigned long long lo,
                                            unsigned long long hi) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
                    static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32)));
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(static_cast<unsigned>(v), static_cast<unsigned>(v >> 32)));
}

// Lane r's row of unit u: assemble its words from the ballots and store them.
__device__ __forceinline__ void store_row(const Unit& u, unsigned long long* mask, int N,
                                          int words) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = u.q >> 1;
  unsigned sets[kBitWords * 4];
#pragma unroll
  for (int k = 0; k < kBitWords; ++k) {
    const uint4 got = s_bits[warp][lane * kBitWords + k];
    sets[4 * k] = got.x;
    sets[4 * k + 1] = got.y;
    sets[4 * k + 2] = got.z;
    sets[4 * k + 3] = got.w;
  }
  const int i = u.q * kRows + lane;
  const int tail = N % kBox;
  unsigned long long v[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int w = u.c0 + k;
    unsigned half[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 2 * k + hf;
      const int s = __popc(u.live & ((1u << c) - 1u));   // its place among the live sets
      unsigned b = 0u;
#pragma unroll
      for (int t = 0; t < kSets; ++t) b = t == s ? sets[t] : b;
      half[hf] = (u.live >> c) & 1u ? b : 0u;
    }
    v[k] = (static_cast<unsigned long long>(half[1]) << 32) | half[0];
    if (w == words - 1 && tail) v[k] &= (1ull << tail) - 1ull;
    if (w == rt) v[k] &= (i & (kBox - 1)) == kBox - 1 ? 0ull : ~0ull << ((i & (kBox - 1)) + 1);
  }
  unsigned long long* dst = mask + (static_cast<size_t>(u.g) * N + i) * words + u.c0;
#pragma unroll
  for (int k = 0; k < kChunk; k += 2) {
    const int w = u.c0 + k;
    const bool pair = k + 1 < kChunk;
    const unsigned long long next = v[pair ? k + 1 : k];
    if (pair && w >= rt && w + 1 < words && (reinterpret_cast<size_t>(dst + k) & 15) == 0) {
      store_words(dst + k, v[k], next);
    } else {
      if (w >= rt && w < words) store_word(dst + k, v[k]);
      if (pair && w + 1 >= rt && w + 1 < words) store_word(dst + k + 1, next);
    }
  }
}

// One warp per unit, listed group by group, row block by row block.
__global__ void __launch_bounds__(kMaskWarps * 32, kMaskMinBlocks)
nms_bitmask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask,
                   int N, int words, int row_blocks, int chunks, int units_per_group,
                   int units, FastTest f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int index = blockIdx.x * kMaskWarps + warp;
  if (index >= units) return;
  const Unit unit = decode_unit(index, units_per_group, row_blocks, chunks, words);
  if (!unit.live) return;                      // below the diagonal (full grid only)
  const float4* gb = boxes + static_cast<size_t>(unit.g) * N;
  const int row0 = unit.q * kRows, n_rows = min(kRows, N - row0);
  if (lane < n_rows) {
    const float4 b = gb[row0 + lane];
    const float a = area(b.x, b.y, b.z, b.w);
    s_box[warp][lane] = b;
    s_area[warp][lane] = make_float2(in_range(a, f) ? a : __int_as_float(0x7fffffff), a);
  }
  __syncwarp();
  unit_rows_n<kSets>(__popc(unit.live), unit, n_rows, gb, N, f);
  __syncwarp();
  if (lane < n_rows) store_row(unit, mask, N, words);
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

// boxes (G, N, 4) score-sorted, 16-byte aligned -> mask (G, N, ceil(N / 64))
// words, from each row's diagonal word on. Returns cudaGetLastError().
extern "C" int ssc_nms_bitmask(const void* boxes, void* mask, int G, int N, float threshold,
                               void* stream) {
  const int words = (N + kBox - 1) / kBox;
  const int row_blocks = (N + kRows - 1) / kRows;
  const int chunks = (words + kChunk - 1) / kChunk;
  const long long units_per_group = units_before(row_blocks, words, chunks);
  const long long units = units_per_group * G;
  if (units == 0) return static_cast<int>(cudaSuccess);
  if (units > INT_MAX - kMaskWarps) return static_cast<int>(cudaErrorInvalidConfiguration);
  nms_bitmask_kernel<<<static_cast<unsigned>((units + kMaskWarps - 1) / kMaskWarps),
                       kMaskWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<unsigned long long*>(mask), N, words,
      row_blocks, chunks, static_cast<int>(units_per_group), static_cast<int>(units),
      fast_test(threshold));
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
