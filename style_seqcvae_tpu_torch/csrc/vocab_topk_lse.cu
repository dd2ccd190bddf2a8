// Tied vocabulary head fused with a streaming top-k and logsumexp: the f32
// path, on the CUDA cores of Hopper (sm_90a).
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py:113
// (matmul_top_k_with_lse, body `_kernel`, :43-110) for f32 inputs: x (R, E)
// and emb (V, E), both f32 with E % 8 == 0 (the wrapper zero-pads E, which
// adds nothing to a dot product) -> the top-k of the logits x . emb^T per
// row as values (R, k) f32 and indices (R, k) i32 (ties to the lower
// index), and the row logsumexp (R,) f32. The (R, V) logits never reach
// device memory. bf16 inputs go to the tensor-core kernel in
// vocab_topk_lse_sm90.cu; this one stays for f32 because the tensor cores
// cannot form an exact f32 product (TF32 would change the results). Each
// logit is one fmaf chain over e = 0 ... E-1 in order, as cuBLAS's f32
// product forms it.
//
// Bound on an H100 SXM: operations. At the flagship decode grid (R =
// 12,800, V = 10,500, E = 600) a launch does 2 * R * V * E = 161 GFLOP,
// 2.41 ms at the 67 TFLOP/s f32 peak of the CUDA cores; it must move only
// 56 MB of x and emb (17 us at 3.35 TB/s).
//
// Design. The work split, the TMA ring and the merge of partial results
// are the bf16 route's (vocab_topk_lse_plan.cuh). What held back the
// kernel this one replaced (11.36 ms at that shape), and what this one does:
//   1. shared-memory loads: 8 scalar loads for 16 FMAs a thread. Here a
//      thread holds an 8 x 8 register micro-tile (rows row0 + 2 i, columns
//      q + 16 c of the tile) and loads 8 + 8 float4 fragments along K for
//      256 FMAs, 4 FMAs a word. The 128-byte swizzle puts the distinct
//      16-byte pieces of each load in distinct banks, and a warp's two
//      half-warps share the emb fragments by broadcast, so a load takes the
//      fewest passes its bytes allow (one for x, two for emb). Each step of
//      4 along K loads the next step's fragments while its FMAs run;
//   2. tiles of 32 rows, 400 blocks, each streaming all of emb: here the
//      units are (128-row, 128-column) tiles, walked by one persistent
//      block per SM in contiguous runs, so the grid fills all 132 SMs at
//      any R and emb is streamed once per 128 rows (5 GB of L2 reads of x
//      and emb a launch at the flagship shape; the old one read 10 GB of emb);
//   3. no overlap of copies and compute: here thread 0 keeps a ring of 6
//      stages of 32-wide K chunks (128 bytes of f32) of the x and emb tiles
//      filled by TMA with mbarrier completion, refilling each stage that
//      all warps have released; no thread stages or transposes data, and
//      no __syncthreads is left in the loop. TMA's zero fill covers rows
//      past R or V and the K tail (E = 600 is 18 chunks and 24);
//   4. a serial epilogue on a logit tile in shared memory: here the
//      epilogue works on the accumulators in registers, where a row of the
//      128 x 128 tile lies across the 16 lanes of a half-warp, 8 values
//      each. Columns >= V become -inf. Each thread keeps its own running
//      max and sum of exp(x - max) per row, merged across the half-warp
//      when a segment ends. Each value is tested against the row's
//      threshold in shared memory; after the first tiles few pass. Only
//      rows with a passing value take the second pass, whose code exists
//      once (the first pass is unrolled over the rows, the second is not):
//      each lane appends its passing values to the row's candidate buffer
//      (k + 16 entries) at its place in a ballot, and when the buffer would
//      overflow, the half-warp ranks the entries in parallel, keeps the k
//      best in order and takes the k-th as the new threshold. In a
//      segment's first tile, when k <= 16, the k-th largest of the 16
//      lanes' maxima seeds the threshold.
// A segment's end writes each row's candidates and (max, sum) to scratch;
// the shared merge kernel turns them into vals, idx and lse.
//
// Measured on an H100 SXM (700 W) at the flagship shape: 4.72 ms, 2.0x the
// bound, of which the product and the logsumexp take 3.95 and the top-k
// the rest (ablate_vocab_topk_lse.py); cuBLAS's f32 product alone takes
// 3.21. PERF.md keeps the numbers.

#include "vocab_topk_lse_plan.cuh"

namespace {

constexpr int kChunk = kChunkBytes / 4;   // K per stage: 32 f32
// Eight warps, 16 tile rows each, and no producer warp: a ninth warp would
// put three warps on one of the SM's four schedulers, whose 16K registers
// then cap every thread at 168, too few for the accumulators and two sets
// of fragments. Thread 0 refills the ring instead.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                // lanes that hold one row
constexpr int kTM = 8;                    // rows of a thread's micro-tile
constexpr int kTN = 8;                    // columns of a thread's micro-tile
using ssc::exp2_approx;
using ssc::kLog2e;

constexpr int kSteps = kChunk / 4;        // steps of 4 along K in a stage
static_assert(kTN == kTM, "k_step loads one emb fragment per row of x");

__device__ __forceinline__ float comp(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Fragments of a stage, 16-byte loads along K. A 16 KB tile holds 128 rows
// of 128 bytes, and the 128-byte swizzle puts 16-byte piece j of row r at
// r * 128 + ((j ^ (r & 7)) << 4). x: the thread's rows are row0 + 2 i, with
// row0 * 128 clear in bits 4-6 and (row0 + 2 i) & 7 == h ^ (2 i & 7), so
// piece j of row row0 + 2 i is at (a_off ^ (((2 i & 7) ^ j) << 4)) + 256 i,
// a_off = (row0 * 128) ^ (h << 4). emb: the thread's rows are q + 16 c, and
// piece j is at (b_off ^ (j << 4)) + 2048 c, b_off = (q * 128) ^ ((q & 7) << 4).
__device__ __forceinline__ float4 load_a(const uint8_t* xs, uint32_t a_off, int j, int i) {
  return *reinterpret_cast<const float4*>(xs + (a_off ^ (((2 * i & 7) ^ j) << 4)) + 256 * i);
}

__device__ __forceinline__ float4 load_e(const uint8_t* es, uint32_t b_off, int j, int c) {
  return *reinterpret_cast<const float4*>(es + (b_off ^ (j << 4)) + 2048 * c);
}

// Step j: acc[i][c] += x[row i][4 j .. 4 j + 3] . emb[col c][same], one
// fmaf at a time in K order, with `a` holding row 0's fragment on entry.
// While row i's 32 FMAs run, row i + 1's fragment (or the next step's row
// 0) and the next step's emb fragment for column c = i come in (when
// kNext), so no FMA waits for a load but a stage's first.
template <bool kNext>
__device__ __forceinline__ void k_step(float (&acc)[kTM][kTN], const uint8_t* xs,
                                       const uint8_t* es, uint32_t a_off, uint32_t b_off, int j,
                                       const float4 (&e)[kTN], float4 (&e_next)[kTN],
                                       float4& a) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float4 a_next = a;
    if (i + 1 < kTM) a_next = load_a(xs, a_off, j, i + 1);
    else if (kNext) a_next = load_a(xs, a_off, j + 1, 0);
    if (kNext) e_next[i] = load_e(es, b_off, j + 1, i);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[i][c] = fmaf(comp(a, p), comp(e[c], p), acc[i][c]);
    a = a_next;
  }
}

// A tile row's top-k state in shared memory: a buffer of buf_entries(k)
// candidate entries, the first n of them filled, among which is the row's
// top k over the columns seen so far, and a threshold: the k-th entry in
// selection order of the buffer at its last compaction, or a seed (v,
// INT_MAX) that k values of a tile reach, or (-inf, INT_MAX). A value
// that does not come before the threshold cannot be in the row's top k.
struct Entry {
  float v;
  int i;
};

__host__ __device__ constexpr int buf_entries(int k) { return k + kGroup; }

// shared memory of a tile row's top-k: its buffer, n and threshold
__host__ __device__ constexpr size_t row_bytes(int k) {
  return static_cast<size_t>(buf_entries(k) + 1) * sizeof(Entry) + sizeof(int);
}

struct RowState {
  Entry* buf;   // [128][buf_entries(k)]
  Entry* thr;   // [128]
  int* n;       // [128]
};

// Keep the buffer's k first entries in selection order, at positions 0 ..
// k - 1 in that order, and make the k-th the row's threshold. The 16 lanes
// of the row's half-warp rank their share of the n entries against all n
// (each entry's rank is its position in selection order), then write
// those ranked below k. Only the lanes of an `active` half-warp change
// anything; the whole warp calls it. A buffer of at most 32 (k <= 16) is
// ranked by an unrolled loop, two entries a lane.
__device__ __forceinline__ void compact(Entry* buf, int& n, Entry& thr, int k, int q,
                                        bool active) {
  __syncwarp();
  if (buf_entries(k) <= 2 * kGroup) {
    Entry e0{-INFINITY, INT_MAX}, e1{-INFINITY, INT_MAX};
    const bool has0 = active && q < n, has1 = active && q + kGroup < n;
    if (has0) e0 = buf[q];
    if (has1) e1 = buf[q + kGroup];
    int rank0 = 0, rank1 = 0;
#pragma unroll
    for (int l = 0; l < 2 * kGroup; ++l) {
      if (active && l < n) {
        const Entry o = buf[l];
        rank0 += ssc::before(o.v, o.i, e0.v, e0.i);
        rank1 += ssc::before(o.v, o.i, e1.v, e1.i);
      }
    }
    __syncwarp();
    if (has0 && rank0 < k) buf[rank0] = e0;
    if (has1 && rank1 < k) buf[rank1] = e1;
  } else {
    constexpr int kPer = (buf_entries(127) + kGroup - 1) / kGroup;
    const int mine = active && q < n ? (n - q + kGroup - 1) / kGroup : 0;
    Entry e[kPer];
    int rank[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      if (t < mine) {
        e[t] = buf[q + kGroup * t];
        rank[t] = 0;
        for (int l = 0; l < n; ++l) {
          const Entry o = buf[l];
          rank[t] += ssc::before(o.v, o.i, e[t].v, e[t].i);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      if (t < mine && rank[t] < k) buf[rank[t]] = e[t];
  }
  __syncwarp();
  if (active && n >= k) {
    n = k;
    thr = buf[k - 1];
  }
}

// The second pass of one row's top-k, taken when a value of the tile came
// before the row's threshold: `v` holds this thread's 8 values (columns
// col0 + 16 c, those >= V already -inf), `tmax` their largest. The values
// that still come before the threshold are appended to the buffer, one a
// lane at a time, the buffer compacted when it would overflow; a buffer
// that reaches k entries without a threshold from a compaction is
// compacted at the end.
__device__ __forceinline__ void append_row(const float (&v)[kTN], float tmax, int row, int col0,
                                           bool ragged, int V, int k, RowState rs, int lane,
                                           int q) {
  Entry* buf = rs.buf + row * buf_entries(k);
  int n = rs.n[row];
  Entry thr = rs.thr[row];
  if (k <= kGroup && __any_sync(ssc::kFullMask, n < k)) {
    // a buffer without k entries would take every value: the k-th largest
    // of the 16 lanes' maxima has k values of the tile at or above it, so
    // nothing below it can be in the row's top k
    int rank = 0;
#pragma unroll
    for (int o = 1; o < kGroup; ++o) {
      const int oq = (q + o) & (kGroup - 1);
      const float om = __shfl_sync(ssc::kFullMask, tmax, (lane & kGroup) | oq);
      rank += ssc::before(om, oq, tmax, q);
    }
    const unsigned hit =
        __ballot_sync(ssc::kFullMask, rank == k - 1) & (0xffffu << (lane & kGroup));
    const float seed = __shfl_sync(ssc::kFullMask, tmax, __ffs(hit) - 1);
    if (n < k && ssc::before(seed, INT_MAX, thr.v, thr.i)) thr = Entry{seed, INT_MAX};
  }
  uint32_t pending = 0;
#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    const bool pass = ssc::before(v[c], col0 + 16 * c, thr.v, thr.i) &&
                      !(ragged && col0 + 16 * c >= V);
    pending |= static_cast<uint32_t>(pass) << c;
  }
  const unsigned half = 0xffffu << (lane & kGroup);
  while (__any_sync(ssc::kFullMask, pending != 0)) {
    bool has = pending != 0;
    const int c = has ? __ffs(pending) - 1 : 0;
    pending &= pending - 1;
    // v[c] by halving on each bit of c
    float sel[kTN / 2];
#pragma unroll
    for (int j = 0; j < kTN / 2; ++j) sel[j] = (c & 1) ? v[2 * j + 1] : v[2 * j];
    sel[0] = (c & 2) ? sel[1] : sel[0];
    sel[1] = (c & 2) ? sel[3] : sel[2];
    const Entry cand{(c & 4) ? sel[1] : sel[0], col0 + 16 * c};
    int m = __popc(__ballot_sync(ssc::kFullMask, has) & half);
    const bool full = n + m > buf_entries(k);
    if (__any_sync(ssc::kFullMask, full)) {
      compact(buf, n, thr, k, q, full);
      // the threshold rose: drop what no longer comes before it
      has = has && ssc::before(cand.v, cand.i, thr.v, thr.i);
      m = __popc(__ballot_sync(ssc::kFullMask, has) & half);
    }
    const unsigned ahead = __ballot_sync(ssc::kFullMask, has) & half & ((1u << lane) - 1);
    if (has) buf[n + __popc(ahead)] = cand;
    n += m;
  }
  const bool settle = n >= k && thr.i == INT_MAX;
  if (__any_sync(ssc::kFullMask, settle)) compact(buf, n, thr, k, q, settle);
  if (q == 0) {
    rs.n[row] = n;
    rs.thr[row] = thr;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vocab_topk_lse_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_emb,
                          float* __restrict__ part_v, int* __restrict__ part_i,
                          float* __restrict__ part_m, float* __restrict__ part_s, int V, int k,
                          int chunks, int col_tiles, long long units, int max_segments,
                          int stages) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [stages: x chunk, emb chunk][rows' top-k state][barriers]
  RowState rs;
  rs.buf = reinterpret_cast<Entry*>(smem + static_cast<size_t>(stages) * kStageBytes);
  rs.thr = rs.buf + kRowsTile * buf_entries(k);
  rs.n = reinterpret_cast<int*>(rs.thr + kRowsTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * kStageBytes +
                                               kRowsTile * row_bytes(k));
  uint64_t* empty = full + kMaxStages;

  const int b = blockIdx.x;
  const long long u_begin = unit_begin(b, units, gridDim.x);
  const long long u_end = unit_begin(b + 1, units, gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Thread 0 loads the block's chunks in order, (unit, K chunk) at
  // (pu, pk), into the ring: first a whole ring's worth, then one into
  // each stage that all eight warps have released.
  long long pu = u_begin;
  int pk = 0;
  auto load_next = [&](int s) {
    const uint32_t bar = smem_u32(full + s);
    mbar_expect_tx(bar, kStageBytes);
    uint8_t* tile = smem + static_cast<size_t>(s) * kStageBytes;
    const int t = static_cast<int>(pu / col_tiles), vt = static_cast<int>(pu % col_tiles);
    tma_load_2d(smem_u32(tile), &map_x, bar, pk * kChunk, t * kRowsTile);
    tma_load_2d(smem_u32(tile + kTileBytes), &map_emb, bar, pk * kChunk, vt * kColsTile);
    if (++pk == chunks) { pk = 0; ++pu; }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kWarps);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages && pu < u_end; ++s) load_next(s);
  }
  __syncthreads();

  // ---- warp w owns tile rows 16 w .. 16 w + 15; half-warp h
  // of it the rows 16 w + h + 2 i, lane q of the half the columns q + 16 c
  const int h = lane >> 4, q = lane & (kGroup - 1);
  const int row0 = warp * 16 + h;
  // the fragments' swizzled offsets (load_a, load_e)
  const uint32_t a_off = static_cast<uint32_t>(row0 * 128) ^ (h << 4);
  const uint32_t b_off = static_cast<uint32_t>(q * 128) ^ ((q & 7) << 4);
  float run_m[kTM], run_s[kTM];

  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (q == 0) {
        rs.n[row0 + 2 * i] = 0;
        rs.thr[row0 + 2 * i] = Entry{-INFINITY, INT_MAX};
      }
      run_m[i] = -INFINITY;
      run_s[i] = 0.f;
    }
    __syncwarp();
  };

  // the segment's per-row candidates (the buffer, filled up with
  // (-inf, INT_MAX)) and (max, sum) to the scratch slot of (block,
  // segment); the merge kernel takes the top k of them
  auto flush = [&](int seg) {
    __syncwarp();  // the appends of every lane are in
    const int entries = buf_entries(k);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = row0 + 2 * i;
      const Entry* buf = rs.buf + row * entries;
      const int n = rs.n[row];
      float m = run_m[i], s = run_s[i];
#pragma unroll
      for (int o = 1; o < kGroup; o <<= 1) {
        ssc::lse_merge(m, s, __shfl_xor_sync(ssc::kFullMask, m, o),
                       __shfl_xor_sync(ssc::kFullMask, s, o));
      }
      const size_t slot = (static_cast<size_t>(b) * max_segments + seg) * kRowsTile + row;
      if (q == 0) { part_m[slot] = m; part_s[slot] = s; }
      for (int j = q; j < entries; j += kGroup) {
        const Entry e = j < n ? buf[j] : Entry{-INFINITY, INT_MAX};
        part_v[slot * entries + j] = e.v;
        part_i[slot * entries + j] = e.i;
      }
    }
    __syncwarp();
  };

  reset();
  int st = 0, seg = 0;
  uint32_t phase = 0;
  int seg_t = static_cast<int>(u_begin / col_tiles);
  for (long long u = u_begin; u < u_end; ++u) {
    const int t = static_cast<int>(u / col_tiles), vt = static_cast<int>(u % col_tiles);
    if (t != seg_t) {
      flush(seg);
      reset();
      ++seg;
      seg_t = t;
    }

    // ---- mainloop: acc[i][c] = x[row0 + 2 i] . emb[col q + 16 c], one fmaf
    // chain over e in order
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[i][c] = 0.f;
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(smem_u32(full + st), phase);
      const uint8_t* xs = smem + static_cast<size_t>(st) * kStageBytes;
      const uint8_t* es = xs + kTileBytes;
      // 8 steps of 4 along K, in pairs that swap the two sets of emb
      // fragments; each step loads the next one's fragments as it runs
      float4 e0[kTN], e1[kTN], a;
#pragma unroll
      for (int c = 0; c < kTN; ++c) e0[c] = load_e(es, b_off, 0, c);
      a = load_a(xs, a_off, 0, 0);
#pragma unroll 1
      for (int j = 0; j < kSteps - 2; j += 2) {
        k_step<true>(acc, xs, es, a_off, b_off, j, e0, e1, a);
        k_step<true>(acc, xs, es, a_off, b_off, j + 1, e1, e0, a);
      }
      k_step<true>(acc, xs, es, a_off, b_off, kSteps - 2, e0, e1, a);
      k_step<false>(acc, xs, es, a_off, b_off, kSteps - 1, e1, e0, a);
      // every lane of the warp is done reading the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + st));
      if (warp == 0) {
        // the stage's next chunk, once every warp has released it; the
        // whole warp waits, so that it runs its next FMAs converged
        if (lane == 0 && pu < u_end) {
          mbar_wait(smem_u32(empty + st), phase);
          load_next(st);
        }
        __syncwarp();
      }
      if (++st == stages) { st = 0; phase ^= 1; }
    }

    // ---- epilogue: this thread holds rows row0 + 2 i, columns col0 + 16 c
    const int col0 = vt * kColsTile + q;
    const bool ragged = vt * kColsTile + kColsTile > V;
    uint32_t passed = 0;  // bit i: a value of row i passed the first test
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        acc[i][c] = ragged && col0 + 16 * c >= V ? -INFINITY : acc[i][c];
        tmax = fmaxf(tmax, acc[i][c]);
      }
      // streaming logsumexp over this thread's columns
      const float mn = fmaxf(run_m[i], tmax);
      const float mb = (mn == -INFINITY ? 0.f : mn) * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTN; ++c) sum += exp2_approx(fmaf(acc[i][c], kLog2e, -mb));
      // the old sum's scale: exactly 1 while the max holds, so that the
      // rounding of mb does not compound over the tiles
      const float scale = run_m[i] == mn ? 1.f : exp2_approx((run_m[i] - mn) * kLog2e);
      run_s[i] = run_s[i] * scale + sum;
      run_m[i] = mn;
      // top-k, first pass: does a value come before the row's threshold?
      // Every index below it is below this tile's columns but a filler's
      // or a seed's INT_MAX, so (v, col) comes before (tv, ti) iff v > tv,
      // or v == tv and ti is INT_MAX.
      const Entry thr = rs.thr[row0 + 2 * i];
      const bool open = thr.i == INT_MAX;
      bool pass = false;
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        pass |= (acc[i][c] > thr.v || (open && acc[i][c] == thr.v)) &&
                !(ragged && col0 + 16 * c >= V);
      passed |= static_cast<uint32_t>(pass) << i;
    }
    // second pass, rare after the first tiles, one row at a time: a single
    // copy of its code, which takes row i's values by selection (indexing
    // the accumulators at run time would move them to local memory)
    if (__any_sync(ssc::kFullMask, passed != 0)) {
#pragma unroll 1
      for (int i = 0; i < kTM; ++i) {
        if (!__any_sync(ssc::kFullMask, (passed >> i) & 1)) continue;
        float v[kTN];
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          v[c] = acc[0][c];
#pragma unroll
          for (int r = 1; r < kTM; ++r) v[c] = i == r ? acc[r][c] : v[c];
          tmax = fmaxf(tmax, v[c]);
        }
        append_row(v, tmax, row0 + 2 * i, col0, ragged, V, k, rs, lane, q);
      }
    }
  }
  flush(seg);
}

}  // namespace

// The launch plan on the current device for E % 8 == 0: out[0] blocks,
// out[1] segments per block at most, out[2] pipeline stages, out[3]
// dynamic shared memory bytes, out[4] scratch bytes that
// ssc_vocab_topk_lse_f32 needs, out[5] K chunks. Returns a CUDA error code.
extern "C" int ssc_vocab_topk_lse_f32_plan(int R, int V, int E, int k, long long* out) {
  return plan_entry(R, V, E, kChunk, row_bytes(k), buf_entries(k), out);
}

// x (R, E), emb (V, E) f32, E % 8 == 0, pointers 16-byte aligned ->
// vals (R, k), idx (R, k), lse (R,); 0 < k < 128, k <= V; scratch of the
// plan's size. Returns a CUDA error code.
extern "C" int ssc_vocab_topk_lse_f32(const void* x, const void* emb, void* vals, void* idx,
                                      void* lse, void* scratch, int R, int V, int E, int k,
                                      void* stream) {
  if (!valid_args(x, emb, R, V, E, k)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t rc = make_plan(R, V, E, kChunk, row_bytes(k), buf_entries(k), &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  CUtensorMap map_x, map_emb;
  if (!make_map(&map_x, x, R, E, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4) ||
      !make_map(&map_emb, emb, V, E, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Partials part = partials(scratch, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = cudaFuncSetAttribute(vocab_topk_lse_f32_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(p.smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vocab_topk_lse_f32_kernel<<<p.blocks, kThreads, p.smem, st>>>(
      map_x, map_emb, part.v, part.i, part.m, part.s, V, k, p.chunks, p.col_tiles, p.units,
      p.max_segments, p.stages);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(launch_merge(part, p, vals, idx, lse, R, k, st));
}
