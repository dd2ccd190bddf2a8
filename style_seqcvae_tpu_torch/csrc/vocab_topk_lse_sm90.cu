// Tied vocabulary head fused with a streaming top-k and logsumexp: the bf16
// path, for Hopper (sm_90a) tensor cores.
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py::
// matmul_top_k_with_lse (body `_kernel`, :43-110) for bf16 inputs: x (R, E)
// and emb (V, E), both bf16 with E % 8 == 0 (the wrapper zero-pads E) ->
// the top-k of the f32 logits x . emb^T per row as values (R, k) f32 and
// indices (R, k) i32 (ties to the lower index), and the row logsumexp (R,)
// f32. The (R, V) logits never reach device memory. f32 inputs go to the
// CUDA-core kernel in vocab_topk_lse.cu: the tensor cores cannot form an
// exact f32 product.
//
// Bound on an H100 SXM: operations. At the flagship decode grid (R =
// 12,800, V = 10,500, E = 600) a launch does 2 * R * V * E = 161 GFLOP,
// 0.163 ms at the 989 TFLOP/s bf16 dense tensor-core peak; it must move
// only 15 MB of x and emb (5 us at 3.35 TB/s).
//
// Design. The work split, the TMA ring and the merge of partial results
// are shared with the f32 route (vocab_topk_lse_plan.cuh): persistent
// blocks over contiguous runs of (128-row, 128-column) units, one segment
// per row tile a run crosses. Per block:
//   * one producer warp issues TMA loads of 64-wide K chunks (128 bytes of
//     bf16) of the x tile and the emb tile into a ring of stages; TMA's
//     zero fill covers rows past R or V and the K tail past E (E = 600 is
//     9 chunks and 24). Keeping x's tile resident for a whole segment
//     halves the L2 traffic (2.7 -> 1.33 GB at the flagship shape) but
//     leaves room for only 3 stages instead of 6, and measured no faster
//     with the top-k in;
//   * two consumer warpgroups, 64 rows each, run wgmma.mma_async
//     m64n128k16 (bf16 x bf16 -> f32 in registers) over the chunks, one
//     wgmma group in flight while the previous stage is released;
//   * the epilogue works on the accumulators in registers, where a row of
//     the 64 x 128 tile lies across the 4 threads of a quad, 32 values
//     each. Columns >= V become -inf. Each thread keeps its own running max
//     and sum of exp(x - max) per row (the streaming logsumexp), merged
//     across the quad only when a segment ends. Each value is tested
//     against the row's k-th entry in selection order (value descending,
//     index ascending) as the tile starts; after the first tiles almost
//     nothing passes. In a segment's first tile, when k <= 12, the quad's
//     least third-largest value stands in for the missing k-th entry. The
//     passing values then go one at a time: each that still comes before
//     the row's worst entry replaces it in an unsorted list of k in shared
//     memory. Thread q of the quad owns list positions q, q + 4, ... and
//     keeps the worst of them in registers; the owner of the replaced
//     entry rescans its own, and two shuffle rounds give the row's new
//     worst.
// A segment's end writes its per-row list and (max, sum) to scratch; the
// shared merge kernel turns them into vals, idx and lse.
//
// Measured on an H100 SXM (700 W) at the flagship shape: 0.747 ms, 4.6x
// the bound. The L2 loads set its floor (0.60 ms with the top-k's second
// pass skipped); the products add little. PERF.md keeps the numbers.

#include "vocab_topk_lse_plan.cuh"

namespace {

constexpr int kChunk = kChunkBytes / 2;          // K per stage: 64 bf16
constexpr int kConsumers = 256;                   // two warpgroups
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kSeed = 3;  // per-thread largest values that seed a new list's threshold
using ssc::exp2_approx;
using ssc::kLog2e;

// shared memory of a tile row's top-k: its list of k
__host__ __device__ constexpr size_t row_bytes(int k) { return static_cast<size_t>(k) * 8; }

// Entry (v, i) at position p is worse than (w, j) at position r: it comes
// after it in selection order, or equals it and sits at a larger position
// (so that every thread of a quad settles on the same worst entry).
__device__ __forceinline__ bool worse(float v, int i, int p, float w, int j, int r) {
  return ssc::before(w, j, v, i) || (v == w && i == j && p > r);
}

// ---- wgmma ------------------------------------------------------------------

// K-major operand in 128-byte swizzle: 8-row groups 1024 bytes apart (SBO);
// the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma fence or wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T (+ D if accumulate)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


// ---- main kernel -------------------------------------------------------------

// Partial results of block b's segment s for tile row r (0..127) live at
// slot (b * max_segments + s) * 128 + r: k values, k indices, max, sum.
__global__ void __launch_bounds__(kThreads, 1)
vocab_topk_lse_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_emb,
                           float* __restrict__ part_v, int* __restrict__ part_i,
                           float* __restrict__ part_m, float* __restrict__ part_s, int V, int k,
                           int chunks, int col_tiles, long long units, int max_segments,
                           int stages) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [stages: x chunk, emb chunk][lists][barriers]
  float* list_v = reinterpret_cast<float*>(smem + static_cast<size_t>(stages) * kStageBytes);
  int* list_i = reinterpret_cast<int*>(list_v + kRowsTile * k);
  uint64_t* full = reinterpret_cast<uint64_t*>(list_i + kRowsTile * k);
  uint64_t* empty = full + kMaxStages;

  const int b = blockIdx.x;
  const long long u_begin = unit_begin(b, units, gridDim.x);
  const long long u_end = unit_begin(b + 1, units, gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: one thread keeps the ring of stages full
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (long long u = u_begin; u < u_end; ++u) {
        const int t = static_cast<int>(u / col_tiles), vt = static_cast<int>(u % col_tiles);
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(smem_u32(empty + st), phase ^ 1);
          const uint32_t bar = smem_u32(full + st);
          mbar_expect_tx(bar, kStageBytes);
          uint8_t* tile = smem + static_cast<size_t>(st) * kStageBytes;
          tma_load_2d(smem_u32(tile), &map_x, bar, kc * kChunk, t * kRowsTile);
          tma_load_2d(smem_u32(tile + kTileBytes), &map_emb, bar, kc * kChunk, vt * kColsTile);
          if (++st == stages) { st = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
    const int wg = warp >> 2, wl = threadIdx.x & 127, q = lane & 3;
    int rows[2];
    rows[0] = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    rows[1] = rows[0] + 8;
    // per row: the row's worst list entry (value, index, position), the
    // same in the quad, and this thread's worst among the entries it owns,
    // positions q, q + 4, ...; only the owner writes or reads an entry
    float run_m[2], run_s[2], worst_v[2], own_v[2];
    int worst_i[2], worst_p[2], own_i[2], own_p[2];

    auto reset = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int j = q; j < k; j += 4) {
          list_v[rows[h] * k + j] = -INFINITY;
          list_i[rows[h] * k + j] = INT_MAX;
        }
        run_m[h] = -INFINITY;
        run_s[h] = 0.f;
        // of equal entries the one at the larger position counts as worse
        worst_v[h] = own_v[h] = -INFINITY;
        worst_i[h] = own_i[h] = INT_MAX;
        worst_p[h] = k - 1;
        own_p[h] = q < k ? q + (k - 1 - q) / 4 * 4 : -1;
      }
    };

    auto flush = [&](int seg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = run_m[h], s = run_s[h];
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          ssc::lse_merge(m, s, __shfl_xor_sync(ssc::kFullMask, m, o),
                         __shfl_xor_sync(ssc::kFullMask, s, o));
        }
        const size_t slot = (static_cast<size_t>(b) * max_segments + seg) * kRowsTile + rows[h];
        if (q == 0) { part_m[slot] = m; part_s[slot] = s; }
        for (int j = q; j < k; j += 4) {
          part_v[slot * k + j] = list_v[rows[h] * k + j];
          part_i[slot * k + j] = list_i[rows[h] * k + j];
        }
      }
      __syncwarp();
    };

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

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

      // ---- mainloop: acc = x tile rows . emb tile^T over all K chunks
      int prev = 0;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(smem_u32(full + st), phase);
        const uint32_t x_chunk = smem_u32(smem + static_cast<size_t>(st) * kStageBytes);
        const uint32_t a = x_chunk + wg * (64 * kChunk * 2);
        const uint32_t e = x_chunk + kTileBytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          wgmma_m64n128k16(acc, wgmma_desc(a + kk * 32), wgmma_desc(e + kk * 32),
                           (kc > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        fence_acc(acc);
        if (kc > 0) {
          wgmma_wait<1>();
          if (wl == 0) mbar_arrive(smem_u32(empty + prev));
        }
        prev = st;
        if (++st == stages) { st = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (wl == 0) mbar_arrive(smem_u32(empty + prev));

      // ---- epilogue: this thread holds rows[h], columns col0 + 8 j + e
      const int col0 = vt * kColsTile + 2 * q;
      const bool ragged = vt * kColsTile + kColsTile > V;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[4 * j + 2 * h + e];
            v = ragged && col0 + 8 * j + e >= V ? -INFINITY : v;
            tmax = fmaxf(tmax, v);
          }
        // streaming logsumexp over this thread's columns
        // (no branch: reading the accumulators on a divergent path would
        // serialize the wgmma instructions)
        const float mn = fmaxf(run_m[h], tmax);
        const float mb = (mn == -INFINITY ? 0.f : mn) * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += exp2_approx(fmaf(acc[4 * j + 2 * h + e], kLog2e, -mb));
        run_s[h] = run_s[h] * exp2_approx(fmaf(run_m[h], kLog2e, -mb)) + sum;
        run_m[h] = mn;

        // top-k, first pass: the values that come before the row's worst
        // entry as the tile starts. Every index in the list is below this
        // tile's columns but a filler's INT_MAX, so (v, col) comes before
        // (wv, wi) iff v > wv, or v == wv and the worst entry is a filler.
        const bool filler = worst_i[h] == INT_MAX;
        float thr = worst_v[h];
        if (k <= 4 * kSeed && __any_sync(ssc::kFullMask, filler)) {
          // a list that is not full yet (a segment's first tile) would take
          // every value: each of the quad's threads has kSeed values at or
          // above its kSeed-th largest, so at least k of the tile's values
          // are at or above the least of the four, and nothing below it
          // can be in the row's top k
          float top[kSeed];
#pragma unroll
          for (int i = 0; i < kSeed; ++i) top[i] = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = acc[4 * j + 2 * h + e];
#pragma unroll
              for (int i = 0; i < kSeed; ++i) {
                const float hi = fmaxf(top[i], v);
                v = fminf(top[i], v);
                top[i] = hi;
              }
            }
          float seed = top[kSeed - 1];
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) seed = fminf(seed, __shfl_xor_sync(ssc::kFullMask, seed, o));
          if (filler) thr = seed;
        }
        uint32_t pending = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * j + 2 * h + e];
            const bool pass = (v > thr || (filler && v == thr)) &&
                              !(ragged && col0 + 8 * j + e >= V);
            pending |= static_cast<uint32_t>(pass) << (2 * j + e);
          }
        // second pass, rare after the first tiles: each thread takes its
        // pending values in turn, the quad's four threads offer theirs one
        // after another, and each that still comes before the row's worst
        // entry replaces it in the unsorted list; its owner finds its own
        // new worst, and the quad the worst of the four
        float* rv = list_v + rows[h] * k;
        int* ri = list_i + rows[h] * k;
        while (__any_sync(ssc::kFullMask, pending != 0)) {
          const bool has = pending != 0;
          const int bit = has ? __ffs(pending) - 1 : 0;
          pending &= pending - 1;
          // acc[4 j + 2 h + e] at bit 2 j + e, by halving on each bit
          float sel[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            sel[j] = (bit & 1) ? acc[4 * j + 2 * h + 1] : acc[4 * j + 2 * h];
#pragma unroll
          for (int level = 1; level < 5; ++level)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < 16 >> level) sel[j] = (bit >> level) & 1 ? sel[2 * j + 1] : sel[2 * j];
          float v = sel[0];
          // none: (-inf, INT_MAX) comes before nothing
          const int col = has ? col0 + 8 * (bit >> 1) + (bit & 1) : INT_MAX;
          if (!has) v = -INFINITY;
          // quad positions that offer a value anywhere in the warp
          const unsigned offers = __ballot_sync(ssc::kFullMask, has);
#pragma unroll
          for (int src = 0; src < 4; ++src) {
            if (!(offers & (0x11111111u << src))) continue;
            const float cv = __shfl_sync(ssc::kFullMask, v, (lane & ~3) | src);
            const int ci = __shfl_sync(ssc::kFullMask, col, (lane & ~3) | src);
            const bool take = ssc::before(cv, ci, worst_v[h], worst_i[h]);  // quad-uniform
            if (!__any_sync(ssc::kFullMask, take)) continue;
            if (take && q == (worst_p[h] & 3)) {
              // the owner replaces the worst entry and finds its own new worst
              rv[worst_p[h]] = cv;
              ri[worst_p[h]] = ci;
              own_p[h] = -1;
              for (int j = q; j < k; j += 4) {
                const float ev = rv[j];
                const int ei = ri[j];
                if (own_p[h] < 0 || worse(ev, ei, j, own_v[h], own_i[h], own_p[h])) {
                  own_v[h] = ev;
                  own_i[h] = ei;
                  own_p[h] = j;
                }
              }
            }
            // the row's new worst entry: the worst of the four owners'
            float xv = own_v[h];
            int xi = own_i[h], xp = own_p[h];
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
              const float ov = __shfl_xor_sync(ssc::kFullMask, xv, o);
              const int oi = __shfl_xor_sync(ssc::kFullMask, xi, o);
              const int op = __shfl_xor_sync(ssc::kFullMask, xp, o);
              if (op >= 0 && (xp < 0 || worse(ov, oi, op, xv, xi, xp))) { xv = ov; xi = oi; xp = op; }
            }
            if (take) {
              worst_v[h] = xv;
              worst_i[h] = xi;
              worst_p[h] = xp;
            }
          }
        }
      }
    }
    flush(seg);
  }
}

}  // namespace

// The launch plan on the current device for E % 8 == 0: out[0] blocks,
// out[1] segments per block at most, out[2] pipeline stages, out[3]
// dynamic shared memory bytes, out[4] scratch bytes that
// ssc_vocab_topk_lse_bf16 needs, out[5] K chunks. Returns a CUDA error code.
extern "C" int ssc_vocab_topk_lse_bf16_plan(int R, int V, int E, int k, long long* out) {
  return plan_entry(R, V, E, kChunk, row_bytes(k), k, out);
}

// x (R, E), emb (V, E) bf16, E % 8 == 0, pointers 16-byte aligned ->
// vals (R, k), idx (R, k), lse (R,); 0 < k < 128, k <= V; scratch of the
// plan's size. Returns a CUDA error code.
extern "C" int ssc_vocab_topk_lse_bf16(const void* x, const void* emb, void* vals, void* idx,
                                       void* lse, void* scratch, int R, int V, int E, int k,
                                       void* stream) {
  if (!valid_args(x, emb, R, V, E, k)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t rc = make_plan(R, V, E, kChunk, row_bytes(k), k, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  CUtensorMap map_x, map_emb;
  if (!make_map(&map_x, x, R, E, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2) ||
      !make_map(&map_emb, emb, V, E, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Partials part = partials(scratch, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = cudaFuncSetAttribute(vocab_topk_lse_sm90_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(p.smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vocab_topk_lse_sm90_kernel<<<p.blocks, kThreads, p.smem, st>>>(
      map_x, map_emb, part.v, part.i, part.m, part.s, V, k, p.chunks, p.col_tiles, p.units,
      p.max_segments, p.stages);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(launch_merge(part, p, vals, idx, lse, R, k, st));
}
