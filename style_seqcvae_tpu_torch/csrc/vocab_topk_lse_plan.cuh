// What kernel A's two routes share (vocab_topk_lse.cu, f32 on the CUDA
// cores; vocab_topk_lse_sm90.cu, bf16 on the tensor cores): the work split,
// the TMA loads with their mbarrier ring, the scratch of partial results
// and the kernel that merges them.
//
// The work is a grid of units, one per (128-row tile of x, 128-column tile
// of the vocabulary). A persistent block per SM takes a contiguous run of
// units in row-tile-major order (the runs of all blocks differ by at most
// one unit), so every SM has work at any R; a run that crosses a row tile
// ends one segment and starts the next. A segment's end writes its per-row
// list of candidates (k for bf16, a few more for f32) and (max, sum) to
// scratch that the wrapper allocates; the merge kernel merges the few
// partial lists of each row (k rounds of a warp-wide argmax, ties to the
// lower index) and their (max, sum) pairs into vals, idx and lse.
//
// Both routes stream 128-byte K chunks of the x tile and the emb tile (64
// bf16 or 32 f32 values a row) into a ring of stages through TMA
// (cp.async.bulk.tensor, 128-byte swizzle, zeros past R, V and E). The
// descriptors come from the driver's cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPointByVersion so that the
// library links with plain `nvcc -shared` and no -lcuda; they are passed to
// the kernels as __grid_constant__ parameters.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "ssc_common.cuh"

namespace {

constexpr int kRowsTile = 128;                 // rows of x per unit
constexpr int kColsTile = 128;                 // vocabulary columns per unit
constexpr int kChunkBytes = 128;               // K per stage and row: one swizzle span
constexpr int kTileBytes = kRowsTile * kChunkBytes;  // 16 KB, each of x and emb
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kMaxStages = 8;
constexpr int kMergeWarps = 8;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- work split --------------------------------------------------------------

// Units [unit_begin(b), unit_begin(b + 1)) belong to block b.
__host__ __device__ __forceinline__ long long unit_begin(int b, long long units, int blocks) {
  return static_cast<long long>(b) * units / blocks;
}

struct Plan {
  int row_tiles, col_tiles, blocks, max_segments, stages, chunks, entries;
  long long units;
  size_t smem;
};

// The split of (R, V, E) on the current device; chunk is the K
// width of a stage in elements (128 bytes), row_bytes the shared memory a
// tile row's top-k state takes, entries the length of a partial list.
cudaError_t make_plan(int R, int V, int E, int chunk, size_t row_bytes, int entries, Plan* p) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return rc;
  p->row_tiles = (R + kRowsTile - 1) / kRowsTile;
  p->col_tiles = (V + kColsTile - 1) / kColsTile;
  p->chunks = (E + chunk - 1) / chunk;
  p->entries = entries;
  p->units = static_cast<long long>(p->row_tiles) * p->col_tiles;
  p->blocks = static_cast<int>(p->units < sms ? p->units : sms);
  p->max_segments = 1;
  for (int b = 0; b < p->blocks; ++b) {
    const long long lo = unit_begin(b, p->units, p->blocks);
    const long long hi = unit_begin(b + 1, p->units, p->blocks) - 1;
    const int segs = static_cast<int>(hi / p->col_tiles - lo / p->col_tiles + 1);
    if (segs > p->max_segments) p->max_segments = segs;
  }
  // 1024 for the swizzle's alignment, the rows' top-k state and the
  // ring's barriers
  const size_t fixed = 1024 + kRowsTile * row_bytes + 2 * kMaxStages * 8;
  const long long room = (static_cast<long long>(smem_max) - static_cast<long long>(fixed)) /
                         kStageBytes;
  if (room < 2) return cudaErrorInvalidValue;
  p->stages = static_cast<int>(room < kMaxStages ? room : kMaxStages);
  p->smem = fixed + static_cast<size_t>(p->stages) * kStageBytes;
  return cudaSuccess;
}

size_t scratch_bytes(const Plan& p) {
  return static_cast<size_t>(p.blocks) * p.max_segments * kRowsTile * (2 * p.entries + 2) * 4;
}

// The plan's figures for the wrappers: blocks, segments per block at most,
// pipeline stages, dynamic shared memory bytes, scratch bytes, K chunks.
int plan_entry(int R, int V, int E, int chunk, size_t row_bytes, int entries, long long* out) {
  Plan p;
  const cudaError_t rc = make_plan(R, V, E, chunk, row_bytes, entries, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = p.blocks;
  out[1] = p.max_segments;
  out[2] = p.stages;
  out[3] = static_cast<long long>(p.smem);
  out[4] = static_cast<long long>(scratch_bytes(p));
  out[5] = p.chunks;
  return 0;
}

// Partial results of block b's segment s for tile row r (0..127) live at
// slot (b * max_segments + s) * 128 + r: `entries` values, as many
// indices, max, sum; (-inf, INT_MAX) fills a list's unused entries.
struct Partials {
  float* v;
  int* i;
  float* m;
  float* s;
};

Partials partials(void* scratch, const Plan& p) {
  const size_t slots = static_cast<size_t>(p.blocks) * p.max_segments * kRowsTile;
  Partials out;
  out.v = static_cast<float*>(scratch);
  out.i = reinterpret_cast<int*>(out.v + slots * p.entries);
  out.m = reinterpret_cast<float*>(out.i + slots * p.entries);
  out.s = out.m + slots;
  return out;
}

// ---- merge kernel --------------------------------------------------------------

// One warp per row: the partial lists of the blocks whose runs cover the
// row's tile, merged by k rounds of a warp-wide argmax; (max, sum) pairs
// merged into the logsumexp.
__global__ void __launch_bounds__(kMergeWarps * 32)
vocab_topk_lse_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                            const float* __restrict__ part_m, const float* __restrict__ part_s,
                            float* __restrict__ vals, int* __restrict__ idx,
                            float* __restrict__ lse, int R, int k, int entries,
                            int col_tiles, long long units, int blocks, int max_segments) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // warp-uniform
  const int t = r / kRowsTile, tr = r % kRowsTile;
  const long long u0 = static_cast<long long>(t) * col_tiles, u1 = u0 + col_tiles;
  // the last block whose run starts at or before u0 holds u0
  const int b0 = static_cast<int>(((u0 + 1) * blocks + units - 1) / units - 1);
  int n_lists = 0;
  while (b0 + n_lists < blocks && unit_begin(b0 + n_lists, units, blocks) < u1) ++n_lists;
  auto slot = [&](int l) {
    const int bl = b0 + l;
    const int seg = t - static_cast<int>(unit_begin(bl, units, blocks) / col_tiles);
    return (static_cast<size_t>(bl) * max_segments + seg) * kRowsTile + tr;
  };

  float m = -INFINITY, s = 0.f;
  for (int l = lane; l < n_lists; l += 32) {
    const size_t sl = slot(l);
    const float om = part_m[sl], os = part_s[sl];
    const float mn = fmaxf(m, om);
    if (mn != -INFINITY) s = s * expf(m - mn) + os * expf(om - mn);
    m = mn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(ssc::kFullMask, m, o);
    const float os = __shfl_xor_sync(ssc::kFullMask, s, o);
    const float mn = fmaxf(m, om);
    if (mn != -INFINITY) s = s * expf(m - mn) + os * expf(om - mn);
    m = mn;
  }
  if (lane == 0) lse[r] = ssc::finish_lse(m, s);

  const int n = n_lists * entries;
  float cv = 0.f;
  int ci = 0;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    bool found = false;
    for (int c = lane; c < n; c += 32) {
      const size_t at = slot(c / entries) * entries + c % entries;
      const float v = part_v[at];
      const int i = part_i[at];
      if ((j == 0 || ssc::before(cv, ci, v, i)) && (!found || ssc::before(v, i, bv, bi))) {
        bv = v;
        bi = i;
        found = true;
      }
    }
    ssc::warp_first(bv, bi);
    if (lane == 0) {
      vals[static_cast<size_t>(r) * k + j] = bv;
      idx[static_cast<size_t>(r) * k + j] = bi;
    }
    cv = bv;
    ci = bi;
  }
}

cudaError_t launch_merge(const Partials& part, const Plan& p, void* vals, void* idx, void* lse,
                         int R, int k, cudaStream_t st) {
  vocab_topk_lse_merge_kernel<<<(R + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, st>>>(
      part.v, part.i, part.m, part.s, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), R, k, p.entries, p.col_tiles, p.units, p.blocks,
      p.max_segments);
  return cudaGetLastError();
}

// ---- TMA descriptors -------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// rows x E row-major of `type` (elem bytes each); boxes of 128 rows x one
// 128-byte chunk, 128-byte swizzle, zeros outside the tensor
bool make_map(CUtensorMap* map, const void* ptr, int rows, int E, CUtensorMapDataType type,
              int elem) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(E) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunkBytes / elem), kRowsTile};
  const cuuint32_t elems[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elems,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The checks both routes' entry points make: E a multiple of 8 (the
// wrapper zero-pads it), 16-byte aligned pointers, 0 < k < 128, k <= V.
bool valid_args(const void* x, const void* emb, int R, int V, int E, int k) {
  return R > 0 && V > 0 && E > 0 && E % 8 == 0 && k > 0 && k < 128 && k <= V &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
}

}  // namespace
