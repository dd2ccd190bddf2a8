// Tied vocabulary head fused with a streaming top-k and logsumexp: the f32
// path, on the CUDA cores of Hopper (sm_90a).
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py::
// matmul_top_k_with_lse (body `_kernel`, :43-110) for f32 inputs: x (R, E)
// and emb (V, E), both f32 -> the top-k of the logits x . emb^T per row as
// values (R, k) f32 and indices (R, k) i32 (ties to the lower index), and
// the row logsumexp (R,) f32. The (R, V) logits never reach device memory.
// bf16 inputs go to the tensor-core kernel in vocab_topk_lse_sm90.cu; this
// one stays for f32 because the tensor cores cannot form an exact f32
// product (TF32 would change the results).
//
// Design: one block of 256 threads owns kRows = 32 rows and loops over the
// vocabulary in tiles of kCols = 128 columns; this loop takes the place of
// the TPU kernel's sequential V grid axis, and the running state it carried
// in VMEM scratch lives in shared memory. Per tile:
//   1. logits: x and emb are staged in shared memory (kDepth = 32 of E at a
//      time) and each thread accumulates a 4 x 4 block of the tile with f32
//      FMAs; the tile goes to shared memory.
//   2. one warp per row merges the tile: the running max and sum of
//      exp(x - max) are rescaled (the streaming logsumexp), then every
//      column that comes before the current k-th entry in selection order
//      (value descending, index ascending) is inserted into the row's sorted
//      list of k entries. After the first tiles almost no column passes that
//      test, so the merge costs a comparison per column.
// Columns past V are never candidates. Rows past R compute on zeros and are
// not written.
//
// Bound on an H100 SXM: operations. At the flagship decode grid (R =
// 12,800, V = 10,500, E = 600) a launch does 2 * R * V * E = 161 GFLOP,
// 2.41 ms at the 67 TFLOP/s f32 peak of the CUDA cores. This design is
// limited by shared-memory loads before that; PERF.md records its time.
#include "ssc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;   // rows per block
constexpr int kCols = 128;  // vocabulary columns per tile
constexpr int kDepth = 32;  // E per staged chunk
constexpr int kMaxK = 128;  // k <= 127, as on the TPU

__host__ __device__ constexpr size_t smem_floats(int k) {
  return static_cast<size_t>(kDepth) * (kRows + 1)      // xs [kDepth][kRows+1]
         + static_cast<size_t>(kDepth) * (kCols + 1)    // es [kDepth][kCols+1]
         + static_cast<size_t>(kRows) * (kCols + 1)     // lt [kRows][kCols+1]
         + 2 * static_cast<size_t>(kRows) * k           // list values, indices
         + 2 * kRows;                                   // running max, sum
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vocab_topk_lse_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                      float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ lse, int R, int V, int E, int k) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* es = xs + kDepth * (kRows + 1);
  float* lt = es + kDepth * (kCols + 1);
  float* lv = lt + kRows * (kCols + 1);
  int* li = reinterpret_cast<int*>(lv + kRows * k);
  float* run_m = reinterpret_cast<float*>(li + kRows * k);
  float* run_s = run_m + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int ty = tid >> 5;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = lane;      // columns tx + 32*j

  for (int i = tid; i < kRows * k; i += kThreads) { lv[i] = -INFINITY; li[i] = INT_MAX; }
  for (int i = tid; i < kRows; i += kThreads) { run_m[i] = -INFINITY; run_s[i] = 0.f; }

  for (int v0 = 0; v0 < V; v0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int e0 = 0; e0 < E; e0 += kDepth) {
      __syncthreads();  // previous chunk / previous tile's merge is done
      for (int i = tid; i < kRows * kDepth; i += kThreads) {
        const int r = i / kDepth, e = i % kDepth;
        const int gr = row0 + r, ge = e0 + e;
        xs[e * (kRows + 1) + r] =
            (gr < R && ge < E) ? ssc::to_float(x[static_cast<size_t>(gr) * E + ge]) : 0.f;
      }
      for (int i = tid; i < kCols * kDepth; i += kThreads) {
        const int c = i / kDepth, e = i % kDepth;
        const int gc = v0 + c, ge = e0 + e;
        es[e * (kCols + 1) + c] =
            (gc < V && ge < E) ? ssc::to_float(emb[static_cast<size_t>(gc) * E + ge]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < kDepth; ++e) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = xs[e * (kRows + 1) + ty * 4 + q];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = es[e * (kCols + 1) + tx + 32 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) lt[(ty * 4 + p) * (kCols + 1) + tx + 32 * q] = acc[p][q];
    __syncthreads();

    const int ncol = min(kCols, V - v0);
    for (int r = warp; r < kRows; r += kWarps) {
      if (row0 + r >= R) continue;  // warp-uniform
      const float* row = lt + r * (kCols + 1);
      float* rv = lv + r * k;
      int* ri = li + r * k;

      // streaming logsumexp
      float tmax = -INFINITY;
      for (int c = lane; c < ncol; c += 32) tmax = fmaxf(tmax, row[c]);
      tmax = ssc::warp_max(tmax);
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, tmax);
      if (isfinite(m_new)) {
        float ts = 0.f;
        for (int c = lane; c < ncol; c += 32) ts += expf(row[c] - m_new);
        ts = ssc::warp_sum(ts);
        if (lane == 0) {
          run_s[r] = run_s[r] * expf(m_old - m_new) + ts;
          run_m[r] = m_new;
        }
      } else if (lane == 0) {
        run_m[r] = m_new;
      }

      // merge the tile into the row's sorted list of k entries
      for (int c0 = 0; c0 < ncol; c0 += 32) {
        const int c = c0 + lane;
        bool pending = c < ncol;
        const float v = pending ? row[c] : -INFINITY;
        const int gi = v0 + c;
        while (true) {
          __syncwarp();
          const bool want = pending && ssc::before(v, gi, rv[k - 1], ri[k - 1]);
          const unsigned ballot = __ballot_sync(ssc::kFullMask, want);
          if (ballot == 0) break;
          const int src = __ffs(ballot) - 1;
          const float cv = __shfl_sync(ssc::kFullMask, v, src);
          const int ci = __shfl_sync(ssc::kFullMask, gi, src);
          int ahead = 0;  // entries that stay before the candidate
          for (int j = lane; j < k; j += 32) ahead += ssc::before(rv[j], ri[j], cv, ci);
          const int pos = static_cast<int>(__reduce_add_sync(ssc::kFullMask, ahead));
          float sv[kMaxK / 32];
          int si[kMaxK / 32];
#pragma unroll
          for (int t = 0; t < kMaxK / 32; ++t) {
            const int j = lane + 32 * t;
            if (j >= pos && j < k - 1) { sv[t] = rv[j]; si[t] = ri[j]; }
          }
          __syncwarp();
#pragma unroll
          for (int t = 0; t < kMaxK / 32; ++t) {
            const int j = lane + 32 * t;
            if (j >= pos && j < k - 1) { rv[j + 1] = sv[t]; ri[j + 1] = si[t]; }
          }
          if (lane == 0) { rv[pos] = cv; ri[pos] = ci; }
          if (lane == src) pending = false;
        }
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= R) continue;
    for (int j = lane; j < k; j += 32) {
      vals[static_cast<size_t>(gr) * k + j] = lv[r * k + j];
      idx[static_cast<size_t>(gr) * k + j] = li[r * k + j];
    }
    if (lane == 0) lse[gr] = ssc::finish_lse(run_m[r], run_s[r]);
  }
}

}  // namespace

// x (R, E), emb (V, E) f32 -> vals (R, k), idx (R, k), lse (R,); k < kMaxK.
// Returns cudaGetLastError().
extern "C" int ssc_vocab_topk_lse_f32(const void* x, const void* emb, void* vals, void* idx,
                                      void* lse, int R, int V, int E, int k, void* stream) {
  const size_t smem = smem_floats(k) * sizeof(float);
  const dim3 grid((R + kRows - 1) / kRows);
  auto kern = vocab_topk_lse_kernel<float>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<float*>(lse), R, V, E, k);
  return static_cast<int>(cudaGetLastError());
}
