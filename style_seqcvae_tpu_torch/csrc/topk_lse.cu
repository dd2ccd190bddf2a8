// Top-k with logsumexp over materialised logits, for Hopper (sm_90a).
//
// Replaces the TPU kernel style_seqcvae_tpu/ops/pallas/topk_lse.py::
// top_k_with_lse (body `_kernel`, :36-73): logits (R, V) in bf16 or f32 ->
// the unmasked top-k values (R, k) f32, their indices (R, k) i32 and the row
// logsumexp (R,) f32, for any V >= k and 1 <= k <= 127. Ties go to the lower
// index; indices stay distinct on a row that is all -inf, and such a row's
// logsumexp is -inf.
//
// Bound on an H100 SXM: memory. At the flagship decode grid (R = 12,800
// rows, V = 10,500, bf16) the kernel must read 12,800 * 10,500 * 2 B =
// 269 MB, about 80 us at 3.35 TB/s (f32: 161 us); its arithmetic, one
// exponential and a few comparisons per element, is a third of that.
//
// Design: one streaming pass. Each row belongs to one warp, or, when R is
// too small to put 16 warps' loads in flight on every SM, to 2-8 warps of a
// block that take interleaved vectors of it and merge at the end. A block
// holds 8 warps; 64 registers a thread let 4 blocks share an SM.
//   * Every lane reads 16 bytes at a time (8 bf16 or 4 f32), four loads in
//     flight, straight from device memory into registers: no copy of the
//     row goes to shared memory, so V has no cap. A row whose start is not
//     16-byte aligned (bf16 rows at V = 10,500 alternate) peels its first
//     few elements, and the last few, as single elements.
//   * Each lane keeps a running max and a rescaled sum of exp(x - max) (the
//     streaming logsumexp); the warp merges them with shuffles at the end.
//   * The top-k is exact by a threshold filter. The warp keeps a list of up
//     to k entries in selection order (value descending, index ascending)
//     in shared memory; its k-th entry is the threshold. Only an element
//     that comes before the threshold is appended (ballot and popc) to a
//     buffer of candidates. When the buffer fills, and at the end of the
//     row, each lane ranks its entries of list and buffer against all the
//     others, those ranked under k make the new list, and the threshold
//     rises. Until the list first fills, the k-th largest of the lanes'
//     maxima over the first loads (k <= 32) stands in for the threshold, so
//     that those loads' elements do not all pass. On random rows only about
//     k * ln(V / k) elements pass; a rising row passes every element and
//     takes a merge per 128 of them: slower, equally exact.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W) at R 12,800, V 10,500,
// k 10: 0.157 ms in bf16 and 0.248 ms in f32 (chip_smoke.py, medians of 5
// timings of 10 launches); the old design (one block of 256 threads per
// row, the row copied to shared memory as f32 and walked k + 2 times with
// block-wide barriers) took 0.904 and 0.903 ms. The loads alone take 0.099
// ms in bf16 (ops/kernels/ablate_topk_roi.py).
#include <cstdint>

#include "ssc_common.cuh"

namespace {

constexpr int kWarps = 8;       // rows, or slices of a row, per block
constexpr int kThreads = kWarps * 32;
constexpr int kCap = 128;       // candidate slots per warp
constexpr int kUnroll = 4;      // 16-byte loads in flight per lane

// One warp's running top-k. The list (len <= k entries, in selection order)
// and the candidates not yet merged into it (cnt) live in shared memory;
// every lane holds the same len, cnt and threshold. All members are
// warp-collective.
struct WarpTopK {
  float* v;  // [2 lists of k][kCap candidates]
  int* i;    // the same layout
  int k, cur = 0, len = 0, cnt = 0;
  // the list's k-th entry; until the list is full, (-inf or the seed, INT_MAX)
  float tv = -INFINITY;
  int ti = INT_MAX;

  __device__ float* list_v() const { return v + cur * k; }
  __device__ int* list_i() const { return i + cur * k; }

  __device__ __forceinline__ bool passes(float x, int j) const {
    return ssc::before(x, j, tv, ti);
  }

  // Before anything is offered: the k-th largest of the lanes' maxima is a
  // value that k distinct elements reach, so no element below it can be in
  // the top-k. It stands in for the threshold until the list is full, so
  // that the first loads' elements do not all pass.
  __device__ __forceinline__ void seed(float lane_max, int lane) {
    if (k > 32) return;
    float x = lane_max == lane_max ? lane_max : -INFINITY;  // NaN ranks last
    // bitonic sort across the warp, the largest to lane 0
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float y = __shfl_xor_sync(ssc::kFullMask, x, stride);
        x = ((lane & stride) == 0) == ((lane & size) == 0) ? fmaxf(x, y) : fminf(x, y);
      }
    tv = __shfl_sync(ssc::kFullMask, x, k - 1);
  }

  // list + candidates -> the best min(k, len + cnt) of them as the new list.
  // Each lane ranks its entries against all the others (read as broadcasts;
  // no two are equal, their indices differ) and writes those ranked under k
  // to their place: no chain of shuffles between the lanes.
  __device__ __forceinline__ void merge(int lane) {
    __syncwarp();
    const float *lv = list_v(), *cv = v + 2 * k;
    const int *li = list_i(), *ci = i + 2 * k;
    float* nv = v + (1 - cur) * k;
    int* ni = i + (1 - cur) * k;
    const int total = len + cnt, n = min(k, total);
    for (int p = lane; p < total; p += 32) {
      const float x = p < len ? lv[p] : cv[p - len];
      const int xi = p < len ? li[p] : ci[p - len];
      int rank = 0;
#pragma unroll 4
      for (int q = 0; q < len; ++q) rank += ssc::before(lv[q], li[q], x, xi);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) rank += ssc::before(cv[q], ci[q], x, xi);
      if (rank < n) { nv[rank] = x; ni[rank] = xi; }
    }
    __syncwarp();
    cur = 1 - cur;
    len = n;
    cnt = 0;
    if (n == k) { tv = nv[k - 1]; ti = ni[k - 1]; }
  }

  // Each lane offers at most one element (ok); those that still come before
  // the threshold join the candidates.
  __device__ __forceinline__ void offer(float x, int j, bool ok, int lane) {
    bool take = ok && passes(x, j);
    unsigned bal = __ballot_sync(ssc::kFullMask, take);
    if (bal == 0) return;
    // while the list is short, merge small batches so the threshold rises early
    const int room = len < k ? max(k, 32) : kCap;
    if (cnt + __popc(bal) > room) {
      merge(lane);
      take = ok && passes(x, j);
      bal = __ballot_sync(ssc::kFullMask, take);
    }
    if (take) {
      const int at = 2 * k + cnt + __popc(bal & ((1u << lane) - 1u));
      v[at] = x;
      i[at] = j;
    }
    cnt += __popc(bal);
  }

  // Offers, lane by lane, the elements marked in `pending` (bit b: element b
  // of this lane's batch, its value and index from get(b)).
  template <typename Get>
  __device__ __forceinline__ void offer_all(unsigned pending, Get get, int lane) {
    while (__any_sync(ssc::kFullMask, pending != 0)) {
      const int b = pending ? __ffs(pending) - 1 : 0;
      float x;
      int j;
      get(b, x, j);
      offer(x, j, pending != 0, lane);
      pending &= pending - 1;
    }
  }
};

// Folds N values, whose max is lm, into this lane's (max, sum of exp(x - max)).
template <int N>
__device__ __forceinline__ void lse_add(float& m, float& s, const float (&x)[N], float lm) {
  const float mn = fmaxf(m, lm);
  if (isfinite(mn)) {  // -inf: nothing yet; +inf: the lse is +inf whatever s is
    // x - mn first: scaling x alone would round away its low bits at large |x|
    float t = s * ssc::exp2_approx((m - mn) * ssc::kLog2e);
#pragma unroll
    for (int j = 0; j < N; ++j) t += ssc::exp2_approx((x[j] - mn) * ssc::kLog2e);
    s = t;
  }
  m = mn;
}

// 64 registers a thread: 4 blocks (32 warps) per SM keep enough loads in flight
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
topk_lse_kernel(const T* __restrict__ logits, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ lse, int R, int V, int k,
                int warps_per_row) {
  using Vec = ssc::Vec16<T>;
  constexpr int N = Vec::kN;
  extern __shared__ float4 smem[];
  __shared__ float part_m[kWarps], part_s[kWarps];
  __shared__ int part_len[kWarps], part_cur[kWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp % warps_per_row;
  const long long r = static_cast<long long>(blockIdx.x) * (kWarps / warps_per_row) +
                      warp / warps_per_row;
  const int per_warp = 2 * k + kCap;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + kWarps * per_warp);
  WarpTopK sel{sv + warp * per_warp, si + warp * per_warp, k};
  float m = -INFINITY, s = 0.f;

  if (r < R) {
    const T* row = logits + r * V;
    // elements before the first 16-byte boundary, then whole vectors
    const int head = min(V, static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T)));
    const int nvec = (V - head) / N;
    const uint4* body = reinterpret_cast<const uint4*>(row + head);
    const int step = 32 * warps_per_row;
    for (int base = slice * 32; base < nvec; base += step * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * step + lane;
        q[u] = j < nvec ? __ldcs(body + j) : uint4{};
      }
      float lm[kUnroll], lane_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        lm[u] = -INFINITY;
        if (base + u * step + lane < nvec) {
          float x[N];
#pragma unroll
          for (int e = 0; e < N; ++e) {
            x[e] = Vec::get(q[u], e);
            lm[u] = fmaxf(lm[u], x[e]);
          }
          lse_add(m, s, x, lm[u]);
          lane_max = fmaxf(lane_max, lm[u]);
        }
      }
      if (base == slice * 32) sel.seed(lane_max, lane);
      unsigned pending = 0;  // bit u * N + e: element e of vector u passes
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * step + lane;
        if (j < nvec && lm[u] >= sel.tv) {
#pragma unroll
          for (int e = 0; e < N; ++e)
            pending |= static_cast<unsigned>(sel.passes(Vec::get(q[u], e), head + j * N + e))
                       << (u * N + e);
        }
      }
      sel.offer_all(pending, [&](int b, float& x, int& xi) {
        const int u = b / N, e = b % N;
        uint4 w = q[0];
#pragma unroll
        for (int t = 1; t < kUnroll; ++t)
          if (t == u) w = q[t];
        x = Vec::get(w, e);
        xi = head + (base + u * step + lane) * N + e;
      }, lane);
    }
    if (slice == 0) {
      // the peeled head and the tail past the last whole vector: < 2N elements
      const int tail = head + nvec * N;
      const int e = lane < head ? lane : tail + lane - head;
      const bool ok = lane < head + V - tail;
      float x[1] = {ok ? ssc::to_float(row[e]) : -INFINITY};
      lse_add(m, s, x, x[0]);
      sel.offer_all(ok && sel.passes(x[0], e), [&](int, float& xv, int& xi) {
        xv = x[0];
        xi = e;
      }, lane);
    }
    if (sel.cnt > 0) sel.merge(lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ssc::lse_merge(m, s, __shfl_xor_sync(ssc::kFullMask, m, o),
                     __shfl_xor_sync(ssc::kFullMask, s, o));
  }

  if (warps_per_row > 1) {
    // the row's first warp takes in the other slices' lists and sums
    if (lane == 0) {
      part_m[warp] = m;
      part_s[warp] = s;
      part_len[warp] = sel.len;
      part_cur[warp] = sel.cur;
    }
    __syncthreads();
    if (r < R && slice == 0) {
      for (int w = warp + 1; w < warp + warps_per_row; ++w) {
        const float* ov = sv + w * per_warp + part_cur[w] * k;
        const int* oi = si + w * per_warp + part_cur[w] * k;
        for (int p0 = 0; p0 < part_len[w]; p0 += 32) {
          const int p = p0 + lane;
          const bool ok = p < part_len[w];
          sel.offer(ok ? ov[p] : -INFINITY, ok ? oi[p] : INT_MAX, ok, lane);
        }
        ssc::lse_merge(m, s, part_m[w], part_s[w]);
      }
      if (sel.cnt > 0) sel.merge(lane);
    }
  }

  if (r < R && slice == 0) {
    const float* lv = sel.list_v();
    const int* li = sel.list_i();
    for (int j = lane; j < k; j += 32) {
      vals[r * k + j] = lv[j];
      idx[r * k + j] = li[j];
    }
    if (lane == 0) lse[r] = ssc::finish_lse(m, s);
  }
}

template <typename T>
void launch(const void* logits, void* vals, void* idx, void* lse, int R, int V, int k,
            cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a row per warp, unless that leaves fewer than 16 warps' loads per SM
  int warps_per_row = 1;
  while (warps_per_row < kWarps && static_cast<long long>(R) * warps_per_row < 16LL * sms)
    warps_per_row *= 2;
  const int rows_per_block = kWarps / warps_per_row;
  const size_t smem = static_cast<size_t>(kWarps) * (2 * k + kCap) * 8;
  topk_lse_kernel<T><<<(R + rows_per_block - 1) / rows_per_block, kThreads, smem, st>>>(
      static_cast<const T*>(logits), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), R, V, k, warps_per_row);
}

}  // namespace

// logits (R, V) -> vals (R, k), idx (R, k), lse (R,). Returns cudaGetLastError().
extern "C" int ssc_topk_lse(const void* logits, void* vals, void* idx, void* lse,
                            int R, int V, int k, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(logits, vals, idx, lse, R, V, k, st);
  else
    launch<float>(logits, vals, idx, lse, R, V, k, st);
  return static_cast<int>(cudaGetLastError());
}
