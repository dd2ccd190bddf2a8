// Bottom-up top-down attention weights in one kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this layer to XLA
// (style_seqcvae_tpu/models/attention.py::attention_weights, a broadcast
// add, tanh, a product with w_attend and a masked softmax). The port had
// run the same four ops through PyTorch, which writes the (rows, N, P) sum
// to device memory, reads and rewrites it for the tanh and reads it again
// for the product: at the CBS decode's 12,800 rows x 100 boxes x P 768 that
// is 983 M elements a step (3.9 GB in f32), most of the decode's attention
// time and a host sync (the masked softmax's -inf scalar) every step.
//
// Computes, for rows r of image b = r / rows_per_image,
//   weights[r, n] = masked_softmax_n(sum_p w[p] * tanh(q[r, p] + pv[b, n, p]))
// with AllenNLP's semantics (ops/masked.py::masked_softmax): boxes whose
// mask is 0 get 0, a row with no box gets zeros, the denominator + 1e-13.
// q (rows, P), pv (B, N, P), w (P) and the weights in f32 or bf16; the
// mask (B, N) as bytes; sums, tanh and softmax in f32.
//
// Bound on an H100 SXM: the tanh, not the bytes. The inputs are ~50 MB a
// step (15 us at 3.35 TB/s), but every (r, n, p) takes its own tanh:
// 983 M of them. bf16 route: one tanh.approx.f32 each on the special
// function unit, 16 a clock per SM, ~0.24 ms at 1.98 GHz. f32 route: tanhf
// (two SFU operations and some ten FP32 ones), ~0.5 ms at one instruction a
// clock per scheduler.
//
// Design: a block owns up to `br` rows of one image and all of that image's
// boxes (in tiles of at most 128), so pv is read once per block and never
// replicated per row, and the (rows, N, P) sum lives only in registers.
//   * P is walked in chunks of 128 bytes a row. Each chunk of the block's
//     q rows, of the tile's pv rows and of w is copied to shared memory by
//     cp.async (zero-filled past P, past the image's rows and past the
//     tile's boxes), two stages deep, so the next chunk's copy runs under
//     this chunk's tanh.
//   * Each thread sums a 2-row x 4-box register tile in f32 (its boxes
//     strided by the number of box groups); per 16 bytes of a row it reads
//     2 + 4 vectors from shared memory for 8 tanh per element, so shared
//     memory stays far below the SFU's pace. At N = 100, 25 box groups x 10
//     row groups make 250 threads: eight warps, two on each of the SM's
//     four schedulers, whose SFUs then share the work evenly (a block of
//     five warps put two on one scheduler and took 1.37x as long).
//   * The tile's logits go to shared memory; a warp per row folds them into
//     a running max and sum (several tiles only when N > 128); after the
//     last tile each row is written as exp(l - max) / (sum + 1e-13).
//   * The bf16 route widens to f32 and takes tanh.approx.f32 (relative
//     error ~2^-11, below the bf16 rounding that the composite applied to
//     the sum and to the tanh); the f32 route takes tanhf, the function
//     PyTorch's tanh calls, so its tanh equals the composite's.
// Optionally the f32 logits are written too (tests and chip_smoke.py).
#include <cstdint>

#include "ssc_common.cuh"

namespace {

constexpr int kTR = 2;            // rows a thread
constexpr int kTN = 4;            // boxes a thread
constexpr int kMaxTile = 128;     // boxes a tile
constexpr int kChunk = 128;       // bytes of a row a stage
constexpr int kRowPitch = kChunk + 16;  // shared row pitch: conflict-free 16-byte reads
constexpr int kVecs = kChunk / 16;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float tanh_of(float x, float) { return tanhf(x); }
__device__ __forceinline__ float tanh_of(float x, __nv_bfloat16) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Copies `vec` bytes (16, 8, 4 or 2) from src to shared dst, or zeros when
// !valid. 16, 8 and 4 go through cp.async; 2 (bf16 rows of odd P) is a
// plain load and store, visible after the next barrier like the others.
__device__ __forceinline__ void copy(void* dst, const char* src, int vec, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? vec : 0;
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *reinterpret_cast<const uint16_t*>(src) : 0;
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Shape {
  int rpi, N, P, upi;   // rows per image, boxes, width, units (blocks) per image
  int br, brg, nbg;     // rows a block, row groups, box groups
  int bt, ntiles, vec;  // boxes a tile, tiles, copy bytes
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
butd_attention_kernel(const T* __restrict__ q, const T* __restrict__ pv,
                      const T* __restrict__ w, const unsigned char* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ logits, Shape s) {
  using V16 = ssc::Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int vrows = s.nbg * kTN;  // pv rows a stage holds, zeros past the tile
  const int stage_bytes = (s.br + vrows) * kRowPitch + kChunk;
  float* lg = reinterpret_cast<float*>(smem + 2 * stage_bytes);  // (br, N) logits
  float* run_m = lg + s.br * s.N;
  float* run_s = run_m + s.br;

  const int b = blockIdx.x / s.upi;
  const int r0 = (blockIdx.x % s.upi) * s.br;
  const int rows = min(s.br, s.rpi - r0);
  const long long row0 = static_cast<long long>(b) * s.rpi + r0;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // this thread's tile: rows rg*kTR + i, boxes bg + nbg*j; the spare lanes
  // past brg*nbg compute on row group 0 and store nothing
  const bool active = tid < s.brg * s.nbg;
  const int rg = active ? tid / s.nbg : 0;
  const int bg = active ? tid % s.nbg : 0;

  const int p_bytes = s.P * static_cast<int>(sizeof(T));
  const int nchunks = (p_bytes + kChunk - 1) / kChunk;
  const int pieces = kChunk / s.vec;  // copies a row a chunk
  const char* qb = reinterpret_cast<const char*>(q) + row0 * p_bytes;
  const char* vb = reinterpret_cast<const char*>(pv) +
                   static_cast<long long>(b) * s.N * p_bytes;
  const char* wb = reinterpret_cast<const char*>(w);
  const unsigned char* mk = mask + static_cast<long long>(b) * s.N;

  for (int r = tid; r < s.br; r += nthreads) {
    run_m[r] = -INFINITY;
    run_s[r] = 0.f;
  }

  for (int tile = 0; tile < s.ntiles; ++tile) {
    const int n0 = tile * s.bt;
    const int nt = min(s.bt, s.N - n0);

    auto load = [&](int c, int stage) {
      unsigned char* base = smem + stage * stage_bytes;
      const int total = (s.br + vrows + 1) * pieces;
      for (int i = tid; i < total; i += nthreads) {
        const int row = i / pieces;
        const int off = (i - row * pieces) * s.vec;
        const int col = c * kChunk + off;
        const bool in_p = col < p_bytes;
        if (row < s.br) {
          copy(base + row * kRowPitch + off,
               row < rows && in_p ? qb + static_cast<long long>(row) * p_bytes + col : qb,
               s.vec, row < rows && in_p);
        } else if (row < s.br + vrows) {
          const int n = row - s.br;
          copy(base + row * kRowPitch + off,
               n < nt && in_p ? vb + static_cast<long long>(n0 + n) * p_bytes + col : vb,
               s.vec, n < nt && in_p);
        } else {
          copy(base + (s.br + vrows) * kRowPitch + off, in_p ? wb + col : wb, s.vec, in_p);
        }
      }
      commit();
    };

    float acc[kTR][kTN];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    load(0, 0);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks)
        load(c + 1, (c + 1) & 1);
      else
        commit();  // an empty group, so that one wait fits every chunk
      wait_all_but_one();
      __syncthreads();
      const unsigned char* base = smem + (c & 1) * stage_bytes;
      const uint4* qs = reinterpret_cast<const uint4*>(base) + rg * kTR * (kRowPitch / 16);
      const uint4* vs = reinterpret_cast<const uint4*>(base + s.br * kRowPitch) +
                        bg * (kRowPitch / 16);
      const uint4* ws = reinterpret_cast<const uint4*>(base + (s.br + vrows) * kRowPitch);
      const int vstride = s.nbg * (kRowPitch / 16);
#pragma unroll 1
      for (int k = 0; k < kVecs; ++k) {
        uint4 qv[kTR], vv[kTN];
#pragma unroll
        for (int i = 0; i < kTR; ++i) qv[i] = qs[i * (kRowPitch / 16) + k];
#pragma unroll
        for (int j = 0; j < kTN; ++j) vv[j] = vs[j * vstride + k];
        const uint4 wv = ws[k];
#pragma unroll
        for (int e = 0; e < V16::kN; ++e) {
          const float we = V16::get(wv, e);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float qe = V16::get(qv[i], e);
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              acc[i][j] = fmaf(we, tanh_of(qe + V16::get(vv[j], e), T()), acc[i][j]);
          }
        }
      }
      __syncthreads();  // the stage is refilled at the next chunk
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = rg * kTR + i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int n = bg + s.nbg * j;
          if (r < rows && n < nt) {
            lg[r * s.N + n0 + n] = acc[i][j];
            if (logits != nullptr) logits[(row0 + r) * s.N + n0 + n] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();
    // fold the tile into each row's running max and sum of exp(l - max)
    for (int r = warp; r < rows; r += nwarps) {
      const float* l = lg + r * s.N + n0;
      float m = -INFINITY;
      for (int n = lane; n < nt; n += 32)
        if (mk[n0 + n]) m = fmaxf(m, l[n]);
      m = ssc::warp_max(m);
      float sum = 0.f;
      if (m != -INFINITY)
        for (int n = lane; n < nt; n += 32)
          if (mk[n0 + n]) sum += expf(l[n] - m);
      sum = ssc::warp_sum(sum);
      if (lane == 0) {
        const float om = run_m[r], mn = fmaxf(om, m);
        if (mn != -INFINITY)
          run_s[r] = (om == -INFINITY ? 0.f : run_s[r] * expf(om - mn)) +
                     (m == -INFINITY ? 0.f : sum * expf(m - mn));
        run_m[r] = mn;
      }
    }
    // the next tile's first copy may land before a slow warp has read lg:
    // it writes only the stages, which every warp has left
  }
  __syncthreads();
  for (int r = warp; r < rows; r += nwarps) {
    const float m = run_m[r], den = run_s[r] + 1e-13f;
    const float* l = lg + r * s.N;
    T* o = out + (row0 + r) * s.N;
    for (int n = lane; n < s.N; n += 32)
      store(o + n, mk[n] ? expf(l[n] - m) / den : 0.f);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

size_t smem_bytes(const Shape& s) {
  return static_cast<size_t>(2) * ((s.br + s.nbg * kTN) * kRowPitch + kChunk) +
         static_cast<size_t>(s.br) * s.N * 4 + static_cast<size_t>(s.br) * 8;
}

// The split of (B * rpi rows, N, P): box tiles of at most 128, four boxes a
// thread; then the row groups a block that waste the fewest lanes, rows (a
// block covers rows of one image only) and scheduler slots (a warp count
// that is not a multiple of 4 loads one scheduler's SFU more than the
// others), that give two blocks an SM where the rows allow it (a serve
// request's 800 rows: 80 blocks of 10 rows, not 40 of 20) and fit shared
// memory, ties to the block nearest 256 threads.
// vec: the widest copy that every row start allows (pointers' alignment
// and P's bytes).
cudaError_t make_shape(int B, int rpi, int N, int P, int elem, uintptr_t align, Shape* s) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  if (B <= 0 || rpi <= 0 || N <= 0 || P <= 0) return cudaErrorInvalidValue;
  s->rpi = rpi;
  s->N = N;
  s->P = P;
  s->ntiles = (N + kMaxTile - 1) / kMaxTile;
  s->bt = (N + s->ntiles - 1) / s->ntiles;
  s->nbg = (s->bt + kTN - 1) / kTN;
  s->vec = gcd(16, gcd(P * elem, static_cast<int>(align % 16 == 0 ? 16 : align % 16)));
  if (s->vec < 2 && elem == 2) return cudaErrorInvalidValue;  // misaligned bf16
  if (s->vec < 4 && elem == 4) return cudaErrorInvalidValue;
  const int max_brg = kMaxThreads / s->nbg;
  const int need_brg = (rpi + kTR - 1) / kTR;
  double best = -1.0;
  int best_brg = 0, best_padded = 0;
  for (int brg = 1; brg <= max_brg && brg <= need_brg; ++brg) {
    Shape t = *s;
    t.brg = brg;
    t.br = brg * kTR;
    if (smem_bytes(t) > static_cast<size_t>(smem_max)) break;
    const int threads = brg * s->nbg, warps = (threads + 31) / 32, padded = warps * 32;
    const int units = (rpi + t.br - 1) / t.br;
    const double blocks = static_cast<double>(units) * B;
    const double score = static_cast<double>(threads) / padded *
                         static_cast<double>(warps) / (4 * ((warps + 3) / 4)) *
                         static_cast<double>(rpi) / (static_cast<double>(units) * t.br) *
                         (blocks < 2.0 * sms ? blocks / (2.0 * sms) : 1.0);
    const bool better = score > best + 1e-9 ||
                        (score > best - 1e-9 && abs(padded - 256) < abs(best_padded - 256));
    if (better) {
      best = score;
      best_brg = brg;
      best_padded = padded;
    }
  }
  if (best_brg == 0) return cudaErrorInvalidValue;  // N too large for shared memory
  s->brg = best_brg;
  s->br = best_brg * kTR;
  s->upi = (rpi + s->br - 1) / s->br;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* pv, const void* w, const void* mask, void* out,
                   void* logits, int B, const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes(s);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(butd_attention_kernel<T>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int threads = (s.brg * s.nbg + 31) / 32 * 32;
  butd_attention_kernel<T><<<static_cast<unsigned>(B) * s.upi, threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pv), static_cast<const T*>(w),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out),
      static_cast<float*>(logits), s);
  return cudaGetLastError();
}

}  // namespace

// The split on the current device, for 16-byte aligned pointers: out[0]
// rows a block, out[1] blocks, out[2] threads a block, out[3] dynamic
// shared memory bytes, out[4] box tiles, out[5] boxes a tile, out[6] copy
// bytes. Returns a CUDA error code (cudaErrorInvalidValue when N does not
// fit shared memory even at two rows a block).
extern "C" int ssc_butd_attention_plan(int B, int rpi, int N, int P, int is_bf16,
                                       long long* out) {
  Shape s;
  const cudaError_t rc = make_shape(B, rpi, N, P, is_bf16 ? 2 : 4, 0, &s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long vals[7] = {s.br, static_cast<long long>(B) * s.upi,
                             (s.brg * s.nbg + 31) / 32 * 32,
                             static_cast<long long>(smem_bytes(s)), s.ntiles, s.bt, s.vec};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// q (B * rpi, P), pv (B, N, P), w (P) of one dtype (bf16 when is_bf16, else
// f32), mask (B, N) bytes -> out (B * rpi, N) in that dtype, and the f32
// logits (B * rpi, N) when `logits` is not null. Returns a CUDA error code.
extern "C" int ssc_butd_attention(const void* q, const void* pv, const void* w,
                                  const void* mask, void* out, void* logits, int B, int rpi,
                                  int N, int P, int is_bf16, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(pv) |
                          reinterpret_cast<uintptr_t>(w);
  Shape s;
  const cudaError_t rc = make_shape(B, rpi, N, P, is_bf16 ? 2 : 4, align, &s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(q, pv, w, mask, out, logits, B, s, st)
                                  : launch<float>(q, pv, w, mask, out, logits, B, s, st));
}
