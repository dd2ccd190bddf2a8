"""Where kernel D's bitmask time goes, on the card.

    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_nms

Builds variants of ``csrc/nms.cu``, each a text substitution of the source
compiled by ``nvcc`` with ``csrc/ssc_common.cu`` into its own library under
``build/ablate_nms/``, and times each with CUDA events around a CUDA graph of
10 launches (so that no host time hides in the number): the median and range
of 5 such timings, the variants taken in turn, then again in reverse order.
Each variant is timed alone (``bitmask``) and followed by the scan on its
words (``with_scan``, which shows what the store policy does to the scan's
reads). Both call sites of a detector forward, on proposal-like boxes seeded
as ``chip_smoke.py`` seeds them: the RPN's 16 x 6,000 at IoU 0.7 and the
per-class 1,280 x 300 at 0.3.

- ``full``: the kernel as it is;
- ``divide``: every pair decided by the IEEE division (``__fdiv_rn``) in
  place of the division-free test;
- ``f64``: every pair decided by an f64 product with the exact midpoint
  between t and the next f32 (two f32 → f64 conversions a pair);
- ``full_grid``: units for every column chunk of every row block, those
  below the diagonal exiting at once, in place of the triangle;
- ``row_per_thread``: each lane tests one row against the unit's live
  columns, read one at a time from shared memory, in place of a lane per
  column and ballots;
- ``plain_stores``: plain stores in place of streaming ones (``__stcs``);
- ``chunk1`` and ``chunk4``: units of 1 or 4 column words in place of 2 (2
  or 8 column sets a lane in place of 4; ``chunk4`` with 6 resident blocks
  an SM, so up to 80 registers a thread);
- ``two_clamps``: the test's intersection clamps h as well as w;
- ``exact_rows``: the kernel as it is, counting the row passes (a unit's
  32 rows each take one) that take the division (``exact_rows`` beside
  ``row_passes`` in the output).

Each variant's words are held against ``full``'s in the upper triangle
(``mismatches``: all variants decide exactly). Prints one JSON line per
(site, variant), then the card's name and power limit. Needs a CUDA GPU and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from style_seqcvae_tpu_torch.ops.kernels import _build
from style_seqcvae_tpu_torch.ops.kernels.ablate_topk_roi import graph_ms

OUT = _build.BUILD_ROOT.parent / "ablate_nms"

TEST = """  const float e = __fmaf_rn(f.neg_t, u, inter);
  const float hu = __fmul_rn(hb, u);
  const bool above = e > hu;
  unsure |= !(e < hu) && !above;
  return above;
"""
STORES = (
    "  __stcs(reinterpret_cast<uint4*>(p),\n"
    "         make_uint4(", "  *reinterpret_cast<uint4*>(p) = (\n         make_uint4(")
STORE8 = (
    "  __stcs(reinterpret_cast<uint2*>(p),\n"
    "         make_uint2(", "  *reinterpret_cast<uint2*>(p) = (\n         make_uint2(")
ROW_PER_THREAD = """  __shared__ float4 s_cb[kMaskWarps][kN][32];
  __shared__ float2 s_ca[kMaskWarps][kN][32];
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    s_cb[warp][s][lane] = col.b[s];
    s_ca[warp][s][lane] = make_float2(col.a[s], col.h[s]);
  }
  __syncwarp();
  if (lane >= n_rows) return;
  const float4 rb = s_box[warp][lane];
  const float2 ra = s_area[warp][lane];
  unsigned bits[kBitWords * 4] = {};
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    for (int l = 0; l < 32; ++l) {
      const float4 cb = s_cb[warp][s][l];
      const float2 ca = s_ca[warp][s][l];
      const float2 wh = overlap(rb, cb);
      const float fast = __fmul_rn(fmaxf(wh.x, 0.0f), wh.y);
      bool unsure = false;
      bool above = above_threshold(fast, __fsub_rn(__fadd_rn(ra.x, ca.x), fast), ca.y, f,
                                   unsure);
      if (unsure) {
        const float inter = __fmul_rn(fmaxf(wh.x, 0.0f), fmaxf(wh.y, 0.0f));
        above = __fdiv_rn(inter, __fsub_rn(__fadd_rn(ra.y, ca.x), inter)) > f.t;
      }
      bits[s] |= static_cast<unsigned>(above) << l;
    }
  }
#pragma unroll
  for (int k = 0; k < kBitWords; ++k)
    s_bits[warp][lane * kBitWords + k] = make_uint4(bits[4 * k], bits[4 * k + 1], bits[4 * k + 2],
                                              bits[4 * k + 3]);
}
"""
EXACT_ROWS_COUNTER = """__device__ unsigned long long g_exact_rows;

// The unit's 32 rows"""
EXACT_ROWS_API = """
extern "C" unsigned long long ssc_nms_exact_rows() {
  unsigned long long v = 0;
  cudaMemcpyFromSymbol(&v, g_exact_rows, sizeof v);
  return v;
}

extern "C" void ssc_nms_exact_rows_reset() {
  const unsigned long long z = 0;
  cudaMemcpyToSymbol(g_exact_rows, &z, sizeof z);
}
"""
ROWS_BODY_START = "#pragma unroll 2\n  for (int r = 0; r < n_rows; ++r) {"
ROWS_BODY_END = " " * 53 + "bits[4 * k + 2], bits[4 * k + 3]);\n    }\n  }\n}\n"

VARIANTS = {
    "full": [],
    "divide": [(TEST, "  return __fdiv_rn(inter, u) > f.t;\n")],
    # a tie inter == m u is impossible for f32 inter and u (m has 25
    # significant bits), so > decides
    "f64": [(TEST, "  unsure |= !(u > 0.0f && u < INFINITY);\n"
                   "  return static_cast<double>(inter) > static_cast<double>(u) *\n"
                   "         (static_cast<double>(f.t) + static_cast<double>(f.h));\n")],
    "full_grid": [("constexpr bool kTriangle = true;", "constexpr bool kTriangle = false;")],
    "row_per_thread": [None],
    "plain_stores": [STORES, STORE8],
    "chunk1": [("constexpr int kChunk = 2;", "constexpr int kChunk = 1;")],
    "chunk4": [("constexpr int kChunk = 2;", "constexpr int kChunk = 4;"),
               ("constexpr int kMaskMinBlocks = 8;", "constexpr int kMaskMinBlocks = 6;")],
    "two_clamps": [("      const float inter = __fmul_rn(fmaxf(wh.x, 0.0f), wh.y);",
                    "      const float inter = __fmul_rn(fmaxf(wh.x, 0.0f), fmaxf(wh.y, 0.0f));")],
    "exact_rows": [("// The unit's 32 rows", EXACT_ROWS_COUNTER),
                   ("    if (__any_sync(ssc::kFullMask, unsure)) {\n",
                    "    if (__any_sync(ssc::kFullMask, unsure)) {\n"
                    "      if (lane == 0) atomicAdd(&g_exact_rows, 1ull);\n"),
                   None],
}
# (groups, boxes, threshold, max_out, presorted) of chip_smoke.py's NMS_CALLS
SITES = {"nms_rpn": (16, 6000, 0.7, 300, True), "nms_per_class": (1280, 300, 0.3, 0, False)}


def variant_source(name: str) -> str:
    src = (_build.CSRC / "nms.cu").read_text()
    for sub in VARIANTS[name]:
        if sub is None:
            continue
        old, new = sub
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is no longer in nms.cu")
        src = src.replace(old, new)
    if name == "row_per_thread":
        a = src.index(ROWS_BODY_START)
        b = src.index(ROWS_BODY_END) + len(ROWS_BODY_END)
        src = src[:a] + ROW_PER_THREAD + src[b:]
    if name == "exact_rows":
        src += EXACT_ROWS_API
    return src


def build() -> None:
    """Compile every variant at once; raises with nvcc's output on failure."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        path = OUT / f"nms_{name}.cu"
        path.write_text(variant_source(name))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-I",
               str(_build.CSRC), str(path), str(_build.CSRC / "ssc_common.cu"),
               "-o", str(OUT / f"libnms_{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on nms/{name}:\n{log}")
        (OUT / f"nms_{name}.log").write_text(log)


def bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / f"libnms_{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssc_nms_bitmask.argtypes = [p, p, i, i, ctypes.c_float, p]
    lib.ssc_nms_scan.argtypes = [p, p, p, p, i, i, i, p]
    lib.ssc_error_string.argtypes = [i]
    lib.ssc_error_string.restype = ctypes.c_char_p
    if name == "exact_rows":
        lib.ssc_nms_exact_rows.restype = ctypes.c_ulonglong
    return lib


def site_inputs(dev, G: int, N: int, presorted: bool):
    """chip_smoke.py's proposal-like boxes (16 to 400 px over a 600 x 900
    image), sorted by their seeded scores."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(N)
    ctr = torch.rand(G, N, 2, generator=gen, device=dev) * torch.tensor([900.0, 600.0],
                                                                         device=dev)
    wh = torch.rand(G, N, 2, generator=gen, device=dev) * 384.0 + 16.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.rand(G, N, generator=gen, device=dev)
    if not presorted:
        scores = torch.where(scores > 0.5, scores, 0.0)
    perm = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.gather(boxes, 1, perm[..., None].expand(G, N, 4)).contiguous()


def row_passes(N: int, chunk: int = 2) -> int:
    """Rows a group's units walk through: each 32-row block once per column
    chunk from its diagonal word on (the kernel's units)."""
    words = -(-N // 64)
    return sum(min(32, N - 32 * q) * -(-(words - q // 2) // chunk) for q in range(-(-N // 32)))


def main() -> int:
    import torch

    build()
    dev = torch.device("cuda")
    libs = {name: bind(name) for name in VARIANTS}
    for site, (G, N, thr, max_out, _) in SITES.items():
        sboxes = site_inputs(dev, G, N, presorted=site == "nms_rpn")
        words = -(-N // 64)
        upper = (torch.arange(words, device=dev)[None, :]
                 >= (torch.arange(N, device=dev) // 64)[:, None])
        out_len = min(max_out, N) if max_out else N
        keep_idx = torch.empty((G, out_len), dtype=torch.int32, device=dev)
        keep_mask = torch.empty((G, N), dtype=torch.bool, device=dev)
        masks = {name: torch.empty((G, N, words), dtype=torch.int64, device=dev)
                 for name in VARIANTS}
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def bitmask(name):
            lib = libs[name]
            _build.check(lib, lib.ssc_nms_bitmask(sboxes.data_ptr(), masks[name].data_ptr(), G,
                                                  N, thr, stream()), name)

        def with_scan(name):
            bitmask(name)
            lib = libs[name]
            _build.check(lib, lib.ssc_nms_scan(masks[name].data_ptr(), None, keep_idx.data_ptr(),
                                               keep_mask.data_ptr(), G, N, out_len, stream()),
                         name)

        results = {name: {"bitmask": [], "with_scan": []} for name in VARIANTS}
        for name in list(VARIANTS) + list(reversed(VARIANTS)):
            for key, fn in (("bitmask", bitmask), ("with_scan", with_scan)):
                ms, rng = graph_ms(lambda: fn(name))
                results[name][key].append({"ms": ms, "ms_range": rng})
        libs["exact_rows"].ssc_nms_exact_rows_reset()
        bitmask("exact_rows")
        torch.cuda.synchronize()
        exact_rows = libs["exact_rows"].ssc_nms_exact_rows()
        for name, runs in results.items():
            row = {"site": site, "groups": G, "boxes": N, "threshold": thr, "variant": name,
                   "mismatches": int(((masks[name] != masks["full"]) & upper).sum()), **runs}
            if name == "exact_rows":
                row["exact_rows"] = exact_rows
                row["row_passes"] = G * row_passes(N)
            print(json.dumps(row), flush=True)
        del sboxes, masks
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
