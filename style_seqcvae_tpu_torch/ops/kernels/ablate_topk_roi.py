"""Where kernels B's and C's time goes, on the card.

    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_topk_roi

Builds variants of ``csrc/topk_lse.cu`` (kernel B) and ``csrc/roi_align.cu``
(kernel C), each a text substitution of the source compiled by ``nvcc`` with
``csrc/ssc_common.cu`` into its own library under
``build/ablate_topk_roi/``, and times each with CUDA events around a CUDA
graph of 10 launches (so that no host time hides in the number): the median
and range of 5 such timings, the variants taken in turn, then again in
reverse order. Kernel B at the flagship decode shape (R 12,800, V 10,500,
k 10, bf16 and f32; the logits from a matmul as in the fused decode) and at
the ragged 1,000 x 10,501 bf16 shape:

- ``full``: the kernel as it is;
- ``no_select``: no element is offered to the top-k (its results are wrong):
  the loads and the logsumexp;
- ``no_lse``: the top-k without the logsumexp's exponentials;
- ``loads_only``: neither;
- ``no_seed``: the threshold not seeded from the first loads' lane maxima,
  so that all of their elements pass and fill the list;
- ``warp_per_row``: one warp per row at any R (the ragged shape gets 4);
- ``three_blocks``: registers capped for 3 blocks per SM instead of 4;
- ``argmax_merge``: merges by k rounds of a warp-wide argmax over list and
  candidates (the exclusion by selection order of the old kernel) instead
  of each lane ranking its entries.

Kernel C at config 5's full width ((16, 38, 58, 1024) map, 4,800 seeded RoIs,
f32 and bf16):

- ``full``: the kernel as it is;
- ``l1_corners``: every sample reads its own four corners (16 reads per bin
  at S = 2), so the reuse between samples is left to L1;
- ``plain_stores``: the output written with plain stores instead of
  streaming ones (``__stcs``, evict-first);
- ``evict_first_stores``: plain stores with an L2 evict-first cache policy;
- ``evict_last_loads``: the map read with an L2 evict-last cache policy;
- ``group7`` and ``group2``: the bins of an output row taken 7 or 2 at a time
  instead of 4 (more or fewer registers and loads in flight per thread,
  fewer or more warps per SM, the same loads).

Prints one JSON line per (kernel, shape, variant), then the card's name and
power limit. Needs a CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

from style_seqcvae_tpu_torch.ops.kernels import _build

OUT = _build.BUILD_ROOT.parent / "ablate_topk_roi"
K = 10

NO_SELECT = ("        if (j < nvec && lm[u] >= sel.tv) {", "        if (false) {")
NO_LSE = ("          lse_add(m, s, x, lm[u]);\n", "")
STORE16 = "{\n  __stcs(reinterpret_cast<uint4*>(p), v);\n}\n"
EVICT_LAST_LOADS = ("  return __ldg(reinterpret_cast<const uint4*>(p));\n", (
    "  uint64_t pol;\n"
    "  asm(\"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\" : \"=l\"(pol));\n"
    "  uint4 v;\n"
    "  asm(\"ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\"\n"
    "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p), \"l\"(pol));\n"
    "  return v;\n"))
RANK_MERGE = """    for (int p = lane; p < total; p += 32) {
      const float x = p < len ? lv[p] : cv[p - len];
      const int xi = p < len ? li[p] : ci[p - len];
      int rank = 0;
#pragma unroll 4
      for (int q = 0; q < len; ++q) rank += ssc::before(lv[q], li[q], x, xi);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) rank += ssc::before(cv[q], ci[q], x, xi);
      if (rank < n) { nv[rank] = x; ni[rank] = xi; }
    }
"""
ARGMAX_MERGE = """    float pv = INFINITY;
    int pi = -1;
    for (int j = 0; j < n; ++j) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int p = lane; p < total; p += 32) {
        const float x = p < len ? lv[p] : cv[p - len];
        const int xi = p < len ? li[p] : ci[p - len];
        if (ssc::before(pv, pi, x, xi) && ssc::before(x, xi, bv, bi)) { bv = x; bi = xi; }
      }
      ssc::warp_first(bv, bi);
      if (lane == 0) { nv[j] = bv; ni[j] = bi; }
      pv = bv;
      pi = bi;
    }
"""
VARIANTS = {
    "topk_lse": ("topk_lse.cu", {
        "full": [],
        "no_select": [NO_SELECT],
        "no_lse": [NO_LSE],
        "loads_only": [NO_SELECT, NO_LSE],
        "no_seed": [("      if (base == slice * 32) sel.seed(lane_max, lane);\n", "")],
        "warp_per_row": [("  while (warps_per_row < kWarps &&", "  while (false &&")],
        "three_blocks": [("__global__ void __launch_bounds__(kThreads, 4)\n",
                          "__global__ void __launch_bounds__(kThreads, 3)\n")],
        "argmax_merge": [(RANK_MERGE, ARGMAX_MERGE)],
    }),
    "roi_align": ("roi_align.cu", {
        "full": [],
        "l1_corners": [("    for (int t = 0; t < n; ++t)\n"
                        "      if (pos[t] == at) { w[t] += weight; return; }\n", "")],
        "plain_stores": [(STORE16, "{ *reinterpret_cast<uint4*>(p) = v; }\n")],
        "evict_first_stores": [(STORE16, (
            "{\n"
            "  uint64_t pol;\n"
            "  asm(\"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\" : \"=l\"(pol));\n"
            "  asm volatile(\"st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\"\n"
            "               :: \"l\"(p), \"r\"(v.x), \"r\"(v.y), \"r\"(v.z), \"r\"(v.w),"
            " \"l\"(pol) : \"memory\");\n"
            "}\n"))],
        "evict_last_loads": [EVICT_LAST_LOADS],
        "group7": [("constexpr int kGroup = 4;", "constexpr int kGroup = 7;")],
        "group2": [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")],
    }),
}


def build() -> None:
    """Compile every variant at once; raises with nvcc's output on failure."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (source, variants) in VARIANTS.items():
        for name, subs in variants.items():
            src = (_build.CSRC / source).read_text()
            for old, new in subs:
                if old not in src:
                    raise RuntimeError(f"{kernel}/{name}: {old!r} is no longer in {source}")
                src = src.replace(old, new)
            path = OUT / f"{kernel}_{name}.cu"
            path.write_text(src)
            cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-I",
                   str(_build.CSRC), str(path), str(_build.CSRC / "ssc_common.cu"),
                   "-o", str(OUT / f"lib{kernel}_{name}.so")]
            procs[(kernel, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)
    for (kernel, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel}/{name}:\n{log}")


def graph_ms(run, reps: int = 10, samples: int = 5):
    """Median and [min, max] of ``samples`` replays of a CUDA graph of
    ``reps`` calls of ``run``, per call."""
    import torch

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            run()
    graph.replay()
    torch.cuda.synchronize()
    ms = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    return statistics.median(ms), [min(ms), max(ms)]


def topk_cases(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.tanh(torch.randn(12800, 600, generator=gen, device=dev))
    emb = torch.randn(10500, 600, generator=gen, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        yield f"12800x10500 {str(dtype)[6:]}", torch.matmul(x.to(dtype), emb.to(dtype).T)
    yield "1000x10501 bfloat16", (3 * torch.randn(1000, 10501, generator=gen, device=dev)
                                  ).to(torch.bfloat16)


def roi_cases(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    per, B = 300, 16
    b = torch.arange(B, device=dev).repeat_interleave(per).float()[:, None]
    xy = torch.rand(B * per, 2, generator=gen, device=dev) * torch.tensor(
        [1000.0, 700.0], device=dev) - 50.0
    wh = torch.rand(B * per, 2, generator=gen, device=dev) * 400.0
    rois = torch.cat([b, xy, xy + wh], dim=1).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn(B, 38, 58, 1024, generator=gen, device=dev).to(dtype)
        yield f"16x38x58x1024 {str(dtype)[6:]}", (feats, rois)


def bind(kernel: str, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / f"lib{kernel}_{name}.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "topk_lse":
        lib.ssc_topk_lse.argtypes = [p, p, p, p, i, i, i, i, p]
    else:
        lib.ssc_roi_align.argtypes = [p, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.ssc_error_string.argtypes = [i]
    lib.ssc_error_string.restype = ctypes.c_char_p
    return lib


def runner(kernel: str, lib: ctypes.CDLL, case):
    """A closure that launches one variant on the case; and its outputs."""
    import torch

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if kernel == "topk_lse":
        logits = case
        R, V = logits.shape
        outs = (torch.empty(R, K, device=logits.device),
                torch.empty(R, K, dtype=torch.int32, device=logits.device),
                torch.empty(R, device=logits.device))

        def run():
            _build.check(lib, lib.ssc_topk_lse(
                logits.data_ptr(), *(o.data_ptr() for o in outs), R, V, K,
                int(logits.dtype == torch.bfloat16), stream()), kernel)
        return run, outs
    feats, rois = case
    B, H, W, C = feats.shape
    out = torch.empty(rois.shape[0], 7, 7, C, dtype=feats.dtype, device=feats.device)

    def run():
        _build.check(lib, lib.ssc_roi_align(
            feats.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, rois.shape[0],
            1 / 16.0, 7, 2, int(feats.dtype == torch.bfloat16), stream()), kernel)
    return run, (out,)


def main() -> int:
    import torch

    build()
    dev = torch.device("cuda")
    for kernel, (_, variants) in VARIANTS.items():
        libs = {name: bind(kernel, name) for name in variants}
        cases = topk_cases(dev) if kernel == "topk_lse" else roi_cases(dev)
        for shape, case in cases:
            results = {}
            order = list(variants) + list(reversed(variants))
            for name in order:
                run, outs = runner(kernel, libs[name], case)
                ms, rng = graph_ms(run)
                results.setdefault(name, []).append({"ms": ms, "ms_range": rng})
                if name == "full" and "ref" not in results:
                    results["ref"] = [o.clone() for o in outs]
                elif kernel == "roi_align" and len(results[name]) == 1:
                    # the variants that keep C's results: within f32 rounding of the kernel's
                    results[name][0]["max_abs_diff"] = (
                        outs[0].float() - results["ref"][0].float()).abs().max().item()
            results.pop("ref")
            for name, runs in results.items():
                print(json.dumps({"kernel": kernel, "shape": shape, "variant": name,
                                  "runs": runs}), flush=True)
            del case
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
