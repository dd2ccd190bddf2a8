"""Where the RoIAlign backward kernel's time goes, on the card.

    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_roi_backward

Builds variants of ``csrc/roi_align.cu``, each a text substitution of the
source compiled by ``nvcc`` with ``csrc/ssc_common.cu`` into its own library
under ``build/ablate_roi_backward/``, and times ``ssc_roi_align_backward``
(plan pass and gather) with CUDA events around a CUDA graph of 10 launches:
the median and range of 5 such timings, the variants taken in turn, then
again in reverse order. Cases: the ResNet-101 training step's (4, 40, 64,
1024) with 512 RoIs in f32 and bf16, and the workflow's stage-1 (8, 24, 32,
1024) with 1,024 RoIs in bf16, RoIs as ``scripts/time_detector.py`` lays
them out (``train_rois``):

- ``full``: the kernel as it is;
- ``stores_only``: the plan pass, then each block writes its zeros and scans
  no RoI;
- ``scan_only``: each block also keeps the RoIs that meet its tile, and
  writes none of their tap weights;
- ``no_compute``: each block also writes the kept RoIs' tap weights, and adds
  nothing;
- ``no_loads``: the adds run on a made-up vector in place of grad_out's;
- ``cols4``: tiles of 4 columns instead of 2, the 64 sums of a thread then
  over half as many channels;
- ``rows2`` and ``rows8``: tiles of 2 or 8 rows instead of 4 (64- or
  256-thread blocks);
- ``warps24`` and ``warps8``: registers capped for 24 or 8 resident warps an
  SM instead of 16 (80 or 255 registers a thread);
- ``same_bin``: every load reads the lane's vectors of grad_out's first bin,
  which stay in L1 (what the loads cost beyond L1);
- ``batch8``: at most 8 RoIs a batch, so that the block's warps take the
  RoIs closer together in time (a barrier every 8 RoIs);
- ``lockstep``: one RoI a batch, so that the block's warps take the RoIs
  together (a barrier a RoI) and share their loads in L1.

Every variant but ``full`` gives wrong gradients. Prints one JSON line per
(case, variant), then the card's name and power limit. Needs a CUDA GPU and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from style_seqcvae_tpu_torch.ops.kernels import _build
from style_seqcvae_tpu_torch.ops.kernels.ablate_topk_roi import graph_ms

OUT = _build.BUILD_ROOT.parent / "ablate_roi_backward"
SOURCE = "roi_align.cu"

NO_SCAN = ("  for (int base = 0; base < R; base += kGatherThreads) {",
           "  for (int base = 0; base < 0; base += kGatherThreads) {")
NO_LISTS = ("    for (int k0 = 0; k0 < total; k0 += batch) {",
            "    for (int k0 = 0; k0 < 0; k0 += batch) {")
NO_COMPUTE = ("      if (valid(0) > 0) {\n        for (int k = 0;",
              "      if (false) {\n        for (int k = 0;")
NO_LOADS = ("? load_vec<T, kVec>(g + 32 * N * v, valid(v))", "? make_uint4(pw, v, 0u, 0u)")
VARIANTS = {
    "full": [],
    "stores_only": [NO_SCAN],
    "scan_only": [NO_LISTS],
    "no_compute": [NO_COMPUTE],
    "no_loads": [NO_LOADS],
    "cols4": [("constexpr int kTileCols = 2;", "constexpr int kTileCols = 4;")],
    "rows2": [("constexpr int kTileRows = 4;", "constexpr int kTileRows = 2;")],
    "rows8": [("constexpr int kTileRows = 4;", "constexpr int kTileRows = 8;")],
    "warps24": [("constexpr int kWarpsPerSM = 16;", "constexpr int kWarpsPerSM = 24;")],
    "warps8": [("constexpr int kWarpsPerSM = 16;", "constexpr int kWarpsPerSM = 8;")],
    "same_bin": [("const T* g = g_row + static_cast<size_t>(pw) * C;",
                  "const T* g = grad_out + c0;")],
    "batch8": [("kListBytes / ((kLines * P + 2) * 4)", "8")],
    "lockstep": [("kListBytes / ((kLines * P + 2) * 4)", "1")],
}


def build() -> None:
    """Compile every variant at once; raises with nvcc's output on failure."""
    OUT.mkdir(parents=True, exist_ok=True)
    for name, subs in VARIANTS.items():
        src = (_build.CSRC / SOURCE).read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is no longer in {SOURCE}")
            src = src.replace(old, new)
        (OUT / f"roi_backward_{name}.cu").write_text(src)
    procs = {}
    for name in VARIANTS:
        path = OUT / f"roi_backward_{name}.cu"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-I",
               str(_build.CSRC), str(path), str(_build.CSRC / "ssc_common.cu"),
               "-o", str(OUT / f"libroi_backward_{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        gather = [" ".join((lines[i - 1] + "," + ln.split(":", 1)[1]).split())
                  for i, ln in enumerate(lines)
                  if "Used" in ln and "backward_kernel" in "".join(lines[max(0, i - 3):i])]
        print(json.dumps({"variant": name, "ptxas": gather}), flush=True)


def bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / f"libroi_backward_{name}.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ssc_roi_align_backward.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.ssc_roi_align_backward_plan_words.argtypes = [i, i]
    lib.ssc_error_string.argtypes = [i]
    lib.ssc_error_string.restype = ctypes.c_char_p
    return lib


def cases(dev):
    import torch

    from style_seqcvae_tpu_torch.scripts.time_detector import train_rois

    for n, canvas, image, dtype in ((4, (640, 1024), (600, 1000), torch.float32),
                                    (4, (640, 1024), (600, 1000), torch.bfloat16),
                                    (8, (384, 512), (384, 512), torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(18)
        rois = train_rois(gen, n, image)
        shape = (n, canvas[0] // 16, canvas[1] // 16, 1024)
        grad_out = torch.randn(rois.shape[0], 7, 7, 1024, generator=gen, device=dev).to(dtype)
        yield f"{'x'.join(map(str, shape))} R{rois.shape[0]} {str(dtype)[6:]}", (
            grad_out, rois, shape)


def runner(lib: ctypes.CDLL, case):
    import torch

    grad_out, rois, (B, H, W, C) = case
    R = rois.shape[0]
    out = torch.empty((B, H, W, C), dtype=grad_out.dtype, device=grad_out.device)
    plan = torch.empty(R * lib.ssc_roi_align_backward_plan_words(7, 2), dtype=torch.int32,
                       device=grad_out.device)

    def run():
        _build.check(lib, lib.ssc_roi_align_backward(
            grad_out.data_ptr(), rois.data_ptr(), out.data_ptr(), plan.data_ptr(), B, H, W, C,
            R, 1 / 16.0, 7, 2, int(grad_out.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "roi_align_backward")
    return run


def main() -> int:
    import torch

    build()
    dev = torch.device("cuda")
    libs = {name: bind(name) for name in VARIANTS}
    for shape, case in cases(dev):
        results = {}
        for name in list(VARIANTS) + list(reversed(VARIANTS)):
            ms, rng = graph_ms(runner(libs[name], case))
            results.setdefault(name, []).append({"ms": ms, "ms_range": rng})
        for name, runs in results.items():
            print(json.dumps({"kernel": "roi_align_backward", "shape": shape, "variant": name,
                              "runs": runs}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
