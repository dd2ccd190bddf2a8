"""Where kernel A's bf16 time goes, on the card.

    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_vocab_topk_lse

Builds variants of ``csrc/vocab_topk_lse_sm90.cu``, each a text substitution
of the source compiled by ``nvcc`` into its own library under
``build/ablate_vocab_topk_lse/``, and times each at the flagship decode shape
(R 12,800, V 10,500, E 600, k 10, bf16) with CUDA events, every variant in a
process of its own:

- ``full``: the kernel as it is;
- ``no_select``: the top-k's second pass skipped (its results are wrong);
- ``no_select_no_mma``: that, and no wgmma either: the loads, the
  logsumexp and the first pass only.

Prints one JSON line per variant, then the card's name and power limit.
Needs a CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from style_seqcvae_tpu_torch.ops.kernels import _build

OUT = _build.BUILD_ROOT.parent / "ablate_vocab_topk_lse"
SOURCE = _build.CSRC / "vocab_topk_lse_sm90.cu"
R, V, E, K = 12800, 10500, 600, 10

NO_SELECT = ("        while (__any_sync(ssc::kFullMask, pending != 0)) {",
             "        while (false) {")
VARIANTS = {
    "full": [],
    "no_select": [NO_SELECT],
    "no_select_no_mma": [NO_SELECT, ("          wgmma_m64n128k16(acc,",
                                     "          if (0) wgmma_m64n128k16(acc,")],
}


def build() -> None:
    """Compile every variant at once; raises with nvcc's output on failure."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = SOURCE.read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is no longer in {SOURCE.name}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-I",
               str(_build.CSRC), str(path), "-o", str(OUT / f"lib{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")


def time_variant(name: str) -> dict:
    import torch

    from style_seqcvae_tpu_torch.ops.kernels.vocab_topk_lse import matmul_top_k_with_lse_plain

    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssc_vocab_topk_lse_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.ssc_vocab_topk_lse_bf16_plan.argtypes = [i, i, i, i, p]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev)).to(torch.bfloat16)
    emb = torch.randn(V, E, generator=gen, device=dev).to(torch.bfloat16)
    plan = (ctypes.c_longlong * 5)()
    _build.check(lib, lib.ssc_vocab_topk_lse_bf16_plan(R, V, E, K, plan), name)
    scratch = torch.empty(plan[4], dtype=torch.uint8, device=dev)
    vals = torch.empty(R, K, device=dev)
    idx = torch.empty(R, K, dtype=torch.int32, device=dev)
    lse = torch.empty(R, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check(lib, lib.ssc_vocab_topk_lse_bf16(
            x.data_ptr(), emb.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), R, V, E, K, stream), name)

    run()
    torch.cuda.synchronize()
    want = matmul_top_k_with_lse_plain(x, emb, K)
    ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / 20)
    return {"variant": name, "ms": ms, "stages": plan[2], "smem_bytes": plan[3],
            "idx_agree": (idx == want[1]).float().mean().item()}


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(time_variant(sys.argv[1])), flush=True)
        return 0
    build()
    for name in VARIANTS:
        run = subprocess.run([sys.executable, "-m", __spec__.name, name], capture_output=True,
                             text=True, timeout=300)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
