"""Where kernel A's time goes, on the card, for each of its two routes.

    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_vocab_topk_lse --fetch-parent
    python -m style_seqcvae_tpu_torch.ops.kernels.ablate_vocab_topk_lse

Builds variants of the kernel's sources, each a text substitution compiled
by ``nvcc`` into its own library under ``build/ablate_vocab_topk_lse/``,
and times each at the flagship decode shape (R 12,800, V 10,500, E 600,
k 10) with CUDA events, every variant in a process of its own. The
variants of a route run in the order A B B A (the list, then the list
reversed), so that a drift of the card's clock over the run shows.

bf16 (``csrc/vocab_topk_lse_sm90.cu``):

- ``full``: the kernel as it is;
- ``no_select``: the top-k's second pass skipped (its results are wrong);
- ``no_select_no_mma``: that, and no wgmma either: the loads, the
  logsumexp and the first pass only.

f32 (``csrc/vocab_topk_lse.cu``):

- ``full``: the kernel as it is;
- ``no_select``: no top-k at all, the product and the logsumexp only (the
  second pass skipped, which leaves the first dead code; its lists are
  wrong);
- ``parent``: the kernel that this design replaced, through its own C
  entry point. Its source is ``git show 1312119:style_seqcvae_tpu_torch/
  csrc/vocab_topk_lse.cu``; ``--fetch-parent`` writes it into the build
  directory, in a checkout that has the history, before the directory is
  copied to the machine with the card.

Each f32 process also times cuBLAS's f32 product ``torch.matmul(x, emb.T)``
(TF32 off) on the same inputs, for scale. Prints one JSON line per run,
then the card's name and power limit. Needs a CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from style_seqcvae_tpu_torch.ops.kernels import _build

OUT = _build.BUILD_ROOT.parent / "ablate_vocab_topk_lse"
PARENT_REV = "1312119"
PARENT_PATH = "style_seqcvae_tpu_torch/csrc/vocab_topk_lse.cu"
PARENT_SOURCE = OUT / "parent_vocab_topk_lse.cu"
R, V, E, K = 12800, 10500, 600, 10

BF16_NO_SELECT = ("        while (__any_sync(ssc::kFullMask, pending != 0)) {",
                  "        while (false) {")
F32_NO_SELECT = [("    if (__any_sync(ssc::kFullMask, passed != 0)) {", "    if (false) {")]
# (source, substitutions) per variant
VARIANTS = {
    "bf16": {
        "full": (_build.CSRC / "vocab_topk_lse_sm90.cu", []),
        "no_select": (_build.CSRC / "vocab_topk_lse_sm90.cu", [BF16_NO_SELECT]),
        "no_select_no_mma": (_build.CSRC / "vocab_topk_lse_sm90.cu",
                             [BF16_NO_SELECT, ("          wgmma_m64n128k16(acc,",
                                               "          if (0) wgmma_m64n128k16(acc,")]),
    },
    "f32": {
        "full": (_build.CSRC / "vocab_topk_lse.cu", []),
        "no_select": (_build.CSRC / "vocab_topk_lse.cu", F32_NO_SELECT),
        "parent": (PARENT_SOURCE, []),
    },
}


def fetch_parent() -> None:
    """Write the replaced f32 kernel's source from git into the build
    directory."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = subprocess.run(["git", "show", f"{PARENT_REV}:{PARENT_PATH}"], check=True,
                         capture_output=True, text=True, cwd=_build.CSRC).stdout
    PARENT_SOURCE.write_text(src)


def build() -> None:
    """Compile every variant at once; raises with nvcc's output on failure."""
    if not PARENT_SOURCE.exists():
        raise RuntimeError(f"{PARENT_SOURCE} is missing: run with --fetch-parent in a "
                           "checkout that has the history first")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for route, variants in VARIANTS.items():
        for name, (source, subs) in variants.items():
            src = source.read_text()
            for old, new in subs:
                if old not in src:
                    raise RuntimeError(f"{route} {name}: {old!r} is no longer in {source.name}")
                src = src.replace(old, new)
            path = OUT / f"{route}_{name}.cu"
            path.write_text(src)
            cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-I",
                   str(_build.CSRC), str(path), "-o", str(OUT / f"lib{route}_{name}.so")]
            procs[route, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    for (route, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {route} {name}:\n{log}")
        (OUT / f"{route}_{name}.log").write_text(log)


def events_ms(fn, reps: int = 20, samples: int = 3) -> list:
    import torch

    ms = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    return ms


def time_variant(route: str, name: str) -> dict:
    import torch

    from style_seqcvae_tpu_torch.ops.kernels.vocab_topk_lse import matmul_top_k_with_lse_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    lib = ctypes.CDLL(str(OUT / f"lib{route}_{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev)).to(dtype)
    emb = torch.randn(V, E, generator=gen, device=dev).to(dtype)
    vals = torch.empty(R, K, device=dev)
    idx = torch.empty(R, K, dtype=torch.int32, device=dev)
    lse = torch.empty(R, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"route": route, "variant": name}
    if name == "parent":
        fn = lib.ssc_vocab_topk_lse_f32
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]

        def run():
            _build.check(lib, fn(x.data_ptr(), emb.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                 lse.data_ptr(), R, V, E, K, stream), name)
    else:
        fn = getattr(lib, f"ssc_vocab_topk_lse_{route}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        plan_fn = getattr(lib, f"ssc_vocab_topk_lse_{route}_plan")
        plan_fn.argtypes = [i, i, i, i, p]
        plan = (ctypes.c_longlong * 6)()
        _build.check(lib, plan_fn(R, V, E, K, plan), name)
        scratch = torch.empty(plan[4], dtype=torch.uint8, device=dev)
        out.update(stages=plan[2], smem_bytes=plan[3])

        def run():
            _build.check(lib, fn(x.data_ptr(), emb.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                 lse.data_ptr(), scratch.data_ptr(), R, V, E, K, stream), name)

    run()
    torch.cuda.synchronize()
    want = matmul_top_k_with_lse_plain(x, emb, K)
    out.update(idx_agree=(idx == want[1]).float().mean().item(),
               max_abs_err_vals=(vals - want[0]).abs().max().item(),
               max_abs_err_lse=(lse - want[2]).abs().max().item())
    out["ms"] = events_ms(run)
    if route == "f32":
        out["torch_matmul_ms"] = events_ms(lambda: torch.matmul(x, emb.T), reps=10)
    return out


def main() -> int:
    if sys.argv[1:] == ["--fetch-parent"]:
        fetch_parent()
        print(PARENT_SOURCE)
        return 0
    if len(sys.argv) == 3:
        print(json.dumps(time_variant(sys.argv[1], sys.argv[2])), flush=True)
        return 0
    build()
    for route, variants in VARIANTS.items():
        names = list(variants)
        for name in names + names[::-1]:
            run = subprocess.run([sys.executable, "-m", __spec__.name, route, name],
                                 capture_output=True, text=True, timeout=300)
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
