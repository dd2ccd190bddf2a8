"""Tied vocabulary head fused with a streaming top-k and logsumexp.

Counterpart of ``style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py::
matmul_top_k_with_lse``. On CUDA tensors :func:`matmul_top_k_with_lse`
launches a hand-written kernel chosen by dtype: bf16 goes to the tensor-core
kernel in ``csrc/vocab_topk_lse_sm90.cu`` (wgmma), f32 to the CUDA-core
kernel in ``csrc/vocab_topk_lse.cu`` (exact f32 FMAs, as cuBLAS's f32
product forms each logit; TF32 would change the results). Both share the
work split, the TMA loads and the merge of partial results
(``csrc/vocab_topk_lse_plan.cuh``); E is zero-padded to a multiple of 8 for
TMA's 16-byte row stride. Neither writes the (R, V) logits to device memory.
On CPU tensors it runs :func:`matmul_top_k_with_lse_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from style_seqcvae_tpu_torch.ops.kernels.topk_lse import top_k_with_lse_plain

# launches of the CUDA kernel in this process (the plain version not counted)
launches = 0


def matmul_top_k_with_lse_plain(x: torch.Tensor, emb: torch.Tensor, k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, E) · emb (V, E)ᵀ with f32 accumulation → (vals (R, k) f32,
    idx (R, k) i32, lse (R,) f32); ties go to the lower index. Materialises
    the logits."""
    return top_k_with_lse_plain(torch.matmul(x.float(), emb.float().T), k)


def _check(x: torch.Tensor, emb: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != emb.shape[1]:
        raise ValueError(f"need x (R, E) and emb (V, E), got {tuple(x.shape)} "
                         f"and {tuple(emb.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or emb.dtype != x.dtype:
        raise TypeError(f"x and emb must both be float32 or both bfloat16, got "
                        f"{x.dtype} and {emb.dtype}")
    if x.device != emb.device:
        raise ValueError(f"x on {x.device} but emb on {emb.device}")
    if not 0 < k < 128 or k > emb.shape[0]:
        raise ValueError(f"need 0 < k < 128 and k <= V, got k={k}, V={emb.shape[0]}")


def pad_width(x: torch.Tensor, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad E of x (R, E) and emb (V, E) up to a multiple of 8 (TMA
    needs rows that are a multiple of 16 bytes: 8 bf16 or 4 f32). Zeros add
    nothing to a dot product, so the head's logits are unchanged."""
    pad = -x.shape[1] % 8
    if pad == 0:
        return x, emb
    return F.pad(x, (0, pad)), F.pad(emb, (0, pad))


def plan(R: int, V: int, E: int, k: int, dtype: torch.dtype) -> Dict[str, int]:
    """How the kernel of ``dtype`` (float32 or bfloat16) splits (R, V, E)
    with k on the current CUDA device (E already a multiple of 8):
    persistent blocks, row-tile segments per block at most, pipeline
    stages, dynamic shared memory, scratch bytes and K chunks."""
    from style_seqcvae_tpu_torch.ops.kernels import _build

    lib = _build.library()
    fn = lib.ssc_vocab_topk_lse_bf16_plan if dtype == torch.bfloat16 else \
        lib.ssc_vocab_topk_lse_f32_plan
    out = (ctypes.c_longlong * 6)()
    _build.check(lib, fn(R, V, E, k, out), "vocab_topk_lse plan")
    return dict(zip(("blocks", "segments", "stages", "smem_bytes", "scratch_bytes", "chunks"),
                    out))


def matmul_top_k_with_lse(x: torch.Tensor, emb: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`matmul_top_k_with_lse_plain`. One call counts
    one launch, although each path runs two CUDA kernels (the product with
    its partial top-k, then the merge)."""
    global launches
    _check(x, emb, k)
    if x.device.type == "cpu":
        return matmul_top_k_with_lse_plain(x, emb, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and emb.is_contiguous()):
        raise ValueError("x and emb must be contiguous")
    from style_seqcvae_tpu_torch.ops.kernels import _build, record_inputs

    lib = _build.library()
    (R, E), V = x.shape, emb.shape[0]
    record_inputs("vocab_topk_lse", x=x, emb=emb, k=k)
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    lse = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R == 0:
        return vals, idx, lse
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        x, emb = pad_width(x, emb)
        E = x.shape[1]
        # TMA reads from 16-byte aligned rows
        x, emb = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, emb))
        scratch = torch.empty(plan(R, V, E, k, x.dtype)["scratch_bytes"], dtype=torch.uint8,
                              device=x.device)
        launch = lib.ssc_vocab_topk_lse_bf16 if x.dtype == torch.bfloat16 else \
            lib.ssc_vocab_topk_lse_f32
        rc = launch(x.data_ptr(), emb.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    lse.data_ptr(), scratch.data_ptr(), R, V, E, k, stream)
    _build.check(lib, rc, "vocab_topk_lse")
    launches += 1
    return vals, idx, lse
