"""Top-k with logsumexp over materialised logits.

Counterpart of ``style_seqcvae_tpu/ops/pallas/topk_lse.py::top_k_with_lse``.
On a CUDA tensor :func:`top_k_with_lse` launches the hand-written kernel in
``csrc/topk_lse.cu``; on a CPU tensor it runs :func:`top_k_with_lse_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from style_seqcvae_tpu_torch.ops.topk import top_k

# launches of the CUDA kernel in this process (the plain version not counted)
launches = 0


def top_k_with_lse_plain(logits: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (R, V) → (vals (R, k) f32, idx (R, k) i32, lse (R,) f32).
    Ties go to the lower index (stable sort); an all -inf row keeps distinct
    indices and has lse -inf."""
    lf = logits.float()
    vals, idx = top_k(lf, k)
    return vals, idx.to(torch.int32), torch.logsumexp(lf, dim=-1)


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits must be (R, V), got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if not 0 < k < 128 or k > logits.shape[1]:
        raise ValueError(f"need 0 < k < 128 and k <= V, got k={k}, V={logits.shape[1]}")


def top_k_with_lse(logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`top_k_with_lse_plain`."""
    global launches
    _check(logits, k)
    if logits.device.type == "cpu":
        return top_k_with_lse_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    R, V = logits.shape
    from style_seqcvae_tpu_torch.ops.kernels import _build

    lib = _build.library()
    vals = torch.empty((R, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=logits.device)
    lse = torch.empty((R,), dtype=torch.float32, device=logits.device)
    if R == 0:
        return vals, idx, lse
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssc_topk_lse(logits.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                              lse.data_ptr(), R, V, k,
                              int(logits.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, "topk_lse")
    launches += 1
    return vals, idx, lse
