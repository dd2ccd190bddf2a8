"""Masked reductions with AllenNLP semantics (counterpart of
``style_seqcvae_tpu/ops/masked.py``)."""

from __future__ import annotations

import torch


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over unmasked entries; a fully masked row stays finite (zeros)."""
    keep = mask > 0
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)
    mx = torch.where(keep, logits, neg_inf).amax(dim=dim, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    probs = torch.exp(torch.where(keep, logits - mx, neg_inf))
    denom = probs.sum(dim=dim, keepdim=True) + 1e-13
    return probs / denom


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` counting only unmasked elements (``mask`` broadcasts
    against ``x``); the count is floored at 1e-13."""
    mask = mask.to(x.dtype)
    total = (x * mask).sum(dim=dim)
    count = mask.sum(dim=dim)
    return total / torch.clamp(count, min=1e-13)
