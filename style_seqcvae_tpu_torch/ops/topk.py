"""Small-k top-k with lowest-index ties (counterpart of
``style_seqcvae_tpu/ops/topk.py``).

``torch.topk`` promises no order among tied values, and the searches must
pick the same beams as the JAX reference, so ties are broken explicitly:
:func:`small_top_k` is the reference's iterative argmax (``torch.argmax``
returns the first maximal index), and :func:`top_k` follows ``lax.top_k``
(distinct indices, lower index first among equals) through a stable sort.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` order along the last axis: values descending, equal
    values by ascending index, indices always distinct."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def small_top_k(x: torch.Tensor, k: int, iterative_threshold: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by k argmax passes for k <=
    ``iterative_threshold`` (each pass masks the chosen column to -inf, as
    the reference does), otherwise :func:`top_k`."""
    if k > iterative_threshold:
        return top_k(x, k)
    col = torch.arange(x.shape[-1], device=x.device)
    # filled on the device: a scalar copied from the host waits for the card
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        idx = torch.argmax(cur, dim=-1)
        vals.append(torch.gather(cur, -1, idx[..., None])[..., 0])
        idxs.append(idx)
        cur = torch.where(col == idx[..., None], neg_inf, cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)
