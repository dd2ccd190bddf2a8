"""The sums a data-parallel step makes over its process group: the
gradients (JAX's implicit ``psum`` under ``jit``), the metrics and the
global denominators of the losses.

Gradients are summed, never averaged: every loss term divides its local
numerator by its global denominator (the captioner's means by the global
batch, the detector's counts summed over the ranks first), so the sum of
the ranks' gradients is the gradient of the global loss. A collective that
fails raises; nothing falls back to the rank's own values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# gradients are flattened into buckets of at most this many bytes, one
# all_reduce a bucket (DDP's default bucket size)
BUCKET_BYTES = 25 * 2 ** 20


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each tensor over ``group`` in place. Tensors of one dtype and
    device are flattened into buckets of at most ``bucket_bytes`` (a larger
    tensor is a bucket of its own), one ``all_reduce`` a bucket, in the
    order given, which every rank must share."""
    if group is None:
        return
    buckets: List[List[torch.Tensor]] = []
    size, key = 0, None
    for t in tensors:
        k = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if not buckets or k != key or size + nbytes > bucket_bytes:
            buckets.append([])
            size, key = 0, k
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=group)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Sum the present ``.grad`` of ``params`` over ``group`` (before the
    clip, which must see the global gradient). Every rank has the same
    gradients present: they follow the same code path."""
    all_reduce_sum_([p.grad for p in params if p.grad is not None], group)


def reduce_scalars(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """0-dim tensors summed over ``group`` in one ``all_reduce`` (f32)."""
    if group is None:
        return values
    names = list(values)
    flat = torch.stack([values[n].detach().float() for n in names])
    dist.all_reduce(flat, group=group)
    return {n: flat[i] for i, n in enumerate(names)}


def global_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """``x`` (a count, no gradient) summed over ``group``; ``x`` itself
    without one."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
