"""The collectives a training step makes over its process groups: the
gradients' sum over the data group (JAX's implicit ``psum`` under
``jit``), the metrics, the global denominators of the losses, the global
gradient norm over sharded leaves, and the all-gather and f32 all-reduce
that ``mesh.gather_params`` and ``tensor_parallel`` build on.

Gradients are summed, never averaged: every loss term divides its local
numerator by its global denominator (the captioner's means by the global
batch, the detector's counts summed over the ranks first), so the sum of
the ranks' gradients is the gradient of the global loss. A collective that
fails raises; nothing falls back to the rank's own values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    gradients present: they follow the same code path. The trainer passes
    the replicated and the model-sharded leaves; a leaf sharded over the
    data axis (FSDP) has its sum from ``tensor_parallel.gather_from_data``'s
    backward and is left out."""
    all_reduce_sum_([p.grad for p in params if p.grad is not None], group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks that the ranks of ``group`` hold, concatenated along
    ``dim`` in the group's rank order (``x`` itself without a group)."""
    n = world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` in f32 (a bf16 partial
    sum is summed in f32 and cast after), in ``x``'s dtype."""
    y = x.detach().to(torch.float32, copy=True)
    if world_size(group) > 1:
        dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


def global_grad_norm(named: Sequence[Tuple[str, torch.Tensor]],
                     groups: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """The f32 norm of the gradients of ``named`` (path, leaf) with every
    element counted once: ``Σ replicated ‖g‖² + Σ_group all_reduce(Σ
    local-shard ‖g‖²)``, ``groups`` mapping the path of a sharded leaf to
    the group it is sharded over (absent: replicated). A leaf without
    ``.grad`` adds 0; every group of ``groups`` is summed over, in the
    order of its first leaf, so every rank makes the same calls."""
    groups = groups or {}
    dev = named[0][1].device
    local = torch.zeros((), dtype=torch.float32, device=dev)
    sharded: Dict[int, List[Any]] = {}
    for path, p in named:
        sq = None if p.grad is None else p.grad.detach().float().square().sum()
        g = groups.get(path)
        if g is None:
            local = local if sq is None else local + sq
            continue
        entry = sharded.setdefault(id(g), [g, torch.zeros((), dtype=torch.float32,
                                                         device=dev)])
        if sq is not None:
            entry[1] = entry[1] + sq
    for g, sq in sharded.values():
        local = local + all_reduce(sq, g)
    return local.sqrt()


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
