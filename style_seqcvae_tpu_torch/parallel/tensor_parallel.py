"""The collectives of tensor parallelism and FSDP, written out as autograd
functions over explicit process groups.

The JAX package shards the vocabulary-facing matrices and the LSTM gate
matrices over the ``model`` axis of its mesh, optionally the FSDP leaves
over ``data`` (``style_seqcvae_tpu/parallel/mesh.py``), and XLA inserts
the collectives. The port's parameters are dict trees of local blocks
(``mesh.shard_params``), and the forward calls these functions where XLA
would communicate:

* :func:`copy_to_model` before every product with a model-sharded matrix:
  identity forward, all-reduce backward, so the input's gradient is summed
  over the model ranks;
* :func:`gather_from_model` after it: the column blocks all-gathered in
  rank order (JAX's contiguous blocks); backward keeps the local block,
  which is right because everything downstream is replicated over the
  model group;
* :func:`reduce_from_model`: all-reduce forward, identity backward (the
  vocab-sharded embedding lookup, the vocab-parallel loss);
* :func:`vocab_parallel_embedding` and :func:`vocab_parallel_nll`: the
  lookup in a vocab-sharded table and the log-softmax + NLL over
  vocab-sharded logits (all-reduces of the row max, the sum of
  exponentials and the target's logit, in f32), never gathering the
  (B, T+1, V) logits;
* :func:`gather_from_data` (FSDP): all-gather over the data group forward;
  backward all-reduces over the data group and keeps the local block,
  which is the leaf's whole gradient sum, so the trainer leaves these
  leaves out of its gradient sum.

Whether a leaf is sharded is read from the leaf itself (its local extent
against the full one), never from the mesh's size alone: a dimension that
does not divide the axis leaves the leaf replicated, as JAX's table does,
and the replicated path runs for it. A sharded leaf without a group
raises. Every reduction is made in f32 and cast to the operand's dtype
after (``collectives.all_reduce``).

Inside :func:`traced` every collective this module starts is counted by
kind and timed (CUDA events on the card, the host clock on the CPU):
what ``chip_smoke.py`` reports as the step's collectives and their time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.parallel.collectives import all_gather, all_reduce, world_size

_trace: Optional["Trace"] = None       # the open :func:`traced` block


class Trace:
    """The collectives started inside one :func:`traced` block: their
    count by kind and one span each."""

    def __init__(self):
        self.spans: List = []
        self.counts: Dict[str, int] = {}

    def ms(self) -> float:
        """Their summed time in milliseconds (waits for the card)."""
        total = 0.0
        for span in self.spans:
            if isinstance(span, float):
                total += 1e3 * span
            else:
                span[1].synchronize()
                total += span[0].elapsed_time(span[1])
        return total


@contextmanager
def traced() -> Iterator[Trace]:
    """Count and time every collective of this module started inside."""
    global _trace
    _trace = Trace()
    try:
        yield _trace
    finally:
        _trace = None


def _run(kind: str, like: torch.Tensor, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    trace = _trace
    if trace is None:
        return fn()
    trace.counts[kind] = trace.counts.get(kind, 0) + 1
    if like.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = fn()
        end.record()
        trace.spans.append((start, end))
        return out
    t0 = time.perf_counter()
    out = fn()
    trace.spans.append(time.perf_counter() - t0)
    return out


def is_sharded(local: int, full: int, group) -> bool:
    """Whether a leaf whose sharded extent is ``local`` of ``full`` is a
    block (raises when it is and no group is given)."""
    if local == full:
        return False
    if group is None or full != local * world_size(group):
        raise ValueError(f"a block of {local} of {full} needs the group it was cut over "
                         f"(got {world_size(group)} ranks)")
    return True


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _run("model_all_reduce", g, lambda: all_reduce(g, ctx.group)), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.block, ctx.index = x.shape[-1], dist.get_rank(group)
        return _run("model_all_gather", x, lambda: all_gather(x, group, -1))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.block, ctx.block).contiguous(), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _run("model_all_reduce", x, lambda: all_reduce(x, group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.block, ctx.index = x.shape[dim], dist.get_rank(group)
        return _run("data_all_gather", x, lambda: all_gather(x, group, dim))

    @staticmethod
    def backward(ctx, g):
        total = _run("data_all_reduce", g, lambda: all_reduce(g, ctx.group))
        return total.narrow(ctx.dim, ctx.index * ctx.block, ctx.block).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if world_size(group) == 1 else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if world_size(group) == 1 else _GatherFromModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if world_size(group) == 1 else _ReduceFromModel.apply(x, group)


def gather_from_data(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if world_size(group) == 1 else _GatherFromData.apply(x, group, dim)


def sharded_matmul(x: torch.Tensor, w: torch.Tensor, full: int, group) -> torch.Tensor:
    """``x · w`` for a ``w`` of ``full`` columns, held whole or as this
    rank's column block: the block's product is all-gathered to the full
    columns, and ``x``'s gradient summed over the model ranks."""
    if not is_sharded(w.shape[-1], full, group):
        return torch.matmul(x, w)
    return gather_from_model(torch.matmul(copy_to_model(x, group), w), group)


def vocab_parallel_embedding(table: torch.Tensor, tokens: torch.Tensor, vocab_size: int,
                             group) -> torch.Tensor:
    """``table[tokens]`` for a (V, E) table held whole or as this rank's
    block of rows: each rank looks up the tokens it holds, zeros the rest,
    and the ranks' lookups are summed."""
    rows = table.shape[0]
    if not is_sharded(rows, vocab_size, group):
        return table[tokens]
    local = tokens - dist.get_rank(group) * rows
    inside = (local >= 0) & (local < rows)
    found = table[local.clamp(0, rows - 1)]
    return reduce_from_model(torch.where(inside[..., None], found, torch.zeros_like(found)),
                             group)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int,
                       group) -> torch.Tensor:
    """``-log_softmax(logits)[targets]`` over the last axis, for logits held
    whole or as this rank's block of the vocabulary. Sharded: the row max
    (a constant for the gradient), the sum of exponentials and the target's
    shifted logit (taken on the rank that holds it) are all-reduced in f32,
    and the result is cast to the logits' dtype."""
    block = logits.shape[-1]
    if not is_sharded(block, vocab_size, group):
        log_probs = torch.log_softmax(logits, dim=-1)
        return -torch.gather(log_probs, -1, targets[..., None])[..., 0]
    x = logits.float()
    with torch.no_grad():
        row_max = _run("model_all_reduce", x,
                       lambda: all_reduce(x.amax(dim=-1), group, dist.ReduceOp.MAX))
    shifted = x - row_max[..., None]
    sum_exp = reduce_from_model(shifted.exp().sum(dim=-1), group)
    local = targets - dist.get_rank(group) * block
    inside = (local >= 0) & (local < block)
    picked = torch.gather(shifted, -1, local.clamp(0, block - 1)[..., None])[..., 0]
    target = reduce_from_model(torch.where(inside, picked, torch.zeros_like(picked)), group)
    return (torch.log(sum_exp) - target).to(logits.dtype)
