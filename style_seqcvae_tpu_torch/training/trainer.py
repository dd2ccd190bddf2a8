"""Captioner training steps (counterpart of
``style_seqcvae_tpu/training/trainer.py:21-178``).

The reference loop (var_updown/scripts/train.py:154-188): objective
``mean(loss) + mean(kld) / KLD_WEIGHT``, backward by ``torch.autograd``,
the SGD step with clip and schedules (:mod:`.optimizer`), per-step scalars.
Each step function takes an optional ``eps``, the (T+1, B, z) z-noise
stack (chained steps: (K, T+1, B, z)); without it the noise is drawn from
the state's ``torch.Generator``.

Data parallel: with a ``DataMesh`` of several ranks (``parallel/mesh.py``)
each rank's objective is its local mean over the world size, the gradients
are summed over the ranks between the backward and the clip (which so sees
the global gradient), and the metrics are summed, so every rank holds the
global step. A step that draws its own z-noise draws the global (T+1,
B·world, z) stack, as one process on the concatenated batch would, and
keeps the rows its samples hold there: ``TrainingDataset.batches``'s
``process_shard`` gives rank r rows r, r+world, ... of that batch.

``compute_dtype=torch.bfloat16`` runs the forward and backward in bf16 on
casts of the f32 master parameters and of the batch's float entries, made
inside the step as JAX's ``_compute_cast`` makes them (``:37-44``), so the
gradients reach the f32 masters through the casts.

:func:`make_baseline_train_step` trains the non-variational UpDown
baseline with the same optimizer; its parameters hold no decoder LSTM, so
the freeze schedule never touches them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.baseline import baseline_train_forward
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, train_forward
from style_seqcvae_tpu_torch.parallel.collectives import reduce_gradients, reduce_scalars
from style_seqcvae_tpu_torch.parallel.mesh import DataMesh
from style_seqcvae_tpu_torch.training.optimizer import (
    SGDFreezeSchedule,
    make_captioner_optimizer,
)
from style_seqcvae_tpu_torch.weights import cast_floats, tree_map


@dataclass
class TrainState:
    """The f32 master params (leaf tensors, updated in place), their
    optimizer with its scheduler, the z-noise generator and the number of
    completed steps."""
    params: Dict[str, Any]
    tx: SGDFreezeSchedule
    generator: torch.Generator
    step: int = 0

    @property
    def optimizer(self) -> torch.optim.SGD:
        return self.tx.optimizer

    @property
    def scheduler(self) -> torch.optim.lr_scheduler.LambdaLR:
        return self.tx.scheduler

    @property
    def device(self) -> torch.device:
        return self.params["embedding"].device


def create_train_state(params: Dict[str, Any], config, model_cfg: CaptionerConfig,
                       seed: int, device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """A fresh state on ``device`` (the GPU unless the caller passes
    ``"cpu"``): copies of ``params`` as trainable leaves, the optimizer of
    ``config``'s OPTIM section, and a generator seeded with ``seed``."""
    dev = resolve_device(device)
    own = tree_map(lambda t: t.detach().to(dev).clone(), params)
    tx = make_captioner_optimizer(config, own, model_cfg.tie_embeddings)
    return TrainState(own, tx, torch.Generator(device=dev).manual_seed(seed))


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _sgd_step(state: TrainState, batch: Dict[str, Any], compute_dtype, objective,
              mesh: Optional[DataMesh] = None):
    """One optimizer step on ``objective(params, batch) -> (loss, metrics)``,
    evaluated on the compute-dtype casts of the params and the batch: the
    freeze schedule's preparation, the backward, the gradients' sum over
    ``mesh``'s ranks, the clip, SGD and LR."""
    iteration = state.step + 1
    state.tx.prepare(iteration)
    batch = cast_floats(_on_device(batch, state.device), compute_dtype)
    loss, metrics = objective(cast_floats(state.params, compute_dtype), batch)
    group = None if mesh is None else mesh.group
    if group is not None:
        # the local mean over the world: the ranks' sum is the global mean
        loss = loss / mesh.world_size
        metrics = {k: v / mesh.world_size for k, v in metrics.items()}
    loss.backward()
    if group is not None:
        reduce_gradients([p for _, p in state.tx.named], group)
        metrics = reduce_scalars(metrics, group)
    state.tx.update()
    state.step = iteration
    return state, metrics


def _global_eps(state: TrainState, mesh: DataMesh, steps: int, local_batch: int,
                z_space: int) -> torch.Tensor:
    """This rank's rows (``rank::world``, the ``process_shard`` stride) of
    the (steps, B·world, z) z-noise that one process on the concatenated
    batch draws, step by step, from the generator."""
    gen, n = state.generator, local_batch * mesh.world_size
    eps = torch.stack([torch.randn((n, z_space), generator=gen, device=state.device)
                       for _ in range(steps)])
    return eps[:, mesh.rank::mesh.world_size]


def _make_train_body(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None,
                     mesh: Optional[DataMesh] = None):
    """The (state, batch, eps) → (state, metrics) step shared by every
    step function."""
    distributed = mesh is not None and mesh.world_size > 1

    def train_step(state: TrainState, batch: Dict[str, Any],
                   eps: Optional[torch.Tensor] = None):
        if eps is None and distributed:
            tokens = batch["caption_tokens"]
            eps = _global_eps(state, mesh, tokens.shape[1] + 1, tokens.shape[0],
                              model_cfg.z_space)

        def objective(params, batch):
            out = train_forward(params, model_cfg, batch, rng=state.generator,
                                eps=None if eps is None
                                else torch.as_tensor(eps, device=state.device))
            reconstr = out["loss"].mean()
            kld = out["kld"].mean()
            loss = reconstr + kld / kld_weight
            return loss, {"loss": loss.detach(), "reconstr_loss": reconstr.detach(),
                          "kld_loss": kld.detach()}

        return _sgd_step(state, batch, compute_dtype, objective, mesh)

    return train_step


def make_train_step(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None,
                    mesh: Optional[DataMesh] = None):
    """``train_step(state, batch, eps=None) -> (state, metrics)``: one
    optimizer step; ``batch`` holds numpy arrays or tensors
    (``image_features``, ``caption_tokens``, ``sentiment``, optional
    ``obj_att_embeds``), this rank's local rows under ``mesh``; metrics are
    0-dim tensors on the device, global under ``mesh``."""
    return _make_train_body(model_cfg, kld_weight, compute_dtype, mesh)


def make_baseline_train_step(model_cfg: CaptionerConfig, compute_dtype=None,
                             mesh: Optional[DataMesh] = None):
    """``train_step(state, batch) -> (state, metrics)`` for the baseline family
    (JAX ``trainer.py:151-178``): the objective is the mean of
    ``baseline_train_forward``'s length-scaled cross entropy, with the same
    SGD, clip and LR decay as :func:`make_train_step`; metrics ``loss``,
    ``reconstr_loss`` (the same value) and ``kld_loss`` (0), 0-dim tensors on
    the device (global under ``mesh``)."""

    def objective(params, batch):
        loss = baseline_train_forward(params, model_cfg, batch)["loss"].mean()
        metric = loss.detach()
        return loss, {"loss": metric, "reconstr_loss": metric,
                      "kld_loss": torch.zeros_like(metric)}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        return _sgd_step(state, batch, compute_dtype, objective, mesh)

    return train_step


def _chain(step):
    def chained(state: TrainState, batches: Dict[str, Any], *tables,
                eps: Optional[torch.Tensor] = None):
        K = len(next(iter(batches.values())))
        per_step = []
        for k in range(K):
            state, m = step(state, *tables, {n: v[k] for n, v in batches.items()},
                            eps=None if eps is None else eps[k])
            per_step.append(m)
        return state, {n: torch.stack([m[n] for m in per_step]) for n in per_step[0]}

    return chained


def make_chained_train_step(model_cfg: CaptionerConfig, kld_weight: float,
                            compute_dtype=None, mesh: Optional[DataMesh] = None):
    """``chained(state, batches, eps=None)``: K steps over batches stacked on
    a leading (K, ...) axis, the metrics stacked (K,); the same K single
    steps in turn."""
    return _chain(_make_train_body(model_cfg, kld_weight, compute_dtype, mesh))


def _gather_corpus_rows(batch: Dict[str, Any], feats_table) -> Dict[str, Any]:
    """The batch with its ``feat_idx`` column replaced by the rows it indexes:
    ``feats_table`` is the (num_images, boxes, F) features table, or a dict
    of per-image tables (``image_features`` and, in mode 2,
    ``obj_att_embeds``), each gathered by the same index."""
    b = dict(batch)
    idx = b.pop("feat_idx")
    tables = feats_table if isinstance(feats_table, dict) else {"image_features": feats_table}
    for k, tbl in tables.items():
        b[k] = tbl[torch.as_tensor(idx, device=tbl.device).long()]
    return b


def make_corpus_train_step(model_cfg: CaptionerConfig, kld_weight: float,
                           compute_dtype=None):
    """``step(state, feats_table, batch, eps=None)``: the batch carries a
    (B,) ``feat_idx`` in place of ``image_features``; the table stays on the
    device and its rows are gathered inside the step. The same math as
    :func:`make_train_step` on the gathered rows."""
    body = _make_train_body(model_cfg, kld_weight, compute_dtype)

    def step(state: TrainState, feats_table, batch: Dict[str, Any],
             eps: Optional[torch.Tensor] = None):
        return body(state, _gather_corpus_rows(batch, feats_table), eps=eps)

    return step


def make_corpus_chained_train_step(model_cfg: CaptionerConfig, kld_weight: float,
                                   compute_dtype=None):
    """``chained(state, feats_table, batches, eps=None)`` with
    ``batches["feat_idx"]`` stacked (K, B); the rows are gathered per step."""
    body = make_corpus_train_step(model_cfg, kld_weight, compute_dtype)

    def chained(state: TrainState, feats_table, batches: Dict[str, Any],
                eps: Optional[torch.Tensor] = None):
        return _chain(body)(state, batches, feats_table, eps=eps)

    return chained
