"""Captioner training steps (counterpart of
``style_seqcvae_tpu/training/trainer.py:21-148``).

The reference loop (var_updown/scripts/train.py:154-188): objective
``mean(loss) + mean(kld) / KLD_WEIGHT``, backward by ``torch.autograd``,
the SGD step with clip and schedules (:mod:`.optimizer`), per-step scalars.
Each step function takes an optional ``eps``, the (T+1, B, z) z-noise
stack (chained steps: (K, T+1, B, z)); without it the noise is drawn from
the state's ``torch.Generator``.

``compute_dtype=torch.bfloat16`` runs the forward and backward in bf16 on
casts of the f32 master parameters and of the batch's float entries, made
inside the step as JAX's ``_compute_cast`` makes them (``:37-44``), so the
gradients reach the f32 masters through the casts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, train_forward
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


def _make_train_body(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None):
    """The (state, batch, eps) → (state, metrics) step shared by every
    step function."""

    def train_step(state: TrainState, batch: Dict[str, Any],
                   eps: Optional[torch.Tensor] = None):
        iteration = state.step + 1
        state.tx.prepare(iteration)
        batch = cast_floats(_on_device(batch, state.device), compute_dtype)
        out = train_forward(cast_floats(state.params, compute_dtype), model_cfg, batch,
                            rng=state.generator,
                            eps=None if eps is None else torch.as_tensor(eps, device=state.device))
        reconstr = out["loss"].mean()
        kld = out["kld"].mean()
        loss = reconstr + kld / kld_weight
        loss.backward()
        state.tx.update()
        state.step = iteration
        return state, {"loss": loss.detach(), "reconstr_loss": reconstr.detach(),
                       "kld_loss": kld.detach()}

    return train_step


def make_train_step(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None):
    """``train_step(state, batch, eps=None) -> (state, metrics)``: one
    optimizer step; ``batch`` holds numpy arrays or tensors
    (``image_features``, ``caption_tokens``, ``sentiment``, optional
    ``obj_att_embeds``); metrics are 0-dim tensors on the device."""
    return _make_train_body(model_cfg, kld_weight, compute_dtype)


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
                            compute_dtype=None):
    """``chained(state, batches, eps=None)``: K steps over batches stacked on
    a leading (K, ...) axis, the metrics stacked (K,); the same K single
    steps in turn."""
    return _chain(_make_train_body(model_cfg, kld_weight, compute_dtype))


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
