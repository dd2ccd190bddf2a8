"""Captioner training steps (counterpart of
``style_seqcvae_tpu/training/trainer.py:21-178``).

The reference loop (var_updown/scripts/train.py:154-188): objective
``mean(loss) + mean(kld) / KLD_WEIGHT``, backward by ``torch.autograd``,
the SGD step with clip and schedules (:mod:`.optimizer`), per-step scalars.
Each step function takes an optional ``eps``, the (T+1, B, z) z-noise
stack (chained steps: (K, T+1, B, z)); without it the noise is drawn from
the state's ``torch.Generator``.

Parallel: with a ``Mesh`` of ``num_data × num_model`` ranks
(``parallel/mesh.py``) each rank's objective is its local mean over
``num_data``, the gradients are summed over the rank's data group between
the backward and the clip (which so sees the global gradient), and the
metrics are summed over it, so every rank holds the global step. The
ranks of one data index (a model group) hold the same rows, rows d,
d+num_data, ... of the global batch (``TrainingDataset.batches``'s
``process_shard``); a step that draws its own z-noise draws the global
(T+1, B·num_data, z) stack, as one process on the concatenated batch
would, and keeps those rows, so a model group uses identical noise.

A state made with a mesh (``create_train_state(mesh=...)``) keeps each
leaf's local block as its trainable master: the blocks of JAX's
``_PARAM_SPEC_TABLE`` over ``model`` (the forward runs on them through
``parallel/tensor_parallel.py``) and, with ``shard_params_over_data``,
the FSDP leaves' blocks over ``data``, all-gathered before the forward;
their gradient sum is the gather's backward, so the data group's sum
leaves them out. The clip's norm counts every element once
(``collectives.global_grad_norm``).

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
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.baseline import baseline_train_forward
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, train_forward
from style_seqcvae_tpu_torch.parallel.collectives import reduce_gradients, reduce_scalars
from style_seqcvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    Spec,
    param_sharding,
    shard_params,
)
from style_seqcvae_tpu_torch.parallel.tensor_parallel import gather_from_data
from style_seqcvae_tpu_torch.training.optimizer import (
    SGDFreezeSchedule,
    make_captioner_optimizer,
)
from style_seqcvae_tpu_torch.weights import cast_floats, tree_map, tree_map_with_path


@dataclass
class TrainState:
    """The f32 master params (leaf tensors, updated in place; under a mesh
    this rank's blocks), their optimizer with its scheduler, the z-noise
    generator, the number of completed steps, the last step's gradient
    norm before the clip, and the mesh with every leaf's spec
    (``parallel/mesh.py::param_sharding``) when the params are blocks."""
    params: Dict[str, Any]
    tx: SGDFreezeSchedule
    generator: torch.Generator
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None
    mesh: Optional[Mesh] = None
    specs: Optional[Dict[str, Spec]] = None

    @property
    def optimizer(self) -> torch.optim.SGD:
        return self.tx.optimizer

    @property
    def scheduler(self) -> torch.optim.lr_scheduler.LambdaLR:
        return self.tx.scheduler

    @property
    def device(self) -> torch.device:
        return self.params["embedding"].device


def _norm_groups(mesh: Optional[Mesh], specs: Optional[Dict[str, Spec]]) -> Dict[str, Any]:
    """Path → the group a sharded leaf's squared norm is summed over."""
    if specs is None:
        return {}
    out = {}
    for path, spec in specs.items():
        axes = [ax for ax in spec if ax is not None and mesh.size(ax) > 1]
        if axes:
            (axis,) = axes
            out[path] = mesh.group(axis)
    return out


def create_train_state(params: Dict[str, Any], config, model_cfg: CaptionerConfig,
                       seed: int, device: Optional[Union[str, torch.device]] = None,
                       mesh: Optional[Mesh] = None, shard_params_over_data: bool = False
                       ) -> TrainState:
    """A fresh state on ``device`` (the GPU unless the caller passes
    ``"cpu"``): copies of ``params`` as trainable leaves, the optimizer of
    ``config``'s OPTIM section, and a generator seeded with ``seed``. With
    ``mesh`` (a process group's) the copies are this rank's blocks of the
    leaves' specs (``shard_params_over_data``: FSDP's too); ``params`` are
    whole and the same on every rank."""
    dev = resolve_device(device)
    specs = None
    if mesh is not None:
        if mesh.world_size == 1 and len(mesh.devices) > 1:
            raise ValueError("a training mesh is a process group's: one device a rank")
        specs = param_sharding(mesh, params, shard_params_over_data)
        params = shard_params(mesh, params, specs)
    own = tree_map(lambda t: t.detach().to(dev).clone(), params)
    tx = make_captioner_optimizer(config, own, model_cfg.tie_embeddings,
                                  _norm_groups(mesh, specs))
    return TrainState(own, tx, torch.Generator(device=dev).manual_seed(seed), mesh=mesh,
                      specs=specs)


def _data_sharded(mesh: Optional[Mesh], spec: Optional[Spec]) -> Optional[Tuple[int, Any]]:
    """(dim, data group) of a leaf sharded over a data axis of several
    ranks, else None."""
    if mesh is None or spec is None or DATA_AXIS not in spec or mesh.num_data == 1:
        return None
    return spec.index(DATA_AXIS), mesh.data_group


def _gather_fsdp(params: Dict[str, Any], state: TrainState) -> Dict[str, Any]:
    """The params with every FSDP block all-gathered whole over the data
    group (its backward sums the leaf's gradient over the group)."""
    if state.specs is None:
        return params

    def gather(path, t):
        sharded = _data_sharded(state.mesh, state.specs[path])
        return t if sharded is None else gather_from_data(t, sharded[1], sharded[0])

    return tree_map_with_path(gather, params)


def _model_group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.model_group


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _sgd_step(state: TrainState, batch: Dict[str, Any], compute_dtype, objective,
              mesh: Optional[Mesh] = None):
    """One optimizer step on ``objective(params, batch) -> (loss, metrics)``,
    evaluated on the compute-dtype casts of the params (the local blocks;
    FSDP's gathered whole) and the batch: the freeze schedule's
    preparation, the backward, the gradients' sum over ``mesh``'s data
    group, the clip, SGD and LR."""
    if state.specs is not None and mesh != state.mesh:
        raise ValueError("the state's params are blocks of another mesh than the step's")
    iteration = state.step + 1
    state.tx.prepare(iteration)
    batch = cast_floats(_on_device(batch, state.device), compute_dtype)
    loss, metrics = objective(_gather_fsdp(cast_floats(state.params, compute_dtype), state),
                              batch)
    group = None if mesh is None else mesh.data_group
    if group is not None:
        # the local mean over the data axis: the data group's sum is the global mean
        loss = loss / mesh.num_data
        metrics = {k: v / mesh.num_data for k, v in metrics.items()}
    loss.backward()
    if group is not None:
        specs = state.specs or {}
        reduce_gradients([p for path, p in state.tx.named
                          if _data_sharded(mesh, specs.get(path)) is None], group)
        metrics = reduce_scalars(metrics, group)
    state.grad_norm = state.tx.update()
    state.step = iteration
    return state, metrics


def _global_eps(state: TrainState, mesh: Mesh, steps: int, local_batch: int,
                z_space: int) -> torch.Tensor:
    """This data index's rows (``d::num_data``, the ``process_shard``
    stride) of the (steps, B·num_data, z) z-noise that one process on the
    concatenated batch draws, step by step, from the generator."""
    gen, n = state.generator, local_batch * mesh.num_data
    eps = torch.stack([torch.randn((n, z_space), generator=gen, device=state.device)
                       for _ in range(steps)])
    return eps[:, mesh.data_index::mesh.num_data]


def _make_train_body(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None,
                     mesh: Optional[Mesh] = None):
    """The (state, batch, eps) → (state, metrics) step shared by every
    step function."""
    distributed = mesh is not None and mesh.num_data > 1

    def train_step(state: TrainState, batch: Dict[str, Any],
                   eps: Optional[torch.Tensor] = None):
        if eps is None and distributed:
            tokens = batch["caption_tokens"]
            eps = _global_eps(state, mesh, tokens.shape[1] + 1, tokens.shape[0],
                              model_cfg.z_space)

        def objective(params, batch):
            out = train_forward(params, model_cfg, batch, rng=state.generator,
                                eps=None if eps is None
                                else torch.as_tensor(eps, device=state.device),
                                model_group=_model_group(mesh))
            reconstr = out["loss"].mean()
            kld = out["kld"].mean()
            loss = reconstr + kld / kld_weight
            return loss, {"loss": loss.detach(), "reconstr_loss": reconstr.detach(),
                          "kld_loss": kld.detach()}

        return _sgd_step(state, batch, compute_dtype, objective, mesh)

    return train_step


def make_train_step(model_cfg: CaptionerConfig, kld_weight: float, compute_dtype=None,
                    mesh: Optional[Mesh] = None):
    """``train_step(state, batch, eps=None) -> (state, metrics)``: one
    optimizer step; ``batch`` holds numpy arrays or tensors
    (``image_features``, ``caption_tokens``, ``sentiment``, optional
    ``obj_att_embeds``), this rank's local rows under ``mesh``; metrics are
    0-dim tensors on the device, global under ``mesh``."""
    return _make_train_body(model_cfg, kld_weight, compute_dtype, mesh)


def make_baseline_train_step(model_cfg: CaptionerConfig, compute_dtype=None,
                             mesh: Optional[Mesh] = None):
    """``train_step(state, batch) -> (state, metrics)`` for the baseline family
    (JAX ``trainer.py:151-178``): the objective is the mean of
    ``baseline_train_forward``'s length-scaled cross entropy, with the same
    SGD, clip and LR decay as :func:`make_train_step`; metrics ``loss``,
    ``reconstr_loss`` (the same value) and ``kld_loss`` (0), 0-dim tensors on
    the device (global under ``mesh``)."""

    def objective(params, batch):
        loss = baseline_train_forward(params, model_cfg, batch,
                                      _model_group(mesh))["loss"].mean()
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
                            compute_dtype=None, mesh: Optional[Mesh] = None):
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
                           compute_dtype=None, mesh: Optional[Mesh] = None):
    """``step(state, feats_table, batch, eps=None)``: the batch carries a
    (B,) ``feat_idx`` in place of ``image_features``; the table stays on the
    device and its rows are gathered inside the step. The same math as
    :func:`make_train_step` on the gathered rows (under ``mesh``, this
    rank's rows of a whole table)."""
    body = _make_train_body(model_cfg, kld_weight, compute_dtype, mesh)

    def step(state: TrainState, feats_table, batch: Dict[str, Any],
             eps: Optional[torch.Tensor] = None):
        return body(state, _gather_corpus_rows(batch, feats_table), eps=eps)

    return step


def make_corpus_chained_train_step(model_cfg: CaptionerConfig, kld_weight: float,
                                   compute_dtype=None, mesh: Optional[Mesh] = None):
    """``chained(state, feats_table, batches, eps=None)`` with
    ``batches["feat_idx"]`` stacked (K, B); the rows are gathered per step."""
    body = make_corpus_train_step(model_cfg, kld_weight, compute_dtype, mesh)

    def chained(state: TrainState, feats_table, batches: Dict[str, Any],
                eps: Optional[torch.Tensor] = None):
        return _chain(body)(state, batches, feats_table, eps=eps)

    return chained
