"""Non-variational UpDown baseline captioner (counterpart of
``style_seqcvae_tpu/models/baseline.py``).

An attention LSTM, BUTD attention and ONE language LSTM: no CVAE split and
no z. The state is ``(h1, c1, h2, c2)``; the attention LSTM reads
``[token_emb, avg_feats, h1, h2]`` and the language LSTM ``[attended, h1,
h2]``. The output head is the Style-SeqCVAE model's (tied to a frozen
embedding for E in {300, 600}), and the searches run its log-prob step.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.attention import (
    AttentionParams,
    attention_weights,
    init_attention,
    project_image_features,
)
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    add_boundary_tokens,
    output_logits,
)
from style_seqcvae_tpu_torch.models.updown_cell import _attend, _concat, image_feature_stats
from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams, init_lstm_cell, lstm_cell
from style_seqcvae_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_embedding,
    vocab_parallel_nll,
)


class BaselineCellParams(NamedTuple):
    attention_lstm: LSTMCellParams
    attention: AttentionParams
    language_lstm: LSTMCellParams


class BaselineState(NamedTuple):
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor


def init_baseline(cfg: CaptionerConfig, *, seed: int = 0,
                  embedding_table: Optional[np.ndarray] = None,
                  device: Optional[Union[str, torch.device]] = None,
                  dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``, from JAX ``init_baseline``'s distributions (PyTorch's
    LSTM and linear inits), not its numbers (use ``from_jax_params`` for
    those). ``embedding_table`` (V, E) is taken as it is; without one the
    table is drawn N(0, 1) with the pad row zeroed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    F, E, H, P = (cfg.image_feature_size, cfg.embedding_size, cfg.hidden_size,
                  cfg.attention_projection_size)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    params: Dict[str, Any] = {"cell": BaselineCellParams(
        attention_lstm=init_lstm_cell(E + F + 2 * H, H, **kw),
        attention=init_attention(H, F, P, **kw),
        language_lstm=init_lstm_cell(F + 2 * H, H, **kw))}
    if embedding_table is not None:
        emb = torch.as_tensor(np.asarray(embedding_table, np.float32), device=dev)
    else:
        emb = torch.randn((cfg.vocab_size, E), generator=gen, device=dev)
        emb[cfg.pad_index] = 0.0
    params["embedding"] = emb.to(dtype)

    def linear(fan_in, fan_out):
        bound = 1.0 / fan_in ** 0.5
        w = (torch.rand((fan_in, fan_out), generator=gen, device=dev) * 2 - 1) * bound
        b = (torch.rand((fan_out,), generator=gen, device=dev) * 2 - 1) * bound
        return {"w": w.to(dtype), "b": b.to(dtype)}

    if cfg.tie_embeddings:
        params["output_projection"] = linear(H, E)
    else:
        params["output_layer"] = linear(H, cfg.vocab_size)
    return params


def baseline_cell_step(params: BaselineCellParams, token_embedding: torch.Tensor,
                       state: BaselineState, *, image_features: torch.Tensor,
                       projected_image_features: torch.Tensor,
                       averaged_image_features: torch.Tensor,
                       image_features_mask: torch.Tensor, model_group=None
                       ) -> Tuple[torch.Tensor, BaselineState]:
    """One step on ``token_embedding`` (B, ..., E) and a state of (B, ..., H)
    fields, any inner grid dims; returns ``(h2, new_state)``. Each LSTM's
    input is concatenated in its parts' promoted dtype, as
    ``jnp.concatenate`` does. ``model_group``: the group over which the
    LSTMs' gate matrices are column blocks, under tensor parallelism."""
    grid = tuple(token_embedding.shape[:-1])
    avg = averaged_image_features.reshape(
        (averaged_image_features.shape[0],) + (1,) * (len(grid) - 1)
        + tuple(averaged_image_features.shape[1:]))
    h1, c1 = lstm_cell(params.attention_lstm,
                       _concat([token_embedding, avg, state.h1, state.h2], grid), state.h1,
                       state.c1, model_group)
    attn_w = attention_weights(params.attention, h1, projected_image_features,
                               image_features_mask)
    attended = _attend(attn_w, image_features)
    h2, c2 = lstm_cell(params.language_lstm, _concat([attended, h1, state.h2], grid), state.h2,
                       state.c2, model_group)
    return h2, BaselineState(h1, c1, h2, c2)


def init_baseline_state(batch_shape: Tuple[int, ...], hidden_size: int, *,
                        device: torch.device, dtype=torch.float32) -> BaselineState:
    z = torch.zeros(tuple(batch_shape) + (hidden_size,), dtype=dtype, device=device)
    return BaselineState(z, z, z, z)


def baseline_train_forward(params: Dict[str, Any], cfg: CaptionerConfig,
                           batch: Dict[str, torch.Tensor], model_group=None
                           ) -> Dict[str, torch.Tensor]:
    """Teacher-forced forward (JAX ``baseline.py:106-136``): a Python loop
    over the ``T + 1`` steps of the boundary-wrapped caption. ``batch``:
    ``image_features`` (B, N, F) and ``caption_tokens`` (B, T) padded with
    ``cfg.pad_index`` (other entries are ignored). Returns the per-sequence
    ``loss``, the length-scaled masked cross entropy. Tensor parallel: as
    ``captioner.train_forward``, on this rank's blocks of ``params`` over
    ``model_group``."""
    image_features = batch["image_features"]
    tokens = add_boundary_tokens(batch["caption_tokens"].long(), cfg.pad_index,
                                 cfg.boundary_index)
    tokens_mask = tokens != cfg.pad_index
    B = image_features.shape[0]

    avg, mask = image_feature_stats(image_features)
    proj = project_image_features(params["cell"].attention, image_features)
    state = init_baseline_state((B,), cfg.hidden_size, device=image_features.device,
                                dtype=image_features.dtype)
    token_embs = vocab_parallel_embedding(params["embedding"], tokens[:, :-1].T,
                                          cfg.vocab_size, model_group)   # (T+1, B, E)
    logits = []
    for t in range(token_embs.shape[0]):
        h2, state = baseline_cell_step(
            params["cell"], token_embs[t], state, image_features=image_features,
            projected_image_features=proj, averaged_image_features=avg,
            image_features_mask=mask, model_group=model_group)
        logits.append(output_logits(params, cfg, h2, model_group))
    targets = tokens[:, 1:]
    target_mask = tokens_mask[:, 1:].float()
    nll = vocab_parallel_nll(torch.stack(logits, dim=1), targets, cfg.vocab_size,
                             model_group)                               # (B, T+1)
    lengths = target_mask.sum(dim=1)
    per_seq = (nll * target_mask).sum(dim=1) / (lengths + 1e-13)
    return {"loss": lengths * per_seq}


def make_baseline_step_fn(params: Dict[str, Any], cfg: CaptionerConfig,
                          image_features: torch.Tensor):
    """The decode step ``step(tokens, state, noise) -> (log_probs,
    new_state)`` on tokens of shape (B, ...) with any inner grid dims; the
    noise slot the searches thread through is accepted and unused (JAX's
    step ignores its ``rng``)."""
    avg, mask = image_feature_stats(image_features)
    proj = project_image_features(params["cell"].attention, image_features)

    def step(tokens: torch.Tensor, state: BaselineState, noise=None):
        h2, new_state = baseline_cell_step(
            params["cell"], params["embedding"][tokens], state, image_features=image_features,
            projected_image_features=proj, averaged_image_features=avg,
            image_features_mask=mask)
        return torch.log_softmax(output_logits(params, cfg, h2), dim=-1), new_state

    return step
