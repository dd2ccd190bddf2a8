"""Variational UpDown cell: parameters, state, the per-decode helpers and the
unfolded step :func:`cell_step`, its posterior (training) and prior
(inference) branches (counterpart of
``style_seqcvae_tpu/models/updown_cell.py``). The decodes run the folded
step, :func:`captioner.make_optimized_step_fn`."""

from __future__ import annotations

from functools import reduce
from typing import NamedTuple, Optional, Tuple, Union

import torch

from style_seqcvae_tpu_torch.models.attention import (
    AttentionParams,
    attention_weights,
    init_attention,
)
from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams, init_lstm_cell, lstm_cell
from style_seqcvae_tpu_torch.ops.masked import masked_mean


class CellParams(NamedTuple):
    attention_lstm: LSTMCellParams
    attention: AttentionParams
    encoder_lstm: LSTMCellParams
    decoder_lstm: LSTMCellParams
    fc_mean_w: torch.Tensor      # (H, z)
    fc_mean_b: torch.Tensor      # (z,)
    fc_log_var_w: torch.Tensor   # (H, z)
    fc_log_var_b: torch.Tensor   # (z,)


class CellState(NamedTuple):
    h1: torch.Tensor
    c1: torch.Tensor
    h_enc: torch.Tensor
    c_enc: torch.Tensor
    h_dec: torch.Tensor
    c_dec: torch.Tensor


def condition_size(sentiment_vae: int, simple_vae: bool, latent_embedding: str,
                   z_space: int) -> int:
    """Width of the style condition appended to encoder/decoder inputs."""
    if simple_vae or sentiment_vae == 0:
        return 0
    if latent_embedding == "senti_word_net" or sentiment_vae == 1:
        return 1
    if sentiment_vae == 2:
        return z_space
    raise NotImplementedError(f"sentiment_vae={sentiment_vae}")


def init_cell(image_feature_size: int, embedding_size: int, hidden_size: int,
              attention_projection_size: int, z_space: int, sentiment_vae: int,
              simple_vae: bool, latent_embedding: str, *, generator: torch.Generator,
              device: torch.device, dtype=torch.float32) -> CellParams:
    """Random cell parameters with the reference's shapes and init ranges."""
    cond = condition_size(sentiment_vae, simple_vae, latent_embedding, z_space)
    kw = dict(generator=generator, device=device, dtype=dtype)

    def linear(fan_in, fan_out):
        bound = 1.0 / fan_in ** 0.5
        w = torch.rand((fan_in, fan_out), generator=generator, device=device) * 2 - 1
        b = torch.rand((fan_out,), generator=generator, device=device) * 2 - 1
        return (w * bound).to(dtype), (b * bound).to(dtype)

    attn = init_lstm_cell(embedding_size + image_feature_size + 2 * hidden_size,
                          hidden_size, **kw)
    attention = init_attention(hidden_size, image_feature_size,
                               attention_projection_size, **kw)
    enc = init_lstm_cell(cond + image_feature_size + 2 * hidden_size, hidden_size, **kw)
    dec = init_lstm_cell(cond + image_feature_size + 2 * hidden_size + z_space,
                         hidden_size, **kw)
    fc_mean_w, fc_mean_b = linear(hidden_size, z_space)
    fc_lv_w, fc_lv_b = linear(hidden_size, z_space)
    return CellParams(attn, attention, enc, dec, fc_mean_w, fc_mean_b, fc_lv_w, fc_lv_b)


def init_cell_state(batch_shape: Tuple[int, ...], hidden_size: int, *,
                    device: torch.device, dtype=torch.float32) -> CellState:
    z = torch.zeros(tuple(batch_shape) + (hidden_size,), dtype=dtype, device=device)
    return CellState(z, z, z, z, z, z)


def _attend(attn_w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Σ_n w[b, ..., n]·values[b, n, f] as one batched matmul."""
    B, N = values.shape[0], values.shape[1]
    grid = attn_w.shape[:-1]
    out = torch.bmm(attn_w.reshape(B, -1, N).to(values.dtype), values)
    return out.reshape(tuple(grid) + (values.shape[-1],))


def _concat(parts, grid: Tuple[int, ...]) -> torch.Tensor:
    """``parts`` broadcast to ``grid`` and concatenated on the last axis in
    their promoted dtype, as ``jnp.concatenate`` promotes."""
    to = reduce(torch.promote_types, [p.dtype for p in parts])
    return torch.cat([p.to(to).expand(grid + (p.shape[-1],)) for p in parts], dim=-1)


def image_feature_stats(image_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-pooled features and the box mask (a box is real iff its feature
    vector is not all zero), computed once per decode."""
    mask = image_features.abs().sum(dim=-1) > 0
    avg = masked_mean(image_features, mask[..., None], dim=-2)
    return avg, mask


def cell_step(
    params: CellParams,
    token_embedding: torch.Tensor,          # (B, ..., E)
    state: CellState,                       # each (B, ..., H)
    *,
    image_features: torch.Tensor,           # (B, N, F)
    projected_image_features: torch.Tensor, # (B, N, P)
    averaged_image_features: torch.Tensor,  # (B, F)
    image_features_mask: torch.Tensor,      # (B, N)
    training: bool,
    rng: Optional[Union[torch.Generator, torch.Tensor]],
    sentiment_vae: int,
    simple_vae: bool,
    latent_embedding: str,
    sentiment: Optional[torch.Tensor] = None,       # (B, 1)
    obj_att_embeds: Optional[torch.Tensor] = None,  # (B, N, z), mode 2
    prior_mean: Optional[torch.Tensor] = None,      # (B, z) or broadcastable
    prior_var: Optional[torch.Tensor] = None,       # (B, z) or broadcastable
    eps: Optional[torch.Tensor] = None,             # z-noise
    model_group=None,
):
    """One step of the cell (JAX ``models/updown_cell.py:146-245``). Returns
    ``(h_dec, new_state, q_mean, q_log_var, prior_mean, attn_w)``, ``q_*``
    being the distribution z was drawn from: the posterior when
    ``training`` (the encoder LSTM over ``[attended, h1, h_dec, c?]``, then
    ``fc_mean`` and ``fc_log_var``), else the prior.

    The z-noise is ``eps`` when given, else a draw from the
    ``torch.Generator`` ``rng``; at inference ``rng`` may also be a
    floating tensor (the searches thread their noise rows through that
    slot), which training refuses. Every LSTM input is concatenated in its
    parts' promoted dtype, as ``jnp.concatenate`` does: under bf16 the prior
    (at inference in modes 0 and 1) and the posterior mean (in training, an
    f32 product plus a bf16 bias) are f32, so z and the decoder LSTM's whole
    input stay f32. ``model_group``: the group over which the LSTMs' gate
    matrices are column blocks (``ops/lstm.py``), under tensor
    parallelism."""
    if training and torch.is_tensor(rng):
        raise TypeError("cell_step(training=True) takes eps or a torch.Generator, "
                        "not a noise tensor in rng")
    grid = tuple(token_embedding.shape[:-1])
    extra = len(grid) - 1

    def bcast(x):  # (B, D) → (B, 1..., D) for the inner grid dims
        return x.reshape((x.shape[0],) + (1,) * extra + tuple(x.shape[1:]))

    attn_in = _concat([token_embedding, bcast(averaged_image_features), state.h1, state.h_dec],
                      grid)
    h1, c1 = lstm_cell(params.attention_lstm, attn_in, state.h1, state.c1, model_group)
    attn_w = attention_weights(params.attention, h1, projected_image_features,
                               image_features_mask)
    attended = _attend(attn_w, image_features)

    if sentiment_vae == 2 and obj_att_embeds is not None:
        prior_mean = _attend(attn_w, obj_att_embeds)
    else:
        prior_mean = bcast(prior_mean).expand(grid + tuple(prior_mean.shape[-1:]))
    if simple_vae:
        prior_mean = torch.zeros_like(prior_mean)
    var = bcast(prior_var).expand(prior_mean.shape)

    cond = condition_size(sentiment_vae, simple_vae, latent_embedding, prior_mean.shape[-1])
    if cond == 0:
        c = None
    elif latent_embedding == "senti_word_net" and sentiment_vae == 2:
        c = prior_mean[..., 0:1]
    elif sentiment_vae == 1:
        c = bcast(sentiment)
    else:  # mode 2, glove conditioning
        c = prior_mean

    if training:
        enc_in = _concat([attended, h1, state.h_dec] + ([c] if c is not None else []), grid)
        h_enc, c_enc = lstm_cell(params.encoder_lstm, enc_in, state.h_enc, state.c_enc,
                                 model_group)
        # f32 products plus the bias, as JAX's preferred_element_type=f32
        q_mean = torch.matmul(h_enc.float(), params.fc_mean_w.float()) + params.fc_mean_b
        q_log_var = (torch.matmul(h_enc.float(), params.fc_log_var_w.float())
                     + params.fc_log_var_b)
        mean, var = q_mean, torch.exp(q_log_var)
    else:
        h_enc, c_enc = state.h_enc, state.c_enc
        mean = prior_mean
    if eps is None and torch.is_tensor(rng) and rng.is_floating_point():
        eps = rng
    if eps is not None:
        eps = eps.to(mean.dtype).expand(mean.shape)
    elif isinstance(rng, torch.Generator):
        eps = torch.randn(mean.shape, generator=rng, device=mean.device, dtype=mean.dtype)
    else:
        raise TypeError("cell_step needs eps, a floating rng tensor or a torch.Generator")
    z = eps * torch.sqrt(var) + mean

    dec_in = _concat([attended, h1, state.h_dec] + ([c] if c is not None else []) + [z], grid)
    h_dec, c_dec = lstm_cell(params.decoder_lstm, dec_in, state.h_dec, state.c_dec,
                             model_group)
    new_state = CellState(h1=h1, c1=c1, h_enc=h_enc, c_enc=c_enc, h_dec=h_dec, c_dec=c_dec)
    if training:
        return h_dec, new_state, q_mean, q_log_var, prior_mean, attn_w
    return h_dec, new_state, mean, torch.log(var), prior_mean, attn_w
