"""Style-SeqCVAE captioner: config, parameters and the inference step
(counterpart of ``style_seqcvae_tpu/models/captioner.py``).

Parameters are a plain dict: ``embedding`` (V, E), ``cell``
(:class:`CellParams`) and, for the tied head (E in {300, 600}),
``output_projection`` = {"w": (H, E), "b": (E,)}; otherwise
``output_layer`` = {"w": (H, V), "b": (V,)}. Layouts are the JAX package's,
so :func:`style_seqcvae_tpu_torch.weights.from_jax_params` carries its
weights over unchanged.

Prior modes: 0 — standard normal (or ``simple_vae``); 1 — scalar sentiment
prior ``sentiment * senti_prior_multip``; 2 — per-step attention-weighted
attribute-embedding prior.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.attention import (
    attention_weights,
    project_image_features,
)
from style_seqcvae_tpu_torch.models.updown_cell import (
    CellState,
    _attend,
    cell_step,
    condition_size,
    image_feature_stats,
    init_cell,
)
from style_seqcvae_tpu_torch.ops.lstm import gate_math


class CaptionerConfig(NamedTuple):
    """Static model hyperparameters (the JAX package's field set)."""
    vocab_size: int
    image_feature_size: int = 2048
    embedding_size: int = 600
    hidden_size: int = 900
    attention_projection_size: int = 768
    z_space: int = 150
    sentiment_vae: int = 0
    simple_vae: bool = True
    latent_embedding: str = "glove"
    latent_embedding_multip: float = 1.0
    prior_std: float = 1.0
    senti_prior_multip: float = 1.0
    max_caption_length: int = 20
    beam_size: int = 1
    use_cbs: bool = False
    cbs_simple: bool = True
    min_constraints_to_satisfy: int = 2
    pad_index: int = 0
    boundary_index: int = 1

    @property
    def tie_embeddings(self) -> bool:
        # frozen GloVe (300/600) → tied input/output embeddings
        return self.embedding_size in (300, 600)

    @classmethod
    def from_config(cls, config, vocabulary) -> "CaptionerConfig":
        """The model fields of a ``Config`` (JAX ``captioner.py:72-94``)."""
        _C = config
        return cls(
            vocab_size=vocabulary.get_vocab_size(),
            image_feature_size=_C.MODEL.IMAGE_FEATURE_SIZE,
            embedding_size=_C.MODEL.EMBEDDING_SIZE,
            hidden_size=_C.MODEL.HIDDEN_SIZE,
            attention_projection_size=_C.MODEL.ATTENTION_PROJECTION_SIZE,
            z_space=_C.MODEL.Z_SPACE,
            sentiment_vae=int(_C.MODEL.SENTIMENT_VAE),
            simple_vae=bool(_C.MODEL.SIMPLE_VAE),
            latent_embedding=_C.MODEL.LATENT_EMBEDDING,
            latent_embedding_multip=float(_C.MODEL.LATENT_EMBEDDING_MULTIP),
            prior_std=float(_C.MODEL.PRIOR_STD),
            senti_prior_multip=float(_C.MODEL.SENTI_PRIOR_MULTIP),
            max_caption_length=_C.DATA.MAX_CAPTION_LENGTH,
            beam_size=_C.MODEL.BEAM_SIZE,
            use_cbs=bool(_C.MODEL.USE_CBS),
            cbs_simple=bool(_C.MODEL.CBS_SIMPLE),
            min_constraints_to_satisfy=_C.MODEL.MIN_CONSTRAINTS_TO_SATISFY,
            pad_index=vocabulary.unk_index,
            boundary_index=vocabulary.boundary_index,
        )


def hashed_random_embeddings(vocab_tokens, dim: int, pad_index: int) -> np.ndarray:
    """Deterministic stand-in for GloVe when its cache is absent (JAX
    ``captioner.py:97-110``, bit for bit): each word's vector is drawn by a
    numpy ``default_rng`` seeded with a SHA-256 of its text; the padding
    row stays zero."""
    out = np.zeros((len(vocab_tokens), dim), dtype=np.float32)
    for i, tok in enumerate(vocab_tokens):
        if i == pad_index:
            continue
        seed = int.from_bytes(hashlib.sha256(tok.encode()).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        out[i] = 2.0 * rng.standard_normal(dim).astype(np.float32) - 1.0
    return out


def init_captioner(cfg: CaptionerConfig, *, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None,
                   dtype=torch.float32,
                   embedding_table: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``. Same shapes and init ranges as the JAX package, not the
    same numbers (use ``from_jax_params`` for those). ``embedding_table``
    (V, E): the frozen table (GloVe or :func:`hashed_random_embeddings`),
    taken as it is, as the JAX ``init_captioner`` takes it; without one the
    table is drawn too."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if embedding_table is not None:
        emb = torch.as_tensor(np.asarray(embedding_table, np.float32), device=dev)
    else:
        emb = torch.randn((cfg.vocab_size, cfg.embedding_size), generator=gen, device=dev)
        emb[cfg.pad_index] = 0.0
    params: Dict[str, Any] = {"embedding": emb.to(dtype)}
    params["cell"] = init_cell(
        cfg.image_feature_size, cfg.embedding_size, cfg.hidden_size,
        cfg.attention_projection_size, cfg.z_space, cfg.sentiment_vae,
        cfg.simple_vae, cfg.latent_embedding, generator=gen, device=dev, dtype=dtype)

    def linear(fan_in, fan_out):
        bound = 1.0 / fan_in ** 0.5
        w = (torch.rand((fan_in, fan_out), generator=gen, device=dev) * 2 - 1) * bound
        b = (torch.rand((fan_out,), generator=gen, device=dev) * 2 - 1) * bound
        return {"w": w.to(dtype), "b": b.to(dtype)}

    if cfg.tie_embeddings:
        params["output_projection"] = linear(cfg.hidden_size, cfg.embedding_size)
    else:
        params["output_layer"] = linear(cfg.hidden_size, cfg.vocab_size)
    return params


def tied_head_projection(params: Dict[str, Any], h_dec: torch.Tensor) -> torch.Tensor:
    """Tied head's (…, E) pre-embedding activation: tanh(h·W_proj + b)."""
    proj = params["output_projection"]
    return torch.tanh(torch.matmul(h_dec, proj["w"]) + proj["b"])


def output_logits(params: Dict[str, Any], cfg: CaptionerConfig, h_dec: torch.Tensor) -> torch.Tensor:
    """Hidden state → vocabulary logits."""
    if cfg.tie_embeddings:
        return torch.matmul(tied_head_projection(params, h_dec), params["embedding"].T)
    out = params["output_layer"]
    return torch.matmul(h_dec, out["w"]) + out["b"]


def base_prior(cfg: CaptionerConfig, batch_size: int, sentiment: Optional[torch.Tensor],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-level prior mean/var (f32). Mode 2's per-step attention prior
    is applied inside the step."""
    if cfg.sentiment_vae == 1:
        prior_mean = sentiment.float().repeat(1, cfg.z_space) * cfg.senti_prior_multip
    else:
        prior_mean = torch.zeros((batch_size, cfg.z_space), device=device)
    prior_var = torch.full((batch_size, cfg.z_space), float(cfg.prior_std) ** 2,
                           device=device)
    return prior_mean, prior_var


class DecodeContext(NamedTuple):
    """Per-batch tensors the decode step closes over."""
    image_features: torch.Tensor
    projected_image_features: torch.Tensor
    averaged_image_features: torch.Tensor
    image_features_mask: torch.Tensor
    prior_mean: torch.Tensor
    prior_var: torch.Tensor
    sentiment: Optional[torch.Tensor]
    obj_att_embeds: Optional[torch.Tensor]


def make_decode_context(params: Dict[str, Any], cfg: CaptionerConfig,
                        image_features: torch.Tensor,
                        sentiment: Optional[torch.Tensor] = None,
                        obj_att_embeds: Optional[torch.Tensor] = None) -> DecodeContext:
    avg_feats, feats_mask = image_feature_stats(image_features)
    proj_feats = project_image_features(params["cell"].attention, image_features)
    prior_mean, prior_var = base_prior(cfg, image_features.shape[0], sentiment,
                                       image_features.device)
    return DecodeContext(image_features, proj_feats, avg_feats, feats_mask,
                         prior_mean, prior_var, sentiment, obj_att_embeds)


def make_step_fn(params: Dict[str, Any], cfg: CaptionerConfig, ctx: DecodeContext,
                 return_raw: bool = False):
    """The unfolded decode step: the token's embedding through
    :func:`cell_step` and the output head.

    ``step(tokens, state, noise) -> (log_probs, new_state)`` on tokens of
    shape (B, ...) with any inner grid dims; ``noise`` is the z-noise slice
    (a float tensor broadcastable to grid + (z,)) or a ``torch.Generator``.
    With ``return_raw`` the step returns ``((logits, logz), new_state)``,
    ``log_probs = logits - logz[..., None]``."""

    def step(tokens: torch.Tensor, state: CellState, noise):
        h_dec, new_state, _, _, _, _ = cell_step(
            params["cell"], params["embedding"][tokens], state,
            image_features=ctx.image_features,
            projected_image_features=ctx.projected_image_features,
            averaged_image_features=ctx.averaged_image_features,
            image_features_mask=ctx.image_features_mask,
            training=False, rng=noise,
            sentiment_vae=cfg.sentiment_vae, simple_vae=cfg.simple_vae,
            latent_embedding=cfg.latent_embedding,
            sentiment=ctx.sentiment, obj_att_embeds=ctx.obj_att_embeds,
            prior_mean=ctx.prior_mean, prior_var=ctx.prior_var)
        logits = output_logits(params, cfg, h_dec)
        if return_raw:
            return (logits, torch.logsumexp(logits.float(), dim=-1)), new_state
        return torch.log_softmax(logits, dim=-1), new_state

    return step


def make_optimized_step_fn(params: Dict[str, Any], cfg: CaptionerConfig,
                           ctx: DecodeContext, return_raw: bool = False,
                           return_prehead: bool = False):
    """Inference step with the step-constant LSTM input segments folded out.

    ``tok_emb @ W`` depends only on the token id (a whole-vocabulary gate
    table, computed once) and ``avg @ W`` only on the image (once per batch);
    the decoder LSTM's sentiment segment (mode 1) folds the same way.

    ``step(tokens, state, noise) -> (out, new_state)``; ``tokens`` is
    (B, ...) with any inner grid dims. ``noise`` is either a float tensor
    broadcastable to grid + (z,) (the z-noise slice ``eps``) or a
    ``torch.Generator`` that draws it. ``out`` is the log-probs (…, V), or
    ``(logits, logz)`` with ``return_raw``, or the tied head's (…, E)
    pre-embedding activation with ``return_prehead``."""
    if return_prehead:
        if return_raw:
            raise ValueError("return_prehead and return_raw are conflicting "
                             "step contracts — pick one")
        if not cfg.tie_embeddings:
            raise ValueError("return_prehead needs the tied output head")
    cell = params["cell"]
    E, F, H = cfg.embedding_size, cfg.image_feature_size, cfg.hidden_size
    cond = condition_size(cfg.sentiment_vae, cfg.simple_vae,
                          cfg.latent_embedding, cfg.z_space)

    # attention LSTM: split W rows by input segment [tok, avg, h1, h_dec | h1]
    w_a = cell.attention_lstm.w
    w_a_tok, w_a_avg, w_a_h = w_a[:E], w_a[E:E + F], w_a[E + F:]
    tok_gate_table = torch.matmul(params["embedding"], w_a_tok)          # (V, 4H)
    avg_gates = torch.matmul(ctx.averaged_image_features, w_a_avg)       # (B, 4H)

    # decoder LSTM input: [attended(F), h1(H), h_dec(H), cond?, z] + recurrent h
    w_d = cell.decoder_lstm.w
    sent_gates = None
    w_rows = [w_d[:F], w_d[F:F + H], w_d[F + H:F + 2 * H]]
    offset = F + 2 * H
    if cond == 1 and cfg.sentiment_vae == 1:
        sent_gates = torch.matmul(ctx.sentiment.to(w_d.dtype),
                                  w_d[offset:offset + 1])                  # (B, 4H)
        offset += 1
    elif cond and cfg.sentiment_vae == 2:
        c_width = 1 if cfg.latent_embedding == "senti_word_net" else cfg.z_space
        w_rows.append(w_d[offset:offset + c_width])
        offset += c_width
    w_rows.append(w_d[offset:offset + cfg.z_space])
    w_rows.append(w_d[offset + cfg.z_space:])
    w_dyn = torch.cat(w_rows, dim=0)          # step-constant, concatenated once

    def step(tokens: torch.Tensor, state: CellState, noise):
        grid = tuple(tokens.shape)
        extra = len(grid) - 1

        def bcast(x):
            return x.reshape((x.shape[0],) + (1,) * extra + tuple(x.shape[1:]))

        xh = torch.cat([state.h1, state.h_dec, state.h1], dim=-1)
        gates = (tok_gate_table[tokens] + bcast(avg_gates)
                 + torch.matmul(xh, w_a_h) + cell.attention_lstm.b)
        h1, c1 = gate_math(gates, state.h1, state.c1)

        attn_w = attention_weights(cell.attention, h1, ctx.projected_image_features,
                                   ctx.image_features_mask)
        attended = _attend(attn_w, ctx.image_features)

        if cfg.sentiment_vae == 2 and ctx.obj_att_embeds is not None:
            prior_mean = _attend(attn_w, ctx.obj_att_embeds)
        else:
            prior_mean = bcast(ctx.prior_mean).expand(grid + tuple(ctx.prior_mean.shape[-1:]))
        if cfg.simple_vae:
            prior_mean = torch.zeros_like(prior_mean)
        prior_var = bcast(ctx.prior_var).expand(prior_mean.shape)

        if isinstance(noise, torch.Generator):
            eps = torch.randn(prior_mean.shape, generator=noise, device=prior_mean.device,
                              dtype=prior_mean.dtype)
        else:
            eps = noise.to(prior_mean.dtype).expand(prior_mean.shape)
        z = eps * torch.sqrt(prior_var) + prior_mean

        parts = [attended, h1, state.h_dec]
        const_gates = cell.decoder_lstm.b
        if sent_gates is not None:
            const_gates = const_gates + bcast(sent_gates)
        elif cond and cfg.sentiment_vae == 2:
            parts.append(prior_mean[..., 0:1] if cfg.latent_embedding == "senti_word_net"
                         else prior_mean)
        parts += [z, state.h_dec]
        dyn = torch.cat([p.to(w_d.dtype).expand(grid + (p.shape[-1],)) for p in parts],
                        dim=-1)
        gates_d = torch.matmul(dyn, w_dyn) + const_gates
        h_dec, c_dec = gate_math(gates_d, state.h_dec, state.c_dec)

        new_state = CellState(h1=h1, c1=c1, h_enc=state.h_enc, c_enc=state.c_enc,
                              h_dec=h_dec, c_dec=c_dec)
        if return_prehead:
            return tied_head_projection(params, h_dec), new_state
        logits = output_logits(params, cfg, h_dec)
        if return_raw:
            return (logits, torch.logsumexp(logits.float(), dim=-1)), new_state
        return torch.log_softmax(logits, dim=-1), new_state

    return step
