"""Style-SeqCVAE captioner: config, parameters, the teacher-forced training
forward and the inference step (counterpart of
``style_seqcvae_tpu/models/captioner.py``).

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
    init_cell_state,
)
from style_seqcvae_tpu_torch.ops.lstm import gate_math
from style_seqcvae_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    is_sharded,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)
from style_seqcvae_tpu_torch.utils.tracing import STEP, STEP_ATTENTION, span


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


def load_glove_embeddings(vocabulary, dim: int, glove_txt_paths, pad_index: int) -> np.ndarray:
    """The frozen embedding table from GloVe-style text files (JAX
    ``captioner.py:113-134``). ``glove_txt_paths`` is a list of (path,
    subdim) whose subdims sum to ``dim`` (GloVe 300 + dependency 300 for the
    published 600); a word missing from a file keeps its
    :func:`hashed_random_embeddings` vector there; the padding row is zero."""
    tokens = [vocabulary.get_token_from_index(i) for i in range(vocabulary.get_vocab_size())]
    wanted = set(tokens)
    pieces = []
    for path, subdim in glove_txt_paths:
        table = hashed_random_embeddings(tokens, subdim, pad_index)
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if parts[0] in wanted and len(parts) == subdim + 1:
                    table[vocabulary.get_token_index(parts[0])] = np.asarray(parts[1:],
                                                                             dtype=np.float32)
        pieces.append(table)
    out = np.concatenate(pieces, axis=1)
    if out.shape[1] != dim:
        raise ValueError(f"GloVe pieces sum to {out.shape[1]} columns, not {dim}")
    out[pad_index] = 0.0
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


def output_logits(params: Dict[str, Any], cfg: CaptionerConfig, h_dec: torch.Tensor,
                  model_group=None) -> torch.Tensor:
    """Hidden state → vocabulary logits; under tensor parallelism, where
    the embedding's rows (tied) or ``output_layer``'s columns and bias are
    this rank's block of the vocabulary, the logits of that block (the
    input's gradient summed over ``model_group``)."""
    if cfg.tie_embeddings:
        x, emb = tied_head_projection(params, h_dec), params["embedding"]
        if is_sharded(emb.shape[0], cfg.vocab_size, model_group):
            x = copy_to_model(x, model_group)
        return torch.matmul(x, emb.T)
    out = params["output_layer"]
    if is_sharded(out["w"].shape[1], cfg.vocab_size, model_group):
        h_dec = copy_to_model(h_dec, model_group)
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


def add_boundary_tokens(caption_tokens: torch.Tensor, pad_index: int,
                        boundary_index: int) -> torch.Tensor:
    """(B, T) → (B, T+2): the boundary prepended and written at position
    ``lengths + 1`` (JAX ``captioner.py:203-216``, AllenNLP's
    ``add_sentence_boundary_token_ids``). ``lengths`` counts the tokens
    that are not ``pad_index``, wherever they stand: the pad index is the
    vocabulary's UNK, so an UNK inside a caption counts as padding, is
    written as padding, and the closing boundary lands at ``lengths + 1``,
    over a real token when the UNK was not at the end."""
    B, T = caption_tokens.shape
    mask = caption_tokens != pad_index
    lengths = mask.sum(dim=1)
    out = torch.full((B, T + 2), pad_index, dtype=caption_tokens.dtype,
                     device=caption_tokens.device)
    out[:, 1:T + 1] = torch.where(mask, caption_tokens, torch.full_like(caption_tokens,
                                                                          pad_index))
    out[:, 0] = boundary_index
    positions = torch.arange(T + 2, device=caption_tokens.device)[None, :]
    return torch.where(positions == (lengths + 1)[:, None],
                       torch.full_like(out, boundary_index), out)


def _per_step_kld(cfg: CaptionerConfig, q_mean, q_log_var, prior_mean, prior_log_var):
    """Both KL closed forms of the reference (JAX ``captioner.py:219-226``):
    against N(0, 1) in mode 0, else against N(prior_mean, exp(prior_log_var))
    with a 1e-5 floor on the prior's variance."""
    if cfg.sentiment_vae == 0:
        return -0.5 * torch.sum(1 + q_log_var - q_mean ** 2 - torch.exp(q_log_var), dim=-1)
    prior_var = torch.exp(prior_log_var)
    q_var = torch.exp(q_log_var)
    kld = (1 + q_log_var - prior_log_var
           - ((q_mean - prior_mean) ** 2 + q_var) / (prior_var + 1e-5))
    return -0.5 * torch.sum(kld, dim=-1)


def train_forward(params: Dict[str, Any], cfg: CaptionerConfig, batch: Dict[str, torch.Tensor],
                  rng: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
                  model_group=None) -> Dict[str, torch.Tensor]:
    """Teacher-forced training forward (JAX ``captioner.py:240-317``): a
    Python loop over the ``T + 1`` steps of the boundary-wrapped caption in
    place of the ``lax.scan``.

    ``batch``: ``image_features`` (B, N, F), ``caption_tokens`` (B, T) padded
    with ``cfg.pad_index``, optional ``sentiment`` (B, 1) and
    ``obj_att_embeds`` (B, N, z), all on one device. The z-noise is ``eps``,
    a (T+1, B, z) stack, when given, else drawn from the ``torch.Generator``
    ``rng`` step by step. Returns the per-sequence ``loss`` (the
    length-scaled masked cross entropy, ``lengths · Σ(nll·mask) / (lengths +
    1e-13)``) and ``kld`` (the masked per-step KL summed over steps).

    Tensor parallel: ``params`` holds this rank's blocks
    (``parallel/mesh.py::shard_params``) and ``model_group`` their group;
    the embedding lookup, the LSTMs, the head and the NLL run on the
    blocks (``parallel/tensor_parallel.py``), every other value is
    replicated over the group."""
    image_features = batch["image_features"]
    sentiment = batch.get("sentiment")
    obj_att_embeds = batch.get("obj_att_embeds")
    B = image_features.shape[0]

    tokens = add_boundary_tokens(batch["caption_tokens"].long(), cfg.pad_index,
                                 cfg.boundary_index)
    tokens_mask = tokens != cfg.pad_index
    num_steps = tokens.shape[1] - 1
    if eps is None and rng is None:
        raise TypeError("train_forward needs eps or a torch.Generator")

    avg_feats, feats_mask = image_feature_stats(image_features)
    proj_feats = project_image_features(params["cell"].attention, image_features)
    prior_mean, prior_var = base_prior(cfg, B, sentiment, image_features.device)
    prior_log_var = torch.log(prior_var)

    state = init_cell_state((B,), cfg.hidden_size, device=image_features.device,
                            dtype=image_features.dtype)
    token_embs = vocab_parallel_embedding(params["embedding"], tokens[:, :-1].T,
                                          cfg.vocab_size, model_group)   # (T+1, B, E)
    logits, klds = [], []
    for t in range(num_steps):
        h_dec, state, q_mean, q_log_var, p_mean, _ = cell_step(
            params["cell"], token_embs[t], state,
            image_features=image_features,
            projected_image_features=proj_feats,
            averaged_image_features=avg_feats,
            image_features_mask=feats_mask,
            training=True, rng=rng, eps=None if eps is None else eps[t],
            sentiment_vae=cfg.sentiment_vae, simple_vae=cfg.simple_vae,
            latent_embedding=cfg.latent_embedding,
            sentiment=sentiment, obj_att_embeds=obj_att_embeds,
            prior_mean=prior_mean, prior_var=prior_var, model_group=model_group)
        logits.append(output_logits(params, cfg, h_dec, model_group))
        klds.append(_per_step_kld(cfg, q_mean, q_log_var, p_mean, prior_log_var))
    logits_bt = torch.stack(logits, dim=1)                    # (B, T+1, V)
    kld_t = torch.stack(klds, dim=1)                          # (B, T+1)
    klds_masked = kld_t * tokens_mask[:, 1:].to(kld_t.dtype)

    targets = tokens[:, 1:]
    target_mask = tokens_mask[:, 1:].float()
    nll = vocab_parallel_nll(logits_bt, targets, cfg.vocab_size, model_group)
    lengths = target_mask.sum(dim=1)
    per_seq = (nll * target_mask).sum(dim=1) / (lengths + 1e-13)
    return {"loss": lengths * per_seq, "kld": klds_masked.sum(dim=1)}


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

    def model_step(tokens: torch.Tensor, state: CellState, noise):
        grid = tuple(tokens.shape)
        extra = len(grid) - 1

        def bcast(x):
            return x.reshape((x.shape[0],) + (1,) * extra + tuple(x.shape[1:]))

        xh = torch.cat([state.h1, state.h_dec, state.h1], dim=-1)
        gates = (tok_gate_table[tokens] + bcast(avg_gates)
                 + torch.matmul(xh, w_a_h) + cell.attention_lstm.b)
        h1, c1 = gate_math(gates, state.h1, state.c1)

        attribute_prior = cfg.sentiment_vae == 2 and ctx.obj_att_embeds is not None
        with span(STEP_ATTENTION):
            attn_w = attention_weights(cell.attention, h1, ctx.projected_image_features,
                                       ctx.image_features_mask)
            attended = _attend(attn_w, ctx.image_features)
            if attribute_prior:
                prior_mean = _attend(attn_w, ctx.obj_att_embeds)

        if not attribute_prior:
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

    def step(tokens: torch.Tensor, state: CellState, noise):
        with span(STEP):
            return model_step(tokens, state, noise)

    return step
