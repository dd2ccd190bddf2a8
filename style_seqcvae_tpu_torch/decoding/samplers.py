"""Stochastic decoding: ancestral sampling with temperature, top-k and top-p
(nucleus) filtering, and Stochastic Beam Search (counterpart of
``style_seqcvae_tpu/decoding/samplers.py``).

Every random draw of the JAX samplers is Gumbel noise:
``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel(key,
logits.shape, logits.dtype))``, and ``gumbel_beam_search`` adds
``jax.random.gumbel`` to its scores directly. So the port's samplers take
their noise as tensors, or draw it from a ``torch.Generator``, and a decode
driven by JAX's PRNG keys is reproduced by handing over the same draws.

``noise`` is either

- a ``torch.Generator`` on the decode device, which draws the z-noise (the
  step draws it) and the Gumbel noise (``-log(E)``, E ~ Exp(1) in f32, cast
  to the dtype JAX adds it in); or
- a pair ``(z_noise, gumbel_noise)`` of ``max_steps``-row stacks. z-noise
  as ``beam_search`` takes it: row t goes to the step at step t, and row 0
  of a (B, K, z) layout is cut to its first beam (``first_noise``).
  Gumbel noise is (T, B, V) for :func:`sample_decode` and (T, B, K, V) for
  :func:`gumbel_beam_search`, whose row 0 carries the first step's (B, V)
  draw in its first beam.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from style_seqcvae_tpu_torch.decoding.beam_search import (
    _add_beam_dim,
    _cleaned_log_probs,
    _tile_beam,
    check_noise,
    first_noise,
    pick_beams,
    reconstruct_sequences,
)
from style_seqcvae_tpu_torch.ops.topk import top_k as lax_top_k

NEG_INF = float("-inf")
SamplerNoise = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def _filter_top_k(log_probs: torch.Tensor, k: int) -> torch.Tensor:
    """Entries below the k-th largest value become -inf; every entry tied
    with it stays (the cutoff is a value, not k indices)."""
    cutoff = torch.topk(log_probs, k, dim=-1).values[..., -1:]
    return log_probs.masked_fill(log_probs < cutoff, NEG_INF)


def _filter_top_p(log_probs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering as the reference's TopPSampler: over the sorted
    distribution, token i is kept while the mass before it is < p (the
    first always); entries below the smallest kept value become -inf, so
    ties with it stay. ``torch.cumsum`` is the reference's own sum; JAX's
    sums in another order, which can move a row whose prefix mass lies
    within a few ulps of p by one token."""
    sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
    cum = torch.cumsum(torch.exp(sorted_lp), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p],
                     dim=-1)
    cutoff = torch.where(keep, sorted_lp, float("inf")).amin(dim=-1, keepdim=True)
    return log_probs.masked_fill(log_probs < cutoff, NEG_INF)


def _split_noise(noise: SamplerNoise, max_steps: int, device: torch.device):
    """(z-noise, Gumbel noise): a generator serves as both; a pair is
    checked as ``check_noise`` checks z-noise."""
    if isinstance(noise, torch.Generator):
        check_noise(noise, max_steps, device)
        return noise, noise
    if not isinstance(noise, (tuple, list)) or len(noise) != 2:
        raise ValueError("sampler noise must be a torch.Generator or a pair "
                         f"(z_noise, gumbel_noise), got {type(noise).__name__}")
    for stack in noise:
        check_noise(stack, max_steps, device)
    return noise[0], noise[1]


def _gumbel(noise, t: int, shape: Tuple[int, ...], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Step t's Gumbel noise of ``shape`` in ``dtype``: drawn from a
    generator, or row t of the stack (row 0 of a (T, B, K, V) stack cut to
    its first beam when ``shape`` is (B, V))."""
    if isinstance(noise, torch.Generator):
        e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=noise)
        return (-torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))).to(dtype)
    row = noise[t]
    if t == 0 and row.dim() == len(shape) + 1:
        row = row[:, 0]
    if tuple(row.shape) != tuple(shape):
        raise ValueError(f"gumbel noise row {t} must be {tuple(shape)}, got {tuple(row.shape)}")
    return row.to(dtype)


def sample_decode(step_fn: Callable, start_tokens: torch.Tensor, init_state,
                  noise: SamplerNoise, *, max_steps: int, end_index: int,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0
                  ) -> torch.Tensor:
    """Ancestral sampling with optional temperature, top-k and top-p
    filtering → (B, T) token ids; once a row emitted ``end_index`` it emits
    nothing else (the step still runs on it).

    ``step_fn(tokens, state, noise_row) -> (log_probs, new_state)`` runs on
    a (B, 1) grid. Each token is ``argmax(filtered + gumbel)`` with the
    Gumbel noise in the log-probs' dtype, as ``jax.random.categorical``
    draws it."""
    dev = start_tokens.device
    z_noise, gumbel = _split_noise(noise, max_steps, dev)
    from_tensor = torch.is_tensor(z_noise)

    def filt(lp):
        if temperature != 1.0:
            # re-normalised, so that top-p sees a distribution
            lp = torch.log_softmax(lp / temperature, dim=-1)
        if top_k:
            lp = _filter_top_k(lp, top_k)
        if top_p:
            lp = _filter_top_p(lp, top_p)
        return lp

    def draw(lp, t):
        lp = filt(lp[:, 0, :])
        return torch.argmax(lp + _gumbel(gumbel, t, tuple(lp.shape), lp.dtype, dev), dim=-1)

    lp, state = step_fn(start_tokens[:, None], _add_beam_dim(init_state),
                        first_noise(z_noise, 1))
    last = draw(lp, 0)
    toks = [last]
    for t in range(1, max_steps):
        lp, state = step_fn(last[:, None], state, z_noise[t] if from_tensor else z_noise)
        nxt = draw(lp, t)
        last = torch.where(last == end_index, torch.full_like(nxt, end_index), nxt)
        toks.append(last)
    return torch.stack(toks, dim=1)


def gumbel_beam_search(step_fn: Callable, start_tokens: torch.Tensor, init_state,
                       noise: SamplerNoise, *, max_steps: int, beam_size: int,
                       end_index: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stochastic Beam Search (Kool et al. 2019; the reference's
    GumbelSampler): beam search over Gumbel-perturbed sequence scores,
    ``beam_size`` samples without replacement per row.

    Returns (sequences (B, K, T), their log-probs phi (B, K) in the step's
    dtype, their perturbed scores (B, K) f32), beams by descending perturbed
    score. JAX returns the first two; the perturbed scores stay inside its
    scan. JAX draws this Gumbel noise in its default dtype, f32
    (``jax.random.gumbel(key, shape)`` without a dtype), so the perturbed
    scores are f32 while phi keeps the log-probs' dtype."""
    dev = start_tokens.device
    z_noise, gumbel = _split_noise(noise, max_steps, dev)
    from_tensor = torch.is_tensor(z_noise)
    K, B = beam_size, start_tokens.shape[0]

    lp0, state = step_fn(start_tokens[:, None], _add_beam_dim(init_state),
                         first_noise(z_noise, 1))
    lp0 = lp0[:, 0, :]
    V = lp0.shape[-1]
    top_g, last_preds = lax_top_k(lp0 + _gumbel(gumbel, 0, (B, V), torch.float32, dev), K)
    last_phi = torch.gather(lp0, 1, last_preds)
    last_g = top_g
    state = _tile_beam(state, K)
    preds_t, bp_t = [last_preds], []

    for t in range(1, max_steps):
        lp, state2 = step_fn(last_preds, state, z_noise[t] if from_tensor else z_noise)
        lp = _cleaned_log_probs(lp, last_preds, end_index)
        phi = last_phi[..., None] + lp                                     # (B, K, V)
        g_phi = phi + _gumbel(gumbel, t, (B, K, V), torch.float32, dev)   # f32
        # condition on the maximum: shift the children so that their
        # maximum equals the parent's perturbed score. JAX's order of
        # operations: at the argmax child log1p(-1) = -inf gives g = last_g.
        z = g_phi.amax(dim=-1, keepdim=True)
        v = last_g[..., None] - g_phi + torch.log1p(
            -torch.exp(torch.clamp(g_phi - z, -30, 0)) + 1e-20)
        g_cond = last_g[..., None] - torch.clamp_min(v, 0) - torch.log1p(
            torch.exp(-torch.abs(v)))
        top_g, idx = lax_top_k(g_cond.reshape(B, K * V), K)
        beam_idx = torch.div(idx, V, rounding_mode="floor")
        last_preds = idx % V
        last_phi = torch.gather(phi.reshape(B, K * V), 1, idx)
        last_g = top_g
        state = type(state2)(*[pick_beams(x, beam_idx) for x in state2])
        preds_t.append(last_preds)
        bp_t.append(beam_idx)

    backptrs = (torch.stack(bp_t) if bp_t
                else torch.zeros((0, B, K), dtype=torch.long, device=dev))
    return reconstruct_sequences(torch.stack(preds_t), backptrs), last_phi, last_g
