"""Beam search and greedy decoding with AllenNLP semantics (counterpart of
``style_seqcvae_tpu/decoding/beam_search.py``).

The JAX package scans a static step count; here the steps are a Python
loop. Ended beams are frozen (they emit ``end`` with log-prob 0), which
gives the same sequences and scores as stopping early. Beams tie-break as
``lax.top_k`` and the reference's ``small_top_k`` do (``ops/topk.py``), and
scores accumulate in f32.

z-noise (``noise``) is a tensor of ``max_steps`` rows, row t handed to the
step at step t, or a ``torch.Generator`` that the step draws from. The
first step's grid is (B, 1): a row 0 of three dims, (B, K', z), is cut to
its first beam, ``[:, :1]``. On every input the JAX functions accept (rows
that broadcast to (B, 1, z)) that cut changes nothing. It also lets a
(max_steps, B, K, z) stack hold, in row 0's first beam, the (B, 1, z) draw
that the JAX step makes from its first key, and in its later rows the
(B, K, z) draws of the later keys: the layout that reproduces a decode
driven by PRNG keys.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from style_seqcvae_tpu_torch.ops.topk import small_top_k, top_k

Noise = Union[torch.Tensor, torch.Generator]


def check_noise(noise: Noise, max_steps: int, device: torch.device) -> None:
    """Raise on z-noise the searches cannot use: a tensor that is not
    floating, lies on another device or has a row count other than
    ``max_steps``, or a generator on another device type."""
    if isinstance(noise, torch.Generator):
        if noise.device.type != device.type:
            raise ValueError(f"noise generator on {noise.device}, decode on {device}")
        return
    if not torch.is_tensor(noise) or not noise.is_floating_point():
        raise ValueError(f"noise must be a floating tensor or a torch.Generator, got "
                         f"{getattr(noise, 'dtype', type(noise))}")
    if noise.device != device:
        raise ValueError(f"noise on {noise.device}, decode on {device}")
    if noise.dim() < 1 or noise.shape[0] != max_steps:
        raise ValueError(f"noise must have max_steps={max_steps} rows, got "
                         f"{tuple(noise.shape)}")


def first_noise(noise: Noise, cut: int) -> Noise:
    """Row 0 of a noise stack, its first grid dims beyond the batch cut to 1
    (``cut`` of them) when the row carries them; a generator as it is."""
    if isinstance(noise, torch.Generator):
        return noise
    row = noise[0]
    if row.dim() == 2 + cut:
        row = row[(slice(None),) + (slice(0, 1),) * cut]
    return row


def _cleaned_log_probs(log_probs: torch.Tensor, last_preds: torch.Tensor,
                       end_index: int) -> torch.Tensor:
    """Freeze ended beams: once a beam emitted ``end`` it can only emit
    ``end`` again, with log-prob 0."""
    after_end = torch.full((log_probs.shape[-1],), float("-inf"), dtype=log_probs.dtype,
                           device=log_probs.device)
    after_end.narrow(0, end_index, 1).fill_(0.0)
    return torch.where((last_preds == end_index)[..., None], after_end, log_probs)


def reconstruct_sequences(predictions: torch.Tensor, backpointers: torch.Tensor) -> torch.Tensor:
    """predictions (T, B, K); backpointers (T-1, B, K) → (B, K, T) by the
    reverse backpointer walk."""
    T, B, K = predictions.shape
    beam = torch.arange(K, device=predictions.device).expand(B, K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(predictions[t], 1, beam)
        if t > 0:
            beam = torch.gather(backpointers[t - 1], 1, beam)
    return torch.stack(out, dim=-1)


def _add_beam_dim(state):
    return type(state)(*[t[:, None] for t in state])


def _tile_beam(state, k: int):
    return type(state)(*[t.expand((t.shape[0], k) + tuple(t.shape[2:])) for t in state])


def pick_beams(x: torch.Tensor, backptr: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) rows reordered along dim 1 by backptr (B, K)."""
    ind = backptr.reshape(tuple(backptr.shape) + (1,) * (x.dim() - 2)).expand(
        tuple(backptr.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, ind)


def beam_search(
    step_fn: Callable,
    start_tokens: torch.Tensor,   # (B,)
    init_state,                   # NamedTuple of (B, ...) tensors, no beam dim
    noise: Noise,
    *,
    max_steps: int,
    beam_size: int,
    per_node_beam_size: int = 0,
    end_index: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (predictions (B, K, T), log-probs (B, K)).

    ``step_fn(tokens, state, noise_row) -> (log_probs, new_state)`` on tokens
    of shape (B, ...) with matching state (``captioner.make_step_fn`` or
    ``make_optimized_step_fn`` with the log-prob contract). Backpointer =
    flat index // ``per_node_beam_size`` (default ``beam_size``)."""
    check_noise(noise, max_steps, start_tokens.device)
    K = beam_size
    pnbs = per_node_beam_size or beam_size
    B = start_tokens.shape[0]
    from_tensor = torch.is_tensor(noise)

    start_lp, state = step_fn(start_tokens[:, None], _add_beam_dim(init_state),
                              first_noise(noise, 1))
    last_lp, last_preds = top_k(start_lp[:, 0, :], K)                   # (B, K)
    last_lp = last_lp.float()
    state = _tile_beam(state, K)
    preds_t, bp_t = [last_preds], []

    for t in range(1, max_steps):
        log_probs, new_state = step_fn(last_preds, state, noise[t] if from_tensor else noise)
        cleaned = _cleaned_log_probs(log_probs, last_preds, end_index)
        top_lp, top_classes = small_top_k(cleaned, pnbs)                   # (B, K, pnbs)
        summed = top_lp.float() + last_lp[..., None]
        last_lp, flat_idx = top_k(summed.reshape(B, K * pnbs), K)          # (B, K)
        last_preds = torch.gather(top_classes.reshape(B, K * pnbs), 1, flat_idx)
        backptr = torch.div(flat_idx, pnbs, rounding_mode="floor")
        state = type(new_state)(*[pick_beams(x, backptr) for x in new_state])
        preds_t.append(last_preds)
        bp_t.append(backptr)

    backptrs = (torch.stack(bp_t) if bp_t
                else torch.zeros((0, B, K), dtype=torch.long, device=start_tokens.device))
    return reconstruct_sequences(torch.stack(preds_t), backptrs), last_lp


def greedy_decode(step_fn: Callable, start_tokens: torch.Tensor, init_state, noise: Noise,
                  *, max_steps: int, end_index: int) -> torch.Tensor:
    """Greedy (beam 1) decode → (B, T); ended rows keep emitting ``end``."""
    check_noise(noise, max_steps, start_tokens.device)
    from_tensor = torch.is_tensor(noise)
    lp, state = step_fn(start_tokens[:, None], _add_beam_dim(init_state),
                        first_noise(noise, 1))
    last = torch.argmax(lp[:, 0, :], dim=-1)
    toks = [last]
    for t in range(1, max_steps):
        lp, state = step_fn(last[:, None], state, noise[t] if from_tensor else noise)
        nxt = torch.argmax(lp[:, 0, :], dim=-1)
        last = torch.where(last == end_index, torch.full_like(nxt, end_index), nxt)
        toks.append(last)
    return torch.stack(toks, dim=1)
