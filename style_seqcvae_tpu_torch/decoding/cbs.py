"""Constrained beam search over a packed FSM bitmask (counterpart of
``style_seqcvae_tpu/decoding/cbs.py``): the dense form of the search, which
selects each target state's candidates in turn over the whole vocabulary.

Semantics as the JAX package's: the first step masks with -inf from state
0, later steps mask with -1e20 after freezing ended beams
(``_cleaned_log_probs``), each (source state, beam) keeps its top
``per_node_beam_size`` tokens into the target state, a flat top-k over the
``S·K·pnbs`` candidates keeps ``beam_size`` beams, and backpointer = flat
index // ``per_node_beam_size``. Ties break as ``lax.top_k``'s
(``ops/topk.py::top_k``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.beam_search import (
    Noise,
    _cleaned_log_probs,
    check_noise,
    first_noise,
    pick_beams,
    reconstruct_sequences,
)
from style_seqcvae_tpu_torch.ops.topk import top_k

MASK_VAL = -1e20


def fsm_bits(fsm_packed, device: torch.device) -> torch.Tensor:
    """(B, S, V) uint32 destination bitmask (numpy or tensor) → (S_to, B,
    S, V) bool on ``device``: entry [i, b, s, v] says token v moves state s
    to state i in image b."""
    if torch.is_tensor(fsm_packed):
        integer = not (fsm_packed.is_floating_point() or fsm_packed.is_complex()
                       or fsm_packed.dtype == torch.bool)
    else:
        fsm_packed = np.asarray(fsm_packed)
        integer = np.issubdtype(fsm_packed.dtype, np.integer)
    if not integer or fsm_packed.ndim != 3:
        raise ValueError(f"fsm_packed must be an integer (B, S, V) bitmask, got "
                         f"{fsm_packed.dtype} {tuple(fsm_packed.shape)}")
    if fsm_packed.shape[1] > 32:
        raise ValueError(f"packed FSM supports <=32 states, got {fsm_packed.shape[1]}")
    packed = (fsm_packed.to(device).long() if torch.is_tensor(fsm_packed)
              else torch.from_numpy(fsm_packed.astype(np.int64)).to(device))
    packed = packed & 0xFFFFFFFF          # int32 input: bit 31 reads as the sign
    shifts = torch.arange(packed.shape[1], device=device)[:, None, None, None]
    return ((packed[None] >> shifts) & 1).bool()


def constrained_beam_search(
    step_fn: Callable,
    start_tokens: torch.Tensor,   # (B,)
    init_state,                   # NamedTuple of (B, ...) tensors
    fsm_packed,                   # (B, S, V) uint32 destination bitmask
    noise: Noise,                 # (max_steps, B, S, K, z) or torch.Generator
    *,
    max_steps: int,
    beam_size: int,
    per_node_beam_size: int = 0,
    end_index: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (predictions (B, S, K, T), log-probs (B, S, K)).

    ``step_fn(tokens, state, noise_row) -> (log_probs, new_state)`` on a
    (B, S, K) grid (the log-prob contract). ``noise`` row t goes to step t,
    row 0 cut to ``[:, :1, :1]`` as in ``cbs_fast``; a generator is handed
    on for the step to draw from."""
    dev = start_tokens.device
    check_noise(noise, max_steps, dev)
    bits = fsm_bits(fsm_packed, dev)                                    # (S_to, B, S, V)
    S, B, _, V = bits.shape
    if B != start_tokens.shape[0]:
        raise ValueError(f"fsm_packed is for {B} images, start_tokens for "
                         f"{start_tokens.shape[0]}")
    K = beam_size
    pnbs = per_node_beam_size or beam_size
    from_tensor = torch.is_tensor(noise)
    # constants filled on the device once a search (a copy from the host waits for the card)
    neg_inf = torch.full((), float("-inf"), device=dev)
    mask_val = torch.full((), MASK_VAL, device=dev)

    lp0, state = step_fn(start_tokens[:, None, None],
                         type(init_state)(*[t[:, None, None] for t in init_state]),
                         first_noise(noise, 2))
    lp0 = lp0[:, 0, 0, :]                                               # (B, V)
    firsts = [top_k(torch.where(bits[i, :, 0, :], lp0, neg_inf), K) for i in range(S)]
    last_lp = torch.stack([f[0] for f in firsts], dim=1).float()        # (B, S, K)
    last_preds = torch.stack([f[1] for f in firsts], dim=1)
    preds_t, bp_t = [last_preds.reshape(B, S * K)], []
    state = type(state)(*[t.expand((B, S, K) + tuple(t.shape[3:])) for t in state])

    for t in range(1, max_steps):
        log_probs, new_state = step_fn(last_preds, state, noise[t] if from_tensor else noise)
        cleaned = _cleaned_log_probs(log_probs, last_preds, end_index)
        new_lp, new_cls, new_bp = [], [], []
        for i in range(S):
            masked = torch.where(bits[i][:, :, None, :], cleaned, mask_val)
            top_lp, top_cls = top_k(masked, pnbs)                       # (B, S, K, pnbs)
            summed = top_lp.float() + last_lp[..., None]
            lp_i, idx = top_k(summed.reshape(B, S * K * pnbs), K)       # (B, K)
            new_lp.append(lp_i)
            new_cls.append(torch.gather(top_cls.reshape(B, S * K * pnbs), 1, idx))
            new_bp.append(torch.div(idx, pnbs, rounding_mode="floor"))
        last_lp = torch.stack(new_lp, dim=1)
        last_preds = torch.stack(new_cls, dim=1)
        backptr = torch.stack(new_bp, dim=1).reshape(B, S * K)          # in [0, S·K)
        state = type(new_state)(*[
            pick_beams(x.reshape((B, S * K) + tuple(x.shape[3:])), backptr).reshape(x.shape)
            for x in new_state])
        preds_t.append(last_preds.reshape(B, S * K))
        bp_t.append(backptr)

    backptrs = (torch.stack(bp_t) if bp_t
                else torch.zeros((0, B, S * K), dtype=torch.long, device=dev))
    sequences = reconstruct_sequences(torch.stack(preds_t), backptrs)
    return sequences.reshape(B, S, K, max_steps), last_lp
