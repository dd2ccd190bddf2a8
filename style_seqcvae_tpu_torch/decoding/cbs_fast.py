"""Constrained beam search through the FSM default/exception decomposition
(counterpart of ``style_seqcvae_tpu/decoding/cbs_fast.py``).

Every FSM state has a default destination for almost the whole vocabulary
plus a few exception tokens (constraint wordforms) with explicit
destinations. Each step therefore needs one vocabulary-wide selection per
beam row: the unmasked top-(pnbs + E) and the row's logsumexp, from which
the exceptions are filtered on tiny tensors (exact, since a state has at
most E exception tokens). Four selections, one for each branch of the
JAX search:

* ``"prehead"``: the step returns the tied head's pre-embedding activation
  (…, E) and :func:`matmul_top_k_with_lse` (kernel A) fuses the vocabulary
  matmul into the selection, so the (rows, V) logits never exist;
* ``"fused"``: the step returns raw logits and :func:`top_k_with_lse`
  (kernel B) selects over them in one pass;
* ``"raw"``: the JAX harness's route (``raw_step=True``): the exception
  tokens are masked out of the raw logits with a static (B, S, V) mask, a
  ``small_top_k`` picks the defaults and only the picked values get the
  ``-logz`` correction;
* ``"logprob"``: the step returns log-probs; ended beams are frozen before
  the selection (``_cleaned_log_probs``), where the three raw-logit
  selections freeze after it.

The numpy FSM packers are copies of the JAX package's (``:39-118``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.beam_search import (
    _cleaned_log_probs,
    check_noise,
    pick_beams,
    reconstruct_sequences,
)
from style_seqcvae_tpu_torch.device import as_tensor
from style_seqcvae_tpu_torch.ops.kernels.topk_lse import top_k_with_lse
from style_seqcvae_tpu_torch.ops.kernels.vocab_topk_lse import matmul_top_k_with_lse
from style_seqcvae_tpu_torch.ops.topk import small_top_k, top_k
from style_seqcvae_tpu_torch.utils.tracing import (
    CBS_FINISH,
    CBS_SEARCH,
    CBS_SELECT,
    CBS_SETUP,
    span,
)

MASK_VAL = -1e20
SELECTIONS = ("prehead", "fused", "raw", "logprob")
# the selections whose step returns ((logits, logz), state)
RAW_SELECTIONS = ("fused", "raw")


class FSMTables(NamedTuple):
    """Exception-form FSM. Batch-leading shapes: default_dest (B, S);
    exc_token / exc_dest (B, S, E) integers; exc_valid (B, S, E) bool.
    numpy arrays when packed, tensors inside the search."""
    default_dest: Union[np.ndarray, torch.Tensor]
    exc_token: Union[np.ndarray, torch.Tensor]
    exc_dest: Union[np.ndarray, torch.Tensor]
    exc_valid: Union[np.ndarray, torch.Tensor]


def pack_exception_entries(default_dest: np.ndarray, entries,
                           max_exceptions: int = 0) -> FSMTables:
    """Pack per-state ``[(token, dest)]`` rows (mask-only entries use dest -1;
    E = longest row or 1; padding is (0, 0, valid False))."""
    S = default_dest.shape[0]
    E = max_exceptions or max((len(r) for r in entries), default=1) or 1
    exc_token = np.zeros((S, E), np.int32)
    exc_dest = np.zeros((S, E), np.int32)
    exc_valid = np.zeros((S, E), bool)
    for s, row in enumerate(entries):
        if len(row) > E:
            raise ValueError(f"state {s} has {len(row)} exceptions > E={E}")
        for j, (v, d) in enumerate(row):
            exc_token[s, j], exc_dest[s, j], exc_valid[s, j] = v, d, True
    return FSMTables(default_dest, exc_token, exc_dest, exc_valid)


def fsm_to_tables(fsm_dense: np.ndarray, max_exceptions: int = 0) -> FSMTables:
    """Dense (S, S, V) adjacency → exception form."""
    S, _, V = fsm_dense.shape
    default_dest = np.zeros((S,), np.int32)
    entries = []
    for s in range(S):
        counts = fsm_dense[s].sum(axis=1)       # transitions per destination
        d = int(np.argmax(counts)) if counts.sum() > 0 else s
        default_dest[s] = d
        other = (fsm_dense[s].sum(axis=0) - fsm_dense[s, d]) > 0
        no_default = fsm_dense[s, d] == 0
        row = []
        for v in np.where(other | no_default)[0]:
            dests = np.where(fsm_dense[s, :, v])[0]
            if len(dests) == 0:
                # dead token: still masked out of the default transition
                row.append((int(v), -1))
            for dest in dests:
                row.append((int(v), int(dest)))
        entries.append(row)
    return pack_exception_entries(default_dest, entries, max_exceptions)


def stack_fsm_tables(tables, pad_exceptions: int = 0) -> FSMTables:
    """Stack per-image FSMTables (padding E) into batch-leading numpy arrays."""
    E = max(pad_exceptions, max(t.exc_token.shape[-1] for t in tables))

    def pad(t: FSMTables) -> FSMTables:
        pw = [(0, 0), (0, E - t.exc_token.shape[-1])]
        return FSMTables(t.default_dest, np.pad(t.exc_token, pw),
                         np.pad(t.exc_dest, pw), np.pad(t.exc_valid, pw))

    ts = [pad(t) for t in tables]
    return FSMTables(*[np.stack([getattr(t, f) for t in ts]) for f in FSMTables._fields])


def fsm_to_device(fsm: FSMTables, device: torch.device) -> FSMTables:
    """numpy (or tensor) tables → tensors on ``device`` (long / bool)."""
    return FSMTables(*[as_tensor(t, device, torch.bool if f == "exc_valid" else torch.long)
                       for f, t in zip(FSMTables._fields, fsm)])


def _map_state(fn, state):
    return type(state)(*[fn(t) for t in state])


def constrained_beam_search_fast(
    step_fn: Callable,
    start_tokens: torch.Tensor,   # (B,)
    init_state,                   # NamedTuple of (B, ...) tensors
    fsm: FSMTables,               # tensors, batch-leading (B, S[, E])
    noise,                        # (max_steps, B, S, K, z) tensor or torch.Generator
    *,
    max_steps: int,
    beam_size: int,
    per_node_beam_size: int = 0,
    end_index: int,
    selection: str = "prehead",
    embedding: torch.Tensor = None,
    finish: Optional[Callable] = None,
):
    """Returns (sequences (B, S, K, T), log-probs (B, S, K)), or what
    ``finish`` makes of them: the caller's last work on the beams (the
    harness's best-beam selection), run inside the search's
    ``ssc.cbs.finish`` span (``utils/tracing.py``).

    ``selection="prehead"``: ``step_fn`` returns the (…, E) pre-embedding
    activation and ``embedding`` (V, E) is the tied table. ``"fused"`` and
    ``"raw"``: ``step_fn`` returns ``((logits, logz), state)``.
    ``"logprob"``: it returns ``(log_probs, state)``. ``noise`` rows are
    handed to the step as its z-noise (row t at step t; row 0 cut to
    ``[:, :1, :1]``); a ``torch.Generator`` is handed on as it is, and the
    step draws from it. The raw-logit selections freeze ended beams after
    the selection (valid because the end token is never a constraint
    wordform, so it always takes the default transition), ``"logprob"``
    before it."""
    if selection not in SELECTIONS:
        raise ValueError(f"selection must be one of {SELECTIONS}, got {selection!r}")
    if selection == "prehead" and embedding is None:
        raise ValueError("prehead selection needs the tied embedding table (V, E)")
    with span(CBS_SETUP):
        check_noise(noise, max_steps, start_tokens.device)
        from_tensor = torch.is_tensor(noise)
        B, S = fsm.default_dest.shape
        E = fsm.exc_token.shape[-1]
        K = beam_size
        pnbs = per_node_beam_size or beam_size
        dev = start_tokens.device
        states = torch.arange(S, device=dev)
        bidx = torch.arange(B, device=dev)
        # the search's constants, filled on the device once a decode
        neg_inf = torch.full((), float("-inf"), device=dev)

        # ---- first step: transitions from state 0 ----------------------------
        k0 = noise[0][:, :1, :1] if from_tensor else noise
        out0, state = step_fn(start_tokens[:, None, None],
                              _map_state(lambda t: t[:, None, None], init_state), k0)
        if selection == "prehead":
            # B rows only: the (B, V) logits are cheap to materialise here
            logits0 = torch.matmul(out0[:, 0, 0, :].float(), embedding.float().T)
            lp0 = logits0 - torch.logsumexp(logits0, dim=-1, keepdim=True)
        elif selection in RAW_SELECTIONS:
            logits0, logz0 = out0
            lp0 = logits0[:, 0, 0, :].float() - logz0[:, 0, 0, None]
        else:
            lp0 = out0[:, 0, 0, :]
        V = lp0.shape[-1]

        # additive scatter, then > 0: a padding entry (token 0, valid False) and a
        # real token-0 exception land on the same index, and accumulate ORs them
        exc_mask0 = torch.zeros((B, V), dtype=torch.int32, device=dev)
        exc_mask0.index_put_((bidx[:, None].expand(B, E), fsm.exc_token[:, 0, :]),
                             fsm.exc_valid[:, 0, :].to(torch.int32), accumulate=True)
        def0_lp, def0_cls = small_top_k(torch.where(exc_mask0 > 0, neg_inf, lp0), K)
        exc0_lp = torch.where(fsm.exc_valid[:, 0, :],
                              torch.gather(lp0, -1, fsm.exc_token[:, 0, :]), neg_inf)

        d0 = fsm.default_dest[:, 0]
        def_part = torch.where((d0[:, None] == states[None, :])[:, :, None],
                               def0_lp[:, None, :], neg_inf)                  # (B, S, K)
        exc_part = torch.where(fsm.exc_dest[:, 0, None, :] == states[None, :, None],
                               exc0_lp[:, None, :], neg_inf)                  # (B, S, E)
        cand0 = torch.cat([def_part, exc_part], dim=-1)
        cand0_cls = torch.cat([def0_cls[:, None, :].expand(B, S, K),
                               fsm.exc_token[:, 0, None, :].expand(B, S, E)], dim=-1)
        last_lp, idx0 = small_top_k(cand0, K)                                 # (B, S, K)
        last_lp = last_lp.float()
        last_preds = torch.gather(cand0_cls, -1, idx0)
        preds_t = [last_preds.reshape(B, S * K)]
        bp_t = []

        state = _map_state(lambda t: t.expand((B, S, K) + tuple(t.shape[3:])).contiguous(), state)

        end_pattern = torch.full((pnbs,), MASK_VAL, device=dev)
        end_pattern.narrow(0, 0, 1).fill_(0.0)
        mask_val = torch.full((), MASK_VAL, device=dev)
        if selection == "prehead":
            # exception-token embedding rows are step-constant: gather them once
            exc_emb = (embedding[fsm.exc_token].float()
                       * fsm.exc_valid[..., None].float())                   # (B, S, E, Ed)
        exc_tok_k = fsm.exc_token[:, :, None, :].expand(B, S, K, E)
        k_tot = pnbs + E
        if selection in ("raw", "logprob"):
            # static per-state exception mask over the vocabulary, by the same
            # additive scatter as exc_mask0
            exc_vocab_mask = torch.zeros((B, S, V), dtype=torch.int32, device=dev)
            exc_vocab_mask.index_put_((bidx[:, None, None].expand(B, S, E),
                                       states[None, :, None].expand(B, S, E), fsm.exc_token),
                                      fsm.exc_valid.to(torch.int32), accumulate=True)
            exc_vocab_mask = (exc_vocab_mask > 0)[:, :, None, :]              # (B, S, 1, V)

    def default_from_topk(tvals, tidx, logz):
        """Drop exception tokens from an unmasked top-(pnbs + E); exact,
        since a state has at most E exception tokens."""
        is_exc = ((tidx[..., :, None] == fsm.exc_token[:, :, None, None, :])
                  & fsm.exc_valid[:, :, None, None, :]).any(dim=-1)
        def_l, pos = small_top_k(torch.where(is_exc, mask_val, tvals), pnbs)
        return def_l - logz[..., None], torch.gather(tidx, -1, pos)

    for t in range(1, max_steps):
        out, new_state = step_fn(last_preds, state, noise[t] if from_tensor else noise)
        with span(CBS_SELECT):
            if selection == "prehead":
                proj = out                                                    # (B, S, K, Ed)
                tvals, tidx, lse = matmul_top_k_with_lse(
                    proj.reshape(B * S * K, -1).contiguous(), embedding, k_tot)
                exc_l = torch.matmul(proj.float(), exc_emb.transpose(-1, -2))  # (B, S, K, E)
            elif selection == "fused":
                logits, _ = out
                tvals, tidx, lse = top_k_with_lse(logits.reshape(B * S * K, V).contiguous(), k_tot)
                exc_l = torch.gather(logits, -1, exc_tok_k).float()
            if selection in ("prehead", "fused"):
                logz = lse.reshape(B, S, K)
                def_lp, def_cls = default_from_topk(tvals.reshape(B, S, K, k_tot),
                                                    tidx.reshape(B, S, K, k_tot).long(), logz)
                exc_lp = torch.where(fsm.exc_valid[:, :, None, :], exc_l - logz[..., None],
                                     mask_val)
            elif selection == "raw":
                logits, logz = out
                def_l, def_cls = small_top_k(torch.where(exc_vocab_mask, mask_val, logits), pnbs)
                def_lp = def_l.float() - logz[..., None]
                # JAX takes the exception logits by a one-hot einsum, because a
                # gather along the lanes is slow on a TPU; the gather returns
                # the same values
                exc_l = torch.gather(logits, -1, exc_tok_k).float()
                exc_lp = torch.where(fsm.exc_valid[:, :, None, :], exc_l - logz[..., None],
                                     mask_val)
            else:
                cleaned = _cleaned_log_probs(out, last_preds, end_index)
                def_lp, def_cls = small_top_k(torch.where(exc_vocab_mask, mask_val, cleaned), pnbs)
                exc_lp = torch.where(fsm.exc_valid[:, :, None, :],
                                     torch.gather(cleaned, -1, exc_tok_k), mask_val)

            if selection != "logprob":
                # end freezing after the selection: ended beams emit end with
                # log-prob 0 (the log-prob branch froze them before it)
                ended = (last_preds == end_index)[..., None]
                def_lp = torch.where(ended, end_pattern, def_lp)
                def_cls = torch.where(ended, torch.full_like(def_cls, end_index), def_cls)
                exc_lp = torch.where(ended, mask_val, exc_lp)

        with span(CBS_SEARCH):
            # candidates per (target state, source state, beam), on tiny tensors
            dmask = fsm.default_dest[:, None, :] == states[None, :, None]     # (B, S_to, S_from)
            def_c = torch.where(dmask[:, :, :, None, None], def_lp[:, None], mask_val)
            emask = fsm.exc_dest[:, None, :, :] == states[None, :, None, None]  # (B, S_to, S_from, E)
            exc_c = torch.where(emask[:, :, :, None, :], exc_lp[:, None], mask_val)
            cand = torch.cat([def_c, exc_c], dim=-1)           # (B, S_to, S_from, K, pnbs + E)
            top_lp, top_idx = small_top_k(cand, pnbs)
            cand_cls = torch.cat([def_cls[:, None].expand(B, S, S, K, pnbs),
                                  fsm.exc_token[:, None, :, None, :].expand(B, S, S, K, E)],
                                 dim=-1)
            top_cls = torch.gather(cand_cls, -1, top_idx)
            summed = top_lp.float() + last_lp[:, None, :, :, None]
            new_lp, idx = top_k(summed.reshape(B, S, S * K * pnbs), K)         # (B, S_to, K)
            new_preds = torch.gather(top_cls.reshape(B, S, S * K * pnbs), 2, idx)
            backptr = torch.div(idx, pnbs, rounding_mode="floor").reshape(B, S * K)
            state = _map_state(lambda x: pick_beams(x.reshape((B, S * K) + tuple(x.shape[3:])),
                                                    backptr).reshape(x.shape), new_state)
            last_preds, last_lp = new_preds, new_lp
            preds_t.append(new_preds.reshape(B, S * K))
            bp_t.append(backptr)

    with span(CBS_FINISH):
        backptrs = torch.stack(bp_t) if bp_t else torch.zeros((0, B, S * K), dtype=torch.long,
                                                              device=dev)
        sequences = reconstruct_sequences(torch.stack(preds_t), backptrs)
        out = sequences.reshape(B, S, K, max_steps), last_lp
        return finish(*out) if finish else out
