"""Beam selection after (constrained) beam search (counterpart of
``style_seqcvae_tpu/decoding/select.py``): the on-device cbs_simple
selection in torch, and copies of the host-side numpy selections that the
JAX inference CLI applies to all beams (``decode_cbs(..., return_all=True)``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def select_best_beam(beams, beam_log_probabilities):
    """(B, K, T) → (B, T): beams arrive sorted by likelihood."""
    return beams[:, 0, :]


def valid_state_mask_simple(num_states: int, given_constraints: torch.Tensor,
                            min_constraints_to_satisfy: int) -> torch.Tensor:
    """(B,) given-constraint counts → (B, S) bool: state s is valid iff
    popcount(s) >= min(given, min_to_satisfy) and s < 2**given."""
    dev = given_constraints.device
    s = torch.arange(num_states, device=dev)
    pop = ((s[:, None] >> torch.arange(32, device=dev)[None, :]) & 1).sum(dim=1)
    given = given_constraints.long()
    need = torch.clamp(given, max=min_constraints_to_satisfy)
    in_range = s[None, :] < (1 << given)[:, None]
    return (pop[None, :] >= need[:, None]) & in_range


def select_best_beam_simple(beams: torch.Tensor, lp: torch.Tensor,
                            given_constraints: torch.Tensor,
                            min_constraints_to_satisfy: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``select_best_beam_simple_jax``. beams (B, S, K, T),
    lp (B, S, K), given_constraints (B,) → (best (B, T), best_lp (B,)):
    beam 0 of the most likely valid state."""
    B, S, K, T = beams.shape
    valid = valid_state_mask_simple(S, given_constraints, min_constraints_to_satisfy)
    top_lp = torch.where(valid, lp[:, :, 0], float("-inf"))
    best_state = torch.argmax(top_lp, dim=1)
    best = beams[torch.arange(B, device=beams.device), best_state, 0, :]
    return best, top_lp.amax(dim=1)


def select_best_beam_with_constraints(
    beams: np.ndarray,                 # (B, S, K, T)
    beam_log_probabilities: np.ndarray,  # (B, S, K)
    given_constraints: Sequence[int],  # (B,)
    constraints: Optional[List[List]] = None,       # grounded mode
    constraint2states: Optional[List[Dict[str, List[int]]]] = None,
    min_constraints_to_satisfy: int = 2,
    cbs_simple: bool = True,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Host-side selection in both modes. Among the FSM states that satisfy
    enough constraints, the top beam of the most likely state. cbs_simple
    counts the set bits of the state id; the grounded mode needs, for an
    object with attributes, one of its attributes too.

    Returns ``(best_beams (B, T) int64, per-image arrays of valid top
    beams)``."""
    beams = np.asarray(beams)
    lp = np.asarray(beam_log_probabilities)
    B = beams.shape[0]
    best_beams, batch_valid_beams = [], []

    for i in range(B):
        given = int(given_constraints[i])
        if cbs_simple:
            valid_states = [s for s in range(2 ** given)
                            if bin(s).count("1") >= min(given, min_constraints_to_satisfy)]
        else:
            # each constraint is (object_name, [attribute names])
            n_states = 2 ** given
            states_objects = np.zeros(n_states, dtype=int)
            objects_with_attributes = np.zeros(n_states, dtype=int)
            for o in constraints[i]:
                states_object = np.zeros(n_states, dtype=int)
                states_object[constraint2states[i][o[0]]] = 1
                states_attributes = np.zeros(n_states, dtype=int)
                if not o[1]:
                    states_attributes[:] = 1
                else:
                    for a in o[1]:
                        sa = np.zeros(n_states, dtype=int)
                        sa[constraint2states[i][a]] = 1
                        states_attributes |= sa
                states_object &= states_attributes
                if not np.all(states_attributes):
                    objects_with_attributes |= states_object
                states_objects += states_object
            if np.any(objects_with_attributes):
                states_objects *= (np.clip(states_objects, 0, 1) & objects_with_attributes)
            valid_states = list(np.where(
                states_objects >= min(len(constraints[i]), min_constraints_to_satisfy))[0])

        valid_beams = beams[i, valid_states, 0, :]
        valid_lp = lp[i, valid_states, 0]
        batch_valid_beams.append(valid_beams)
        best_beams.append(valid_beams[int(np.argmax(valid_lp))])

    return np.stack(best_beams).astype(np.int64), batch_valid_beams
