"""Packed FSM layout for the dense constrained beam search (copy of
``style_seqcvae_tpu/decoding/fsm.py::pack_fsm`` and ``unpack_fsm``, numpy).

Bit ``i`` of ``packed[s, v]`` says token ``v`` moves state ``s`` to state
``i``: 32× smaller than the dense (S, S, V) adjacency and general for
nondeterministic transitions (two constraints sharing a wordform). The
FSM builder itself is not ported yet (ROADMAP A4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def pack_fsm(fsm_dense: np.ndarray) -> np.ndarray:
    """(S, S, V) {0,1} → (S, V) uint32 destination bitmask (S <= 32)."""
    S = fsm_dense.shape[0]
    if S > 32:
        raise ValueError(f"packed FSM supports <=32 states, got {S}")
    weights = (1 << np.arange(S, dtype=np.uint64))
    packed = (fsm_dense.astype(np.uint64) * weights[None, :, None]).sum(axis=1)
    return packed.astype(np.uint32)


def unpack_fsm(packed: np.ndarray, num_states: Optional[int] = None) -> np.ndarray:
    """(S, V) uint32 → (S, S', V) dense uint8 (inverse of :func:`pack_fsm`)."""
    S, V = packed.shape
    Sp = num_states or S
    bits = (packed[:, None, :] >> np.arange(Sp, dtype=np.uint32)[None, :, None]) & 1
    return bits.astype(np.uint8)
