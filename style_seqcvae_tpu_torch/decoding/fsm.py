"""Host-side finite-state machines for constrained beam search (copy of
``style_seqcvae_tpu/decoding/fsm.py:1-268``, numpy).

:class:`FiniteStateMachineBuilder` mirrors
updown-baseline/updown/utils/constraints.py:212-478: up to k = 3
constraints (2^k main states), up to w = 3 words per constraint through
sub-states, several wordforms per word, repeated constraints through the
``state_idxs`` bookkeeping (constraints.py:394-401), and the COCO-Attributes
wordform TSV merged into an "all" meta-class with the attribute whitelist
(constraints.py:305-327). ``build`` gives the dense (S, S, V) uint8
adjacency; ``build_tables`` replays the same assignments on a sparse
adjacency and gives the exception-form tables directly.

Bit ``i`` of ``pack_fsm(...)[s, v]`` says token ``v`` moves state ``s`` to
state ``i``: 32x smaller than the dense adjacency and general for
nondeterministic transitions (two constraints sharing a wordform).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

import numpy as np

from style_seqcvae_tpu_torch.decoding.cbs_fast import pack_exception_entries


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


class FiniteStateMachineBuilder:
    def __init__(
        self,
        vocabulary,
        wordforms_tsvpath: str = "",
        wordforms_attribs_tsvpath: str = "",
        max_given_constraints: int = 3,
        max_words_per_constraint: int = 3,
        use_coco_attributes: bool = False,
        attrib_selection: Optional[Dict[str, bool]] = None,
    ):
        self._vocabulary = vocabulary
        self._max_given_constraints = max_given_constraints
        self._max_words_per_constraint = max_words_per_constraint
        self._num_main_states = 2 ** max_given_constraints
        self._num_total_states = self._num_main_states * max_words_per_constraint

        self._wordforms: Dict[str, List[str]] = {}
        if wordforms_tsvpath:
            self._read_tsv(wordforms_tsvpath)
        if wordforms_attribs_tsvpath:
            self._read_tsv(wordforms_attribs_tsvpath)
            if use_coco_attributes and attrib_selection:
                # Merge selected attribute wordforms into an "all" meta-class
                # and prune deselected attributes (constraints.py:314-327).
                all_forms = set()
                for att, is_selected in attrib_selection.items():
                    att_cleaned = att.split(" ")[-1] or att.split(" ")[-2]
                    if not is_selected:
                        self._wordforms.pop(att_cleaned, None)
                    elif att_cleaned in self._wordforms:
                        all_forms.update(self._wordforms[att_cleaned])
                self._wordforms["all"] = sorted(all_forms)

    def _read_tsv(self, path: str) -> None:
        with open(path) as f:
            reader = csv.DictReader(f, delimiter="\t", fieldnames=["class_name", "words"])
            for row in reader:
                self._wordforms[row["class_name"]] = row["words"].split(",")

    def add_wordforms(self, class_name: str, forms: List[str]) -> None:
        self._wordforms[class_name] = list(forms)

    @property
    def wordforms(self) -> Dict[str, List[str]]:
        """class/attribute cleaned name → wordform list (whitelist-pruned);
        the input for device_fsm.build_attribute_wordform_table."""
        return self._wordforms

    @property
    def num_total_states(self) -> int:
        return self._num_total_states

    def build(self, constraints: List[str]) -> Tuple[np.ndarray, int, Dict[str, List[int]]]:
        """Returns ``(fsm_dense (S,S,V) uint8, next_substate_idx,
        constraint2states)`` — contract identical to constraints.py:329-361."""
        S, V = self._num_total_states, self._vocabulary.get_vocab_size()
        fsm = np.zeros((S, S, V), dtype=np.uint8)
        for s in range(self._num_main_states):
            fsm[s, s, :] = 1  # self-loops on main states for all words

        constraint2states: Dict[str, List[int]] = {}
        substate_idx = self._num_main_states
        state_idxs: Dict[str, List[int]] = {}
        for i, constraint in enumerate(constraints):
            fsm, substate_idx, main_states, state_idxs = self._add_nth_constraint(
                fsm, i + 1, substate_idx, constraint, 2 ** len(constraints), state_idxs)
            constraint2states[constraint] = main_states
        return fsm, substate_idx, constraint2states

    def _add_nth_constraint(self, fsm, n: int, substate_idx: int, constraint: str,
                            max_valid_states: int, state_idxs):
        """Bit-lattice wiring of the n-th constraint (constraints.py:363-425),
        including the repeated-constraint branch (:394-401)."""
        words = constraint.split()
        connection_stride = 2 ** (n - 1)
        main_states: List[int] = []

        if constraint in state_idxs:
            from_state = state_idxs[constraint][-1]
            from_state_max = from_state + 1
            state_idxs[constraint].append(n)
        else:
            from_state = 0
            from_state_max = self._num_main_states
            state_idxs[constraint] = [n]

        while from_state < from_state_max:
            for _ in range(connection_stride):
                word_from_state = from_state
                for i, word in enumerate(words):
                    if i != len(words) - 1:
                        fsm = self._connect(fsm, word_from_state, substate_idx, word,
                                            reset_state=from_state)
                        word_from_state = substate_idx
                        substate_idx += 1
                    else:
                        if from_state + connection_stride < max_valid_states:
                            main_states.append(from_state + connection_stride)
                        fsm = self._connect(fsm, word_from_state,
                                            from_state + connection_stride, word,
                                            reset_state=from_state)
                from_state += 1
            from_state += connection_stride
        return fsm, substate_idx, main_states, state_idxs

    def _connect(self, fsm, from_state: int, to_state: int, word: str,
                 reset_state: Optional[int] = None):
        """Wordform transitions + multi-word reset wiring
        (constraints.py:427-478)."""
        wordforms = self._wordforms[word]
        wordform_indices = [self._vocabulary.get_token_index(w) for w in wordforms]

        for wi in wordform_indices:
            fsm[from_state, to_state, wi] = 1
            fsm[from_state, from_state, wi] = 0

        if reset_state is not None:
            fsm[from_state, from_state, :] = 0
            fsm[from_state, reset_state, :] = 1
            for wi in wordform_indices:
                fsm[from_state, reset_state, wi] = 0
        return fsm

    def build_packed(self, constraints: List[str], num_states: Optional[int] = None
                     ) -> Tuple[np.ndarray, int, Dict[str, List[int]]]:
        """Build + pack, trimming to ``num_states`` (≥ used states) if given
        — the on-device format. Mirrors the collate-time trim at
        updown-baseline/updown/data/datasets.py:604-620."""
        fsm, used, c2s = self.build(constraints)
        S = num_states or used
        S = max(S, self._num_main_states)
        packed = pack_fsm(fsm[:S, :S, :])
        return packed, used, c2s

    def build_tables(self, constraints: List[str],
                     num_states: Optional[int] = None):
        """Build the exception-form FSMTables DIRECTLY — no dense
        (S, S, V) materialization. Replays exactly the assignment sequence
        of :meth:`_connect` against a sparse adjacency; the inference host
        path builds one FSM per (image, z-sample), so this is ~1000× less
        work than dense-build + convert.

        Returns ``(FSMTables, used_states, constraint2states)``."""
        sparse = _SparseAdjacency(self._num_main_states)
        constraint2states: Dict[str, List[int]] = {}
        substate_idx = self._num_main_states
        state_idxs: Dict[str, List[int]] = {}
        for i, constraint in enumerate(constraints):
            sparse, substate_idx, main_states, state_idxs = self._add_nth_constraint(
                sparse, i + 1, substate_idx, constraint, 2 ** len(constraints),
                state_idxs)
            constraint2states[constraint] = main_states

        S = max(num_states or substate_idx, self._num_main_states)
        default_dest = np.zeros((S,), np.int32)
        entries: List[List[Tuple[int, int]]] = []
        for s in range(S):
            d = sparse.default.get(s, s)
            d = s if d is None else d
            default_dest[s] = d
            row: List[Tuple[int, int]] = []
            for tok, dests in sorted(sparse.exc.get(s, {}).items()):
                dests = {t for t in dests if t < S}
                if dests == {d}:
                    continue  # identical to the default transition
                if not dests:
                    # dead token (destinations trimmed): mask-only entry so
                    # it stays excluded from the default transition
                    row.append((tok, -1))
                for t in sorted(dests):
                    row.append((tok, t))
            entries.append(row)

        return (pack_exception_entries(default_dest, entries),
                substate_idx, constraint2states)


class _SparseAdjacency:
    """Replays the dense assignment patterns of
    FiniteStateMachineBuilder._connect on a sparse representation:
    per-state default destination + {token: dest-set} exceptions.

    Supported keys (the only patterns _connect uses):
    ``[f, t, wi] = 1``, ``[f, f, wi] = 0``, ``[f, f, :] = 0``,
    ``[f, r, :] = 1``, ``[f, r, wi] = 0``."""

    def __init__(self, num_main: int):
        self.default: Dict[int, Optional[int]] = {s: s for s in range(num_main)}
        self.exc: Dict[int, Dict[int, set]] = {}

    def _domain(self, f: int, w: int) -> set:
        row = self.exc.setdefault(f, {})
        if w not in row:
            d = self.default.get(f)
            row[w] = set() if d is None else {d}
        return row[w]

    def __setitem__(self, key, value):
        f, t, w = key
        if isinstance(w, slice):          # fsm[f, t, :] = value
            if value == 0:
                # remove destination t for ALL tokens
                if self.default.get(f) == t:
                    self.default[f] = None
                for dests in self.exc.get(f, {}).values():
                    dests.discard(t)
            else:
                # add destination t for ALL tokens
                d = self.default.get(f)
                if d is None:
                    self.default[f] = t
                elif d != t:
                    raise NotImplementedError(
                        "dense-slice add with existing default — pattern "
                        "not produced by _connect")
                for dests in self.exc.get(f, {}).values():
                    dests.add(t)
            return
        dests = self._domain(f, w)
        if value == 0:
            dests.discard(t)
        else:
            dests.add(t)
