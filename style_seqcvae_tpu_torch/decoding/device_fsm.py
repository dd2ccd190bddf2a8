"""CBS constraint selection and FSM table construction on the device
(counterpart of ``style_seqcvae_tpu/decoding/device_fsm.py``).

For the ``cbs_simple`` mode the constraints are single-word attribute
wordforms (at most five single-token forms an attribute), so choosing them
from the detector's outputs and building the exception-form FSM tables are
gathers and arithmetic on the card, with no host round trip between the
detector and the decode (``serving.py``).

* **Selection** mirrors the host ``cbs_simple`` path: one random attribute
  for each detected object class (attributes unioned over the class's
  boxes, deduplicated by cleaned name), up to ``max_constraints`` objects
  in descending detection-score order. The random pick is an argmax over
  Gumbel noise that the caller draws or hands in, batched over the FSM
  samples and the images (JAX vmaps over them and draws from PRNG keys).
* **Tables**: S = 2**k main states; a word picked by two objects is wired
  into both constraint bits (JAX ``:29-36``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.cbs_fast import FSMTables

MAX_WORDFORMS = 5   # the longest row of constraint_wordforms_attribs_exp.tsv

ArrayLike = Union[np.ndarray, torch.Tensor]


class AttributeWordformTable(NamedTuple):
    """Lookup tables of one vocabulary, built once on the host.

    tokens     (A, W) int32: vocabulary ids of attribute ``a``'s cleaned
               name's wordforms (rows gathered through ``canonical``);
    valid      (A, W) bool: which wordform slots are real;
    selectable (A,) bool: whitelisted and with wordforms;
    canonical  (A,) int32: the lowest attribute id with the same cleaned
               name (the host selection works on a set of cleaned names).
    """
    tokens: ArrayLike
    valid: ArrayLike
    selectable: ArrayLike
    canonical: ArrayLike


def clean_attribute_name(name: str) -> str:
    """The reference's attribute-name cleanup: the last space-separated
    token, the second-to-last when the name ends in a space."""
    parts = name.split(" ")
    return parts[-1] or parts[-2]


def build_attribute_wordform_table(att_id2name: Sequence[str],
                                   wordforms: Dict[str, List[str]], vocabulary,
                                   max_wordforms: int = MAX_WORDFORMS
                                   ) -> AttributeWordformTable:
    """The :class:`AttributeWordformTable` (numpy) of the attribute head's
    names ``att_id2name`` (COCO-Attributes index order) and ``wordforms``
    (cleaned name → forms; ``FiniteStateMachineBuilder.wordforms``, whose
    whitelist pruning is applied). Multi-token wordforms are dropped with a
    warning."""
    A = len(att_id2name)
    tokens = np.zeros((A, max_wordforms), np.int32)
    valid = np.zeros((A, max_wordforms), bool)
    selectable = np.zeros((A,), bool)
    canonical = np.arange(A, dtype=np.int32)
    first_by_clean: Dict[str, int] = {}
    dropped_multitoken = 0
    for a, name in enumerate(att_id2name):
        cleaned = clean_attribute_name(name)
        canonical[a] = first_by_clean.setdefault(cleaned, a)
        forms = wordforms.get(cleaned)
        if not forms:
            continue
        single = [w for w in forms if " " not in w.strip()]
        dropped_multitoken += len(forms) - len(single)
        single = single[:max_wordforms]
        if not single:
            continue
        selectable[a] = True
        for j, w in enumerate(single):
            tokens[a, j] = vocabulary.get_token_index(w)
            valid[a, j] = True
    if dropped_multitoken:
        warnings.warn(f"build_attribute_wordform_table: dropped {dropped_multitoken} "
                      "multi-token wordforms (the device tables take single-token forms only)")
    # canonical rows carry the wordforms; aliases gather through them
    return AttributeWordformTable(tokens=tokens[canonical], valid=valid[canonical],
                                  selectable=selectable[canonical], canonical=canonical)


def table_to_device(table: AttributeWordformTable, device: torch.device
                    ) -> AttributeWordformTable:
    """The table's arrays as tensors on ``device`` (tokens and canonical
    long, valid and selectable bool)."""
    kinds = {"tokens": torch.long, "valid": torch.bool, "selectable": torch.bool,
             "canonical": torch.long}
    return AttributeWordformTable(*[torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                                    else x, device=device).to(kinds[f])
                                    for f, x in zip(AttributeWordformTable._fields, table)])


def draw_gumbel(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise in f32 on the generator's device:
    -log(-log(u)), u uniform in [tiny, 1), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def select_attribute_constraints(class_ids: torch.Tensor, valid: torch.Tensor,
                                 att_scores: torch.Tensor, table: AttributeWordformTable,
                                 gumbel: Union[torch.Tensor, torch.Generator], *,
                                 n_fsm: int = 1, att_thresh: float = 0.3,
                                 max_constraints: int = 3
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cbs_simple selection for a batch of images and ``n_fsm`` FSM
    samples each. class_ids (B, M), valid (B, M) and att_scores (B, M, A)
    are ``select_detections_device``'s outputs (descending detection
    score). ``gumbel``: (n_fsm, B, max_constraints, A) noise (JAX draws
    ``gumbel(key, (max_constraints, A))`` for each (sample, image)), or a
    generator that draws it.

    Returns (att_ids (n_fsm, B, max_constraints) long, canonical attribute
    ids with -1 padding, for :func:`build_tables_device`; num_given (B,)
    long, the same for every sample)."""
    dev = att_scores.device
    table = table_to_device(table, dev)
    B, M, A = att_scores.shape
    k = max_constraints
    if isinstance(gumbel, torch.Generator):
        gumbel = draw_gumbel((n_fsm, B, k, A), gumbel)
    if tuple(gumbel.shape) != (n_fsm, B, k, A):
        raise ValueError(f"gumbel must be ({n_fsm}, {B}, {k}, {A}), got {tuple(gumbel.shape)}")

    present = (att_scores > att_thresh) & valid[..., None] & table.selectable
    # the host's set of cleaned names: OR onto the canonical ids
    present_c = torch.zeros((B, M, A), dtype=torch.uint8, device=dev).scatter_reduce(
        2, table.canonical.expand(B, M, A), present.to(torch.uint8), "amax")
    same = (class_ids[:, :, None] == class_ids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    # attributes unioned over the boxes of one class
    obj_att = torch.bmm(same.float(), present_c.float()) > 0                  # (B, M, A)
    idx = torch.arange(M, device=dev)
    earlier_same = same & (idx[None, :] < idx[:, None])
    first = valid & ~earlier_same.any(dim=2)
    cand = first & obj_att.any(dim=2)                                          # (B, M)
    rank = torch.cumsum(cand.long(), dim=1) - 1
    slot_onehot = cand[:, None, :] & (rank[:, None, :] == torch.arange(k, device=dev)[:, None])
    slot_valid = slot_onehot.any(dim=2)                                        # (B, k)
    slot_box = torch.argmax(slot_onehot.to(torch.uint8), dim=2)                # first True
    slot_att = torch.gather(obj_att, 1, slot_box[..., None].expand(B, k, A))   # (B, k, A)
    pick = torch.argmax(torch.where(slot_att, gumbel.float(), float("-inf")), dim=-1)
    att_ids = torch.where(slot_valid, pick, -1)
    return att_ids, slot_valid.sum(dim=1)


def build_tables_device(att_ids: torch.Tensor, table: AttributeWordformTable,
                        max_constraints: int = 3, num_states: int = 0) -> FSMTables:
    """Exception-form FSM tables for ``att_ids`` (..., k) canonical attribute
    ids (-1: none), batched over the leading dims: default_dest (..., S),
    exc_token / exc_dest (..., S, k·W) long, exc_valid (..., S, k·W) bool,
    with S = ``num_states`` or 2**k main states."""
    dev = att_ids.device
    table = table_to_device(table, dev)
    k = att_ids.shape[-1]
    if k > max_constraints:
        raise ValueError(f"{k} constraint slots > max_constraints {max_constraints}")
    S = num_states or 2 ** k
    if S < 2 ** k:
        raise ValueError(f"num_states {S} < 2**{k} main states")
    W = table.tokens.shape[1]
    lead = tuple(att_ids.shape[:-1])

    ids = att_ids.clamp(min=0)
    tok = table.tokens[ids]                                                    # (..., k, W)
    val = table.valid[ids] & (att_ids >= 0)[..., None]
    states = torch.arange(S, device=dev)
    bits = (states[:, None] >> torch.arange(k, device=dev)[None, :]) & 1     # (S, k)
    bit_vals = 1 << torch.arange(k, device=dev)
    exc_token = tok.reshape(lead + (1, k * W)).expand(lead + (S, k * W))
    exc_dest = (states[:, None] | bit_vals.repeat_interleave(W)[None, :]).expand(lead + (S, k * W))
    exc_valid = val.reshape(lead + (1, k * W)) & (bits == 0).repeat_interleave(W, dim=1)
    return FSMTables(default_dest=states.expand(lead + (S,)), exc_token=exc_token,
                     exc_dest=exc_dest, exc_valid=exc_valid)


def tables_for_samples(att_ids: torch.Tensor, table: AttributeWordformTable, n_z: int,
                       max_constraints: int = 3) -> FSMTables:
    """(n_fsm, B, k) att_ids → (n_z, B, S[, E]) tables: one FSM for each z
    sample when n_fsm == n_z, one shared by every sample when n_fsm == 1."""
    tables = build_tables_device(att_ids, table, max_constraints)
    if att_ids.shape[0] == n_z:
        return tables
    if att_ids.shape[0] != 1:
        raise ValueError(f"att_ids hold {att_ids.shape[0]} FSM samples for {n_z} z-samples")
    return FSMTables(*[t.expand((n_z,) + tuple(t.shape[1:])) for t in tables])
