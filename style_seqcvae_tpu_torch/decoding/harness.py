"""Diverse CBS decoding: n_z z-samples × constrained beam search over a batch
of images (counterpart of ``style_seqcvae_tpu/decoding/harness.py``).

The JAX harness vmaps the search over z. Here z is a batch dimension written
out: the search runs on B·n_z rows ordered image-major (row b·n_z + z), so a
view turns them into the (B, n_z, S, K) grid the step expects, and the image
features stay (B, N, F), never replicated per z or beam.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.cbs_fast import (
    FSMTables,
    constrained_beam_search_fast,
    fsm_to_device,
)
from style_seqcvae_tpu_torch.decoding.select import select_best_beam_simple
from style_seqcvae_tpu_torch.device import as_tensor, resolve_device
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    make_decode_context,
    make_optimized_step_fn,
)
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state


def _bucket(n: int, buckets=(8, 12, 16, 24, 32)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def pad_tables_batch(tables_per_image: List[List[FSMTables]], n_z: int) -> FSMTables:
    """Per-image per-z FSMTables → one (Z, B, S[, E]) numpy stack. S and E pad
    to shared bucket sizes; padded states self-loop; images with fewer than
    n_z tables repeat their last one."""
    per_image = [list(ts) for ts in tables_per_image]
    for ts in per_image:
        while len(ts) < n_z:
            ts.append(ts[-1])
    flat = [t for ts in per_image for t in ts]
    S = _bucket(max(t.default_dest.shape[0] for t in flat))
    E = _bucket(max(t.exc_token.shape[-1] for t in flat))

    def pad(t: FSMTables) -> FSMTables:
        s, e = t.default_dest.shape[0], t.exc_token.shape[-1]
        dd = np.concatenate([np.asarray(t.default_dest), np.arange(s, S, dtype=np.int32)])
        pw = [(0, S - s), (0, E - e)]
        return FSMTables(dd, np.pad(np.asarray(t.exc_token), pw),
                         np.pad(np.asarray(t.exc_dest), pw), np.pad(np.asarray(t.exc_valid), pw))

    padded = [[pad(t) for t in ts] for ts in per_image]
    return FSMTables(*[
        np.stack([np.stack([np.asarray(getattr(padded[b][z], f)) for b in range(len(padded))])
                  for z in range(n_z)])
        for f in FSMTables._fields])


def pad_tables(tables: List[FSMTables], n_z: int) -> FSMTables:
    """Single-image form of :func:`pad_tables_batch` → (Z, 1, S[, E])."""
    return pad_tables_batch([tables], n_z)


class DecodeHarness:
    def __init__(self, params: Dict[str, Any], cfg: CaptionerConfig,
                 device: Optional[Union[str, torch.device]] = None):
        """``params`` must already lie on ``device`` (``init_captioner`` or
        ``from_jax_params`` with the same device)."""
        self.device = resolve_device(device)
        if params["embedding"].device.type != self.device.type:
            raise ValueError(f"params on {params['embedding'].device}, harness on {self.device}")
        self.params = params
        self.cfg = cfg

    @torch.inference_mode()
    def decode_cbs(self, feats, sentiment, obj_att_embeds, tables, num_constraints,
                   noise: Union[np.ndarray, torch.Tensor, torch.Generator], n_z: int,
                   selection: str = "prehead", return_all: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``selection``: "prehead" (kernel A) or "fused" (kernel B).
        feats (B, N, F); sentiment (B, 1) or None; obj_att_embeds (B, N, z)
        or None; ``tables`` is per-z ``List[FSMTables]`` (B = 1), per-image
        ``List[List[FSMTables]]`` or an already padded (n_z, B, S[, E])
        FSMTables; num_constraints (B,), or fewer, whose first entry then
        holds for every image. ``noise``: z-noise in the JAX layout (n_z,
        max_steps, B, S, K, z), or a ``torch.Generator`` on the decode device
        that draws it.

        Returns (best (n_z, B, T), best_lp (n_z, B)), or all beams
        ((n_z, B, S, K, T), (n_z, B, S, K)) with ``return_all``."""
        cfg, dev = self.cfg, self.device
        dtype = self.params["embedding"].dtype
        feats = as_tensor(feats, dev, dtype)
        B = feats.shape[0]
        sentiment = as_tensor(sentiment, dev)
        obj_att_embeds = as_tensor(obj_att_embeds, dev, dtype)
        if isinstance(tables, FSMTables):
            stacked = tables
        elif tables and isinstance(tables[0], FSMTables):
            if B != 1:
                raise ValueError(f"a per-z List[FSMTables] is for one image, got B={B}; "
                                 "pass per-image lists for a batch")
            stacked = pad_tables(list(tables), n_z)
        else:
            stacked = pad_tables_batch(tables, n_z)
        fsm = fsm_to_device(stacked, dev)
        Z = fsm.default_dest.shape[0]
        if Z != n_z or fsm.default_dest.shape[1] != B:
            raise ValueError(f"tables are {tuple(fsm.default_dest.shape[:2])}, want ({n_z}, {B})")
        # (Z, B, ...) → image-major rows (B·Z, ...)
        fsm = FSMTables(*[t.transpose(0, 1).reshape((B * Z,) + tuple(t.shape[2:])) for t in fsm])
        nc = np.asarray(num_constraints).reshape(-1)
        nc = torch.as_tensor(np.repeat(nc[:1], B) if nc.size < B else nc[:B], device=dev)

        prehead = selection == "prehead"
        ctx = make_decode_context(self.params, cfg, feats, sentiment=sentiment,
                                  obj_att_embeds=obj_att_embeds)
        step = make_optimized_step_fn(self.params, cfg, ctx, return_raw=not prehead,
                                      return_prehead=prehead)

        def grid_step(tokens, state, eps):
            # rows b·Z + z → the (B, Z, ...) grid the step broadcasts over
            def split(t):
                return t.reshape((B, Z) + tuple(t.shape[1:]))

            def merge(t):
                return t.reshape((B * Z,) + tuple(t.shape[2:]))

            out, new_state = step(split(tokens), type(state)(*map(split, state)),
                                  eps if isinstance(eps, torch.Generator) else split(eps))
            out = tuple(map(merge, out)) if isinstance(out, tuple) else merge(out)
            return out, type(new_state)(*map(merge, new_state))

        if not isinstance(noise, torch.Generator):
            noise = as_tensor(noise, dev, torch.float32)
            if noise.shape[:3] != (Z, cfg.max_caption_length, B):
                raise ValueError(f"noise must be (n_z, max_steps, B, S, K, z), got "
                                 f"{tuple(noise.shape)}")
            # (Z, T, B, S, K, z) → (T, B·Z, S, K, z), image-major rows
            noise = noise.permute(1, 2, 0, 3, 4, 5).reshape(
                (noise.shape[1], B * Z) + tuple(noise.shape[3:]))

        start = torch.full((B * Z,), cfg.boundary_index, dtype=torch.long, device=dev)
        init_state = init_cell_state((B * Z,), cfg.hidden_size, device=dev, dtype=dtype)
        seqs, lp = constrained_beam_search_fast(
            grid_step, start, init_state, fsm, noise,
            max_steps=cfg.max_caption_length, beam_size=cfg.beam_size,
            per_node_beam_size=cfg.beam_size // 2, end_index=cfg.boundary_index,
            selection=selection, embedding=self.params["embedding"] if prehead else None)

        def z_major(t):  # (B·Z, ...) → (Z, B, ...)
            return t.reshape((B, Z) + tuple(t.shape[1:])).transpose(0, 1)

        if return_all:
            return z_major(seqs), z_major(lp)
        best, best_lp = select_best_beam_simple(seqs, lp, nc.repeat_interleave(Z),
                                                cfg.min_constraints_to_satisfy)
        return z_major(best), z_major(best_lp)
