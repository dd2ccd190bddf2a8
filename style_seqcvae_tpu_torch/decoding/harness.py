"""Diverse decoding: n_z z-samples × (constrained) beam search or a
stochastic sampler over a batch of images (counterpart of
``style_seqcvae_tpu/decoding/harness.py``).

The JAX harness vmaps the search over z. Here z is a batch dimension written
out: the search runs on B·n_z rows ordered image-major (row b·n_z + z), so a
view turns them into the (B, n_z, ...) grid the step expects, and the image
features stay (B, N, F), never replicated per z or beam.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.beam_search import beam_search
from style_seqcvae_tpu_torch.decoding.cbs_fast import (
    RAW_SELECTIONS,
    FSMTables,
    constrained_beam_search_fast,
    fsm_to_device,
)
from style_seqcvae_tpu_torch.decoding.samplers import gumbel_beam_search, sample_decode
from style_seqcvae_tpu_torch.decoding.select import select_best_beam_simple
from style_seqcvae_tpu_torch.device import as_tensor, resolve_device
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    make_decode_context,
    make_optimized_step_fn,
)
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state


# the choices of scripts/inference.py --sampler
SAMPLERS = ("multinomial", "topk", "topp", "gumbel")


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

    def _grid_step(self, feats, sentiment, obj_att_embeds, n_z: int, **contract):
        """The optimized step with the requested return contract, taking and
        returning image-major rows (B·n_z, ...): a view splits them into the
        (B, n_z, ...) grid the step broadcasts the image features over."""
        ctx = make_decode_context(self.params, self.cfg, feats, sentiment=sentiment,
                                  obj_att_embeds=obj_att_embeds)
        step = make_optimized_step_fn(self.params, self.cfg, ctx, **contract)
        B = feats.shape[0]

        def split(t):
            return t.reshape((B, n_z) + tuple(t.shape[1:]))

        def merge(t):
            return t.reshape((B * n_z,) + tuple(t.shape[2:]))

        def grid_step(tokens, state, eps):
            out, new_state = step(split(tokens), type(state)(*map(split, state)),
                                  eps if isinstance(eps, torch.Generator) else split(eps))
            out = tuple(map(merge, out)) if isinstance(out, tuple) else merge(out)
            return out, type(new_state)(*map(merge, new_state))

        return grid_step

    def _inputs(self, feats, sentiment, obj_att_embeds):
        dtype = self.params["embedding"].dtype
        return (as_tensor(feats, self.device, dtype), as_tensor(sentiment, self.device),
                as_tensor(obj_att_embeds, self.device, dtype))

    def _noise_rows(self, noise, n_z: int, B: int, inner: Tuple[int, ...], last: int = 0):
        """Noise in the layout (n_z, max_steps, B, *inner, last) → (max_steps,
        B·n_z, *inner, last), image-major rows; ``last`` is z (the default)
        for z-noise, V for Gumbel noise. A generator passes through (the
        search checks its device)."""
        if isinstance(noise, torch.Generator):
            return noise
        noise = as_tensor(noise, self.device)
        T, last = self.cfg.max_caption_length, last or self.cfg.z_space
        if (not noise.is_floating_point() or noise.dim() != 4 + len(inner)
                or tuple(noise.shape[:3]) != (n_z, T, B) or noise.shape[-1] != last
                or any(d not in (1, k) for d, k in zip(noise.shape[3:-1], inner))):
            dims = "".join(f"{k} or 1, " for k in inner)
            raise ValueError(f"noise must be floating ({n_z}, {T}, {B}, {dims}{last}), got "
                             f"{noise.dtype} {tuple(noise.shape)}")
        # (n_z, T, B, ...) → (T, B, n_z, ...) → (T, B·n_z, ...)
        noise = noise.float().permute(1, 2, 0, *range(3, noise.dim()))
        return noise.reshape((T, B * n_z) + tuple(noise.shape[3:]))

    @staticmethod
    def _z_major(t: torch.Tensor, B: int, n_z: int) -> torch.Tensor:
        """(B·n_z, ...) image-major rows → (n_z, B, ...)."""
        return t.reshape((B, n_z) + tuple(t.shape[1:])).transpose(0, 1)

    @torch.inference_mode()
    def decode_cbs(self, feats, sentiment, obj_att_embeds, tables, num_constraints,
                   noise: Union[np.ndarray, torch.Tensor, torch.Generator], n_z: int,
                   selection: str = "prehead", return_all: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``selection``: "prehead" (kernel A), "fused" (kernel B), "raw" or
        "logprob" (no kernel). ``"raw"`` is the JAX harness's own route: its
        ``decode_cbs`` always asks the step for raw logits and selects with
        ``small_top_k`` over them (``raw_step=True``, neither kernel).
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
        feats, sentiment, obj_att_embeds = self._inputs(feats, sentiment, obj_att_embeds)
        B = feats.shape[0]
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
        grid_step = self._grid_step(feats, sentiment, obj_att_embeds, Z,
                                    return_raw=selection in RAW_SELECTIONS,
                                    return_prehead=prehead)
        noise = self._noise_rows(noise, Z, B, (fsm.default_dest.shape[1], cfg.beam_size))
        start = torch.full((B * Z,), cfg.boundary_index, dtype=torch.long, device=dev)
        init_state = init_cell_state((B * Z,), cfg.hidden_size, device=dev, dtype=feats.dtype)
        seqs, lp = constrained_beam_search_fast(
            grid_step, start, init_state, fsm, noise,
            max_steps=cfg.max_caption_length, beam_size=cfg.beam_size,
            per_node_beam_size=cfg.beam_size // 2, end_index=cfg.boundary_index,
            selection=selection, embedding=self.params["embedding"] if prehead else None)

        if return_all:
            return self._z_major(seqs, B, Z), self._z_major(lp, B, Z)
        best, best_lp = select_best_beam_simple(seqs, lp, nc.repeat_interleave(Z),
                                                cfg.min_constraints_to_satisfy)
        return self._z_major(best, B, Z), self._z_major(best_lp, B, Z)

    @torch.inference_mode()
    def decode_beam(self, feats, sentiment, obj_att_embeds,
                    noise: Union[np.ndarray, torch.Tensor, torch.Generator], n_z: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """n_z z-samples × plain beam search (beam ``cfg.beam_size``, per-node
        beam ``beam_size // 2``) through the optimized step's log-prob
        contract, as the JAX harness's ``decode_beam``. feats (B, N, F);
        sentiment (B, 1) or None; obj_att_embeds (B, N, z) or None.
        ``noise``: (n_z, max_steps, B, K, z) or (n_z, max_steps, B, 1, z)
        z-noise, row 0 of each z cut to its first beam (see
        ``beam_search``), or a ``torch.Generator`` on the decode device.

        Returns the top beam of each (z, image): (seqs (n_z, B, T),
        lp (n_z, B))."""
        cfg, dev = self.cfg, self.device
        feats, sentiment, obj_att_embeds = self._inputs(feats, sentiment, obj_att_embeds)
        B = feats.shape[0]
        grid_step = self._grid_step(feats, sentiment, obj_att_embeds, n_z)
        noise = self._noise_rows(noise, n_z, B, (cfg.beam_size,))
        start = torch.full((B * n_z,), cfg.boundary_index, dtype=torch.long, device=dev)
        init_state = init_cell_state((B * n_z,), cfg.hidden_size, device=dev, dtype=feats.dtype)
        seqs, lp = beam_search(grid_step, start, init_state, noise,
                               max_steps=cfg.max_caption_length, beam_size=cfg.beam_size,
                               per_node_beam_size=cfg.beam_size // 2,
                               end_index=cfg.boundary_index)
        return self._z_major(seqs[:, 0, :], B, n_z), self._z_major(lp[:, 0], B, n_z)

    @torch.inference_mode()
    def decode_sample(self, feats, sentiment, obj_att_embeds, noise, n_z: int, method: str,
                      top_k: int = 5, top_p: float = 0.9, temperature: float = 1.0
                      ) -> torch.Tensor:
        """Diverse decoding by the stochastic samplers (``scripts/inference.py
        --sampler``), n_z z-samples per image through the optimized step's
        log-prob contract: ``method`` "multinomial", "topk" (``top_k``),
        "topp" (``top_p``; both at ``temperature``) or "gumbel" (Stochastic
        Beam Search at beam ``cfg.beam_size``, its highest perturbed-score
        sample). feats (B, N, F); sentiment (B, 1) or None; obj_att_embeds
        (B, N, z) or None. ``noise``: a ``torch.Generator`` on the decode
        device, or a pair (z-noise, Gumbel noise) in the JAX-major layout:
        z-noise (n_z, max_steps, B, 1 or K, z) and Gumbel noise (n_z,
        max_steps, B, V), or (n_z, max_steps, B, K, V) for "gumbel" (row 0's
        first beam holds the first step's draw; see ``decoding/samplers.py``).

        Returns (n_z, B, T) token ids."""
        if method not in SAMPLERS:
            raise ValueError(f"method must be one of {SAMPLERS}, got {method!r}")
        cfg, dev = self.cfg, self.device
        feats, sentiment, obj_att_embeds = self._inputs(feats, sentiment, obj_att_embeds)
        B = feats.shape[0]
        K = cfg.beam_size if method == "gumbel" else 1
        if not isinstance(noise, torch.Generator):
            if not isinstance(noise, (tuple, list)) or len(noise) != 2:
                raise ValueError("noise must be a torch.Generator or a pair (z_noise, "
                                 f"gumbel_noise), got {type(noise).__name__}")
            noise = (self._noise_rows(noise[0], n_z, B, (K,)),
                     self._noise_rows(noise[1], n_z, B, (K,) if method == "gumbel" else (),
                                      cfg.vocab_size))
        grid_step = self._grid_step(feats, sentiment, obj_att_embeds, n_z)
        start = torch.full((B * n_z,), cfg.boundary_index, dtype=torch.long, device=dev)
        init_state = init_cell_state((B * n_z,), cfg.hidden_size, device=dev, dtype=feats.dtype)
        kw = dict(max_steps=cfg.max_caption_length, end_index=cfg.boundary_index)
        if method == "gumbel":
            seqs = gumbel_beam_search(grid_step, start, init_state, noise,
                                      beam_size=cfg.beam_size, **kw)[0][:, 0, :]
        else:
            seqs = sample_decode(grid_step, start, init_state, noise, temperature=temperature,
                                 top_k=top_k if method == "topk" else 0,
                                 top_p=top_p if method == "topp" else 0.0, **kw)
        return self._z_major(seqs, B, n_z)


def detokenize(token_ids, vocabulary, boundary_index: int) -> str:
    """Token ids -> caption string, truncated at ``@@BOUNDARY@@`` (JAX
    ``harness.py:316-324``)."""
    words = []
    for t in np.asarray(token_ids).tolist():
        if t == boundary_index:
            break
        words.append(vocabulary.get_token_from_index(int(t)))
    return " ".join(words)
