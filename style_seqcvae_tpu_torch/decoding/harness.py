"""Diverse decoding: n_z z-samples × (constrained) beam search or a
stochastic sampler over a batch of images (counterpart of
``style_seqcvae_tpu/decoding/harness.py``).

The JAX harness vmaps the search over z. Here z is a batch dimension written
out: the search runs on B·n_z rows ordered image-major (row b·n_z + z), so a
view turns them into the (B, n_z, ...) grid the step expects, and the image
features stay (B, N, F), never replicated per z or beam.

With a ``Mesh`` of several devices (``parallel/mesh.py``, the JAX
harness's ``mesh``) the grid splits over them as ``decode_grid_split``
says: along z when the device count divides n_z, else along the batch,
else not at all. Each chunk decodes on its own device with its own copy of
the params, one thread per device (each inside ``torch.cuda.device`` of
its device, since the kernel wrappers launch on the current stream), and
the chunks' results are concatenated on the first device. A noise stack is
sliced along its z or batch axis. A ``torch.Generator`` first draws, on its
device, every tensor the unsplit decode would draw from it, in the same
order, shapes and dtypes (:meth:`DecodeHarness._drawn_noise`), so that a
split decode runs on the unsplit noise: on the CPU it gives the unsplit
tokens; on the card a chunk's GEMMs of fewer rows may round differently
(cuBLAS picks its kernels by shape), which moves near ties.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.decoding.beam_search import beam_search
from style_seqcvae_tpu_torch.decoding.cbs_fast import (
    RAW_SELECTIONS,
    FSMTables,
    constrained_beam_search_fast,
    fsm_to_device,
)
from style_seqcvae_tpu_torch.decoding.samplers import _gumbel, gumbel_beam_search, sample_decode
from style_seqcvae_tpu_torch.decoding.select import select_best_beam_simple
from style_seqcvae_tpu_torch.device import as_tensor, resolve_device
from style_seqcvae_tpu_torch.models.baseline import init_baseline_state, make_baseline_step_fn
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    make_decode_context,
    make_optimized_step_fn,
)
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state
from style_seqcvae_tpu_torch.parallel.mesh import Mesh, decode_grid_split, replicate
from style_seqcvae_tpu_torch.utils.tracing import CBS_SETUP, DECODE_CBS, span
from style_seqcvae_tpu_torch.weights import FAMILIES, param_family


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


def _stacked_tables(tables, n_z: int, B: int) -> FSMTables:
    """``decode_cbs``'s ``tables`` argument as one (n_z, B, S[, E]) stack."""
    if isinstance(tables, FSMTables):
        return tables
    if tables and isinstance(tables[0], FSMTables):
        if B != 1:
            raise ValueError(f"a per-z List[FSMTables] is for one image, got B={B}; "
                             "pass per-image lists for a batch")
        return pad_tables(list(tables), n_z)
    return pad_tables_batch(tables, n_z)


def _constraint_counts(num_constraints, B: int):
    """(B,) constraint counts: a shorter argument's first entry holds for
    every image; a tensor stays where it lies, anything else is numpy."""
    if torch.is_tensor(num_constraints):
        nc = num_constraints.reshape(-1)
    else:
        nc = np.asarray(num_constraints).reshape(-1)
    return nc[:1].repeat(B) if nc.shape[0] < B else nc[:B]


def _rows(x, rows: slice):
    return None if x is None else x[rows]


class DecodeHarness:
    def __init__(self, params: Dict[str, Any], cfg: CaptionerConfig,
                 device: Optional[Union[str, torch.device]] = None, family: str = "cvae",
                 mesh: Optional[Mesh] = None):
        """``params`` must already lie on ``device`` (``init_captioner``,
        ``init_baseline`` or ``from_jax_params`` with the same device).
        ``family``: ``"cvae"`` (Style-SeqCVAE, z-sampled) or ``"baseline"``
        (the non-variational UpDown, deterministic: its step ignores the
        z-noise, so callers pass n_z = 1 unless a sampler draws); the
        parameters must be that family's. ``mesh``: one process's decode
        devices, over which every decode splits its grid (``device`` is
        then the first of them, where the results land)."""
        if mesh is not None:
            if mesh.world_size > 1:
                raise ValueError("a decode mesh holds one process's devices; in a process "
                                 "group each rank decodes with its own harness")
            device = mesh.device
        self.device = resolve_device(device)
        if family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
        if param_family(params) != family:
            raise ValueError(f"a {family} harness was given the {param_family(params)} "
                             "family's parameters")
        if params["embedding"].device.type != self.device.type:
            raise ValueError(f"params on {params['embedding'].device}, harness on {self.device}")
        self.params = params
        self.cfg = cfg
        self.family = family
        self.mesh = mesh
        self._chunk_harness: Dict[torch.device, "DecodeHarness"] = {}
        if mesh is not None:
            for d, p in zip(mesh.data_devices, replicate(mesh, params)):
                self._chunk_harness.setdefault(d, DecodeHarness(p, cfg, d, family))

    def _init_state(self, rows: int, dtype: torch.dtype):
        init = init_baseline_state if self.family == "baseline" else init_cell_state
        return init((rows,), self.cfg.hidden_size, device=self.device, dtype=dtype)

    def _grid_step(self, feats, sentiment, obj_att_embeds, n_z: int, **contract):
        """The family's step with the requested return contract (the
        baseline's: log-probs only), taking and returning image-major rows
        (B·n_z, ...): a view splits them into the (B, n_z, ...) grid the step
        broadcasts the image features over. The cvae family runs the
        optimized step, the baseline ``make_baseline_step_fn``."""
        if self.family == "baseline":
            step = make_baseline_step_fn(self.params, self.cfg, feats)
        else:
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

    # ------------------------------------------------------------ the split

    def _z_dtype(self, obj_att_embeds) -> torch.dtype:
        """The dtype the cvae step draws its z-noise in: the prior mean's,
        f32, or in mode 2 the attribute embeddings' (the params' dtype)."""
        if self.cfg.sentiment_vae == 2 and obj_att_embeds is not None:
            return self.params["embedding"].dtype
        return torch.float32

    def _drawn_noise(self, gen: torch.Generator, n_z: int, B: int, inner0: Tuple[int, ...],
                     inner: Tuple[int, ...], z_dtype: torch.dtype,
                     gumbel: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None):
        """What the unsplit decode of a (B, n_z) grid draws from ``gen``, in
        the JAX layout: at each step t the cvae step's z-noise over its grid
        (B, n_z, *inner0 at t = 0 else *inner, z) in ``z_dtype``, then, for
        the samplers, their Gumbel noise over (B·n_z, *gumbel[0 or 1], V)
        from f32 exponentials. Returns (z-noise (n_z, T, B, *inner, z),
        Gumbel noise (n_z, T, B, *gumbel[1], V) or None); the first step's
        draws fill each stack's leading slots. The baseline draws no z-noise
        (its z-stack is zeros over a grid of ones)."""
        cfg, dev = self.cfg, gen.device
        T, V = cfg.max_caption_length, cfg.vocab_size
        cvae = self.family == "cvae"
        zs = torch.zeros((n_z, T, B) + (inner if cvae else (1,) * len(inner))
                         + (cfg.z_space,), dtype=z_dtype, device=dev)
        gs = (None if gumbel is None
              else torch.zeros((n_z, T, B) + gumbel[1] + (V,), device=dev))

        def put(stack, t, draw, dims):
            stack[(slice(None), t, slice(None)) + tuple(slice(0, k) for k in dims)] = (
                draw.reshape((B, n_z) + tuple(draw.shape[-1 - len(dims):])).transpose(0, 1))

        for t in range(T):
            if cvae:
                dims = inner0 if t == 0 else inner
                put(zs, t, torch.randn((B, n_z) + dims + (cfg.z_space,), generator=gen,
                                       device=dev, dtype=z_dtype), dims)
            if gumbel is not None:
                dims = gumbel[0] if t == 0 else gumbel[1]
                put(gs, t, _gumbel(gen, t, (B * n_z,) + dims + (V,), torch.float32, dev), dims)
        return zs, gs

    def _split(self, n_z: int, B: int, run: Callable) -> Tuple[torch.Tensor, ...]:
        """``run(harness, zs, bs, n_z')`` decodes the grid's chunk (z slice
        ``zs``, image slice ``bs``, n_z' z-samples) on ``harness``'s device
        and returns (n_z', B', ...) tensors. The chunks of the mesh's grid
        split run in a pool of one worker thread per distinct device (the
        chunks of a device listed twice in turn, in its thread; a mesh of
        one device too) and are concatenated along the split axis on
        ``self.device``."""
        split = decode_grid_split(self.mesh, n_z, B)
        full = slice(None)
        chunks = [((sl, full) if split.axis == "z" else (full, sl), d)
                  for sl, d in split.chunks]
        by_device: Dict[torch.device, List[int]] = {}
        for i, (_, d) in enumerate(chunks):
            by_device.setdefault(d, []).append(i)

        def work(d: torch.device) -> Dict[int, Tuple[torch.Tensor, ...]]:
            on_device = (torch.cuda.device(d) if d.type == "cuda"
                         else contextlib.nullcontext())
            with on_device:
                return {i: run(self._chunk_harness[d], *chunks[i][0],
                               len(range(n_z)[chunks[i][0][0]]))
                        for i in by_device[d]}

        results: Dict[int, Tuple[torch.Tensor, ...]] = {}
        with ThreadPoolExecutor(len(by_device)) as pool:
            for fut in [pool.submit(work, d) for d in by_device]:
                results.update(fut.result())
        dim = 1 if split.axis == "batch" else 0
        return tuple(torch.cat([results[i][k].to(self.device) for i in range(len(chunks))],
                               dim=dim) for k in range(len(results[0])))

    def _split_cbs(self, feats, sentiment, obj_att_embeds, tables, num_constraints, noise,
                   n_z: int, selection: str, return_all: bool):
        B = feats.shape[0]
        stacked = _stacked_tables(tables, n_z, B)
        nc = _constraint_counts(num_constraints, B)
        if isinstance(noise, torch.Generator):
            S = stacked.default_dest.shape[2]
            noise = self._drawn_noise(noise, n_z, B, (1, 1), (S, self.cfg.beam_size),
                                      self._z_dtype(obj_att_embeds))[0]
        return self._split(n_z, B, lambda h, zs, bs, nz: h.decode_cbs(
            feats[bs], _rows(sentiment, bs), _rows(obj_att_embeds, bs),
            FSMTables(*[t[zs][:, bs] for t in stacked]), nc[bs], noise[zs][:, :, bs], nz,
            selection=selection, return_all=return_all))

    @torch.inference_mode()
    def decode_cbs(self, feats, sentiment, obj_att_embeds, tables, num_constraints,
                   noise: Union[np.ndarray, torch.Tensor, torch.Generator], n_z: int,
                   selection: Optional[str] = None, return_all: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``selection``: "prehead" (kernel A, the cvae family's default),
        "fused" (kernel B), "raw" or "logprob" (no kernel). ``"raw"`` is the
        JAX harness's own route for the cvae family: its ``decode_cbs`` asks
        the step for raw logits and selects with ``small_top_k`` over them
        (``raw_step=True``, neither kernel). The baseline family takes only
        ``"logprob"`` (its default): JAX hands it to the search with
        ``raw_step=False``, and its step has no raw or pre-head contract.
        feats (B, N, F); sentiment (B, 1) or None; obj_att_embeds (B, N, z)
        or None; ``tables`` is per-z ``List[FSMTables]`` (B = 1), per-image
        ``List[List[FSMTables]]`` or an already padded (n_z, B, S[, E])
        FSMTables; num_constraints (B,), or fewer, whose first entry then
        holds for every image (a tensor stays where it lies, with no copy
        to the host). ``noise``: z-noise in the JAX layout (n_z,
        max_steps, B, S, K, z), or a ``torch.Generator`` on the decode device
        that draws it. Inputs on the host are copied through pinned memory,
        and nothing in the decode waits for the card.

        Returns (best (n_z, B, T), best_lp (n_z, B)), or all beams
        ((n_z, B, S, K, T), (n_z, B, S, K)) with ``return_all``."""
        if selection is None:
            selection = "logprob" if self.family == "baseline" else "prehead"
        if self.family == "baseline" and selection != "logprob":
            raise ValueError(f"the baseline family decodes CBS through selection "
                             f"'logprob' only, got {selection!r}")
        if self.mesh is not None:
            return self._split_cbs(feats, sentiment, obj_att_embeds, tables, num_constraints,
                                   noise, n_z, selection, return_all)
        with span(DECODE_CBS):
            with span(CBS_SETUP):
                cfg, dev = self.cfg, self.device
                feats, sentiment, obj_att_embeds = self._inputs(feats, sentiment,
                                                                obj_att_embeds)
                B = feats.shape[0]
                fsm = fsm_to_device(_stacked_tables(tables, n_z, B), dev)
                Z = fsm.default_dest.shape[0]
                if Z != n_z or fsm.default_dest.shape[1] != B:
                    raise ValueError(f"tables are {tuple(fsm.default_dest.shape[:2])}, "
                                     f"want ({n_z}, {B})")
                # (Z, B, ...) → image-major rows (B·Z, ...)
                fsm = FSMTables(*[t.transpose(0, 1).reshape((B * Z,) + tuple(t.shape[2:]))
                                  for t in fsm])
                nc = _constraint_counts(num_constraints, B)
                nc = as_tensor(nc, dev)

                prehead = selection == "prehead"
                grid_step = self._grid_step(feats, sentiment, obj_att_embeds, Z,
                                            return_raw=selection in RAW_SELECTIONS,
                                            return_prehead=prehead)
                noise = self._noise_rows(noise, Z, B, (fsm.default_dest.shape[1],
                                                       cfg.beam_size))
                start = torch.full((B * Z,), cfg.boundary_index, dtype=torch.long, device=dev)
                init_state = self._init_state(B * Z, feats.dtype)

            def finish(seqs, lp):
                if return_all:
                    return self._z_major(seqs, B, Z), self._z_major(lp, B, Z)
                best, best_lp = select_best_beam_simple(seqs, lp, nc.repeat_interleave(Z),
                                                        cfg.min_constraints_to_satisfy)
                return self._z_major(best, B, Z), self._z_major(best_lp, B, Z)

            return constrained_beam_search_fast(
                grid_step, start, init_state, fsm, noise,
                max_steps=cfg.max_caption_length, beam_size=cfg.beam_size,
                per_node_beam_size=cfg.beam_size // 2, end_index=cfg.boundary_index,
                selection=selection, embedding=self.params["embedding"] if prehead else None,
                finish=finish)

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
        if self.mesh is not None:
            B = feats.shape[0]
            if isinstance(noise, torch.Generator):
                noise = self._drawn_noise(noise, n_z, B, (1,), (self.cfg.beam_size,),
                                          self._z_dtype(obj_att_embeds))[0]
            return self._split(n_z, B, lambda h, zs, bs, nz: h.decode_beam(
                feats[bs], _rows(sentiment, bs), _rows(obj_att_embeds, bs),
                noise[zs][:, :, bs], nz))
        cfg, dev = self.cfg, self.device
        feats, sentiment, obj_att_embeds = self._inputs(feats, sentiment, obj_att_embeds)
        B = feats.shape[0]
        grid_step = self._grid_step(feats, sentiment, obj_att_embeds, n_z)
        noise = self._noise_rows(noise, n_z, B, (cfg.beam_size,))
        start = torch.full((B * n_z,), cfg.boundary_index, dtype=torch.long, device=dev)
        init_state = self._init_state(B * n_z, feats.dtype)
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
        if self.mesh is not None:
            B = feats.shape[0]
            if isinstance(noise, torch.Generator):
                K = self.cfg.beam_size
                inner, gumbel = (((K,), ((1,), (K,))) if method == "gumbel"
                                 else ((1,), ((), ())))
                noise = self._drawn_noise(noise, n_z, B, (1,), inner,
                                          self._z_dtype(obj_att_embeds), gumbel)
            kw = dict(top_k=top_k, top_p=top_p, temperature=temperature)
            return self._split(n_z, B, lambda h, zs, bs, nz: (h.decode_sample(
                feats[bs], _rows(sentiment, bs), _rows(obj_att_embeds, bs),
                tuple(x[zs][:, :, bs] for x in noise), nz, method, **kw),))[0]
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
        init_state = self._init_state(B * n_z, feats.dtype)
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
