"""Caption inference with diverse z-sampling (counterpart of the JAX
package's ``scripts/inference.py``, itself a mirror of
var_updown/scripts/inference.py:53-191).

    python -m style_seqcvae_tpu_torch.scripts.inference --config cfg.yml \\
        --output-path preds.json [--model baseline] [--batch-images 16] \\
        [--bf16] [--cpu]

For every evaluation image: N_Z_SAMPLES decodes (a batch dimension on the
card, not a Python loop), optional constrained beam search (CBS) with one
FSM per z-sample, best-beam selection with constraint satisfaction,
detokenization truncated at @@BOUNDARY@@, and a predictions JSON
``[{"image_id", "caption"}...]`` in the image-major, z-minor order the
evaluator expects. Flags, seeds, output and progress lines are the JAX
CLI's. It runs on ``cuda`` unless ``--cpu`` is given, and raises without a
GPU. The CBS decode takes ``DecodeHarness.decode_cbs``'s default selection
for the family: ``"prehead"`` for the cvae, kernel A
(``ops/kernels/vocab_topk_lse.py``) on the card; ``"logprob"`` for the
baseline (``--model baseline``, the non-variational UpDown), which no
kernel serves, as in JAX. The baseline is deterministic, so it decodes one
z-sample an image unless ``--sampler`` draws.

Parameters: ``--checkpoint-path DIR --checkpoint-name NAME`` reads the
params of the checkpoint ``DIR/NAME`` that the port's train CLI wrote (as
the JAX CLI reads its own orbax checkpoints); a ``--checkpoint-path`` that
is a file names a ``.npz`` of the JAX parameter tree
(``weights.save_params_npz``); either must hold the ``--model`` family's
parameters; without either they are drawn by ``init_captioner`` (or
``init_baseline``) on the CPU, with ``hashed_random_embeddings`` for a tied
head, and moved to the device, so that a CPU run and a card run use the
same weights. z-noise comes from a ``torch.Generator`` seeded with
``RANDOM_SEED + 7``; candidates from ``random`` seeded with
``RANDOM_SEED``, as the JAX CLI seeds them.

Host collation of the next group runs on a producer thread
(``data/prefetch.py``) while the current group decodes.

``--num-data N`` splits every decode's (z, batch, states, beam) grid over
the first N devices (``cuda:0`` … ``cuda:N-1``, or N CPU entries under
``--cpu``; ``DecodeHarness(mesh=...)``): z when N divides N_Z_SAMPLES, else
the images of a group; fewer cards than N raise. On the CPU the captions
are those of ``--num-data 1``, token for token. On CUDA a chunk's products
have fewer rows, and cuBLAS picks its kernels by shape, so they round
otherwise and near ties may flip: at config 3 split 2 x 10 on one H100,
99.4-99.7% of the captions were identical in f32 and 13-25% in bf16
(ROADMAP.md section C, "Split decodes on the card round in other places").
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.datasets import (
    EvaluationDataset,
    EvaluationDatasetWithConstraints,
)
from style_seqcvae_tpu_torch.data.latents import LatentDictionary
from style_seqcvae_tpu_torch.data.prefetch import prefetch
from style_seqcvae_tpu_torch.data.vocabulary import (
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness, detokenize
from style_seqcvae_tpu_torch.decoding.select import select_best_beam_with_constraints
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.baseline import init_baseline
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    hashed_random_embeddings,
    init_captioner,
)
from style_seqcvae_tpu_torch.ops.kernels import report_launches
from style_seqcvae_tpu_torch.ops.kernels._build import KernelError
from style_seqcvae_tpu_torch.parallel.mesh import make_mesh
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.weights import (
    cast_floats,
    from_jax_params,
    load_params_npz,
    to_device,
)

# failures that a per-image retry would only hide: the card's code or memory
_NO_FALLBACK = (KernelError, torch.cuda.OutOfMemoryError)

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--config", required=True)
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", default="",
                    help="the train CLI's serialization directory (with "
                         "--checkpoint-name), or a .npz of the JAX parameter tree "
                         "(weights.save_params_npz)")
parser.add_argument("--checkpoint-name", default="checkpoint_best",
                    help="the checkpoint directory in --checkpoint-path to read")
parser.add_argument("--output-path", required=True)
parser.add_argument("--in-memory", action="store_true")
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions)")
parser.add_argument("--max-images", type=int, default=0)
parser.add_argument("--model", choices=["cvae", "baseline"], default="cvae",
                    help="cvae = Style-SeqCVAE (var_updown); baseline = "
                         "non-variational UpDown (updown-baseline)")
parser.add_argument("--batch-images", type=int, default=1,
                    help="images per device dispatch (the reference decodes "
                         "strictly one at a time, inference.py:95)")
parser.add_argument("--num-data", type=int, default=1,
                    help="split the (z x batch x states x beam) decode grid over the "
                         "first N devices; on the CPU the captions are those of "
                         "--num-data 1, on CUDA near ties may flip (kernels chosen by "
                         "shape; see ROADMAP.md section C)")
parser.add_argument("--sampler", default="",
                    choices=["", "multinomial", "topk", "topp", "gumbel"],
                    help="decode with a stochastic sampler instead of beam/CBS "
                         "(the vendored AllenNLP sampler classes, var_updown "
                         "beam_search.py:88-295); CBS constraints are ignored "
                         "under --sampler")
parser.add_argument("--sampler-k", type=int, default=5, help="k for --sampler topk")
parser.add_argument("--sampler-p", type=float, default=0.9, help="p for --sampler topp")
parser.add_argument("--sampler-temperature", type=float, default=1.0,
                    help="softmax temperature for multinomial/topk/topp")
parser.add_argument("--bf16", action="store_true",
                    help="decode with bfloat16 parameters and features (f32 score "
                         "accumulators)")


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, float]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the
    exit code. ``stats``, when given, receives the run's counts and host
    clock seconds: ``images``, ``predictions``, ``fallbacks``, ``wall_s``
    and ``setup_s`` (config, vocabulary, dataset, parameters); on the
    producer thread ``item_s`` (reading and FSM building), ``collate_s``
    (trims, packing, tables) and ``latents_s``; on the main thread
    ``wait_s`` (waiting for a prepared group) and ``decode_s`` (the
    decodes, the selections and the detokenization)."""
    _A = parser.parse_args(argv)
    device = resolve_device("cpu" if _A.cpu else None)
    mesh = None
    if _A.num_data > 1:
        if device.type == "cuda" and torch.cuda.device_count() < _A.num_data:
            raise SystemExit(f"--num-data {_A.num_data} needs {_A.num_data} devices, found "
                             f"{torch.cuda.device_count()} (cuda)")
        mesh = make_mesh(_A.num_data, 1, ["cpu"] * _A.num_data if _A.cpu
                         else [f"cuda:{i}" for i in range(_A.num_data)])
    t_start = time.perf_counter()
    st: Dict[str, float] = {k: 0.0 for k in ("item_s", "collate_s", "latents_s", "wait_s",
                                             "decode_s")}

    _C = Config(_A.config, _A.config_override)
    random.seed(_C.RANDOM_SEED)
    np.random.seed(_C.RANDOM_SEED)

    vocabulary = Vocabulary.from_files(_C.DATA.VOCABULARY)
    if _C.DATA.CBS.WORDFORMS:
        add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS)
    if _C.DATA.CBS.WORDFORMS_ATTRIBS:
        add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS_ATTRIBS)

    if _C.MODEL.USE_CBS:
        dataset = EvaluationDatasetWithConstraints.from_config(
            _C, vocabulary=vocabulary, in_memory=_A.in_memory)
    else:
        dataset = EvaluationDataset.from_config(_C, in_memory=_A.in_memory)

    model_cfg = CaptionerConfig.from_config(_C, vocabulary)
    if _A.checkpoint_path and os.path.isdir(_A.checkpoint_path):
        tree = read_checkpoint(os.path.join(_A.checkpoint_path, _A.checkpoint_name))
        params = from_jax_params(tree["params"], device="cpu", family=_A.model)
    elif _A.checkpoint_path:
        params = from_jax_params(load_params_npz(_A.checkpoint_path), device="cpu",
                                 family=_A.model)
    else:
        tokens = [vocabulary.get_token_from_index(i)
                  for i in range(vocabulary.get_vocab_size())]
        emb = (hashed_random_embeddings(tokens, model_cfg.embedding_size,
                                        model_cfg.pad_index)
               if model_cfg.tie_embeddings else None)
        init = init_baseline if _A.model == "baseline" else init_captioner
        params = init(model_cfg, seed=_C.RANDOM_SEED, device="cpu", embedding_table=emb)

    latent_dict = None
    if model_cfg.sentiment_vae == 2:
        if model_cfg.latent_embedding == "glove" and _C.DATA.SENTIGLOVE:
            latent_dict = LatentDictionary.from_sentiglove(
                _C.DATA.SENTIGLOVE, model_cfg.z_space, model_cfg.latent_embedding_multip)
        elif model_cfg.latent_embedding == "senti_word_net" and _C.DATA.SWN_SCORES:
            latent_dict = LatentDictionary.from_swn_scores(
                _C.DATA.SWN_SCORES, model_cfg.z_space, model_cfg.latent_embedding_multip)

    decode_dtype = torch.bfloat16 if _A.bf16 else torch.float32
    params = to_device(cast_floats(params, decode_dtype), device)
    harness = DecodeHarness(params, model_cfg, device=device, family=_A.model, mesh=mesh)
    sampler_spec = None
    if _A.sampler:
        sampler_spec = dict(method=_A.sampler, top_k=_A.sampler_k, top_p=_A.sampler_p,
                            temperature=_A.sampler_temperature)
        if _C.MODEL.USE_CBS:
            print("--sampler: CBS constraints ignored (the reference's "
                  "samplers exist only in the plain BeamSearch path, "
                  "beam_search.py:88-295)")
    # the baseline is deterministic: its z-samples would all be identical,
    # unless a stochastic sampler draws the tokens
    n_z = max(_C.MODEL.N_Z_SAMPLES, 1) if _A.model != "baseline" or _A.sampler else 1
    noise = torch.Generator(device=device).manual_seed(_C.RANDOM_SEED + 7)

    predictions: List[Dict[str, Any]] = []
    n_fallbacks = 0
    n_images = len(dataset) if not _A.max_images else min(_A.max_images, len(dataset))
    group_size = max(_A.batch_images, 1)

    def prepare(idx):
        t0 = time.perf_counter()
        item = dataset[idx]
        t1 = time.perf_counter()
        batch = dataset.collate_fn([item])
        t2 = time.perf_counter()
        obj_att_embeds = None
        if latent_dict is not None:
            # images WITHOUT attribute detections still get a (zeros)
            # embedding so that a mixed group concatenates
            obj_att_embeds = latent_dict.translate_obj_atts(
                batch.get("obj_atts") or [[]], _C.DATA.MAX_BOXES)
        st["item_s"] += t1 - t0
        st["collate_s"] += t2 - t1
        st["latents_s"] += time.perf_counter() - t2
        return batch, obj_att_embeds

    def decode_single(batch, obj_att_embeds):
        """Per-image decode with the reference's counted fallback
        (inference.py:160-170): unconstrained beam when CBS fails. Kernel
        and device-memory failures are raised, not retried."""
        nonlocal n_fallbacks
        feats = batch["image_features"]
        sentiment = batch["sentiment"]
        try:
            return _decode_one(_C, model_cfg, harness, batch, feats, sentiment,
                               obj_att_embeds, noise, n_z, sampler=sampler_spec)
        except _NO_FALLBACK:
            raise
        except Exception as e:
            what = "sampler decode" if sampler_spec is not None else "CBS"
            print(f"image {int(batch['image_id'][0])}: {what} failed ({e}); "
                  "falling back to unconstrained beam search")
            n_fallbacks += 1
            seqs, _ = harness.decode_beam(feats, sentiment, obj_att_embeds, noise, n_z)
            return seqs[:, 0, :].cpu().numpy()

    def emit(batch, captions_tok):
        image_id = int(batch["image_id"][0])
        for z in range(n_z):
            predictions.append({
                "image_id": image_id,
                "caption": detokenize(captions_tok[z], vocabulary, model_cfg.boundary_index),
            })

    def group_stream():
        """Host collation and device staging of the next group, on the
        producer thread."""
        for start in range(0, n_images, group_size):
            idxs = range(start, min(start + group_size, n_images))
            prepared = [prepare(i) for i in idxs]
            staged = None
            if len(prepared) > 1:
                sents = [b["sentiment"] for b, _ in prepared]
                oaes = [o for _, o in prepared]
                feats = np.concatenate([b["image_features"] for b, _ in prepared])
                staged = {
                    "feats": torch.from_numpy(feats).to(device, decode_dtype),
                    "sentiment": (torch.from_numpy(np.concatenate(sents)).to(device)
                                  if sents[0] is not None else None),
                    "oae": (torch.from_numpy(np.concatenate(oaes)).to(device)
                            if oaes[0] is not None else None),
                }
            yield start, prepared, staged

    # Groups are decoded in turn: the decode ends in a host synchronisation
    # (a blocking copy to the device in the beam selection), so the JAX
    # CLI's one-deep dispatch pipeline would overlap nothing.
    st["setup_s"] = time.perf_counter() - t_start
    stream = iter(prefetch(group_stream(), buffer_size=2))
    while True:
        t0 = time.perf_counter()
        nxt = next(stream, None)
        t1 = time.perf_counter()
        st["wait_s"] += t1 - t0
        if nxt is None:
            break
        start, prepared, staged = nxt
        if len(prepared) > 1:
            try:
                kind_out = _dispatch_group(_C, model_cfg, harness, prepared, noise, n_z,
                                           staged=staged, sampler=sampler_spec)
                per_image = _collect_group(_C, model_cfg, kind_out, prepared, n_z)
                for (batch, _), toks in zip(prepared, per_image):
                    emit(batch, toks)
            except _NO_FALLBACK:
                raise
            except Exception as e:
                print(f"group decode failed ({e}); retrying per image")
                for batch, oae in prepared:
                    emit(batch, decode_single(batch, oae))
        else:
            batch, oae = prepared[0]
            emit(batch, decode_single(batch, oae))
        st["decode_s"] += time.perf_counter() - t1
        done_n = min(start + group_size, n_images)
        if done_n % 50 < group_size and done_n >= 50 or done_n == n_images:
            print(f"{done_n}/{n_images} images decoded")

    os.makedirs(os.path.dirname(os.path.abspath(_A.output_path)), exist_ok=True)
    with open(_A.output_path, "w") as f:
        json.dump(predictions, f)
    if n_fallbacks:
        print(f"{n_fallbacks} images fell back to unconstrained decoding")
    print(f"wrote {len(predictions)} predictions to {_A.output_path}")
    if stats is not None:
        stats.update(st, images=n_images, predictions=len(predictions),
                     fallbacks=n_fallbacks, wall_s=time.perf_counter() - t_start)
    return 0


def _dispatch_group(_C, model_cfg, harness, prepared, noise, n_z, staged=None,
                    sampler=None):
    """Decode a group of images in one call (the reference forces bs=1,
    inference.py:95). Returns ``(kind, device_out)`` for
    :func:`_collect_group`. ``noise``: a
    ``torch.Generator`` on the decode device, or the stacks the harness
    takes (z-noise, and for ``sampler`` the pair with Gumbel noise);
    ``staged`` carries the group's inputs already on the device;
    ``sampler`` switches to the stochastic sampler path (--sampler),
    bypassing CBS and beam search."""
    if staged is not None:
        feats, sentiment, obj_att_embeds = (staged["feats"], staged["sentiment"],
                                            staged["oae"])
    else:
        feats = np.concatenate([b["image_features"] for b, _ in prepared])
        sents = [b["sentiment"] for b, _ in prepared]
        sentiment = np.concatenate(sents) if sents[0] is not None else None
        oaes = [o for _, o in prepared]
        obj_att_embeds = None if oaes[0] is None else np.concatenate(oaes)
    if sampler is not None:
        return ("sample", harness.decode_sample(feats, sentiment, obj_att_embeds, noise,
                                                n_z, **sampler))
    if _C.MODEL.USE_CBS:
        tables = [list(b["fsm_tables"]) for b, _ in prepared]
        ncs = np.asarray([int(np.asarray(b["num_constraints"]).reshape(-1)[0])
                          for b, _ in prepared])
        if model_cfg.cbs_simple:
            return ("cbs_simple", harness.decode_cbs(
                feats, sentiment, obj_att_embeds, tables, ncs, noise, n_z))
        return ("cbs_grounded", harness.decode_cbs(
            feats, sentiment, obj_att_embeds, tables, ncs, noise, n_z, return_all=True))
    return ("beam", harness.decode_beam(feats, sentiment, obj_att_embeds, noise, n_z))


def _numpy(out):
    if isinstance(out, tuple):
        return tuple(_numpy(o) for o in out)
    return out.cpu().numpy()


def _collect_group(_C, model_cfg, kind_out, prepared, n_z):
    """Fetch a dispatched group's results and run the host-side selection.
    Returns a list of (n_z, T) token arrays, one per image, in input
    order."""
    kind, out = kind_out
    out = _numpy(out)
    B = len(prepared)
    if kind == "sample":
        return [out[:, b, :] for b in range(B)]               # (n_z, T) each
    if kind == "cbs_simple":
        best, _ = out
        return [best[:, b, :] for b in range(B)]              # (n_z, T) each
    if kind == "cbs_grounded":
        seqs, lp = out
        grouped = [[] for _ in range(B)]
        for z in range(n_z):
            cands, c2s, per_nc = [], [], []
            for b, _ in prepared:
                ci = min(z, len(b["candidates"]) - 1)
                ni = min(z, len(b["num_constraints"]) - 1)
                cands.append(b["candidates"][ci])
                c2s.append(b["constraint2states"][ci])
                per_nc.append(int(b["num_constraints"][ni]))
            best, _ = select_best_beam_with_constraints(
                seqs[z], lp[z], per_nc, cands, c2s,
                model_cfg.min_constraints_to_satisfy, cbs_simple=False)
            for b in range(B):
                grouped[b].append(best[b])
        return [np.stack(toks) for toks in grouped]
    seqs, _ = out
    return [seqs[:, b, :] for b in range(B)]


def _decode_one(_C, model_cfg, harness, batch, feats, sentiment, obj_att_embeds, noise, n_z,
                sampler=None):
    """One image's decode, as a group of one: (n_z, T) token ids."""
    if sampler is not None:
        toks = harness.decode_sample(feats, sentiment, obj_att_embeds, noise, n_z, **sampler)
        return toks[:, 0, :].cpu().numpy()                    # (n_z, T)
    if _C.MODEL.USE_CBS:
        if model_cfg.cbs_simple:
            best, _ = harness.decode_cbs(
                feats, sentiment, obj_att_embeds, batch["fsm_tables"],
                batch["num_constraints"], noise, n_z)
            return best[:, 0, :].cpu().numpy()               # (n_z, T)
        seqs, lp = _numpy(harness.decode_cbs(
            feats, sentiment, obj_att_embeds, batch["fsm_tables"],
            batch["num_constraints"], noise, n_z, return_all=True))
        captions_tok = []
        for z in range(n_z):
            ci = min(z, len(batch["candidates"]) - 1)
            ni = min(z, len(batch["num_constraints"]) - 1)
            best, _ = select_best_beam_with_constraints(
                seqs[z], lp[z], [int(batch["num_constraints"][ni])],
                [batch["candidates"][ci]], [batch["constraint2states"][ci]],
                model_cfg.min_constraints_to_satisfy, cbs_simple=False)
            captions_tok.append(best[0])
        return np.stack(captions_tok)
    seqs, _ = harness.decode_beam(feats, sentiment, obj_att_embeds, noise, n_z)
    return seqs[:, 0, :].cpu().numpy()


if __name__ == "__main__":
    raise SystemExit(report_launches(main()))
