"""Train the Style-SeqCVAE captioner or the UpDown baseline (counterpart of
the JAX package's ``scripts/train.py``, itself a mirror of
var_updown/scripts/train.py:76-188).

    python -m style_seqcvae_tpu_torch.scripts.train --config cfg.yml \\
        --serialization-dir runs/x [--model baseline] [--bf16-compute] \\
        [--device-corpus] [--steps-per-dispatch K] [--max-iterations N] [--cpu]

The loop is the JAX CLI's: infinite shuffled batches from
``TrainingDataset.batches`` (``random.Random(RANDOM_SEED)``), loss =
mean(reconstruction) + mean(kld) / KLD_WEIGHT, SGD with momentum, weight
decay, ``LambdaLR`` linear decay and the global-norm clip, the decoder-freeze
schedule, ``metrics.jsonl`` every PRINT_EVERY_N_BATCHES steps, a line every
2,000, ``checkpoint_{it}`` every ``--checkpoint-every`` steps (print and
checkpoint cadences snap to the ends of K-step calls), and the final
``checkpoint_{N}``. Host collation and the copy to the device run on a
prefetch thread. It runs on ``cuda`` unless ``--cpu`` is given, and raises
without a GPU.

Parameters are drawn by ``init_captioner`` (``init_baseline`` for
``--model baseline``) on the CPU with seed RANDOM_SEED (GloVe from
DATA.GLOVE_CACHE, else ``hashed_random_embeddings``, for the tied head) and
copied to the device; the z-noise generator is seeded with RANDOM_SEED + 1.
The baseline trains the masked cross entropy alone (no KL, no decoder
freeze), as the JAX CLI's: ``--device-corpus`` is off for it and
``--steps-per-dispatch`` above 1 is refused. Checkpoints are the port's
directories (``training/checkpointing.py``), which
``--start-from-checkpoint NAME`` resumes step for step and the port's
inference CLI reads.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.datasets import TrainingDataset
from style_seqcvae_tpu_torch.data.latents import LatentDictionary
from style_seqcvae_tpu_torch.data.prefetch import prefetch
from style_seqcvae_tpu_torch.data.vocabulary import (
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.baseline import init_baseline
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    hashed_random_embeddings,
    init_captioner,
    load_glove_embeddings,
)
from style_seqcvae_tpu_torch.training.checkpointing import CheckpointManager
from style_seqcvae_tpu_torch.training.trainer import (
    create_train_state,
    make_baseline_train_step,
    make_chained_train_step,
    make_corpus_chained_train_step,
    make_corpus_train_step,
    make_train_step,
)
from style_seqcvae_tpu_torch.utils.logging import MetricsWriter, StepTimer, device_sync

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--config", required=True)
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument("--model", choices=["cvae", "baseline"], default="cvae",
                    help="cvae = Style-SeqCVAE (var_updown); baseline = "
                         "non-variational UpDown (updown-baseline)")
parser.add_argument("--serialization-dir", default="checkpoints/experiment")
parser.add_argument("--checkpoint-every", type=int, default=10000)
parser.add_argument("--start-from-checkpoint", default="",
                    help="a checkpoint name in --serialization-dir to resume from")
parser.add_argument("--in-memory", action="store_true")
parser.add_argument("--num-data", type=int, default=-1,
                    help="data-parallel size: -1 (all) and 1 both mean the one device "
                         "the port trains on; more waits for ROADMAP A10")
parser.add_argument("--num-model", type=int, default=1)
parser.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the GPU")
parser.add_argument("--bf16-compute", action="store_true",
                    help="bfloat16 forward and backward with float32 master params "
                         "and optimizer")
parser.add_argument("--max-iterations", type=int, default=0,
                    help="override OPTIM.NUM_ITERATIONS for smoke runs")
parser.add_argument("--device-corpus", action="store_true",
                    help="copy the whole features corpus (and the mode-2 attribute "
                         "embedding table) to the device once and gather each batch's "
                         "rows by index inside the step")
parser.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K optimizer steps per call over K stacked batches; the same "
                         "math as K single steps; checkpoint and print cadences snap "
                         "to call boundaries")


def _embedding_table(_C, model_cfg: CaptionerConfig, vocabulary) -> Optional[np.ndarray]:
    """The frozen table of the tied head: GloVe if cached, else hashed."""
    if not model_cfg.tie_embeddings:
        return None
    if _C.DATA.GLOVE_CACHE:
        paths = [(os.path.join(_C.DATA.GLOVE_CACHE, "glove.42B.300d.txt"), 300)]
        if model_cfg.embedding_size == 600:
            paths.append((os.path.join(_C.DATA.GLOVE_CACHE, "deps.words"), 300))
        return load_glove_embeddings(vocabulary, model_cfg.embedding_size, paths,
                                     model_cfg.pad_index)
    tokens = [vocabulary.get_token_from_index(i) for i in range(vocabulary.get_vocab_size())]
    return hashed_random_embeddings(tokens, model_cfg.embedding_size, model_cfg.pad_index)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, float]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code. ``stats``, when given, receives ``steps`` (run here), ``start``
    (the first iteration) and the :class:`StepTimer` summary (``data_ms``,
    ``step_ms``: host milliseconds a step)."""
    _A = parser.parse_args(argv)
    if _A.num_data not in (-1, 1) or _A.num_model != 1:
        raise NotImplementedError("--num-data/--num-model other than one device: "
                                  "multi-GPU training is not ported yet (ROADMAP A10)")
    device = resolve_device("cpu" if _A.cpu else None)

    _C = Config(_A.config, _A.config_override)
    print(_C)
    os.makedirs(_A.serialization_dir, exist_ok=True)
    _C.dump(os.path.join(_A.serialization_dir, "config.yml"))

    random.seed(_C.RANDOM_SEED)
    np.random.seed(_C.RANDOM_SEED)

    vocabulary = Vocabulary.from_files(_C.DATA.VOCABULARY)
    if _C.DATA.CBS.WORDFORMS:
        add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS)
    if _C.DATA.CBS.WORDFORMS_ATTRIBS:
        add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS_ATTRIBS)

    dataset = TrainingDataset.from_config(_C, vocabulary=vocabulary, in_memory=_A.in_memory)
    print("final dataset length:", len(dataset))
    model_cfg = CaptionerConfig.from_config(_C, vocabulary)

    latent_dict = None
    if model_cfg.sentiment_vae == 2:
        if model_cfg.latent_embedding == "glove" and _C.DATA.SENTIGLOVE:
            latent_dict = LatentDictionary.from_sentiglove(
                _C.DATA.SENTIGLOVE, model_cfg.z_space, model_cfg.latent_embedding_multip)
        elif model_cfg.latent_embedding == "senti_word_net" and _C.DATA.SWN_SCORES:
            latent_dict = LatentDictionary.from_swn_scores(
                _C.DATA.SWN_SCORES, model_cfg.z_space, model_cfg.latent_embedding_multip)

    init = init_baseline if _A.model == "baseline" else init_captioner
    params = init(model_cfg, seed=_C.RANDOM_SEED, device="cpu",
                  embedding_table=_embedding_table(_C, model_cfg, vocabulary))
    state = create_train_state(params, _C, model_cfg, _C.RANDOM_SEED + 1, device=device)
    del params
    compute_dtype = torch.bfloat16 if _A.bf16_compute else None
    k_steps = max(1, _A.steps_per_dispatch)
    kld_weight = _C.MODEL.KLD_WEIGHT
    device_corpus = _A.device_corpus and _A.model != "baseline"

    feats_dev, feat_row_of = None, None
    if _A.model == "baseline":
        if k_steps > 1:
            raise SystemExit("--steps-per-dispatch supports the cvae family")
        train_step = make_baseline_train_step(model_cfg, compute_dtype)
    elif device_corpus:
        table, feat_row_of = dataset.feature_table()
        to = compute_dtype or torch.float32
        feats_dev = torch.from_numpy(table).to(device, to)
        if latent_dict is not None:
            # mode 2: the per-image prior-embedding table, gathered by the
            # same feat_idx
            oae = dataset.obj_att_embed_table(latent_dict, feat_row_of)
            feats_dev = {"image_features": feats_dev,
                         "obj_att_embeds": torch.from_numpy(oae).to(device, to)}
        dataset.skip_feature_read = True
        nbytes = sum(t.numel() * t.element_size() for t in
                     (feats_dev.values() if isinstance(feats_dev, dict) else [feats_dev]))
        print(f"device corpus: {table.shape} ({nbytes / 1e6:.0f} MB on device"
              f"{', + mode-2 embed table' if latent_dict is not None else ''})")
        del table
        step1 = make_corpus_train_step(model_cfg, kld_weight, compute_dtype)
        stepk = make_corpus_chained_train_step(model_cfg, kld_weight, compute_dtype)
        train_step = lambda s, b: step1(s, feats_dev, b)  # noqa: E731
        chained_step = lambda s, b: stepk(s, feats_dev, b)  # noqa: E731
    else:
        train_step = make_train_step(model_cfg, kld_weight, compute_dtype)
        chained_step = make_chained_train_step(model_cfg, kld_weight, compute_dtype)

    ckpt = CheckpointManager(_A.serialization_dir, mode="max")
    start_iteration = 1
    if _A.start_from_checkpoint:
        state = ckpt.restore(_A.start_from_checkpoint, state)
        start_iteration = state.step + 1
        print(f"resumed from step {start_iteration - 1}")

    writer = MetricsWriter(_A.serialization_dir)
    timer = StepTimer()
    num_iterations = _A.max_iterations or _C.OPTIM.NUM_ITERATIONS
    batches = dataset.batches(_C.OPTIM.BATCH_SIZE, rng=random.Random(_C.RANDOM_SEED),
                              process_shard=(0, 1))

    def host_batches():
        for batch in batches:
            model_batch = {"caption_tokens": batch["caption_tokens"],
                           "sentiment": batch["sentiment"]}
            if device_corpus:
                model_batch["feat_idx"] = np.asarray(
                    [feat_row_of[int(i)] for i in batch["image_id"]], np.int64)
            else:
                model_batch["image_features"] = batch["image_features"]
            if (latent_dict is not None and not device_corpus
                    and batch["obj_atts"] is not None):
                model_batch["obj_att_embeds"] = latent_dict.translate_obj_atts(
                    batch["obj_atts"], _C.DATA.MAX_BOXES)
            yield model_batch

    total_steps = num_iterations - start_iteration + 1
    n_windows = total_steps // k_steps if k_steps > 1 else 0

    def staged_batches():
        """Host collation and the copy to the device, ahead of the loop:
        K stacked batches a call for the full windows, then singles."""
        src = host_batches()
        for _ in range(n_windows):
            group = [next(src) for _ in range(k_steps)]
            yield {k: torch.from_numpy(np.stack([g[k] for g in group])).to(device)
                   for k in group[0]}
        for model_batch in src:
            yield {k: torch.from_numpy(np.asarray(v)).to(device)
                   for k, v in model_batch.items()}

    staged = iter(prefetch(staged_batches(), buffer_size=2))

    def emit(iteration, metrics, idx=None):
        get = (lambda m: device_sync(m) if idx is None else float(m[idx]))
        if iteration % _C.PRINT_EVERY_N_BATCHES == 0:
            writer.scalars(iteration, {
                "reconstr_loss": get(metrics["reconstr_loss"]),
                "kld_loss": get(metrics["kld_loss"]),
                "loss": get(metrics["loss"]),
                **timer.summary()})
        if iteration % 2000 == 0:
            print(f"{iteration}: loss={get(metrics['loss']):.6f}")

    iteration = start_iteration
    windows_done = 0
    while iteration <= num_iterations:
        if windows_done < n_windows:
            windows_done += 1
            with timer.phase("data", count=k_steps):
                model_batch = next(staged)
            with timer.phase("step", count=k_steps):
                state, metrics_k = chained_step(state, model_batch)
            window = range(iteration, iteration + k_steps)
            if any(it % _C.PRINT_EVERY_N_BATCHES == 0 or it % 2000 == 0 for it in window):
                metrics_k = {k: v.cpu().numpy() for k, v in metrics_k.items()}
                for j, it in enumerate(window):
                    emit(it, metrics_k, idx=j)
            if any(it % _A.checkpoint_every == 0 for it in window):
                # the chained state exists only at the window's end
                ckpt.step(state, metric=0.0, iteration=window[-1])
            iteration += k_steps
        else:
            with timer.phase("data"):
                model_batch = next(staged)
            with timer.phase("step"):
                state, metrics = train_step(state, model_batch)
            emit(iteration, metrics)
            if iteration % _A.checkpoint_every == 0:
                ckpt.step(state, metric=0.0, iteration=iteration)
            iteration += 1

    ckpt.save(state, f"checkpoint_{num_iterations}")
    writer.close()
    if stats is not None:
        stats.update(timer.summary(), steps=total_steps, start=start_iteration)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
