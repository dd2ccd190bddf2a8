#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``style_seqcvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100 for the ``sm_90a`` kernels) and ``nvcc``; makes
its weights, features, FSM tables and z-noise from seeds, in-process. Prints
one JSON line per phase as it goes:

1. ``build``: the CUDA kernels built from ``style_seqcvae_tpu_torch/csrc``,
   then kernel A's registers and spills as ``-Xptxas -v`` reported them;
2. ``kernel``: each kernel against its plain PyTorch version at the flagship
   decode shapes, in bf16 and f32, with its time (the median of 5 timings of
   10 launches, and their range), the plain version's time and the least
   time the card could take (fails above the stated tolerances); kernels A
   and B in bf16 also at ragged shapes (A: R = 1,000, E = 300, which the
   wrapper pads to 304; B: R = 1,000, V = 10,501, whose odd rows start off
   16-byte boundaries);
3. ``agree``: small f32 decodes on the GPU against the same decodes on the
   CPU on shared seeded noise: ``decode_cbs`` with each of its four
   selections (prehead and fused through the kernels, whose plain versions
   run on the CPU; raw and logprob without a kernel), ``decode_beam``,
   ``greedy_decode``, and the dense CBS over the packed FSM against
   ``constrained_beam_search_fast`` (logprob) on the CPU on the reachable
   states, ``decode_sample`` with each of its four samplers on shared
   z-noise and Gumbel noise (topp at temperature 0.8), and ``decode_cbs``
   with the mode-2 prior (``sentiment_vae=2``, seeded attribute embeddings)
   through raw and prehead; each row reports the share of identical tokens
   and the largest score difference where they are identical;
4. ``decode``: the full-width Style-SeqCVAE CBS decode (BASELINE.json config
   3: V=10500, E=600, H=900, P=768, z=150, F=2048, 100 boxes, 20 steps, batch
   16 x 20 z-samples x 8 FSM states x beam 5, sentiment_vae 1, bf16) through
   ``DecodeHarness.decode_cbs`` once per selection, with each kernel's launch
   count from that run, then ``decode_compare``: the share of identical best
   captions for every pair of selections;
5. ``beam``: ``DecodeHarness.decode_beam`` at config 3's widths (batch 16 x
   20 z x beam 5, bf16); ``greedy``: BASELINE.json config 1 as bench.py
   builds it (``greedy_decode`` on the log-prob step, batch 100, 20 steps,
   bf16), one decode and 10 back to back with fresh noise;
6. ``kernel`` rows for the detector's kernels at the full-width shapes of
   BASELINE.json config 5: RoIAlign on a (16, 38, 58, 1024) C4 map with 4,800
   RoIs in f32 and bf16, and NMS at the RPN's 16 x 6,000 boxes and the
   per-class 1,280 x 300, each against its plain version and timed the same way,
   with NMS's two CUDA kernels, the bitmask and the scan, also timed alone
   (back to back as above, and as a CUDA graph of 10 calls, which leaves the
   wrapper's host time out), the bitmask's words held against
   ``suppression_bitmask_plain`` in the upper triangle, the scan alone held
   against ``greedy_scan_plain`` on the same mask, and all three again on
   the boundary set (boxes whose IoUs sit at the threshold's rounding
   boundary) against the plain versions on the CPU;
7. ``detect``: the full-width Faster R-CNN ResNet-101 (81 classes, 98
   attributes, 12 anchors, 16 canvases of 608 x 928) through
   ``extract_device_features``, with RoIAlign's and NMS's launch counts;
8. ``detect_agree``: the same forward stage by stage, each kernel's inputs
   from the path copied to the CPU and run through the plain versions there,
   and each stage's device time on the card;
9. ``e2e``: config 5 end to end, the detector's bf16 features fed to the
   full-width CBS decode (fused selection);
10. ``sample``: ``DecodeHarness.decode_sample`` at config 3's widths (16 x 20
   z, gumbel at beam 5, bf16) with each sampler at the inference CLI's
   defaults: first and warm decode seconds, captions/s, the output checks,
   the selection kernels' launches (0), ``distinct_per_image`` (distinct
   captions among an image's 20) and ``repeat_identical`` (the share of
   captions a second decode from the same seed repeats);
11. ``diverse``: BASELINE.json config 4 as bench.py:511-581 runs it (config
   3's model with the mode-2 prior, attribute embeddings RandomState(7)),
   3 rounds of a CBS decode and an oracle CIDEr re-score on the host,
   through raw and then prehead: decode and scoring seconds per round,
   captions/s with the scoring, ``oracle_cider``; ``diverse_kernel``:
   kernel A timed on its inputs from a mode-1 and a mode-2 decode;
12. ``cli``: the inference CLI (``style_seqcvae_tpu_torch.scripts.inference``)
   on a world that the port's own code writes (a vocabulary of 10,500
   tokens, a wordform TSV, a features.h5 of 48 images x 100 boxes x 2048,
   a YAML config with the published config's MODEL section at beam 5, 20 z,
   CBS on the sentiment word): first an ``agree`` row (its group functions
   on the GPU against the CPU at a small f32 width), ``cli_host`` (the
   host data path per image: reading, FSM building, packing, tables), then
   the CBS run (``--bf16 --batch-images 16``: 960 captions, kernel A 19
   times a group, no fallback) and a ``--sampler topp`` run (no kernel),
   each with its wall time, images/s, captions/s and the host's share;
13. ``train_agree``: small f32 train steps (TF32 off), the GPU against the
   CPU on the same params, batch and z-noise, in prior modes 0, 1 and 2:
   the metrics of 3 steps, each leaf's gradient norm and every leaf after
   the third, across the decoder's freeze boundary (no gradient at the
   first step on either side, one at the second);
14. ``train``: BASELINE.json config 2 (the published model, 100 boxes, 21
   teacher-forced steps) at batch 32 and 150, f32 and bf16 compute: ms a
   step (median of 18 single steps and its range; of 3 chained calls of
   K = 10), captions/s, peak memory, the card's time a step and its busy
   share from a ``torch.profiler`` trace of 3 steps, the loss over ~50
   steps on a fixed batch (finite and falling), the kernels' launches (0);
   batch 32 with the
   decoder frozen (the schedule's first phase) and through the device
   corpus; then ``train_bf16_vs_f32``, the two first losses;
15. ``train_cli``: the train CLI on a world the port writes (COCO and
   Senticap captions, features.h5, the vocabulary, the published MODEL and
   OPTIM sections at 12 iterations): 6 iterations with checkpoints every
   3, a resume from ``checkpoint_6`` to 12, StepTimer's data and step ms
   and the wall time of each run, then the inference CLI decoding 16 images
   from ``checkpoint_12`` (kernel A);
16. ``baseline_agree``: the UpDown baseline family (``--model baseline``),
   small f32 decodes on the GPU against the CPU on shared seeded noise
   (``decode_cbs`` through logprob, ``decode_beam``, ``decode_sample`` with
   each sampler; token-identical), then 3 train steps (TF32 off) with the
   tied and the untied head: the metrics, each leaf's gradient norm and
   every leaf after the third step;
17. ``baseline_decode``: the baseline at config 3's widths without z, bf16,
   ``decode_cbs`` (logprob) at batch 16 and 320 x 1 z and ``decode_beam``
   at 320 x 1 z: first and warm seconds, captions/s, the output checks;
18. ``baseline_train``: the baseline at config 2's widths, batch 32 and 150,
   f32 and bf16: ms a step (median of 18 and its range), captions/s, peak
   memory, the card's time, ops and busy share from a profiler trace of 3
   steps, the loss over 50 steps on a fixed batch (finite and falling);
19. ``baseline_cli`` and ``eval``: the train CLI at ``--model baseline`` on
   train_cli's world (12 iterations, checkpoints every 6), the inference
   CLI at ``--model baseline --bf16`` from its ``checkpoint_12`` over 16
   images on the card and on the CPU (no more fallbacks on the card), then
   the eval CLI (``style_seqcvae_tpu_torch.scripts.eval``) on those
   predictions and on train_cli's 320 cvae captions: seconds, every metric
   (finite, each oracle at or above its mean over z) and which METEOR ran.
   The kernels launch 0 times in phases 16-19;
20. ``images``: the JPEG fixtures (``tests/fixtures/images``) decoded on the
   card by nvjpeg against PIL's pixels (their ``.npy``), each within its own
   measured bound (``nvjpeg_bounds.json`` beside them); ``photo_a`` as
   PIL's PNG (``photo_a.png``, most rows Paeth) and as PPM, exact on the
   card; the decode times of a 480 x 640 JPEG, PNG and PPM and the prepare
   time to 600 x 800;
21. ``extract_cli``: the extract CLI over 32 images of 480 x 640 (30 JPEGs,
   the two photo fixtures in turn, one PNG, one PPM) with config 5's
   detector (ResNet-101, 81
   classes, 98 attributes, seeded weights passed as a ``.npz``), canvas 640
   x 1024, batch 16, ``--thresh 0.013``: images/s, the seconds of decode and
   prepare, forward, host post and write, detections per image, kernel C
   once and D once a batch (the host selection's per-class NMS is numpy, as
   JAX's); features.h5 read back by ``FeaturesReader``; then
   ``extract_cli_inference``, the inference CLI on that features.h5 (20 z,
   bf16, kernel A 19 times a group of 16);
22. ``serve_agree``: a small f32 serve (ResNet-50, 81 classes, 98
   attributes, 4 images): the card's detector outputs copied to the CPU,
   then the constraints, tables and decode on both sides: equal tables,
   identical captions, log-probs within 1e-5;
23. ``serve``: ``serving.make_serve_fn`` at full width (config 5's detector,
   config 3's captioner, 20 z, beam 5, 100 boxes, bf16, canvas 608 x 928,
   mode 1, bench.py's seeded table of 98 attributes): one request (median
   of 5), groups of 16 (median of 3, and each stage synchronised alone),
   images/s, captions/s, constraints and distinct captions per image, peak
   memory, and one group's launches (A 19, C 1, D 2);
24. ``serve_http``: the serve CLI started as a user starts it
   (``--http 0 --canvas 608 928 --batch-requests 8``, a subprocess) and
   ``scripts/load_test.py`` posting a 480 x 640 JPEG at 4 and 12 requests/s
   and its PNG at 4 requests/s (decoded on the host by the server's
   worker processes), 10 s each: p50, p95 and p99 ms, throughput, errors (any
   fails); the server is stopped after;

then the ``{"kernels": [...]}`` summary, the card's name and power limit from
``nvidia-smi``, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Exits non-zero at once without a GPU.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import pickle
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data import image_decode
from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection
from style_seqcvae_tpu_torch.data.datasets import EvaluationDatasetWithConstraints
from style_seqcvae_tpu_torch.data.detection import prepare_image
from style_seqcvae_tpu_torch.data.vocabulary import (
    BOUNDARY_TOKEN,
    UNK_TOKEN,
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.decoding import cbs_fast
from style_seqcvae_tpu_torch.decoding.beam_search import greedy_decode
from style_seqcvae_tpu_torch.decoding.cbs import constrained_beam_search
from style_seqcvae_tpu_torch.decoding.cbs_fast import (
    SELECTIONS,
    constrained_beam_search_fast,
    fsm_to_device,
    fsm_to_tables,
    stack_fsm_tables,
)
from style_seqcvae_tpu_torch.decoding.device_fsm import AttributeWordformTable, draw_gumbel
from style_seqcvae_tpu_torch.decoding.fsm import pack_fsm
from style_seqcvae_tpu_torch.decoding.harness import SAMPLERS, DecodeHarness, pad_tables_batch
from style_seqcvae_tpu_torch.evaluation import metrics as eval_metrics
from style_seqcvae_tpu_torch.evaluation.metrics import Cider
from style_seqcvae_tpu_torch.models.baseline import init_baseline
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    init_captioner,
    make_decode_context,
    make_optimized_step_fn,
)
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state
from style_seqcvae_tpu_torch.models.detector import defaults as det
from style_seqcvae_tpu_torch.models.detector import resnet
from style_seqcvae_tpu_torch.models.detector.extract import (
    decode_boxes,
    extract_device_features,
    select_detections_device,
)
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import (
    DetectorConfig,
    detector_forward_test,
    init_detector,
)
from style_seqcvae_tpu_torch.models.detector.rpn import (
    anchors_for,
    proposal_candidates,
    proposal_nms,
    rpn_heads,
)
from style_seqcvae_tpu_torch.ops.kernels import _build, nms, roi_align, topk_lse, vocab_topk_lse
from style_seqcvae_tpu_torch.scripts import eval as eval_cli
from style_seqcvae_tpu_torch.scripts import extract_features as extract_cli
from style_seqcvae_tpu_torch.scripts import inference as cli
from style_seqcvae_tpu_torch.scripts import load_test
from style_seqcvae_tpu_torch.scripts import train as train_cli
from style_seqcvae_tpu_torch.serving import make_serve_fn
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.training.trainer import (
    create_train_state,
    make_baseline_train_step,
    make_chained_train_step,
    make_corpus_chained_train_step,
    make_corpus_train_step,
    make_train_step,
)
from style_seqcvae_tpu_torch.utils.features_io import (
    FeaturesReader,
    FeaturesWriter,
    pack_obj_atts,
)
from style_seqcvae_tpu_torch.weights import (
    named_leaves,
    save_params_npz,
    to_device,
    to_jax_detector_params,
)

# flagship decode (bench.py:54-55, :424): reference run dims and grid
V, E, H, P, Z, F, BOXES, STEPS = 10500, 600, 900, 768, 150, 2048, 100, 20
BATCH, N_Z, STATES, BEAM = 16, 20, 8, 5
N_CONSTRAINTS = 3

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without them, HBM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# Kernel A's logits are E-long f32 dot products (|x| <= 1, |emb| ~ N(0, 1))
# summed in another order than cuBLAS's: a few 1e-5 apart. Kernel B reads
# the same values as its plain version and selects in the same order, so
# values and indices must be equal; its logsumexp sums 10,500 terms in
# another order.
TOL = {"vocab_topk_lse": {"vals": 1e-3, "lse": 1e-3, "idx_agree": 0.999},
       "topk_lse": {"vals": 0.0, "lse": 1e-3, "idx_agree": 1.0}}
# the small agreement decode: f32 on both sides, token-identical best
# captions for nearly every (z, image); a near-tie may flip one. The
# selections and decodes without a kernel (raw, logprob, beam, greedy, the
# dense CBS) differ from the CPU only in how the step's products are summed,
# so they must be identical on these seeded inputs.
AGREE_MIN = 0.9
AGREE_MIN_NO_KERNEL = 1.0
AGREE_LP_TOL = 1e-3
# config 1 (bench.py:243-323): greedy, batch 100, 10 decodes chained
GREEDY_BATCH, GREEDY_CHAIN = 100, 10
END_INDEX = CaptionerConfig(vocab_size=V).boundary_index
# the samplers as scripts/inference.py runs them by default (--sampler-k,
# --sampler-p, --sampler-temperature)
SAMPLER_KW = dict(top_k=5, top_p=0.9, temperature=1.0)
# config 4 (bench.py:511-581): the decode's mode-2 attribute embeddings,
# RandomState(7); the reference corpus decoded under another noise seed
# (bench.py's key 777); 3 rounds, each under a fresh seed
DIVERSE_OAE_SEED, DIVERSE_REF_SEED, DIVERSE_SEED0, DIVERSE_ROUNDS = 7, 777, 50, 3
# kernel A's input is taken from this step of a prehead decode to time it
# on the path's own activations
PREHEAD_PROBE_STEP = 10

# config 5's detector (bench.py:602-640): ResNet-101 C4, 81 classes, 98
# attributes, anchor scales (4, 8, 16, 32) x ratios (0.5, 1, 2), RoIAlign,
# 16 canvases of 608 x 928 holding 600 x 900 images at scale 1.5
DET_BATCH, CANVAS, IM_INFO = 16, (608, 928), (600.0, 900.0, 1.5)
DET_CLASSES, DET_ATTS, DET_DEPTH = 81, 98, 101
TEST = det.InferenceConfig()
C4 = (DET_BATCH, 38, 58, 1024)
ROIS = DET_BATCH * TEST.rpn_post_nms_top_n
# kernel D's two call sites in a forward, each one launch: (groups, boxes,
# threshold, max_out, presorted)
NMS_CALLS = {"nms_rpn": (DET_BATCH, TEST.rpn_pre_nms_top_n, TEST.rpn_nms_thresh,
                         TEST.rpn_post_nms_top_n, True),
             "nms_per_class": (DET_BATCH * (DET_CLASSES - 1), TEST.rpn_post_nms_top_n,
                               TEST.nms_thresh, 0, False)}
# f32 operations per IoU of a pair: 2 x (min, max, sub, add), 2 clamps, the
# product, add, sub, divide and the comparison. None is an FMA, while the
# published 67 TFLOP/s counts an FMA as two: the card issues these at about
# half that rate, so the stated bound is about half what it can reach.
NMS_OPS_PER_PAIR = 15
NMS_BOUND_NOTE = ("15 non-FMA f32 operations a pair over 67 TFLOP/s, a rate that counts an "
                  "FMA as two: the card issues them at about half that")
# the boundary set's groups at each site, small enough for the plain
# versions on the CPU
NMS_BOUNDARY_GROUPS = {"nms_rpn": 2, "nms_per_class": 64}
# f32 operations per RoIAlign output element: S^2 = 4 samples of 4 corner
# products and sums, and the mean
ROI_OPS_PER_OUT = 33
# Kernel C sums each bin's 16 weighted corners in another order than its
# plain version (same f32 weights and corner indices): a few 1e-7 on O(1)
# features, so 1e-5 absolute in f32; in bf16 both round their f32 means
# once, so neighbours one bf16 ulp (2^-7 relative) apart. Kernel D's
# decisions are exact: keep_idx and keep_mask must be identical.
ROI_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-6, 2.0 ** -7)}
# the inference CLI at config 3's grid: 48 images in groups of 16, 20 z each,
# CBS on the sentiment word ("pos", whose wordforms the CLI adds to the
# vocabulary); the model is the published config's MODEL section
# (configs/style_seqcvae_senticap.yml) at beam 5
CLI_IMAGES, CLI_GROUP, CLI_HOST_IMAGES = 48, 16, 4
CLI_FORMS = ("good", "great", "nice", "lovely")
PUBLISHED_MODEL = dict(IMAGE_FEATURE_SIZE=F, EMBEDDING_SIZE=E, HIDDEN_SIZE=H,
                       ATTENTION_PROJECTION_SIZE=P, Z_SPACE=Z, SENTIMENT_VAE=1,
                       SIMPLE_VAE="false", PRIOR_STD=1.0, SENTI_PRIOR_MULTIP=1.0,
                       KLD_WEIGHT=750, N_Z_SAMPLES=N_Z, STATE_MACHINE_PER_Z_SAMPLE="true",
                       BEAM_SIZE=BEAM, USE_CBS="true", CBS_SIMPLE="true",
                       MIN_CONSTRAINTS_TO_SATISFY=2)
# detect_agree: pooled features of the path, whose scale is set by the
# random ResNet (measured up to ~10): 1e-5 relative to the largest value
DETECT_AGREE_REL = 1e-5

SOURCES = {
    # the summary row is the bf16 path's; f32 runs csrc/vocab_topk_lse.cu
    "vocab_topk_lse": ("style_seqcvae_tpu_torch/csrc/vocab_topk_lse_sm90.cu",
                       "style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py:113"),
    "topk_lse": ("style_seqcvae_tpu_torch/csrc/topk_lse.cu",
                 "style_seqcvae_tpu/ops/pallas/topk_lse.py:76"),
    "roi_align": ("style_seqcvae_tpu_torch/csrc/roi_align.cu",
                  "style_seqcvae_tpu/ops/pallas/roi_align.py:92"),
    **{site: ("style_seqcvae_tpu_torch/csrc/nms.cu", "style_seqcvae_tpu/ops/pallas/nms.py:58")
       for site in NMS_CALLS},
}

KERNELS = {"vocab_topk_lse": vocab_topk_lse, "topk_lse": topk_lse, "roi_align": roi_align,
           "nms": nms}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_range(fn, reps: int = 10, samples: int = 5):
    """Median and [min, max] of ``samples`` timings by :func:`time_ms`, each
    the mean of ``reps`` launches, after one warm-up call."""
    ms = sorted(time_ms(fn, reps, warmup=1 if i == 0 else 0) for i in range(samples))
    return ms[samples // 2], [ms[0], ms[-1]]


def graph_ms_range(fn, reps: int = 10, samples: int = 5):
    """Device time of one call of ``fn``: median and [min, max] over
    ``samples`` replays of a CUDA graph of ``reps`` calls (CUDA events), so
    that the host's time per call, which back-to-back timing sees when a
    kernel is shorter, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms, rng = time_ms_range(graph.replay, reps=3, samples=samples)
    return ms / reps, [rng[0] / reps, rng[1] / reps]


def bound(n_bytes: float, n_ops: float, peak: float) -> dict:
    """The least time the card could take: bytes over HBM's rate or
    operations over the type's peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def synthetic_fsm(rng: np.random.RandomState, vocab: int) -> np.ndarray:
    """Simple-CBS FSM as bench.py:151-172 builds it: 3 single-word constraints
    x 2 wordforms over ``STATES`` states."""
    fsm = np.zeros((STATES, STATES, vocab), np.uint8)
    for s in range(STATES):
        fsm[s, s, :] = 1
    toks = rng.randint(2, vocab, (N_CONSTRAINTS, 2))
    for c in range(N_CONSTRAINTS):
        stride = 2 ** c
        for s in range(STATES):
            if not (s & stride) and (s | stride) < STATES:
                for t in toks[c]:
                    fsm[s, s | stride, t] = 1
                    fsm[s, s, t] = 0
    return fsm


def ptxas_entries(log: str, needle: str) -> list:
    """Registers, static shared memory, stack and spills that ``-Xptxas -v``
    reported for each entry function whose name holds ``needle``."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": m.group(1)} if needle in m.group(1) else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def phase_build() -> None:
    t0 = time.time()
    # the nvjpeg binding's own library, built beside the kernels' at once
    nvjpeg_lib = []
    nvjpeg_thread = threading.Thread(target=lambda: nvjpeg_lib.append(_build.build_nvjpeg()))
    nvjpeg_thread.start()
    path = _build.build()
    _build.library()
    nvjpeg_thread.join()
    if not nvjpeg_lib:
        fail("the nvjpeg binding did not build")
    log = (path.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "library": str(path),
          "nvjpeg_library": str(nvjpeg_lib[0]), "ptxas": ptxas})
    # kernel A's two paths: bf16 (wgmma product + partial top-k, then the
    # merge) and f32 (CUDA cores); its bf16 shared memory is dynamic
    emit({"phase": "build_vocab_topk_lse", "ptxas": ptxas_entries(log, "vocab_topk_lse")})


def kernel_row(name: str, c: dict, dtype: torch.dtype, shape: dict) -> dict:
    """Run one kernel case against its plain version, time both, emit the
    row and fail above the tolerance."""
    got = c["kernel"]()
    want = c["plain"]()
    torch.cuda.synchronize()
    vals_err = (got[0] - want[0]).abs().max().item()
    lse_err = (got[2] - want[2]).abs().max().item()
    agree = (got[1] == want[1]).float().mean().item()
    kernel_ms, kernel_range = time_ms_range(c["kernel"])
    plain_ms = time_ms(c["plain"], c["plain_reps"])
    row = {"phase": "kernel", "name": name, "dtype": str(dtype).split(".")[-1], **shape,
           "max_abs_err_vals": vals_err, "max_abs_err_lse": lse_err,
           "idx_agree": agree, "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
           "plain_ms": plain_ms,
           # no single PyTorch call computes top-k with logsumexp
           "library_ms": None,
           **bound(c["bytes"], c["ops"], c["peak"]),
           "tolerance": TOL[name], **c.get("extra", {})}
    emit(row)
    tol = TOL[name]
    if not (vals_err <= tol["vals"] and lse_err <= tol["lse"] and agree >= tol["idx_agree"]):
        fail(f"{name} ({row['dtype']}) disagrees with its plain version: {row}")
    return row


def vocab_case(x: torch.Tensor, emb: torch.Tensor, k: int) -> dict:
    (R, E), V = x.shape, emb.shape[0]
    size = x.element_size()
    extra = {}
    if x.dtype == torch.bfloat16:
        extra["plan"] = vocab_topk_lse.bf16_plan(R, V, E + (-E % 8), k)
    return dict(kernel=lambda: vocab_topk_lse.matmul_top_k_with_lse(x, emb, k),
                plain=lambda: vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, k),
                bytes=(R * E + V * E) * size + R * k * 8 + R * 4,
                ops=2 * R * V * E, peak=PEAK_OPS[x.dtype], plain_reps=2, extra=extra)


def topk_case(logits: torch.Tensor, k: int) -> dict:
    R, V = logits.shape
    return dict(kernel=lambda: topk_lse.top_k_with_lse(logits, k),
                plain=lambda: topk_lse.top_k_with_lse_plain(logits, k),
                bytes=R * V * logits.element_size() + R * k * 8 + R * 4,
                # max, exp, add and one comparison per element, f32 on CUDA cores
                ops=4 * R * V, peak=PEAK_OPS[torch.float32], plain_reps=2)


def phase_kernels(k: int, dev: torch.device) -> dict:
    """Each kernel against its plain version at the flagship shapes, and
    kernel A's bf16 path at a ragged shape; returns the bf16 flagship rows
    for the summary line."""
    R = BATCH * N_Z * STATES * BEAM
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.tanh(torch.randn(R, E, generator=gen, device=dev)).to(dtype)
        emb = torch.randn(V, E, generator=gen, device=dev).to(dtype)
        logits = torch.matmul(x, emb.T)                # the fused path's (R, V) logits
        cases = {"vocab_topk_lse": vocab_case(x, emb, k), "topk_lse": topk_case(logits, k)}
        for name, c in cases.items():
            row = kernel_row(name, c, dtype, {"rows": R, "vocab": V, "k": k, "width":
                                              E if name == "vocab_topk_lse" else None})
            if dtype == torch.bfloat16:
                out[name] = row
        # yardsticks, for scale only: cuBLAS's head matmul alone and torch.topk alone
        emit({"phase": "yardstick", "dtype": str(dtype).split(".")[-1],
              "torch_matmul_head_ms": time_ms(lambda: torch.matmul(x, emb.T), 5),
              "torch_topk_ms": time_ms(lambda: torch.topk(logits, k), 5)})
        del x, emb, logits
    # ragged rows and a width that TMA's 16-byte rows need padded (300 -> 304)
    r_rag, e_rag = 1000, 300
    x = torch.tanh(torch.randn(r_rag, e_rag, generator=gen, device=dev)).to(torch.bfloat16)
    emb = torch.randn(V, e_rag, generator=gen, device=dev).to(torch.bfloat16)
    kernel_row("vocab_topk_lse", vocab_case(x, emb, k), torch.bfloat16,
               {"rows": r_rag, "vocab": V, "k": k, "width": e_rag})
    # odd V: every other bf16 row starts off a 16-byte boundary
    v_rag = V + 1
    logits = (3 * torch.randn(r_rag, v_rag, generator=gen, device=dev)).to(torch.bfloat16)
    kernel_row("topk_lse", topk_case(logits, k), torch.bfloat16,
               {"rows": r_rag, "vocab": v_rag, "k": k, "width": None})
    return out


def decode_setup(cfg: CaptionerConfig, batch: int, n_z: int, boxes: int, seed: int):
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, boxes, cfg.image_feature_size).astype(np.float32)
    sentiment = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    tables = [[fsm_to_tables(synthetic_fsm(rng, cfg.vocab_size))] for _ in range(batch)]
    return feats, sentiment, pad_tables_batch(tables, n_z)


def agree_row(path: str, got: torch.Tensor, want: torch.Tensor, lp_got, lp_want, need: float,
              live=None, phase: str = "agree", **extra) -> tuple:
    """Emit the share of identical token rows (last axis) and the largest
    score difference where they are identical; fail below ``need`` or above
    AGREE_LP_TOL. ``live`` restricts both to the rows where it holds.
    Returns (share, score difference)."""
    got, want = got.cpu(), want.cpu()
    same = (got == want).all(dim=-1)
    live = torch.ones_like(same) if live is None else live.cpu()
    frac = same[live].float().mean().item()
    lp_err = None
    if lp_got is not None and bool((same & live).any()):
        lp_err = (lp_got.cpu() - lp_want.cpu())[same & live].abs().max().item()
    emit({"phase": phase, "path": path, "token_identical": frac, "rows": int(live.sum()),
          "max_abs_err_lp_where_identical": lp_err, **extra})
    if frac < need or (lp_err is not None and lp_err > AGREE_LP_TOL):
        fail(f"GPU {path} disagrees with the CPU: {frac} identical (need {need}), "
             f"lp error {lp_err}")
    return frac, lp_err


def phase_agree(dev: torch.device) -> None:
    """Small f32 decodes: the GPU against the CPU on shared seeded noise."""
    cfg = CaptionerConfig(vocab_size=700, image_feature_size=64, embedding_size=300,
                          hidden_size=48, attention_projection_size=32, z_space=16,
                          sentiment_vae=1, simple_vae=False, max_caption_length=10,
                          beam_size=BEAM)
    batch, n_z, boxes = 4, 3, 10
    T = cfg.max_caption_length
    feats, sentiment, tables = decode_setup(cfg, batch, n_z, boxes, seed=2)
    noise = np.random.RandomState(3).randn(
        n_z, T, batch, STATES, BEAM, cfg.z_space).astype(np.float32)
    params_cpu = init_captioner(cfg, seed=4, device="cpu")
    params_gpu = to_device(params_cpu, dev)
    cpu = DecodeHarness(params_cpu, cfg, device="cpu")
    gpu = DecodeHarness(params_gpu, cfg, device=dev)
    for selection in SELECTIONS:
        args = (feats, sentiment, None, tables, N_CONSTRAINTS, noise, n_z)
        ref = cpu.decode_cbs(*args, selection=selection)
        got = gpu.decode_cbs(*args, selection=selection)
        kernel = selection in ("prehead", "fused")
        agree_row(f"decode_cbs/{selection}", got[0], ref[0], got[1], ref[1],
                  AGREE_MIN if kernel else AGREE_MIN_NO_KERNEL, selection=selection)

    beam_noise = noise[:, :, :, 0]                                  # (n_z, T, B, K, z)
    ref = cpu.decode_beam(feats, sentiment, None, beam_noise, n_z)
    got = gpu.decode_beam(feats, sentiment, None, beam_noise, n_z)
    agree_row("decode_beam", got[0], ref[0], got[1], ref[1], AGREE_MIN_NO_KERNEL)

    # greedy and the dense CBS on one z: (T, B, ...) noise rows
    rows = torch.from_numpy(noise[0])                                # (T, B, S, K, z)
    dense = [synthetic_fsm(np.random.RandomState(5 + b), cfg.vocab_size) for b in range(batch)]
    packed = np.stack([pack_fsm(d) for d in dense])
    fsm_cpu = fsm_to_device(stack_fsm_tables([fsm_to_tables(d) for d in dense]),
                            torch.device("cpu"))
    kw = dict(max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2,
              end_index=cfg.boundary_index)
    out = {}
    for side, d, params in (("cpu", torch.device("cpu"), params_cpu), ("gpu", dev, params_gpu)):
        ctx = make_decode_context(params, cfg, torch.from_numpy(feats).to(d),
                                  sentiment=torch.from_numpy(sentiment).to(d))
        step = make_optimized_step_fn(params, cfg, ctx)
        start = torch.full((batch,), cfg.boundary_index, device=d)
        st = init_cell_state((batch,), cfg.hidden_size, device=d)
        with torch.inference_mode():
            out[side] = {"greedy": greedy_decode(step, start, st, rows[:, :, 0, :1].to(d),
                                                 max_steps=T, end_index=cfg.boundary_index)}
            if side == "cpu":
                out[side]["fast"] = constrained_beam_search_fast(
                    step, start, st, fsm_cpu, rows, selection="logprob", **kw)
            else:
                out[side]["dense"] = constrained_beam_search(step, start, st, packed,
                                                             rows.to(d), **kw)
    agree_row("greedy_decode", out["gpu"]["greedy"], out["cpu"]["greedy"], None, None,
              AGREE_MIN_NO_KERNEL)
    (seqs, lp), (fseqs, flp) = out["gpu"]["dense"], out["cpu"]["fast"]
    reach = flp > -1e18
    agree_row("dense_cbs_vs_fast_logprob_on_cpu", seqs, fseqs, lp, flp, AGREE_MIN_NO_KERNEL,
              live=reach, reachable_share=reach.float().mean().item())
    if not torch.equal(lp.cpu() > -1e18, reach):
        fail("the dense CBS on the GPU reaches other states than the fast CBS on the CPU")

    # the samplers on shared z-noise and Gumbel noise (-log E, E ~ Exp(1));
    # no kernel on their path
    rng = np.random.RandomState(6)
    for method in SAMPLERS:
        inner = (BEAM,) if method == "gumbel" else ()
        z = rng.randn(n_z, T, batch, BEAM if inner else 1, cfg.z_space).astype(np.float32)
        g = -np.log(rng.exponential(size=(n_z, T, batch) + inner + (cfg.vocab_size,)))
        sample_noise = (z, g.astype(np.float32))
        kw = {"temperature": 0.8} if method == "topp" else {}
        ref = cpu.decode_sample(feats, sentiment, None, sample_noise, n_z, method, **kw)
        got = gpu.decode_sample(feats, sentiment, None, sample_noise, n_z, method, **kw)
        agree_row(f"decode_sample/{method}", got, ref, None, None, AGREE_MIN_NO_KERNEL, **kw)

    # the mode-2 prior (config 4's): raw without a kernel, prehead through A
    cfg2 = cfg._replace(sentiment_vae=2)
    params2 = init_captioner(cfg2, seed=4, device="cpu")
    oae = np.random.RandomState(7).randn(batch, boxes, cfg2.z_space).astype(np.float32)
    cpu2 = DecodeHarness(params2, cfg2, device="cpu")
    gpu2 = DecodeHarness(to_device(params2, dev), cfg2, device=dev)
    for selection in ("raw", "prehead"):
        args = (feats, sentiment, oae, tables, N_CONSTRAINTS, noise, n_z)
        ref = cpu2.decode_cbs(*args, selection=selection)
        got = gpu2.decode_cbs(*args, selection=selection)
        agree_row(f"decode_cbs_mode2/{selection}", got[0], ref[0], got[1], ref[1],
                  AGREE_MIN if selection == "prehead" else AGREE_MIN_NO_KERNEL,
                  selection=selection, sentiment_vae=2)


def frozen_after_end(tokens: torch.Tensor, live: torch.Tensor) -> bool:
    """Live captions that emitted the end token emit nothing else after it."""
    ended = (torch.cumsum((tokens == END_INDEX).int(), dim=-1) > 0) & live[..., None]
    return bool((tokens[ended] == END_INDEX).all())


def check_decode_output(name: str, best: torch.Tensor, best_lp, shape: list, counts: dict,
                        expected: dict, row: dict) -> None:
    """Shape, vocabulary range, finite scores, frozen ended captions and the
    kernels' launch counts of a decode; emits ``row`` with them first."""
    in_vocab = bool(((best >= 0) & (best < V)).all())
    finite = True if best_lp is None else bool(torch.isfinite(best_lp).all())
    live = torch.ones(best.shape[:-1], dtype=torch.bool, device=best.device) \
        if best_lp is None else best_lp > -1e18
    frozen = frozen_after_end(best, live)
    emit({**row, "shape": list(best.shape), "launches": counts, "expected_launches": expected,
          "in_vocab": in_vocab, "finite_scores": finite, "frozen_after_end": frozen,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if list(best.shape) != shape or not in_vocab or not finite or not frozen:
        fail(f"{name} produced bad output")
    if counts != expected:
        fail(f"{name} launch counts {counts}, expected {expected}")


def decode_cfg(**kw) -> CaptionerConfig:
    """Config 3's model (bench.py:142-148), sentiment_vae 1."""
    base = dict(vocab_size=V, image_feature_size=F, embedding_size=E, hidden_size=H,
                attention_projection_size=P, z_space=Z, sentiment_vae=1, simple_vae=False,
                max_caption_length=STEPS, beam_size=BEAM)
    return CaptionerConfig(**{**base, **kw})


def selection_counts() -> dict:
    return {"vocab_topk_lse": vocab_topk_lse.launches, "topk_lse": topk_lse.launches}


def reset_selection_counts() -> None:
    vocab_topk_lse.launches = 0
    topk_lse.launches = 0


def phase_decode(dev: torch.device):
    cfg = decode_cfg()
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    feats, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    harness = DecodeHarness(params, cfg, device=dev)
    launches, best_by_sel = {}, {}
    kernel_of = {"prehead": "vocab_topk_lse", "fused": "topk_lse"}
    for selection in SELECTIONS:
        noise = torch.Generator(device=dev).manual_seed(7)
        reset_selection_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        best, best_lp = harness.decode_cbs(feats, sentiment, None, tables, N_CONSTRAINTS,
                                           noise, N_Z, selection=selection)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = selection_counts()
        t0 = time.time()
        harness.decode_cbs(feats, sentiment, None, tables, N_CONSTRAINTS,
                           torch.Generator(device=dev).manual_seed(7), N_Z, selection=selection)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        expected = {name: STEPS - 1 if kernel_of.get(selection) == name else 0
                    for name in counts}
        check_decode_output(f"decode ({selection})", best, best_lp, [N_Z, BATCH, STEPS],
                            counts, expected,
                            {"phase": "decode", "selection": selection,
                             "best_lp_min": best_lp.min().item(), "first_run_s": first_s,
                             "warm_run_s": warm_s, "captions_per_s": BATCH * N_Z / warm_s})
        if selection in kernel_of:
            launches[kernel_of[selection]] = counts[kernel_of[selection]]
        best_by_sel[selection] = best

    def identical(a, b):
        return (best_by_sel[a] == best_by_sel[b]).all(dim=-1).float().mean().item()

    # in bf16 only raw and fused rank the same rounded logits (kernel B
    # against small_top_k on ties); prehead computes its logits in the
    # kernel, logprob ranks the rounded log-probs
    emit({"phase": "decode_compare",
          "prehead_vs_fused_identical": identical("prehead", "fused"),
          "identical": {f"{a}_vs_{b}": identical(a, b)
                        for i, a in enumerate(SELECTIONS) for b in SELECTIONS[i + 1:]}})
    return launches, (harness, sentiment, tables)


def phase_beam(dev: torch.device, decode_state) -> None:
    """decode_beam at config 3's widths: 16 images x 20 z x beam 5, bf16."""
    harness, sentiment, _ = decode_state
    feats = np.random.RandomState(0).randn(BATCH, BOXES, F).astype(np.float32)
    reset_selection_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    best, best_lp = harness.decode_beam(feats, sentiment, None,
                                        torch.Generator(device=dev).manual_seed(8), N_Z)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    counts = selection_counts()
    t0 = time.time()
    harness.decode_beam(feats, sentiment, None, torch.Generator(device=dev).manual_seed(8), N_Z)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    check_decode_output("beam", best, best_lp, [N_Z, BATCH, STEPS], counts,
                        {name: 0 for name in counts},
                        {"phase": "beam", "batch": BATCH, "n_z": N_Z, "beam": BEAM,
                         "best_lp_min": best_lp.min().item(), "first_run_s": first_s,
                         "warm_run_s": warm_s, "captions_per_s": BATCH * N_Z / warm_s})


def phase_greedy(dev: torch.device) -> None:
    """BASELINE.json config 1 as bench.py:243-323 builds it: greedy_decode on
    the optimized log-prob step, batch 100, 20 steps, bf16, beam 1. bench.py
    chains its 10 decodes in one dispatch and reports batch x 10 over their
    time: ``captions_per_s_chained`` (10 decodes back to back, one
    synchronisation) is the number to hold against it."""
    cfg = decode_cfg(beam_size=1)
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(GREEDY_BATCH, BOXES, F).astype(np.float32)).to(
        dev, torch.bfloat16)
    sentiment = torch.from_numpy(rng.choice([-1.0, 1.0], (GREEDY_BATCH, 1)).astype(
        np.float32)).to(dev)
    start = torch.full((GREEDY_BATCH,), cfg.boundary_index, device=dev)
    st = init_cell_state((GREEDY_BATCH,), cfg.hidden_size, device=dev, dtype=torch.bfloat16)

    def decode(gen):
        with torch.inference_mode():
            ctx = make_decode_context(params, cfg, feats, sentiment=sentiment)
            step = make_optimized_step_fn(params, cfg, ctx)
            return greedy_decode(step, start, st, gen, max_steps=STEPS,
                                 end_index=cfg.boundary_index)

    gen = torch.Generator(device=dev).manual_seed(9)
    reset_selection_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    toks = decode(gen)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    counts = selection_counts()
    t0 = time.time()
    decode(gen)
    torch.cuda.synchronize()
    one_s = time.time() - t0
    t0 = time.time()
    chained = [decode(gen) for _ in range(GREEDY_CHAIN)]
    torch.cuda.synchronize()
    chained_s = time.time() - t0
    distinct = len({tuple(c.flatten().tolist()) for c in chained})
    check_decode_output("greedy", torch.stack(chained), None,
                        [GREEDY_CHAIN, GREEDY_BATCH, STEPS], counts,
                        {name: 0 for name in counts},
                        {"phase": "greedy", "batch": GREEDY_BATCH, "first_run_s": first_s,
                         "one_decode_s": one_s,
                         "captions_per_s_one_decode": GREEDY_BATCH / one_s,
                         "chained_decodes": GREEDY_CHAIN, "chained_s": chained_s,
                         "captions_per_s_chained": GREEDY_BATCH * GREEDY_CHAIN / chained_s,
                         "comparable_to_bench": "captions_per_s_chained",
                         "distinct_chained_outputs": distinct})
    if toks.shape != (GREEDY_BATCH, STEPS):
        fail(f"greedy: one decode gave {tuple(toks.shape)}")


def phase_sample(dev: torch.device, decode_state) -> None:
    """DecodeHarness.decode_sample at config 3's widths (16 images x 20 z;
    gumbel at beam 5), bf16, sentiment_vae 1, one row per sampler with the
    inference CLI's defaults; each decode twice from the same seed."""
    harness, sentiment, _ = decode_state
    feats = np.random.RandomState(0).randn(BATCH, BOXES, F).astype(np.float32)
    for i, method in enumerate(SAMPLERS):
        def run():
            return harness.decode_sample(feats, sentiment, None,
                                         torch.Generator(device=dev).manual_seed(20 + i),
                                         N_Z, method, **SAMPLER_KW)

        reset_selection_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        toks = run()
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = selection_counts()
        t0 = time.time()
        again = run()
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        rows = toks.cpu().tolist()                                    # (n_z, B, T)
        distinct = float(np.mean([len({tuple(rows[k][b]) for k in range(N_Z)})
                                  for b in range(BATCH)]))
        check_decode_output(f"sample ({method})", toks, None, [N_Z, BATCH, STEPS], counts,
                            {name: 0 for name in counts},
                            {"phase": "sample", "method": method, **SAMPLER_KW,
                             "beam": BEAM if method == "gumbel" else None, "batch": BATCH,
                             "n_z": N_Z, "first_run_s": first_s, "warm_run_s": warm_s,
                             "captions_per_s": BATCH * N_Z / warm_s,
                             "distinct_per_image": distinct,
                             "repeat_identical": (toks == again).all(dim=-1).float()
                             .mean().item()})
        if method == "multinomial" and distinct == 1.0:
            fail("multinomial sampling gave one caption for every z of every image: "
                 "the noise does not reach the draw")


def tok_str(row) -> str:
    """bench.py's caption string: ``w{t}`` for every token t > 1."""
    return " ".join(f"w{t}" for t in row if t > 1) or "w0"


def oracle_cider(cider: Cider, corpus, gts: dict, seqs: list) -> float:
    """bench.py:549-558: each image's z whose caption scores the best CIDEr
    against the corpus, then the corpus CIDEr of those captions."""
    n_z, batch = len(seqs), len(seqs[0])
    per_z = [cider.compute_score(gts, {i: [tok_str(seqs[k][i])] for i in range(batch)},
                                 corpus=corpus)[1] for k in range(n_z)]
    best = np.argmax(np.stack(per_z, axis=1), axis=1)
    return cider.compute_score(gts, {i: [tok_str(seqs[best[i]][i])] for i in range(batch)},
                               corpus=corpus)[0]


def prehead_input(decode) -> torch.Tensor:
    """Kernel A's input (R, E) at step PREHEAD_PROBE_STEP of ``decode()``, a
    prehead decode, copied by a spy around the search's call of A."""
    calls, real = [], cbs_fast.matmul_top_k_with_lse

    def spy(x, emb, k):
        calls.append(x.clone() if len(calls) == PREHEAD_PROBE_STEP - 1 else None)
        return real(x, emb, k)

    cbs_fast.matmul_top_k_with_lse = spy
    try:
        decode()
    finally:
        cbs_fast.matmul_top_k_with_lse = real
    return calls[PREHEAD_PROBE_STEP - 1]


def phase_diverse(dev: torch.device, decode_state) -> None:
    """BASELINE.json config 4 as bench.py:511-581 runs it: config 3's model
    with the mode-2 prior (attribute embeddings RandomState(7)), bf16, 8
    FSM states, beam 5, then the oracle CIDEr re-score on the host, for 3
    rounds; once through the raw selection (bench.py's route) and once
    through prehead (kernel A). bench.py overlaps a round's scoring with the
    next decode; here they run in turn and are reported apart. Then kernel
    A timed on its inputs from a mode-1 and a mode-2 decode."""
    cfg = decode_cfg(sentiment_vae=2)
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    feats, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    oae = np.random.RandomState(DIVERSE_OAE_SEED).randn(BATCH, BOXES, Z).astype(np.float32)
    harness = DecodeHarness(params, cfg, device=dev)

    def decode(seed: int, selection: str):
        return harness.decode_cbs(feats, sentiment, oae, tables, N_CONSTRAINTS,
                                  torch.Generator(device=dev).manual_seed(seed), N_Z,
                                  selection=selection)

    ref = decode(DIVERSE_REF_SEED, "raw")[0].cpu().tolist()
    gts = {i: [tok_str(ref[0][i])] for i in range(BATCH)}
    cider = Cider()
    corpus = cider.make_corpus(gts)
    for selection in ("raw", "prehead"):
        expected = {"vocab_topk_lse": STEPS - 1 if selection == "prehead" else 0,
                    "topk_lse": 0}
        decode_s, score_s, scores = [], [], []
        for i in range(DIVERSE_ROUNDS):
            reset_selection_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            best, best_lp = decode(DIVERSE_SEED0 + i, selection)
            torch.cuda.synchronize()
            decode_s.append(time.time() - t0)
            counts = selection_counts()
            if counts != expected:
                fail(f"diverse ({selection}) round {i}: launch counts {counts}, "
                     f"expected {expected}")
            t0 = time.time()
            scores.append(oracle_cider(cider, corpus, gts, best.cpu().tolist()))
            score_s.append(time.time() - t0)
        total = sum(decode_s) + sum(score_s)
        check_decode_output(f"diverse ({selection})", best, best_lp, [N_Z, BATCH, STEPS],
                            counts, expected,
                            {"phase": "diverse", "config": 4, "selection": selection,
                             "sentiment_vae": 2, "rounds": DIVERSE_ROUNDS,
                             "decode_s": decode_s, "scoring_s": score_s,
                             "scoring_share": sum(score_s) / total,
                             "captions_per_s_with_scoring":
                                 DIVERSE_ROUNDS * BATCH * N_Z / total,
                             "captions_per_s_decode_only":
                                 DIVERSE_ROUNDS * BATCH * N_Z / sum(decode_s),
                             "oracle_cider": scores})
        if not all(np.isfinite(c) and c >= 0 for c in scores):
            fail(f"diverse ({selection}): oracle CIDEr {scores}")

    # kernel A on its own path's inputs: does the mode-2 prior change its time?
    mode1, sentiment1, tables1 = decode_state
    feats1 = np.random.RandomState(0).randn(BATCH, BOXES, F).astype(np.float32)
    x1 = prehead_input(lambda: mode1.decode_cbs(
        feats1, sentiment1, None, tables1, N_CONSTRAINTS,
        torch.Generator(device=dev).manual_seed(7), N_Z, selection="prehead"))
    x2 = prehead_input(lambda: decode(DIVERSE_SEED0, "prehead"))
    k = BEAM // 2 + tables.exc_token.shape[-1]
    timing = {}
    for name, x, emb in (("mode1", x1, mode1.params["embedding"]),
                         ("mode2", x2, params["embedding"])):
        ms, ms_range = time_ms_range(lambda: vocab_topk_lse.matmul_top_k_with_lse(x, emb, k))
        timing[name] = {"ms": ms, "ms_range": ms_range, "rows": x.shape[0]}
    emit({"phase": "diverse_kernel", "name": "vocab_topk_lse", "step": PREHEAD_PROBE_STEP,
          "k": k, "on_path_inputs": timing})


def seeded_rois(gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """4,800 RoIs in image coordinates, image-major as the proposal layer
    emits them: random boxes over and past the 600 x 900 image, tiny boxes
    and all-zero padding rows."""
    per = TEST.rpn_post_nms_top_n
    b = torch.arange(DET_BATCH, device=dev).repeat_interleave(per).float()[:, None]
    xy = torch.rand(ROIS, 2, generator=gen, device=dev) * torch.tensor(
        [1000.0, 700.0], device=dev) - 50.0
    wh = torch.rand(ROIS, 2, generator=gen, device=dev) * 400.0
    rois = torch.cat([b, xy, xy + wh], dim=1)
    rois[1::10, 3:] = rois[1::10, 1:3] + 3.0                 # tiny
    rois[per - 20::per, 1:] = 0.0                            # padding rows
    return rois.contiguous()


def seeded_nms_inputs(gen: torch.Generator, dev: torch.device, G: int, N: int,
                      presorted: bool):
    """Proposal-like boxes over a 600 x 900 image (16 to 400 px) with random
    scores, a share of them 0 like the per-class call's non-candidates."""
    ctr = torch.rand(G, N, 2, generator=gen, device=dev) * torch.tensor([900.0, 600.0],
                                                                         device=dev)
    wh = torch.rand(G, N, 2, generator=gen, device=dev) * 384.0 + 16.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.rand(G, N, generator=gen, device=dev)
    if presorted:
        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(G, N, 4))
    else:
        scores = torch.where(scores > 0.5, scores, 0.0)
    return boxes.contiguous(), scores


def phase_detector_kernels(dev: torch.device) -> dict:
    """Kernels C and D against their plain versions at config 5's shapes;
    returns the summary rows: C in f32, the detector's dtype, and one row for
    each of D's two call sites."""
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    rois = seeded_rois(gen, dev)
    P, S = det.POOLING_SIZE, 2
    kw = dict(spatial_scale=1.0 / det.FEAT_STRIDE, pooled_height=P, pooled_width=P,
              sampling_ratio=S)
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        feats = torch.randn(C4, generator=gen, device=dev).to(dtype)
        got = roi_align.roi_align(feats, rois, **kw)
        want = roi_align.roi_align_plain(feats, rois, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        atol, rtol = ROI_TOL[dtype]
        within = bool((err <= atol + rtol * want.float().abs()).all())
        n_out = ROIS * P * P * C4[-1]
        kernel_ms, kernel_range = time_ms_range(lambda: roi_align.roi_align(feats, rois, **kw))
        row = {"phase": "kernel", "name": "roi_align", "dtype": str(dtype).split(".")[-1],
               "features": list(C4), "rois": ROIS, "max_abs_err": err.max().item(),
               "tolerance": {"atol": atol, "rtol": rtol}, "within_tolerance": within,
               "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
               "plain_ms": time_ms(lambda: roi_align.roi_align_plain(feats, rois, **kw), 2),
               # no torchvision on the card's machine: no library RoIAlign
               "library_ms": None,
               **bound(feats.numel() * size + rois.numel() * 4 + n_out * size,
                       ROI_OPS_PER_OUT * n_out, PEAK_OPS[torch.float32])}
        emit(row)
        if not within:
            fail(f"roi_align ({row['dtype']}) disagrees with its plain version: {row}")
        if dtype == torch.float32:
            rows["roi_align"] = row
        del feats, got, want, err

    for site, (G, N, thr, max_out, presorted) in NMS_CALLS.items():
        boxes, scores = seeded_nms_inputs(gen, dev, G, N, presorted)
        got = nms.nms(boxes, scores, thr, max_out=max_out, presorted=presorted)
        want = nms.nms_plain(boxes, scores, thr, max_out=max_out, presorted=presorted)
        torch.cuda.synchronize()
        idx_diff = (got[0].long() - want[0].long()).abs()
        mask_diff = (got[1].long() - want[1].long()).abs()
        mismatches = int((idx_diff > 0).sum() + (mask_diff > 0).sum())
        perm = torch.arange(N, device=dev).expand(G, N) if presorted else \
            torch.sort(scores, dim=1, descending=True, stable=True).indices
        sboxes = torch.gather(boxes, 1, perm[..., None].expand(G, N, 4)).contiguous()
        order = None if presorted else perm.to(torch.int32).contiguous()
        mask = nms.suppression_bitmask(sboxes, thr)
        bitmask_mismatches = triangle_mismatches(mask, nms.suppression_bitmask_plain(sboxes, thr))
        words = mask.shape[-1]
        span = words - torch.arange(N, device=dev) // 64       # words from the diagonal on
        upper_words = G * int(span.sum())
        kept_words = int((torch.gather(got[1], 1, perm).long() * span).sum())
        out_len = min(max_out, N) if max_out else N
        # the scan alone on this mask, against its plain version on the CPU
        scan_got = nms.greedy_scan(mask, order, max_out)
        scan_want = nms.greedy_scan_plain(mask.cpu(), None if order is None else order.cpu(),
                                          max_out)
        scan_mismatches = int(sum((x.cpu() != y).sum() for x, y in zip(scan_got, scan_want)))
        boundary = boundary_check(site, N, thr, max_out, presorted, dev)
        bitmask_ms, bitmask_range = time_ms_range(lambda: nms.suppression_bitmask(sboxes, thr))
        scan_ms, scan_range = time_ms_range(lambda: nms.greedy_scan(mask, order, max_out))
        bitmask_dev, bitmask_dev_range = graph_ms_range(
            lambda: nms.suppression_bitmask(sboxes, thr))
        scan_dev, scan_dev_range = graph_ms_range(lambda: nms.greedy_scan(mask, order, max_out))
        kernel_ms, kernel_range = time_ms_range(
            lambda: nms.nms(boxes, scores, thr, max_out=max_out, presorted=presorted))
        out_bytes = G * out_len * 4 + G * N
        order_bytes = 0 if presorted else G * N * 4
        iou_ops = NMS_OPS_PER_PAIR * G * N * (N - 1) / 2
        row = {"phase": "kernel", "name": site, "groups": G, "boxes": N,
               "threshold": thr, "max_out": max_out, "presorted": presorted,
               "kept_per_group": got[1].sum(dim=1).float().mean().item(),
               "mismatches": mismatches,
               "max_abs_err": float(max(idx_diff.max().item(), mask_diff.max().item())),
               "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
               "plain_ms": time_ms(lambda: nms.nms_plain(boxes, scores, thr, max_out=max_out,
                                                         presorted=presorted), 1, warmup=0),
               # no torchvision on the card's machine: no library NMS
               "library_ms": None,
               **bound(boxes.numel() * 4 + (0 if presorted else scores.numel() * 4)
                       + out_bytes, iou_ops, PEAK_OPS[torch.float32]),
               "bound_note": NMS_BOUND_NOTE,
               # the wrapper's two CUDA kernels, each timed alone. The
               # bitmask computes the upper triangle's IoUs and writes its
               # words; the scan needs the words of the kept rows only.
               "bitmask": {"ms": bitmask_ms, "ms_range": bitmask_range,
                           "graph_ms": bitmask_dev, "graph_ms_range": bitmask_dev_range,
                           "mismatches": bitmask_mismatches,
                           **bound(sboxes.numel() * 4 + upper_words * 8, iou_ops,
                                   PEAK_OPS[torch.float32]),
                           "bound_note": NMS_BOUND_NOTE},
               "scan": {"ms": scan_ms, "ms_range": scan_range,
                        "graph_ms": scan_dev, "graph_ms_range": scan_dev_range,
                        "mismatches_vs_greedy_scan_plain": scan_mismatches,
                        **bound(kept_words * 8 + order_bytes + out_bytes, 0,
                                PEAK_OPS[torch.float32])},
               "boundary": boundary}
        emit(row)
        if mismatches or boundary["mismatches"]:
            fail(f"{site}: keep_idx/keep_mask differ from the plain version in "
                 f"{mismatches} entries (boundary set: {boundary['mismatches']})")
        if bitmask_mismatches or boundary["bitmask_mismatches"]:
            fail(f"{site}: the bitmask's words differ from suppression_bitmask_plain in "
                 f"{bitmask_mismatches} words (boundary set: {boundary['bitmask_mismatches']})")
        if scan_mismatches or boundary["scan_mismatches"]:
            fail(f"{site}: the scan alone differs from greedy_scan_plain on the same mask "
                 f"in {scan_mismatches} entries (boundary set: {boundary['scan_mismatches']})")
        rows[site] = row
        del boxes, scores, got, want, mask, sboxes, scan_got, scan_want
    return rows


def triangle_mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words of the strict upper triangle (each row's words from its
    diagonal word on; the kernel leaves the rest unwritten) that differ."""
    G, N, words = got.shape
    upper = (torch.arange(words, device=got.device)[None, :]
             >= (torch.arange(N, device=got.device) // 64)[:, None])
    return int(((got != want.to(got.device)) & upper).sum())


def boundary_check(site: str, N: int, thr: float, max_out: int, presorted: bool,
                   dev: torch.device) -> dict:
    """The boundary set at a call site's box count and threshold (pairs of
    one-pixel-high boxes with IoU c / U exactly, c = round(t U) ± 2): the
    whole call, the bitmask's words and the scan alone on them, against the
    plain versions on the CPU."""
    G = NMS_BOUNDARY_GROUPS[site]
    boxes = nms.boundary_boxes(G, N, thr, seed=N)
    scores = torch.from_numpy(np.random.RandomState(N).rand(G, N).astype(np.float32))
    if presorted:
        scores = torch.sort(scores, dim=1, descending=True).values
    got = nms.nms(boxes.to(dev), scores.to(dev), thr, max_out=max_out, presorted=presorted)
    want = nms.nms_plain(boxes, scores, thr, max_out=max_out, presorted=presorted)
    perm = torch.arange(N).expand(G, N) if presorted else nms.sort_desc(scores)
    sboxes = torch.gather(boxes, 1, perm[..., None].expand(G, N, 4)).contiguous()
    order = None if presorted else perm.to(torch.int32)
    mask = nms.suppression_bitmask(sboxes.to(dev), thr)
    scan_got = nms.greedy_scan(mask, None if order is None else order.to(dev), max_out)
    scan_want = nms.greedy_scan_plain(mask.cpu(), order, max_out)
    return {"groups": G, "boxes": N,
            "kept_per_group": got[1].sum(dim=1).float().mean().item(),
            "mismatches": int(sum((x.cpu() != y).sum() for x, y in zip(got, want))),
            "bitmask_mismatches": triangle_mismatches(
                mask.cpu(), nms.suppression_bitmask_plain(sboxes, thr)),
            "scan_mismatches": int(sum((x.cpu() != y).sum()
                                       for x, y in zip(scan_got, scan_want)))}


def detector_setup(dev: torch.device):
    cfg = DetectorConfig(num_classes=DET_CLASSES, num_att_classes=DET_ATTS, depth=DET_DEPTH,
                         pooling_mode=det.POOLING_MODE, anchor_scales=det.ANCHOR_SCALES,
                         anchor_ratios=det.ANCHOR_RATIOS)
    params = init_detector(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((DET_BATCH,) + CANVAS + (3,), generator=gen, device=dev) * 255.0
    im_info = torch.tensor([IM_INFO] * DET_BATCH, device=dev)
    return cfg, params, images, im_info


def extract(det_state, dev):
    cfg, params, images, im_info = det_state
    return extract_device_features(params, cfg, images, im_info, max_boxes=BOXES, test=TEST,
                                   device=dev)


def phase_detect(dev: torch.device, det_state) -> dict:
    """The full-width detector through extract_device_features: a warm-up,
    then one timed run with the kernels' launch counters read around it."""
    extract(det_state, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    roi_align.launches = 0
    nms.launches = 0
    nms.launches_by_shape.clear()
    t0 = time.time()
    sel = extract(det_state, dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = {"roi_align": roi_align.launches, "nms": nms.launches,
              **{site: nms.launches_by_shape[call[:2]] for site, call in NMS_CALLS.items()}}
    expected = {"roi_align": 1, "nms": 2, "nms_rpn": 1, "nms_per_class": 1}
    feats = sel["features"]
    finite = bool(torch.isfinite(feats.float()).all())
    emit({"phase": "detect", "batch": DET_BATCH, "canvas": list(CANVAS), "depth": DET_DEPTH,
          "seconds": dt, "images_per_s": DET_BATCH / dt, "launches": counts,
          "expected_launches": expected, "features": list(feats.shape),
          "features_dtype": str(feats.dtype).split(".")[-1], "finite": finite,
          "detections_per_image": sel["valid"].sum(dim=1).tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if list(feats.shape) != [DET_BATCH, BOXES, F] or not finite:
        fail("detect produced bad features")
    if counts != expected:
        fail(f"detect launch counts {counts}, expected {expected}")
    return counts


def phase_detect_agree(dev: torch.device, det_state) -> None:
    """Each kernel of the path held against its plain version on the path's
    own inputs: the GPU's candidates, C4 map, rois and selection inputs are
    copied to the CPU and run through the plain versions there. Whole
    forwards are not compared: cuDNN and the CPU sum convolutions in other
    orders, and a near-tie in the RPN scores may swap two proposals."""
    cfg, params, images, im_info = det_state
    cpu = torch.device("cpu")
    post, thr = TEST.rpn_post_nms_top_n, TEST.rpn_nms_thresh
    with torch.inference_mode():
        base = resnet.backbone(params["resnet"], images)
        cls, bbox = rpn_heads(params["rpn"], base)
        anchors = anchors_for(base.shape[1], base.shape[2], cfg.feat_stride,
                              cfg.anchor_scales, cfg.anchor_ratios, dev)
        props, scores = proposal_candidates(cls, bbox, anchors, im_info,
                                            pre_nms_top_n=TEST.rpn_pre_nms_top_n)
        rois, _, valid = proposal_nms(props, scores, post_nms_top_n=post, nms_thresh=thr)
        t0 = time.time()
        rois_c, _, valid_c = proposal_nms(props.to(cpu), scores.to(cpu),
                                          post_nms_top_n=post, nms_thresh=thr)
        rpn_s = time.time() - t0
        rpn_same = torch.equal(rois.cpu(), rois_c) and torch.equal(valid.cpu(), valid_c)
        # informational: the candidates the CPU itself derives from the GPU's heads
        props_c, _ = proposal_candidates(cls.cpu(), bbox.cpu(), anchors.cpu(), im_info.cpu(),
                                         pre_nms_top_n=TEST.rpn_pre_nms_top_n)
        cand_same = (props_c == props.cpu()).all(dim=-1).float().mean().item()

        flat = rois.reshape(-1, 5)
        kw = dict(spatial_scale=1.0 / cfg.feat_stride, pooled_height=cfg.pooling_size,
                  pooled_width=cfg.pooling_size, sampling_ratio=2)
        pooled_gpu = roi_align.roi_align(base, flat, **kw)
        pooled = pooled_gpu.cpu()
        t0 = time.time()
        pooled_c = roi_align.roi_align_plain(base.cpu(), flat.cpu(), **kw)
        roi_s = time.time() - t0
        roi_err = (pooled - pooled_c).abs().max().item()
        roi_tol = DETECT_AGREE_REL * max(pooled_c.abs().max().item(), 1.0)

        out = detector_forward_test(params, cfg, images, im_info,
                                    post_nms_top_n=post,
                                    pre_nms_top_n=TEST.rpn_pre_nms_top_n, nms_thresh=thr)
        pred = decode_boxes(out["rois"][..., 1:5], out["bbox_pred"], im_info,
                            TEST.bbox_normalize_stds, TEST.bbox_normalize_means, im_info[:, 2],
                            cfg.num_classes)
        args = (out["cls_prob"], pred, out["pooled_feat"], out["cls_prob_atts"])
        sel_kw = dict(thresh=TEST.score_thresh, nms_thresh=TEST.nms_thresh,
                      max_per_image=min(TEST.max_per_image, BOXES))
        sel = select_detections_device(*args, **sel_kw)
        t0 = time.time()
        sel_c = select_detections_device(*[a.cpu() for a in args], **sel_kw)
        sel_s = time.time() - t0
        sel_same = all(torch.equal(sel[k].cpu(), sel_c[k]) for k in sel)

        def decode_and_select():
            boxes = decode_boxes(out["rois"][..., 1:5], out["bbox_pred"], im_info,
                                 TEST.bbox_normalize_stds, TEST.bbox_normalize_means,
                                 im_info[:, 2], cfg.num_classes)
            return select_detections_device(out["cls_prob"], boxes, out["pooled_feat"],
                                            out["cls_prob_atts"], **sel_kw)

        # device time of each stage on the same inputs (CUDA events, 3 runs
        # after a warm-up); the class heads' products and softmax are the rest
        stage_ms = {
            "backbone": time_ms(lambda: resnet.backbone(params["resnet"], images), 3),
            "rpn_heads": time_ms(lambda: rpn_heads(params["rpn"], base), 3),
            "proposal_candidates": time_ms(lambda: proposal_candidates(
                cls, bbox, anchors, im_info, pre_nms_top_n=TEST.rpn_pre_nms_top_n), 3),
            "proposal_nms": time_ms(lambda: proposal_nms(
                props, scores, post_nms_top_n=post, nms_thresh=thr), 3),
            "roi_align": time_ms(lambda: roi_align.roi_align(base, flat, **kw), 3),
            "head_to_tail": time_ms(lambda: resnet.head_to_tail(params["resnet"], pooled_gpu), 3),
            "decode_and_select": time_ms(decode_and_select, 3),
        }
    emit({"phase": "detect_agree", "rpn_keep_identical": rpn_same,
          "valid_proposals_per_image": valid.sum(dim=1).tolist(),
          "cpu_candidates_identical_share": cand_same,
          "roi_align_max_abs_err": roi_err, "roi_align_tolerance": roi_tol,
          "pooled_abs_max": pooled_c.abs().max().item(),
          "selection_identical": sel_same,
          "detections_per_image": sel["valid"].sum(dim=1).tolist(),
          "cpu_seconds": {"rpn_nms": rpn_s, "roi_align": roi_s, "selection": sel_s},
          "gpu_stage_ms": stage_ms})
    if not rpn_same:
        fail("the RPN's NMS on the GPU and on the CPU kept different proposals")
    if not roi_err <= roi_tol:
        fail(f"pooled features on the path disagree: {roi_err} > {roi_tol}")
    if not sel_same:
        fail("the per-class NMS on the GPU and on the CPU selected different boxes")


def phase_e2e(dev: torch.device, det_state, decode_state) -> None:
    """Config 5 end to end: raw canvases → detector → bf16 features → CBS
    decode (fused selection), timed warm as one run."""
    harness, sentiment, tables = decode_state
    for mod in KERNELS.values():
        mod.launches = 0
    nms.launches_by_shape.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    sel = extract(det_state, dev)
    best, best_lp = harness.decode_cbs(sel["features"], sentiment, None, tables, N_CONSTRAINTS,
                                       torch.Generator(device=dev).manual_seed(7), N_Z,
                                       selection="fused")
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    counts.update({site: nms.launches_by_shape[call[:2]] for site, call in NMS_CALLS.items()})
    expected = {"vocab_topk_lse": 0, "topk_lse": STEPS - 1, "roi_align": 1, "nms": 2,
                "nms_rpn": 1, "nms_per_class": 1}
    in_vocab = bool(((best >= 0) & (best < V)).all())
    finite = bool(torch.isfinite(best_lp).all())
    emit({"phase": "e2e", "selection": "fused", "seconds": dt,
          "images_per_s": DET_BATCH / dt, "captions_per_s": DET_BATCH * N_Z / dt,
          "shape": list(best.shape), "launches": counts, "expected_launches": expected,
          "in_vocab": in_vocab, "finite_scores": finite})
    if list(best.shape) != [N_Z, DET_BATCH, STEPS] or not in_vocab or not finite:
        fail("e2e produced bad captions")
    if counts != expected:
        fail(f"e2e launch counts {counts}, expected {expected}")


def kernel_counts() -> dict:
    return {k: mod.launches for k, mod in KERNELS.items()}


def reset_kernel_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def write_cli_world(root: Path, *, vocab_size: int, images: int, boxes: int, steps: int,
                    model: dict, seed: int) -> Path:
    """The inference CLI's inputs, written by the port's own code: a
    vocabulary that holds ``vocab_size`` tokens once the CLI adds the
    wordforms, the wordform TSV, a features.h5 of seeded random features
    with packed object ids, and the YAML config; returns the config's path."""
    root.mkdir(parents=True)
    words = [f"w{i}" for i in range(vocab_size - 2 - len(CLI_FORMS))]
    Vocabulary([UNK_TOKEN, BOUNDARY_TOKEN] + words).save_to_files(str(root / "vocab"))
    (root / "wordforms.tsv").write_text("pos\t" + ",".join(CLI_FORMS) + "\n")
    rng = np.random.RandomState(seed)
    w = FeaturesWriter(str(root / "features.h5"), images)
    for i in range(images):
        w.write(i, 1000 + i, rng.randn(boxes, model["IMAGE_FEATURE_SIZE"]).astype(np.float32),
                pack_obj_atts(rng.randint(1, 81, boxes), [[a] for a in rng.randint(0, 50, boxes)]),
                np.zeros((0,), np.float32))
    w.close()
    text = "\n".join([
        "RANDOM_SEED: 0", "DATA:", f"  VOCABULARY: {root / 'vocab'}", "  TRAIN_FEATURES: ''",
        f"  INFER_FEATURES: {root / 'features.h5'}", "  DO_LOAD_COCO: false",
        "  DO_LOAD_SENTICAP: false", "  SENTICAP_SENTIMENT: pos",
        f"  MAX_CAPTION_LENGTH: {steps}", f"  MAX_BOXES: {boxes}", "  CBS:",
        "    INFER_BOXES: ''", "    CLASS_HIERARCHY: ''", f"    WORDFORMS: {root / 'wordforms.tsv'}",
        "    MAX_GIVEN_CONSTRAINTS: 3", "    MAX_WORDS_PER_CONSTRAINT: 3", "MODEL:",
        *(f"  {k}: {v}" for k, v in model.items())])
    (root / "cfg.yml").write_text(text + "\n")
    return root / "cfg.yml"


def cli_dataset(cfg_path: Path):
    """The CLI's config, vocabulary and CBS dataset, seeded as it seeds them."""
    C = Config(str(cfg_path))
    voc = Vocabulary.from_files(C.DATA.VOCABULARY)
    add_constraint_words_to_vocabulary(voc, C.DATA.CBS.WORDFORMS)
    random.seed(C.RANDOM_SEED)
    return C, voc, EvaluationDatasetWithConstraints.from_config(C, vocabulary=voc)


def cli_agree(dev: torch.device, root: Path) -> None:
    """The CLI's group functions on the GPU against the CPU, f32, small
    width, on the same noise stacks (kernel A on the GPU, its plain version
    on the CPU)."""
    small = dict(PUBLISHED_MODEL, IMAGE_FEATURE_SIZE=64, EMBEDDING_SIZE=300, HIDDEN_SIZE=48,
                 ATTENTION_PROJECTION_SIZE=32, Z_SPACE=16, N_Z_SAMPLES=3)
    C, voc, ds = cli_dataset(write_cli_world(root / "small", vocab_size=700, images=4, boxes=10,
                                             steps=10, model=small, seed=1))
    prepared = [(ds.collate_fn([ds[i]]), None) for i in range(len(ds))]
    cfg = CaptionerConfig.from_config(C, voc)
    params = init_captioner(cfg, seed=4, device="cpu")
    n_z = C.MODEL.N_Z_SAMPLES
    noise = np.random.RandomState(3).randn(n_z, cfg.max_caption_length, len(prepared), STATES,
                                           cfg.beam_size, cfg.z_space).astype(np.float32)
    out = {}
    for side, d, p in (("cpu", torch.device("cpu"), params), ("gpu", dev, to_device(params, dev))):
        kind_out = cli._dispatch_group(C, cfg, DecodeHarness(p, cfg, device=d), prepared, noise, n_z)
        out[side] = torch.from_numpy(np.stack(cli._collect_group(C, cfg, kind_out, prepared, n_z)))
    agree_row("cli_group/cbs_simple", out["gpu"], out["cpu"], None, None, AGREE_MIN,
              selection="prehead", images=len(prepared), n_z=n_z)


def cli_host(cfg_path: Path) -> None:
    """Host milliseconds per image of the CLI's data path at full width
    (the producer thread's work): the features read, the FSM builds (one
    dense (24, 24, V) uint8 FSM per z), and the collate's trim, packing and
    exception tables."""
    C, _, ds = cli_dataset(cfg_path)
    ms = {k: 0.0 for k in ("item", "read_features", "collate", "pack_fsm", "fsm_to_tables")}
    for i in range(CLI_HOST_IMAGES):
        t0 = time.perf_counter()
        ds._val_features[ds._image_ids[i]]
        t1 = time.perf_counter()
        item = ds[i]
        t2 = time.perf_counter()
        batch = ds.collate_fn([item])
        t3 = time.perf_counter()
        trimmed = [f[0] for f in batch["fsm"]]
        for f in trimmed:
            pack_fsm(f)
        t4 = time.perf_counter()
        for f in trimmed:
            fsm_to_tables(f)
        t5 = time.perf_counter()
        for k, dt in (("read_features", t1 - t0), ("item", t2 - t1), ("collate", t3 - t2),
                      ("pack_fsm", t4 - t3), ("fsm_to_tables", t5 - t4)):
            ms[k] += 1e3 * dt / CLI_HOST_IMAGES
    emit({"phase": "cli_host", "images": CLI_HOST_IMAGES, "n_z": C.MODEL.N_Z_SAMPLES,
          "vocab": V, "ms_per_image": ms,
          "fsm_build_ms_per_image": ms["item"] - ms["read_features"],
          "states": int(batch["fsm"][0].shape[1])})


def cli_run(cfg_path: Path, out: Path, extra: list, expected: dict, name: str) -> int:
    """One CLI run on the card with every kernel's count reset before it;
    checks the predictions and the launches, emits the row; returns kernel
    A's launches."""
    reset_kernel_counts()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli.main(["--config", str(cfg_path), "--output-path", str(out), *extra], stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_counts()
    preds = json.loads(out.read_text())
    order = [p["image_id"] for p in preds] == [1000 + i for i in range(CLI_IMAGES)
                                               for _ in range(N_Z)]
    schema = all(set(p) == {"image_id", "caption"} and isinstance(p["caption"], str)
                 and "@@" not in p["caption"] for p in preds)
    loop = stats["wall_s"] - stats["setup_s"]
    producer = stats["item_s"] + stats["collate_s"] + stats["latents_s"]
    emit({"phase": "cli", "run": name, "args": extra, "rc": rc, "predictions": len(preds),
          "image_major_order": order, "schema": schema, "fallbacks": stats["fallbacks"],
          "wall_s": wall, "images_per_s": CLI_IMAGES / wall,
          "captions_per_s": len(preds) / wall, "setup_s": stats["setup_s"], "loop_s": loop,
          "loop_captions_per_s": len(preds) / loop,
          "host_wait_share_of_loop": stats["wait_s"] / loop,
          "producer_busy_share_of_loop": producer / loop,
          "host_s": {k: stats[k] for k in ("item_s", "collate_s", "latents_s", "wait_s",
                                           "decode_s")},
          "distinct_captions": len({p["caption"] for p in preds}),
          "launches": counts, "expected_launches": expected})
    if rc != 0 or len(preds) != CLI_IMAGES * N_Z or not order or not schema:
        fail(f"cli ({name}) produced bad predictions")
    if stats["fallbacks"] != 0:
        fail(f"cli ({name}): {stats['fallbacks']} images fell back to beam search")
    if counts != expected:
        fail(f"cli ({name}) launch counts {counts}, expected {expected}")
    return counts["vocab_topk_lse"]


def phase_cli(dev: torch.device) -> int:
    """The inference CLI: the agree row, the host path's split, then the CBS
    and sampler runs at config 3's widths; returns kernel A's launches in
    the CBS run."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cli_agree(dev, root)
        cfg = write_cli_world(root / "full", vocab_size=V, images=CLI_IMAGES, boxes=BOXES,
                              steps=STEPS, model=PUBLISHED_MODEL, seed=0)
        _, voc, _ = cli_dataset(cfg)
        if voc.get_vocab_size() != V:
            fail(f"cli world: vocabulary of {voc.get_vocab_size()} tokens, not {V}")
        cli_host(cfg)
        groups = -(-CLI_IMAGES // CLI_GROUP)
        none = {k: 0 for k in KERNELS}
        launches = cli_run(cfg, root / "cbs.json", ["--bf16", "--batch-images", str(CLI_GROUP)],
                           {**none, "vocab_topk_lse": (STEPS - 1) * groups}, "cbs")
        cli_run(cfg, root / "topp.json", ["--bf16", "--batch-images", str(CLI_GROUP),
                                          "--sampler", "topp"], none, "sampler_topp")
    return launches


# captioner training (BASELINE.json config 2, bench.py:325-423): the
# published model (configs/style_seqcvae_senticap.yml: E 600 tied, H 900,
# P 768, z 150, F 2048, mode 1, SIMPLE_VAE false) teacher-forced over 20
# caption tokens (21 steps) and 100 boxes, at bench.py's batch 32 and the
# published OPTIM.BATCH_SIZE 150
TRAIN_BATCHES = (32, 150)
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_K, TRAIN_CHAINS = 2, 18, 10, 3
# the decoder trains on every timed step (the schedule's second phase, from
# EPOCH_START_DECODER_TRAINING on); FROZEN_OVERRIDES times the first
# phase's steps, where it trains one step in 30
ACTIVE_OVERRIDES = ["OPTIM.EPOCH_START_DECODER_TRAINING", "0"]
FROZEN_OVERRIDES = ["OPTIM.EPOCH_START_DECODER_TRAINING", "100000"]
# the device corpus: images in the on-device features table
CORPUS_IMAGES = 512
# the bf16 step's first loss against the f32 step's on the same params,
# batch and noise: bf16 keeps 8 bits, the 10,500-way log-softmax and the
# products round in bf16 (the CPU tests hold the port's bf16 to JAX's bf16
# within 1e-2)
BF16_FIRST_LOSS_REL = 2e-2
# train_agree: the GPU against the CPU in f32 without TF32; the products
# sum in other orders (and the untied embedding's gradient by atomics), so
# the losses agree to 1e-5, each leaf's gradient norm to 1e-4 and each
# leaf after 3 SGD steps to 1e-5 of its norm
TRAIN_AGREE_TOL = {"metrics": 1e-5, "grad_norm": 1e-4, "params": 1e-5}
TRAIN_AGREE_CASES = {"mode0_untied": dict(sentiment_vae=0, embedding_size=16),
                     "mode1_tied": dict(sentiment_vae=1, embedding_size=300),
                     "mode2_glove_tied": dict(sentiment_vae=2, embedding_size=300)}
# decoder inactive at iteration 1, active at 2 and 3: the schedule's boundary
AGREE_OVERRIDES = ["OPTIM.LR", "0.05", "OPTIM.EPOCH_START_DECODER_TRAINING", "1",
                   "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "30"]


def train_batch(cfg: CaptionerConfig, batch: int, boxes: int, seed: int, dev) -> dict:
    """A seeded training batch on ``dev``: features with padding boxes,
    captions of 8 to T tokens padded with the pad index, sentiment ±1."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, boxes, cfg.image_feature_size).astype(np.float32)
    feats[:, boxes - boxes // 10:] = 0.0
    T = cfg.max_caption_length
    toks = rng.randint(2, cfg.vocab_size, (batch, T)).astype(np.int32)
    for i, n in enumerate(rng.randint(min(8, T), T + 1, batch)):
        toks[i, n:] = cfg.pad_index
    out = {"image_features": feats, "caption_tokens": toks,
           "sentiment": rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)}
    if cfg.sentiment_vae == 2:
        out["obj_att_embeds"] = rng.randn(batch, boxes, cfg.z_space).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def phase_train_agree(dev: torch.device) -> None:
    """Small f32 train steps, the GPU against the CPU on the same params,
    batch and z-noise: the metrics of 3 steps, each leaf's gradient norm
    after the first (the decoder inactive: no gradient on either side) and
    the second (active), and every leaf after the third."""
    for case, kw in TRAIN_AGREE_CASES.items():
        cfg = CaptionerConfig(vocab_size=50, image_feature_size=64, hidden_size=48,
                              attention_projection_size=32, z_space=16, simple_vae=False,
                              max_caption_length=10, **kw)
        config = Config(config_override=AGREE_OVERRIDES)
        params = init_captioner(cfg, seed=3, device="cpu")
        states = {side: create_train_state(params, config, cfg, seed=0, device=d)
                  for side, d in (("cpu", torch.device("cpu")), ("gpu", dev))}
        step = make_train_step(cfg, config.MODEL.KLD_WEIGHT)
        rng = np.random.RandomState(11)
        worst = {"metrics": 0.0, "grad_norm": 0.0, "params": 0.0}
        decoder_grads = []
        for it in range(3):
            batch = {k: v.cpu() for k, v in train_batch(cfg, 8, 10, it, "cpu").items()}
            eps = rng.randn(cfg.max_caption_length + 1, 8, cfg.z_space).astype(np.float32)
            metrics = {}
            for side, state in states.items():
                states[side], metrics[side] = step(state, batch, eps=eps)
            for name in metrics["cpu"]:
                worst["metrics"] = max(worst["metrics"], abs(
                    metrics["gpu"][name].item() / metrics["cpu"][name].item() - 1))
            grads = {side: {p: t.grad for p, t in named_leaves(s.params)}
                     for side, s in states.items()}
            decoder_grads.append({side: any(g is not None for p, g in grads[side].items()
                                            if "decoder_lstm" in p) for side in grads})
            for path, g in grads["cpu"].items():
                if (g is None) != (grads["gpu"][path] is None):
                    fail(f"train_agree {case}: {path} has a gradient on one side only")
                if g is not None:
                    worst["grad_norm"] = max(worst["grad_norm"], abs(
                        grads["gpu"][path].norm().item() / g.norm().item() - 1))
        for (path, t_cpu), (_, t_gpu) in zip(named_leaves(states["cpu"].params),
                                             named_leaves(states["gpu"].params)):
            worst["params"] = max(worst["params"], rel_err(t_gpu, t_cpu))
        boundary = [d["gpu"] for d in decoder_grads] == [False, True, True] and \
            [d["cpu"] for d in decoder_grads] == [False, True, True]
        emit({"phase": "train_agree", "case": case, "steps": 3, "max_rel_err": worst,
              "tolerance": TRAIN_AGREE_TOL, "decoder_grad_by_step": decoder_grads})
        if not boundary:
            fail(f"train_agree {case}: the freeze schedule differs: {decoder_grads}")
        bad = {k: v for k, v in worst.items() if not v <= TRAIN_AGREE_TOL[k]}
        if bad:
            fail(f"train_agree {case}: the GPU disagrees with the CPU: {bad}")


def train_cfg() -> CaptionerConfig:
    return CaptionerConfig(vocab_size=V, image_feature_size=F, embedding_size=E, hidden_size=H,
                           attention_projection_size=P, z_space=Z, sentiment_vae=1,
                           simple_vae=False, max_caption_length=STEPS)


def timed_steps(fn, n: int) -> list:
    """Host wall milliseconds of ``n`` calls of ``fn``, each synchronised."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def median_range(ms: list) -> tuple:
    s = sorted(ms)
    return s[len(s) // 2], [s[0], s[-1]]


def profile_steps(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: the card's kernel and
    copy time a call, their count and the host's kernel-launch calls (None
    where the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum("LaunchKernel" in e.name for e in prof.events())
    if not evs:
        return {"device_ms_per_step": None, "device_ops_per_step": None,
                "kernel_launch_calls_per_step": None}
    return {"device_ms_per_step": sum(e.time_range.elapsed_us() for e in evs) / 1e3 / n,
            "device_ops_per_step": len(evs) / n, "kernel_launch_calls_per_step": launches / n}


def train_row(cfg, params, batch_size: int, dtype, dev, overrides, chained=True,
              corpus=False, profiled=False) -> dict:
    """One configuration's single steps (and chained K-step calls) on a
    fixed batch: ms a step, captions/s, peak memory, the losses; with
    ``profiled``, the card's time a step from a profiler trace of 3 more
    steps and its busy share of the median step."""
    gc.collect()                    # the previous row's state (optimizer cycles)
    config = Config(config_override=overrides)
    kld_weight = config.MODEL.KLD_WEIGHT
    compute = None if dtype == torch.float32 else dtype
    state = create_train_state(params, config, cfg, seed=1, device=dev)
    batch = train_batch(cfg, batch_size, BOXES, seed=batch_size, dev=dev)
    if corpus:
        gen = torch.Generator(device=dev).manual_seed(2)
        table = torch.randn(CORPUS_IMAGES, BOXES, F, generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, CORPUS_IMAGES, (batch_size,), generator=gen, device=dev)
        batch = {"caption_tokens": batch["caption_tokens"], "sentiment": batch["sentiment"],
                 "feat_idx": idx}
        step1 = make_corpus_train_step(cfg, kld_weight, compute)
        stepk = make_corpus_chained_train_step(cfg, kld_weight, compute)
        single = lambda: step1(state, table, batch)  # noqa: E731
        many = lambda b: stepk(state, table, b)  # noqa: E731
    else:
        step1 = make_train_step(cfg, kld_weight, compute)
        stepk = make_chained_train_step(cfg, kld_weight, compute)
        single = lambda: step1(state, batch)  # noqa: E731
        many = lambda b: stepk(state, b)  # noqa: E731
    losses = []
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    first = timed_steps(lambda: losses.append(single()[1]["loss"]), 1)[0]
    warm = timed_steps(lambda: losses.append(single()[1]["loss"]), TRAIN_WARMUP - 1)
    ms = timed_steps(lambda: losses.append(single()[1]["loss"]), TRAIN_TIMED)
    row = {"batch": batch_size, "dtype": str(dtype).split(".")[-1],
           "decoder_trains": overrides is ACTIVE_OVERRIDES, "device_corpus": corpus,
           "first_step_ms": first, "warm_ms": warm}
    med, rng_ = median_range(ms)
    row.update(single_ms=med, single_ms_range=rng_, single_captions_per_s=batch_size / med * 1e3)
    if chained:
        stacked = {k: v.unsqueeze(0).expand((TRAIN_K,) + tuple(v.shape)) for k, v in
                   batch.items()}
        kms = timed_steps(lambda: losses.extend(many(stacked)[1]["loss"].unbind()), TRAIN_CHAINS)
        kmed, krng = median_range([m / TRAIN_K for m in kms])
        row.update(chained_k=TRAIN_K, chained_ms=kmed, chained_ms_range=krng,
                   chained_captions_per_s=batch_size / kmed * 1e3)
    if profiled:
        prof = profile_steps(lambda: losses.append(single()[1]["loss"]), 3)
        busy = prof["device_ms_per_step"]
        row.update(prof, device_busy_share=None if busy is None else busy / med)
    loss = [x.item() for x in losses]
    counts = kernel_counts()
    row.update(steps=len(loss), loss_first=loss[0], loss_last=loss[-1],
               loss_finite=bool(np.isfinite(loss).all()),
               loss_falling=bool(np.mean(loss[-5:]) < np.mean(loss[:5])),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    emit({"phase": "train", **row})
    if not (row["loss_finite"] and row["loss_falling"]):
        fail(f"train: the loss is not finite and falling on a fixed batch: {loss}")
    if any(counts.values()):
        fail(f"train: a kernel ran in the training step: {counts}")
    del state
    return row


def phase_train(dev: torch.device) -> None:
    """BASELINE.json config 2 at full width on the card: batch 32 and 150, f32
    (TF32 off) and bf16 compute, single steps and chained K = 10, the first
    phase's frozen decoder at batch 32, and the device corpus; then the
    bf16 step's first loss against the f32 step's."""
    cfg = train_cfg()
    params = init_captioner(cfg, seed=0, device=dev)
    rows = []
    for batch_size in TRAIN_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(train_row(cfg, params, batch_size, dtype, dev, ACTIVE_OVERRIDES,
                                  profiled=True))
    rows.append(train_row(cfg, params, 32, torch.float32, dev, FROZEN_OVERRIDES, chained=False))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(train_row(cfg, params, 32, dtype, dev, ACTIVE_OVERRIDES, corpus=True))
    first = {(r["batch"], r["dtype"]): r["loss_first"] for r in rows[:4]}
    for b in TRAIN_BATCHES:
        rel = abs(first[(b, "bfloat16")] / first[(b, "float32")] - 1)
        emit({"phase": "train_bf16_vs_f32", "batch": b, "first_loss_rel": rel,
              "tolerance": BF16_FIRST_LOSS_REL})
        if rel > BF16_FIRST_LOSS_REL:
            fail(f"train: the bf16 step's first loss is {rel} off the f32 step's")


# the train CLI on a world the port writes: the published config's MODEL
# and OPTIM sections (batch 150) at 12 iterations, checkpoints every 3; the
# first run stops at 6, the second resumes from checkpoint_6; then the
# inference CLI decodes 16 images from the final checkpoint (CBS, bf16)
TRAIN_CLI_IMAGES, TRAIN_CLI_ITERS, TRAIN_CLI_DECODE = 64, 12, 16
PUBLISHED_OPTIM = dict(BATCH_SIZE=150, NUM_ITERATIONS=TRAIN_CLI_ITERS, LR=0.015, MOMENTUM=0.9,
                       WEIGHT_DECAY=0.001, CLIP_GRADIENTS=12.5,
                       EPOCH_START_DECODER_TRAINING=40000, BEFORE_UPDATE_DECODER_EVERY=30)


def write_train_cli_world(root: Path) -> Path:
    """The train CLI's inputs, written by the port's own code: the inference
    world (vocabulary of V tokens with the wordforms, features.h5 of 100 x
    2048, the published MODEL section), COCO captions (5 an image) and
    Senticap captions over the train, val and test splits, and a config with
    the published OPTIM section; returns the config's path."""
    cfg = write_cli_world(root, vocab_size=V, images=TRAIN_CLI_IMAGES, boxes=BOXES, steps=STEPS,
                          model=PUBLISHED_MODEL, seed=5)
    words = [f"w{i}" for i in range(V - 2 - len(CLI_FORMS))] + list(CLI_FORMS)
    rng = np.random.RandomState(6)

    def sentence():
        return " ".join(words[j] for j in rng.randint(0, len(words), rng.randint(6, STEPS + 3)))

    anns = [{"id": k, "image_id": 1000 + int(i), "caption": sentence()}
            for k, i in enumerate(np.repeat(np.arange(TRAIN_CLI_IMAGES), 5))]
    (root / "captions.json").write_text(json.dumps({"annotations": anns}))
    senti = [{"filename": f"COCO_val2014_{1000 + i:012d}.jpg",
              "split": ("train", "val", "test")[i % 3],
              "sentences": [{"raw": sentence(), "sentiment": i % 2}]}
             for i in range(0, TRAIN_CLI_IMAGES, 2)]
    (root / "senticap.json").write_text(json.dumps({"images": senti}))
    text = cfg.read_text().replace("  TRAIN_FEATURES: ''\n", "").replace(
        "  DO_LOAD_COCO: false\n", "").replace("  DO_LOAD_SENTICAP: false\n", "")
    text = text.replace("DATA:\n", "\n".join([
        "PRINT_EVERY_N_BATCHES: 1", "DATA:", f"  TRAIN_FEATURES: {root / 'features.h5'}",
        f"  TRAIN_CAPTIONS: {root / 'captions.json'}",
        f"  SENTICAP_CAPTIONS: {root / 'senticap.json'}", "  DO_LOAD_COCO: true",
        "  DO_LOAD_SENTICAP: true", ""]), 1)
    text += "OPTIM:\n" + "".join(f"  {k}: {v}\n" for k, v in PUBLISHED_OPTIM.items())
    (root / "train.yml").write_text(text)
    return root / "train.yml"


def train_cli_run(cfg: Path, ser: Path, extra: list, every: int = 3) -> dict:
    reset_kernel_counts()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    rc = train_cli.main(["--config", str(cfg), "--serialization-dir", str(ser),
                         "--checkpoint-every", str(every), *extra], stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_counts()
    if rc != 0 or any(counts.values()):
        fail(f"train_cli: rc {rc}, kernel launches {counts}")
    return dict(stats, wall_s=wall, launches=counts)


def phase_train_cli(dev: torch.device, root: Path) -> tuple:
    """The train CLI (``python -m style_seqcvae_tpu_torch.scripts.train``) as a
    user runs it, a resume, then the inference CLI on the final checkpoint
    directory, all under ``root`` (the world in ``root/world``); returns
    kernel A's launches in the inference run and its predictions' path."""
    cfg = write_train_cli_world(root / "world")
    ser = root / "run"
    first = train_cli_run(cfg, ser, ["--max-iterations", str(TRAIN_CLI_ITERS // 2)])
    ckpts = sorted(p.name for p in ser.iterdir() if p.name.startswith("checkpoint_"))
    second = train_cli_run(cfg, ser, ["--start-from-checkpoint",
                                      f"checkpoint_{TRAIN_CLI_ITERS // 2}"])
    rows = [json.loads(line) for line in (ser / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows]
    finite = all(np.isfinite(r["loss"]) for r in rows)
    reset_kernel_counts()
    out = root / "preds.json"
    t0 = time.time()
    rc = cli.main(["--config", str(cfg), "--output-path", str(out), "--bf16",
                   "--batch-images", str(CLI_GROUP), "--max-images", str(TRAIN_CLI_DECODE),
                   "--checkpoint-path", str(ser), "--checkpoint-name",
                   f"checkpoint_{TRAIN_CLI_ITERS}", "--config-override",
                   "DATA.DO_LOAD_COCO", "false", "DATA.DO_LOAD_SENTICAP", "false"])
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    counts = kernel_counts()
    preds = json.loads(out.read_text())
    restored = read_checkpoint(str(ser / f"checkpoint_{TRAIN_CLI_ITERS}"))
    emit({"phase": "train_cli", "batch": PUBLISHED_OPTIM["BATCH_SIZE"],
          "iterations": TRAIN_CLI_ITERS, "first_run": first, "resumed_run": second,
          "checkpoints_after_first": ckpts, "metrics_steps": steps, "loss_finite": finite,
          "losses": [r["loss"] for r in rows],
          "checkpoint_step": int(restored["opt_state"]["step"]),
          "inference": {"rc": rc, "predictions": len(preds), "seconds": decode_s,
                        "launches": counts}})
    if steps != list(range(1, TRAIN_CLI_ITERS + 1)) or not finite:
        fail(f"train_cli: metrics steps {steps}, finite {finite}")
    if second["start"] != TRAIN_CLI_ITERS // 2 + 1 or \
            int(restored["opt_state"]["step"]) != TRAIN_CLI_ITERS:
        fail("train_cli: the resume did not continue from its checkpoint")
    want = {k: 0 for k in KERNELS}
    want["vocab_topk_lse"] = (STEPS - 1) * -(-TRAIN_CLI_DECODE // CLI_GROUP)
    if rc != 0 or len(preds) != TRAIN_CLI_DECODE * N_Z or counts != want:
        fail(f"train_cli: inference from the checkpoint: rc {rc}, {len(preds)} "
             f"predictions, launches {counts} (expected {want})")
    return counts["vocab_topk_lse"], out


# the UpDown baseline family (JAX models/baseline.py): no kernel on its path,
# as in JAX, whose harness hands it to the CBS search with raw_step=False
# (the log-prob route). Its decodes at batch 16 x 1 z (the inference CLI's
# grid for the family) and 320 x 1 z (config 3's 12,800 rows a step); its
# training at config 2's widths and batches; ~50 steps on a fixed batch
BASELINE_GRIDS = (16, 320)
BASELINE_TRAIN_STEPS = 50
BASELINE_AGREE_HEADS = {"tied": 300, "untied": 16}
# the metrics whose oracle (per-image best z, then the corpus re-scored) is
# held against the mean over z
EVAL_METRICS = ("B1", "B2", "B3", "B4", "rouge", "cider", "meteor")


def phase_baseline_agree(dev: torch.device) -> None:
    """Small f32 baseline decodes, the GPU against the CPU on shared seeded
    noise (CBS through logprob, beam, each sampler), then 3 train steps
    (TF32 off) with the tied and the untied head: the metrics, each leaf's
    gradient norm and every leaf after the third step."""
    cfg = CaptionerConfig(vocab_size=700, image_feature_size=64, embedding_size=300,
                          hidden_size=48, attention_projection_size=32, z_space=16,
                          max_caption_length=10, beam_size=BEAM)
    batch, n_z, boxes = 4, 3, 10
    T = cfg.max_caption_length
    feats, _, tables = decode_setup(cfg, batch, 1, boxes, seed=2)
    params_cpu = init_baseline(cfg, seed=4, device="cpu")
    cpu = DecodeHarness(params_cpu, cfg, device="cpu", family="baseline")
    gpu = DecodeHarness(to_device(params_cpu, dev), cfg, device=dev, family="baseline")
    rng = np.random.RandomState(3)
    noise = rng.randn(1, T, batch, STATES, BEAM, cfg.z_space).astype(np.float32)
    reset_kernel_counts()
    shares, lp_errs = [], []

    def row(path, got, ref, lp_got=None, lp_ref=None, **extra):
        frac, err = agree_row(f"baseline/{path}", got, ref, lp_got, lp_ref,
                              AGREE_MIN_NO_KERNEL, phase="baseline_agree", **extra)
        shares.append(frac)
        lp_errs.append(err or 0.0)

    args = (feats, None, None, tables, N_CONSTRAINTS, noise, 1)
    ref, got = cpu.decode_cbs(*args), gpu.decode_cbs(*args)
    row("decode_cbs/logprob", got[0], ref[0], got[1], ref[1], selection="logprob")
    ref = cpu.decode_beam(feats, None, None, noise[:, :, :, 0], 1)
    got = gpu.decode_beam(feats, None, None, noise[:, :, :, 0], 1)
    row("decode_beam", got[0], ref[0], got[1], ref[1])
    for method in SAMPLERS:
        inner = (BEAM,) if method == "gumbel" else ()
        z = rng.randn(n_z, T, batch, BEAM if inner else 1, cfg.z_space).astype(np.float32)
        g = -np.log(rng.exponential(size=(n_z, T, batch) + inner + (cfg.vocab_size,)))
        kw = {"temperature": 0.8} if method == "topp" else {}
        sample_args = (feats, None, None, (z, g.astype(np.float32)), n_z, method)
        row(f"decode_sample/{method}", gpu.decode_sample(*sample_args, **kw),
            cpu.decode_sample(*sample_args, **kw), **kw)

    worst_all = {"metrics": 0.0, "grad_norm": 0.0, "params": 0.0}
    for head, emb in BASELINE_AGREE_HEADS.items():
        tcfg = cfg._replace(vocab_size=50, embedding_size=emb)
        config = Config(config_override=AGREE_OVERRIDES)
        params = init_baseline(tcfg, seed=3, device="cpu")
        states = {side: create_train_state(params, config, tcfg, seed=0, device=d)
                  for side, d in (("cpu", torch.device("cpu")), ("gpu", dev))}
        step = make_baseline_train_step(tcfg)
        worst = {"metrics": 0.0, "grad_norm": 0.0, "params": 0.0}
        for it in range(3):
            b = {k: v.cpu() for k, v in train_batch(tcfg, 8, boxes, it, "cpu").items()}
            metrics = {}
            for side, state in states.items():
                states[side], metrics[side] = step(state, b)
            for name in ("loss", "reconstr_loss"):
                worst["metrics"] = max(worst["metrics"], abs(
                    metrics["gpu"][name].item() / metrics["cpu"][name].item() - 1))
            if metrics["gpu"]["kld_loss"].item() != 0.0:
                fail("baseline_agree: the baseline's kld_loss is not 0")
            grads = {side: dict((p, t.grad) for p, t in named_leaves(s.params))
                     for side, s in states.items()}
            for path, g in grads["cpu"].items():
                if (g is None) != (grads["gpu"][path] is None):
                    fail(f"baseline_agree {head}: {path} has a gradient on one side only")
                if g is not None:
                    worst["grad_norm"] = max(worst["grad_norm"], abs(
                        grads["gpu"][path].norm().item() / g.norm().item() - 1))
        for (path, t_cpu), (_, t_gpu) in zip(named_leaves(states["cpu"].params),
                                             named_leaves(states["gpu"].params)):
            worst["params"] = max(worst["params"], rel_err(t_gpu, t_cpu))
        emit({"phase": "baseline_agree", "case": f"train_{head}", "steps": 3,
              "max_rel_err": worst, "tolerance": TRAIN_AGREE_TOL})
        bad = {k: v for k, v in worst.items() if not v <= TRAIN_AGREE_TOL[k]}
        if bad:
            fail(f"baseline_agree {head}: the GPU's train steps disagree with the CPU's: {bad}")
        worst_all = {k: max(v, worst[k]) for k, v in worst_all.items()}
    counts = kernel_counts()
    emit({"phase": "baseline_agree", "summary": True, "token_identical": min(shares),
          "max_abs_err_lp_where_identical": max(lp_errs), "train_max_rel_err": worst_all,
          "largest_rel_err": max(worst_all.values()), "launches": counts})
    if any(counts.values()):
        fail(f"baseline_agree: a kernel ran on the baseline's path: {counts}")


def phase_baseline_decode(dev: torch.device) -> None:
    """The baseline at full width (config 3's model without z: V 10,500, E
    600 tied, H 900, P 768, F 2048, 100 boxes, 20 steps, beam 5, 8 FSM
    states, bf16): ``decode_cbs`` (logprob) at batch 16 and 320 x 1 z, then
    ``decode_beam`` at 320 x 1 z; first and warm seconds, captions/s, the
    output checks and the kernels' launches (none)."""
    cfg = decode_cfg()
    params = init_baseline(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    harness = DecodeHarness(params, cfg, device=dev, family="baseline")
    none = {k: 0 for k in KERNELS}

    def timed(name, run, batch, row):
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        best, best_lp = run()
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = kernel_counts()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        check_decode_output(name, best, best_lp, [1, batch, STEPS], counts, none,
                            {"phase": "baseline_decode", **row, "batch": batch, "n_z": 1,
                             "best_lp_min": best_lp.min().item(), "first_run_s": first_s,
                             "warm_run_s": warm_s, "captions_per_s": batch / warm_s})

    for batch in BASELINE_GRIDS:
        feats, _, tables = decode_setup(cfg, batch, 1, BOXES, seed=0)
        timed(f"baseline_decode (cbs, batch {batch})",
              lambda: harness.decode_cbs(feats, None, None, tables, N_CONSTRAINTS,
                                         torch.Generator(device=dev).manual_seed(7), 1),
              batch, {"search": "cbs", "selection": "logprob", "states": STATES, "beam": BEAM,
                      "rows_per_step": batch * STATES * BEAM})
    timed("baseline_decode (beam)",
          lambda: harness.decode_beam(feats, None, None,
                                      torch.Generator(device=dev).manual_seed(8), 1),
          BASELINE_GRIDS[-1], {"search": "beam", "beam": BEAM,
                               "rows_per_step": BASELINE_GRIDS[-1] * BEAM})


def baseline_train_row(cfg, params, batch_size: int, dtype, dev) -> None:
    """The baseline's single steps on a fixed batch: ms a step (median of
    18 and its range), captions/s, peak memory, the card's time, ops and
    busy share from a profiler trace of 3 steps, the loss over
    BASELINE_TRAIN_STEPS steps (finite and falling) and the launches."""
    gc.collect()
    compute = None if dtype == torch.float32 else dtype
    state = create_train_state(params, Config(), cfg, seed=1, device=dev)
    batch = train_batch(cfg, batch_size, BOXES, seed=batch_size, dev=dev)
    step = make_baseline_train_step(cfg, compute)
    losses = []

    def single():
        losses.append(step(state, batch)[1]["loss"])

    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    first = timed_steps(single, 1)[0]
    warm = timed_steps(single, TRAIN_WARMUP - 1)
    ms = timed_steps(single, TRAIN_TIMED)
    med, rng_ = median_range(ms)
    prof = profile_steps(single, 3)
    timed_steps(single, BASELINE_TRAIN_STEPS - len(losses))
    loss = [x.item() for x in losses]
    counts = kernel_counts()
    busy = prof["device_ms_per_step"]
    row = {"phase": "baseline_train", "batch": batch_size, "dtype": str(dtype).split(".")[-1],
           "first_step_ms": first, "warm_ms": warm, "single_ms": med, "single_ms_range": rng_,
           "single_captions_per_s": batch_size / med * 1e3, **prof,
           "device_busy_share": None if busy is None else busy / med, "steps": len(loss),
           "loss_first": loss[0], "loss_last": loss[-1],
           "loss_finite": bool(np.isfinite(loss).all()),
           "loss_falling": bool(np.mean(loss[-5:]) < np.mean(loss[:5])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
    emit(row)
    if not (row["loss_finite"] and row["loss_falling"]):
        fail(f"baseline_train: the loss is not finite and falling on a fixed batch: {loss}")
    if any(counts.values()):
        fail(f"baseline_train: a kernel ran in the baseline's step: {counts}")


def phase_baseline_train(dev: torch.device) -> None:
    """The baseline at config 2's widths (E 600 tied, H 900, P 768, F 2048,
    100 boxes, 21 teacher-forced steps), batch 32 and 150, f32 (TF32 off)
    and bf16 compute."""
    cfg = train_cfg()
    params = init_baseline(cfg, seed=0, device=dev)
    for batch_size in TRAIN_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            baseline_train_row(cfg, params, batch_size, dtype, dev)


def eval_run(preds: Path, refs: Path, forms: Path, out: Path, name: str) -> None:
    """The eval CLI (``python -m style_seqcvae_tpu_torch.scripts.eval``) on a
    predictions JSON: its seconds, every number (finite; each oracle at or
    above its mean over z) and which METEOR ran."""
    reset_kernel_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = eval_cli.main(["--predictions", str(preds), "--references", str(refs),
                            "--wordforms", str(forms), "--output", str(out)])
    seconds = time.perf_counter() - t0
    scores = json.loads(out.read_text())
    captions = json.loads(preds.read_text())
    finite = all(np.isfinite(v) for v in scores.values())
    oracle_ok = {k: scores[k] >= scores[f"mean {k}"] for k in EVAL_METRICS}
    emit({"phase": "eval", "predictions": name, "rc": rc, "captions": len(captions),
          "images": len({p["image_id"] for p in captions}), "seconds": seconds,
          "captions_per_s": len(captions) / seconds,
          "meteor": "MeteorJava" if eval_metrics._jvm_meteor_available() else "MeteorPy",
          "meteor_stemmer": ("porter (nltk)" if eval_metrics._porter_stem("running") == "run"
                             else "identity"),
          "printed_lines": len(printed.getvalue().splitlines()), "scores": scores,
          "finite": finite, "oracle_at_least_mean": oracle_ok, "launches": kernel_counts()})
    if rc != 0 or not finite or not all(oracle_ok.values()) or set(EVAL_METRICS) - set(scores):
        fail(f"eval ({name}): rc {rc}, finite {finite}, oracle >= mean {oracle_ok}")


def phase_baseline_cli(dev: torch.device, root: Path, cvae_preds: Path) -> None:
    """The train CLI at ``--model baseline`` on train_cli's world (12
    iterations, checkpoints every 6), the inference CLI at ``--model
    baseline --bf16`` from its ``checkpoint_12`` over 16 images on the card
    and on the CPU (no more fallbacks on the card), then the eval CLI on
    these predictions and on train_cli's cvae predictions (320 captions)."""
    cfg = root / "world" / "train.yml"
    ser = root / "baseline_run"
    run = train_cli_run(cfg, ser, ["--model", "baseline"], every=TRAIN_CLI_ITERS // 2)
    rows = [json.loads(line) for line in (ser / "metrics.jsonl").read_text().splitlines()]
    restored = read_checkpoint(str(ser / f"checkpoint_{TRAIN_CLI_ITERS}"))
    family = sorted(restored["params"]["cell"])
    args = ["--config", str(cfg), "--model", "baseline", "--bf16", "--batch-images",
            str(CLI_GROUP), "--max-images", str(TRAIN_CLI_DECODE), "--checkpoint-path", str(ser),
            "--checkpoint-name", f"checkpoint_{TRAIN_CLI_ITERS}", "--config-override",
            "DATA.DO_LOAD_COCO", "false", "DATA.DO_LOAD_SENTICAP", "false"]
    decoded = {}
    for side, extra in (("gpu", []), ("cpu", ["--cpu"])):
        out = root / f"baseline_preds_{side}.json"
        reset_kernel_counts()
        stats = {}
        t0 = time.time()
        rc = cli.main(args + ["--output-path", str(out), *extra], stats=stats)
        torch.cuda.synchronize()
        decoded[side] = {"rc": rc, "seconds": time.time() - t0, "fallbacks": stats["fallbacks"],
                         "predictions": json.loads(out.read_text()), "launches": kernel_counts(),
                         "path": out}
    gpu, cpu = decoded["gpu"], decoded["cpu"]
    same = np.mean([a == b for a, b in zip(gpu["predictions"], cpu["predictions"])])
    emit({"phase": "baseline_cli", "batch": PUBLISHED_OPTIM["BATCH_SIZE"],
          "iterations": TRAIN_CLI_ITERS, "train": run, "metrics_steps": [r["step"] for r in rows],
          "losses": [r["loss"] for r in rows], "kld_losses": [r["kld_loss"] for r in rows],
          "checkpoint_cell": family,
          "inference": {side: {k: v for k, v in d.items() if k not in ("predictions", "path")}
                        | {"predictions": len(d["predictions"])} for side, d in decoded.items()},
          "gpu_vs_cpu_identical_captions": float(same)})
    if [r["step"] for r in rows] != list(range(1, TRAIN_CLI_ITERS + 1)) or \
            not all(np.isfinite(r["loss"]) and r["kld_loss"] == 0.0 for r in rows):
        fail("baseline_cli: the train CLI's metrics are wrong")
    if family != ["attention", "attention_lstm", "language_lstm"]:
        fail(f"baseline_cli: the checkpoint holds a cell of {family}")
    if gpu["rc"] != 0 or len(gpu["predictions"]) != TRAIN_CLI_DECODE or \
            any(gpu["launches"].values()) or gpu["fallbacks"] > cpu["fallbacks"]:
        fail(f"baseline_cli: inference on the card: rc {gpu['rc']}, "
             f"{len(gpu['predictions'])} predictions, launches {gpu['launches']}, "
             f"fallbacks {gpu['fallbacks']} (CPU {cpu['fallbacks']})")
    world = root / "world"
    for name, preds in (("baseline", gpu["path"]), ("cvae", cvae_preds)):
        eval_run(preds, world / "captions.json", world / "wordforms.tsv",
                 root / f"scores_{name}.json", name)


# ---------------------------------------------------------------- images,
# the extract CLI and serving (slice 12)

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "images"
# the JPEG fixtures, PIL's decodes beside them (make_fixtures.py), each
# fixture's subsampling and its own bound against PIL's pixels
NVJPEG_BOUNDS = json.loads((FIXTURES / "nvjpeg_bounds.json").read_text())["fixtures"]
DECODE_TIMED = 5
# the extract CLI's world: 32 images of 480 x 640 (JPEG, as COCO is, with
# one PNG and one PPM), config 5's detector (81 classes, 98 attributes) at the CLI's
# canvas 640 x 1024, batch 16; the threshold sits above the random
# detector's uniform score (1/81 ~ 0.0123), so that each class keeps its
# highest-scoring boxes and the cap of 100 binds
EXTRACT_IMAGES, EXTRACT_BATCH, EXTRACT_CANVAS, EXTRACT_THRESH = 32, 16, (640, 1024), 0.013
# the COCO-Attributes index: 3 whitelisted attributes on every object (kept)
# and 8 on one object each (fewer than 20 images: pruned), so the reader
# keeps 106 - 8 = 98 attributes, config 5's head
COMMON_ATTS, RARE_ATTS = 3, 8
# serving at full width (bench.py:679-850): config 5's detector, config
# 3's captioner, 20 z, beam 5, 100 boxes, bf16, canvas 608 x 928, mode 1,
# 98 attributes with a seeded wordform table (bench.py:775-791)
SERVE_ONE_TIMED, SERVE_GROUP, SERVE_GROUP_TIMED = 5, 16, 3
# serve_agree: the chain after the detector on the card against the CPU, f32
SERVE_AGREE_LP_RTOL = 1e-5
# serve_http: the serve CLI as a subprocess, load_test.py at two offered
# rates of JPEG and one of PNG, for 10 s each
HTTP_BATCH, HTTP_RATES, HTTP_PNG_RATES = 8, (4.0, 12.0), (4.0,)
HTTP_DURATION, HTTP_START_TIMEOUT = 10.0, 300


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded photo-like (h, w, 3) uint8 RGB picture: gradients, noise,
    filled blocks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h, (x * 3 + y * 5) % 256], -1)
    img = img + rng.randn(h, w, 3) * 12
    for _ in range(8):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        img[y0:y0 + rng.randint(20, h // 3), x0:x0 + rng.randint(20, w // 3)] = \
            rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode_ppm(rgb: np.ndarray) -> bytes:
    return b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]) + rgb.tobytes()


def timed_decode_ms(data: bytes, dev: torch.device) -> list:
    out = []
    for _ in range(DECODE_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image_decode.decode_image_bgr(data, dev)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out[1:]


def phase_images(dev: torch.device) -> None:
    """nvjpeg on the card against PIL's pixels (the fixtures' .npy), PNG and
    PPM exact on the card, and the decode times of a 480 x 640 image."""
    rows, failed = {}, []
    for name, bound in NVJPEG_BOUNDS.items():
        got = image_decode.decode_image_bgr((FIXTURES / f"{name}.jpg").read_bytes(), dev)
        want = np.load(FIXTURES / f"{name}.npy")[:, :, ::-1].astype(np.float32)
        diff = np.abs(got.cpu().numpy() - want)
        rows[name] = {"shape": list(got.shape), "subsampling": bound["subsampling"],
                      "mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max()),
                      "identical_share": float((diff == 0).mean()), "bound": bound["bound"]}
        if not (diff.mean() <= bound["bound"]["mean"] and diff.max() <= bound["bound"]["max"]):
            failed.append(name)
    photo = np.load(FIXTURES / "photo_a.npy")
    png, ppm = (FIXTURES / "photo_a.png").read_bytes(), encode_ppm(photo)
    exact = {fmt: bool(np.array_equal(image_decode.decode_image_bgr(data, dev).cpu().numpy(),
                                      photo[:, :, ::-1].astype(np.float32)))
             for fmt, data in (("png", png), ("ppm", ppm))}
    jpeg = (FIXTURES / "photo_a.jpg").read_bytes()
    ms = {fmt: timed_decode_ms(data, dev) for fmt, data in (("jpeg", jpeg), ("png", png),
                                                            ("ppm", ppm))}
    img = image_decode.decode_image_bgr(jpeg, dev)
    prep = []
    for _ in range(DECODE_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepare_image(img, 600, 1000)
        torch.cuda.synchronize()
        prep.append(1e3 * (time.perf_counter() - t0))
    emit({"phase": "images", "decoder": "nvjpeg (libnvjpeg, CUDA toolkit)", "jpeg": rows,
          "png_ppm_exact_on_card": exact,
          "decode_ms_480x640": {k: {"median": float(np.median(v)), "range": [min(v), max(v)]}
                                for k, v in ms.items()},
          "prepare_ms_480x640_to_600x800": float(np.median(prep[1:]))})
    if failed or not all(exact.values()):
        fail(f"images: nvjpeg outside its bound on {failed}, exact {exact}")


def whitelisted_attributes() -> list:
    """Whitelisted COCO-Attributes names whose inventory index is below 98
    (so that their GT packing stays inside the attribute head)."""
    names = list(attrib_selection)
    return [n for i, n in enumerate(names) if attrib_selection[n] and i < 98]


def write_extract_world(root: Path) -> tuple:
    """The extract CLI's inputs: 32 images of 480 x 640 (30 JPEGs, the two
    photo fixtures in turn, then PIL's PNG of photo_a and a PPM of a seeded
    picture), an instances JSON of
    80 categories with 3 boxes an image, and a COCO-Attributes index whose
    reader keeps 98 attributes. Returns (instances, image root, attribs)."""
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(11)
    inventory = list(attrib_selection)
    pos = {n: i for i, n in enumerate(inventory)}
    white = whitelisted_attributes()
    common, rare = white[:COMMON_ATTS], white[COMMON_ATTS:COMMON_ATTS + RARE_ATTS]
    images, anns = [], []
    tables = {k: {} for k in ("attrib_inst2attrib_vector", "attrib_inst2obj_inst",
                              "obj_inst2attrib_inst", "obj_inst2image", "image2obj_insts",
                              "obj_inst2obj_id")}
    for k in range(EXTRACT_IMAGES):
        iid = 1000 + k
        if k < EXTRACT_IMAGES - 2:
            name = f"{iid}.jpg"
            shutil.copy(FIXTURES / ("photo_a.jpg", "photo_b.jpg")[k % 2], root / "images" / name)
        elif k == EXTRACT_IMAGES - 2:
            name = f"{iid}.png"
            shutil.copy(FIXTURES / "photo_a.png", root / "images" / name)
        else:
            name = f"{iid}.ppm"
            (root / "images" / name).write_bytes(encode_ppm(picture(480, 640, k)))
        images.append({"id": iid, "file_name": name, "width": 640, "height": 480})
        for j in range(3):
            oi = len(anns) + 1
            x, y = rng.uniform(0, 320), rng.uniform(0, 240)
            w, h = rng.uniform(120, 640 - x), rng.uniform(100, 480 - y)
            cat = int(rng.randint(1, 81))
            anns.append({"id": oi, "image_id": iid, "bbox": [x, y, w, h], "area": w * h,
                         "iscrowd": 0, "category_id": cat})
            vec = np.zeros((len(inventory),), np.float32)
            for a in common + ([rare[k]] if j == 0 and k < len(rare) else []):
                vec[pos[a]] = 0.6
            tables["obj_inst2image"][oi] = iid
            tables["image2obj_insts"].setdefault(iid, []).append(oi)
            tables["obj_inst2obj_id"][oi] = cat
            tables["attrib_inst2attrib_vector"][oi] = vec
            tables["attrib_inst2obj_inst"][oi] = oi
            tables["obj_inst2attrib_inst"][oi] = oi
    tables["attrib2string"] = dict(enumerate(inventory))
    tables["obj_id2obj_name"] = {i: f"c{i}" for i in range(1, 81)}
    (root / "attribs").mkdir()
    for key, value in tables.items():
        with open(root / "attribs" / f"{key}.pkl", "wb") as f:
            pickle.dump(value, f)
    inst = {"images": images, "annotations": anns,
            "categories": [{"id": i, "name": f"c{i}"} for i in range(1, 81)]}
    (root / "instances.json").write_text(json.dumps(inst))
    return str(root / "instances.json"), str(root / "images"), str(root / "attribs")


def phase_extract_cli(dev: torch.device) -> dict:
    """The extract CLI (``python -m style_seqcvae_tpu_torch.scripts.extract_features``)
    over 32 images at config 5's detector, its weights seeded and passed as
    a .npz; features.h5 read back with FeaturesReader; then the inference
    CLI on that features.h5 through kernel A. Returns the launches."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        inst, image_root, attribs = write_extract_world(root / "world")
        cfg = DetectorConfig(num_classes=DET_CLASSES, num_att_classes=DET_ATTS, depth=DET_DEPTH)
        t0 = time.perf_counter()
        save_params_npz(to_jax_detector_params(init_detector(cfg, seed=3, device=dev)),
                        str(root / "det.npz"))
        npz_s = time.perf_counter() - t0
        reset_kernel_counts()
        nms.launches_by_shape.clear()
        stats, out = {}, root / "features.h5"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = extract_cli.main([
                "--instances-json", inst, "--image-root", image_root, "--attribs-dir", attribs,
                "--checkpoint-path", str(root / "det.npz"), "--output", str(out),
                "--detections-output", str(root / "dets.json"),
                "--canvas", *map(str, EXTRACT_CANVAS), "--batch-size", str(EXTRACT_BATCH),
                "--depth", str(DET_DEPTH), "--thresh", str(EXTRACT_THRESH)], stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        by_shape = dict(nms.launches_by_shape)
        reader = FeaturesReader(str(out))
        rows = [reader[iid] for iid in sorted(reader.image_ids)]
        finite = all(np.isfinite(f).all() for f, _ in rows)
        dets = json.loads((root / "dets.json").read_text())
        loop = wall - stats["setup_s"]
        batches = stats["batches"]
        expected = {"vocab_topk_lse": 0, "topk_lse": 0, "roi_align": batches, "nms": batches}
        emit({"phase": "extract_cli", "rc": rc, "images": stats["images"],
              "skipped": stats["skipped"], "batches": batches, "batch": EXTRACT_BATCH,
              "canvas": list(EXTRACT_CANVAS), "thresh": EXTRACT_THRESH,
              "detector": {"depth": DET_DEPTH, "classes": DET_CLASSES, "attributes": DET_ATTS},
              "npz_write_s": npz_s, "wall_s": wall, "setup_s": stats["setup_s"],
              "loop_s": loop, "images_per_s": stats["images"] / wall,
              "loop_images_per_s": stats["images"] / loop,
              "seconds": {k: stats[k] for k in ("decode_prepare_s", "forward_s", "post_s",
                                                "write_s")},
              "host_share_of_loop": (stats["decode_prepare_s"] + stats["post_s"]
                                     + stats["write_s"]) / loop,
              "detections_per_image": stats["detections"],
              "detections_json": len(dets), "rows_read_back": len(rows),
              "boxes_per_row": [int(f.shape[0]) for f, _ in rows], "finite": finite,
              "launches": counts, "nms_by_shape": {str(k): v for k, v in by_shape.items()},
              "expected_launches": expected,
              "note": "the per-class NMS of the host selection is nms_reference in numpy, as "
                      "the JAX CLI's; kernel D runs once a batch, in the proposal layer"})
        if rc != 0 or stats["skipped"] or len(rows) != EXTRACT_IMAGES or not finite:
            fail(f"extract_cli: rc {rc}, {stats['skipped']} skipped, {len(rows)} rows, "
                 f"finite {finite}")
        if not any(stats["detections"]) or not dets:
            fail("extract_cli: no detections at the stated threshold")
        if counts != expected:
            fail(f"extract_cli launch counts {counts}, expected {expected}")
        launches = {"roi_align": counts["roi_align"], "nms_rpn": counts["nms"]}

        # the inference CLI on the extracted features.h5 (kernel A)
        cfg_path = write_cli_world(root / "infer", vocab_size=V, images=1, boxes=1, steps=STEPS,
                                   model=PUBLISHED_MODEL, seed=0)
        reset_kernel_counts()
        stats = {}
        t0 = time.perf_counter()
        preds = root / "preds.json"
        rc = cli.main(["--config", str(cfg_path), "--output-path", str(preds), "--bf16",
                       "--batch-images", str(CLI_GROUP), "--config-override",
                       "DATA.INFER_FEATURES", str(out)], stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        captions = json.loads(preds.read_text())
        groups = -(-EXTRACT_IMAGES // CLI_GROUP)
        expected = {"vocab_topk_lse": (STEPS - 1) * groups, "topk_lse": 0, "roi_align": 0,
                    "nms": 0}
        emit({"phase": "extract_cli_inference", "rc": rc, "predictions": len(captions),
              "wall_s": wall, "captions_per_s": len(captions) / wall,
              "fallbacks": stats["fallbacks"], "launches": counts,
              "expected_launches": expected})
        if rc != 0 or len(captions) != EXTRACT_IMAGES * N_Z or stats["fallbacks"]:
            fail(f"extract_cli_inference: rc {rc}, {len(captions)} predictions, "
                 f"{stats['fallbacks']} fallbacks")
        if counts != expected:
            fail(f"extract_cli_inference launch counts {counts}, expected {expected}")
        launches["vocab_topk_lse"] = counts["vocab_topk_lse"]
    return launches


def serve_table(vocab_size: int, seed: int) -> AttributeWordformTable:
    """bench.py:775-791's seeded wordform table: 98 attributes, 5 random
    tokens each, all selectable."""
    rng = np.random.RandomState(seed)
    return AttributeWordformTable(tokens=rng.randint(2, vocab_size, (DET_ATTS, 5)).astype(np.int32),
                                  valid=np.ones((DET_ATTS, 5), bool),
                                  selectable=np.ones((DET_ATTS,), bool),
                                  canonical=np.arange(DET_ATTS, dtype=np.int32))


def phase_serve_agree(dev: torch.device) -> None:
    """A small f32 serve: the card's detector outputs copied to the CPU, then
    the constraints, tables and decode on both sides from them."""
    det_cfg = DetectorConfig(num_classes=DET_CLASSES, num_att_classes=DET_ATTS, depth=50)
    cap_cfg = decode_cfg(vocab_size=700, image_feature_size=F, embedding_size=300,
                         hidden_size=48, attention_projection_size=32, z_space=16,
                         max_caption_length=10)
    det = init_detector(det_cfg, seed=5, device="cpu")
    cap = init_captioner(cap_cfg, seed=6, device="cpu")
    table = serve_table(cap_cfg.vocab_size, 12)
    kw = dict(n_z=4, beam_size=BEAM, max_boxes=20, rpn_pre_nms_top_n=1000,
              rpn_post_nms_top_n=100, dtype=torch.float32)
    s_gpu = make_serve_fn(det_cfg, cap_cfg, table, device=dev, **kw)
    s_cpu = make_serve_fn(det_cfg, cap_cfg, table, device="cpu", **kw)
    gen = torch.Generator().manual_seed(13)
    images = torch.rand((4, 224, 320, 3), generator=gen) * 255 - 120
    info = torch.tensor([[224.0, 320.0, 1.0]] * 4)
    sel = s_gpu.detect(to_device(det, dev), images.to(dev), info.to(dev))
    sel_cpu = {k: v.cpu() for k, v in sel.items()}
    gumbel = draw_gumbel((4, 4, N_CONSTRAINTS, DET_ATTS), gen)
    ids_g, n_g, tables_g = s_gpu.constrain(sel, gumbel.to(dev))
    ids_c, n_c, tables_c = s_cpu.constrain(sel_cpu, gumbel)
    tables_equal = all(torch.equal(a.cpu(), b) for a, b in zip(tables_g, tables_c)) and \
        torch.equal(ids_g.cpu(), ids_c) and torch.equal(n_g.cpu(), n_c)
    noise = torch.randn((4, 10, 4, 2 ** N_CONSTRAINTS, BEAM, 16), generator=gen)
    sentiment = torch.tensor([[1.0], [-1.0], [1.0], [-1.0]])
    best_g, lp_g = s_gpu.caption(to_device(cap, dev), sel, sentiment.to(dev), tables_g, n_g,
                                 noise.to(dev))
    best_c, lp_c = s_cpu.caption(cap, sel_cpu, sentiment, tables_c, n_c, noise)
    same = (best_g.cpu() == best_c).all(dim=-1).float().mean().item()
    lp_rel = ((lp_g.cpu() - lp_c).abs() / lp_c.abs().clamp(min=1e-30)).max().item()
    emit({"phase": "serve_agree", "dtype": "float32", "detections_per_image":
          sel["valid"].sum(dim=1).tolist(), "num_constraints": n_c.tolist(),
          "tables_identical": tables_equal, "identical_captions": same,
          "lp_max_rel_diff": lp_rel, "lp_rtol": SERVE_AGREE_LP_RTOL})
    if not tables_equal or same != 1.0 or not lp_rel <= SERVE_AGREE_LP_RTOL:
        fail(f"serve_agree: tables {tables_equal}, identical {same}, lp rel {lp_rel}")


def phase_serve(dev: torch.device, det_state, decode_state) -> dict:
    """Serving at full width: one request (warm, median of 5), then groups
    of 16, with the kernels' launches of one group. Returns the launches."""
    det_cfg, det_params, images, im_info = det_state
    harness = decode_state[0]
    serve = make_serve_fn(det_cfg, harness.cfg, serve_table(V, 0), n_z=N_Z, beam_size=BEAM,
                          max_boxes=BOXES, det_thresh=0.05, det_nms_thresh=TEST.nms_thresh,
                          rpn_pre_nms_top_n=TEST.rpn_pre_nms_top_n,
                          rpn_post_nms_top_n=TEST.rpn_post_nms_top_n,
                          rpn_nms_thresh=TEST.rpn_nms_thresh, device=dev)
    cap = harness.params
    gen = torch.Generator(device=dev).manual_seed(21)
    one = torch.rand((1,) + CANVAS + (3,), generator=gen, device=dev) * 255.0
    one_info = torch.tensor([IM_INFO], device=dev)

    def request(imgs, info, seed):
        out = serve(det_params, cap, imgs, info, torch.ones((imgs.shape[0], 1), device=dev),
                    generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        return out

    request(one, one_info, 0)
    one_ms = []
    for i in range(SERVE_ONE_TIMED):
        t0 = time.perf_counter()
        request(one, one_info, 1 + i)
        one_ms.append(1e3 * (time.perf_counter() - t0))
    request(images, im_info, 10)
    torch.cuda.reset_peak_memory_stats()
    group_ms, counts = [], None
    for i in range(SERVE_GROUP_TIMED):
        reset_kernel_counts()
        nms.launches_by_shape.clear()
        t0 = time.perf_counter()
        best, lp, num_given = request(images, im_info, 11 + i)
        group_ms.append(1e3 * (time.perf_counter() - t0))
        if counts is None:
            counts = {**kernel_counts(),
                      **{site: nms.launches_by_shape[call[:2]] for site, call in NMS_CALLS.items()}}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the stages of one group, synchronised one by one
    stage_ms = {}
    t0 = time.perf_counter()
    sel = serve.detect(det_params, images, im_info)
    torch.cuda.synchronize()
    stage_ms["detect"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, n_given, tables = serve.constrain(sel, torch.Generator(device=dev).manual_seed(30))
    torch.cuda.synchronize()
    stage_ms["constrain"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    serve.caption(cap, sel, torch.ones((SERVE_GROUP, 1), device=dev), tables, n_given,
                  torch.Generator(device=dev).manual_seed(31))
    torch.cuda.synchronize()
    stage_ms["caption"] = 1e3 * (time.perf_counter() - t0)
    expected = {"vocab_topk_lse": STEPS - 1, "topk_lse": 0, "roi_align": 1, "nms": 2,
                "nms_rpn": 1, "nms_per_class": 1}
    distinct = [len({tuple(best[z, b].tolist()) for z in range(N_Z)}) for b in range(SERVE_GROUP)]
    in_vocab = bool(((best >= 0) & (best < V)).all())
    finite = bool(torch.isfinite(lp).all())
    group_med = float(np.median(group_ms))
    emit({"phase": "serve", "dtype": "bfloat16", "canvas": list(CANVAS), "n_z": N_Z,
          "beam": BEAM, "boxes": BOXES, "attributes": DET_ATTS,
          "one_request_ms": {"median": float(np.median(one_ms)), "range": [min(one_ms),
                                                                          max(one_ms)]},
          "group": SERVE_GROUP,
          "group_ms": {"median": group_med, "range": [min(group_ms), max(group_ms)]},
          "images_per_s": SERVE_GROUP / group_med * 1e3,
          "captions_per_s": SERVE_GROUP * N_Z / group_med * 1e3,
          "stage_ms": stage_ms, "launches_per_group": counts, "expected_launches": expected,
          "num_constraints": num_given.tolist(), "distinct_captions_per_image": distinct,
          "shape": list(best.shape), "in_vocab": in_vocab, "finite_scores": finite,
          "peak_mem_gb": peak})
    if list(best.shape) != [N_Z, SERVE_GROUP, STEPS] or not in_vocab or not finite:
        fail("serve produced bad captions")
    if counts != expected:
        fail(f"serve launch counts {counts}, expected {expected}")
    return {"vocab_topk_lse": counts["vocab_topk_lse"], "roi_align": counts["roi_align"],
            "nms_rpn": counts["nms_rpn"], "nms_per_class": counts["nms_per_class"]}


def live_in_group(pgid: int) -> list:
    """The pids of the process group ``pgid`` that are alive (not zombies)."""
    pids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) == pgid:
            pids.append(int(stat.parent.name))
    return pids


def phase_serve_http(dev: torch.device) -> None:
    """The serve CLI's HTTP mode as a user starts it (a subprocess on the
    card, config 5's detector and config 3's captioner, 98 attributes),
    driven by load_test.py at two offered rates; any error fails."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        names = [f"w{i}" for i in range(DET_ATTS)]
        cfg = write_cli_world(root / "world", vocab_size=V, images=1, boxes=1, steps=STEPS,
                              model=PUBLISHED_MODEL, seed=0)
        (root / "names.json").write_text(json.dumps(names))
        (root / "forms.tsv").write_text("".join(f"{n}\t{n}\n" for n in names))
        text = cfg.read_text().replace(
            "    MAX_GIVEN_CONSTRAINTS: 3",
            f"    WORDFORMS_ATTRIBS: {root / 'forms.tsv'}\n    MAX_GIVEN_CONSTRAINTS: 3")
        cfg.write_text(text)
        cmd = [sys.executable, "-m", "style_seqcvae_tpu_torch.scripts.serve", "--config",
               str(cfg), "--attrib-names-json", str(root / "names.json"), "--http", "0",
               "--canvas", *map(str, CANVAS), "--batch-requests", str(HTTP_BATCH)]
        t0 = time.perf_counter()
        # its own process group: the server and its decode workers
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        lines, url = [], None
        try:
            while url is None:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line.rstrip())
                found = re.search(r"serving on (http://127\.0\.0\.1:\d+)", line)
                if found:
                    url = found.group(1)
                if time.perf_counter() - t0 > HTTP_START_TIMEOUT:
                    break
            start_s = time.perf_counter() - t0
            if url is None:
                fail(f"serve_http: the server did not start: {lines[-20:]}")
            threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
            with contextlib.redirect_stdout(io.StringIO()):
                rows = load_test.main(["--url", url, "--image", str(FIXTURES / "photo_a.jpg"),
                                       "--rates", *map(str, HTTP_RATES), "--duration",
                                       str(HTTP_DURATION)])
                png_rows = load_test.main(["--url", url, "--image",
                                           str(FIXTURES / "photo_a.png"), "--rates",
                                           *map(str, HTTP_PNG_RATES), "--duration",
                                           str(HTTP_DURATION)])
        finally:
            proc.terminate()                # SIGTERM: the server stops its workers and exits
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        deadline = time.perf_counter() + 10
        while live_in_group(proc.pid):
            if time.perf_counter() > deadline:
                os.killpg(proc.pid, signal.SIGKILL)
                fail(f"serve_http: the server left {live_in_group(proc.pid)} running")
            time.sleep(0.1)
        errors = sum(r["errors"] for r in rows + png_rows)
        emit({"phase": "serve_http", "batch_requests": HTTP_BATCH, "canvas": list(CANVAS),
              "image": "tests/fixtures/images/photo_a.jpg (480 x 640 JPEG, nvjpeg)",
              "start_to_serving_s": start_s,
              "server_lines": [ln for ln in lines if "warm-up" in ln or "serving on" in ln],
              "rates": rows,
              "png_image": "tests/fixtures/images/photo_a.png (PIL's PNG, decoded on the "
                           "host by the server's worker processes)",
              "png_rates": png_rows, "errors": errors})
        if errors or len(rows) != len(HTTP_RATES) or len(png_rows) != len(HTTP_PNG_RATES):
            fail(f"serve_http: {errors} errors; server said {lines[-20:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    phase_build()
    # selection width from the decode's own padded tables: pnbs + E
    _, _, tables = decode_setup(CaptionerConfig(vocab_size=V), 1, 1, 1, seed=0)
    k = BEAM // 2 + tables.exc_token.shape[-1]
    rows = phase_kernels(k, dev)
    phase_agree(dev)
    launches, decode_state = phase_decode(dev)
    phase_beam(dev, decode_state)
    phase_greedy(dev)
    det_rows = phase_detector_kernels(dev)
    det_state = detector_setup(dev)
    launches.update(phase_detect(dev, det_state))
    phase_detect_agree(dev, det_state)
    phase_e2e(dev, det_state, decode_state)
    # the diverse-decoding paths last, so that the earlier paths run as
    # they did before these were added
    phase_sample(dev, decode_state)
    phase_diverse(dev, decode_state)
    # the inference CLI: its prehead decodes add to kernel A's count
    launches["vocab_topk_lse"] += phase_cli(dev)
    # captioner training last, so that every earlier path runs as before;
    # its steps launch none of the kernels; the train CLI's closing
    # inference run adds to A's count
    phase_train_agree(dev)
    phase_train(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        a_launches, cvae_preds = phase_train_cli(dev, root)
        launches["vocab_topk_lse"] += a_launches
        # the baseline family and the evaluation after every earlier path,
        # so that those run as before; none launches a kernel, and the eval
        # phase scores train_cli's cvae predictions too
        phase_baseline_agree(dev)
        phase_baseline_decode(dev)
        phase_baseline_train(dev)
        phase_baseline_cli(dev, root, cvae_preds)
    # images, the extract CLI and serving after every earlier path, so that
    # those run as before; their launches add to the kernels' counts (the
    # HTTP server's are its own process's)
    phase_images(dev)
    new_launches = [phase_extract_cli(dev)]
    phase_serve_agree(dev)
    new_launches.append(phase_serve(dev, det_state, decode_state))
    phase_serve_http(dev)
    for counts in new_launches:
        for name, n in counts.items():
            launches[name] += n

    kernels = []
    for name, row in {**rows, **det_rows}.items():
        source, replaces = SOURCES[name]
        err = row.get("max_abs_err")
        if err is None:
            err = max(row["max_abs_err_vals"], row["max_abs_err_lse"])
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": row["kernel_ms"],
                        "ms_range": row["kernel_ms_range"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
