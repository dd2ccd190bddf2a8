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
   count from that run (the attention kernel's 20 in every selection), then
   ``decode_compare``: the share of identical best captions for every pair
   of selections; then the decode that the inference CLI runs by default,
   f32 parameters and features through "prehead" (kernel A's f32 route, 19
   launches; the attention kernel's, 20), timed, against the same f32
   decode through "raw" (no selection kernel): at least 99% of the best
   captions identical; then ``sync_free``: ``decode_cbs`` in bf16 and f32,
   each selection, under ``set_sync_debug_mode("error")`` (a host-device
   sync raises), on inputs on the card and on inputs that arrive on the
   host, with its launches (A or B 19, the attention 20) and ms a decode
   (``--sync-free`` runs the build and this alone);
   then ``attention``: the BUTD attention kernel
   (``csrc/butd_attention.cu``) against its plain version in f32 and bf16
   at the cells' decode step (16 images x 800 rows over 100 boxes, P 768)
   and a serve request's (one image, 800 rows, a ragged mask), timed by CUDA
   graph beside the plain version's time and its bound (the tanh count over
   the SFU's rate or the FP32 lanes' rate, or the bytes over 3.35 TB/s,
   whichever is longest), and at edge shapes (ragged boxes, one box, 150
   boxes, odd widths); its f32 logits against the plain arithmetic in f32,
   masked boxes 0, two launches bit-equal; ``attention_tanh``, the f32
   route's tanh against tanhf over a sweep; ``attention_decode``, config 3's
   f32 prehead decode through the kernel (20 launches) against the same
   decode with the routing's call swapped for the composite: at least 99%
   of the best captions identical; ``attention_train``, a training step's
   launches (0);
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
   the selection kernels' launches (0) and the attention kernel's (20),
   ``distinct_per_image`` (distinct captions among an image's 20) and
   ``repeat_identical`` (the share of captions a second decode from the
   same seed repeats);
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
25. ``kernel`` rows for detector training, at (4, 40, 64, 1024) with 512
   RoIs laid out as ``proposal_target`` yields them, f32 and bf16:
   ``roi_align_train``, kernel C against its plain version, and
   ``roi_align_backward`` (the hand-written backward of RoIAlign) against
   autograd of the plain RoIAlign (error relative to the largest gradient)
   and a second launch bit for bit (``deterministic``), also in bf16 on the
   workflow's stage-1 shapes (8, 24, 32, 1024) with 1,024 RoIs;
   and ``nms_rpn_train``, kernel D at the RPN's
   training call (4 x 12,000, 0.7, 2,000 kept), 0 mismatches;
26. ``detector_train``: the training step at full width (ResNet-101, 81
   classes, 196 attributes, 4 images on 640 x 1024, 12,000 / 2,000
   proposals, 128 RoIs an image), 8 steps in f32 (TF32 off) then 8 in bf16
   compute: ms a step (median of the last 5), images/s, peak memory, the
   first and last total loss, and the launches a step of C, its backward
   and D (one each);
27. ``train_detector_cli``: the train CLI on 8 of the JPEG fixtures
   (ResNet-101, 2 images a step, one epoch), the extract CLI from its
   checkpoint with ``--detections-output``, then ``eval_detections``
   with ``--vis-dir`` (the JPEGs decoded by nvjpeg, every box drawn):
   step ms, mAP, AP50 (near zero after 4 steps: nothing is claimed), one
   PNG per image with detections, each equal to ``vis_image_detections``
   of that image's nvjpeg pixels, and decode, draw and encode ms an image;
28. ``detector_variants``: VGG16 (no attribute head) with ``align``,
   ``pool`` and ``crop``: one inference forward on 2 images at config 5's
   608 x 928 and 2 training steps: ms and peak memory;
29. ``multigpu``, data and tensor parallelism on the one card (single-card
   numbers, no scaling): ``decode_split``, config 3's CBS decode through prehead and
   fused on a mesh of the card listed twice (z split 2 x 10), in bf16 and
   f32: each chunk bit-equal to the unsplit harness on its z slice of the
   same noise, a one-device mesh bit-equal to the unsplit decode, A or B
   held to its plain version on each chunk's 6,400-row inputs; against the
   unsplit decode from the same seeded generator (a chunk's GEMMs of half
   the rows round differently), f32 at least 98% of the captions identical
   (their log-probs rtol 1e-5), in bf16 the median per-caption best
   log-prob difference within a bound set from readings, each gate broken
   by a control (the chunks' noise swapped); A or B 19 launches a chunk, counted over both
   runs of each decode, and captions/s; ``ddp_captioner``, config 2's widths at a global batch of 150
   as two ranks of 75 sharing the card over gloo (``parallel/
   distributed_worker.py``), 3 steps f32, against one process on the 150
   rows: loss and params within rtol 1e-5, ms a step per rank and the
   gradient sum's ms; ``ddp_detector``, ResNet-101 at 2 + 2 images on 640 x
   1024, 2 steps, against one process on the 4 images: every loss within
   rtol 1e-3, C, its backward and D once a step on each rank;
   ``nccl_world1``, the train CLI as a one-rank NCCL group under
   ``SSC_COORDINATOR``, its losses equal to the plain run's; and ``tp``
   (tensor parallelism), config 2's widths as a 1 x 2 mesh at 150 rows and
   a 2 x 2 mesh at 100, ranks sharing the card over gloo, 2 steps f32 with
   the clip engaged, against one process on the same rows: metrics, the
   pre-clip norm and every leaf within TP_RTOL, the leaves held whole over
   the model axis bit-equal across each model group, no kernel launched;
   ms a step per rank, ms of the step's tensor-parallel collectives (CUDA
   events), their count and the peak memory per rank;

30. ``pipeline``, the user's three-stage workflow: ``make_world`` renders
   the JAX test's world (40 / 6 / 6 images of 384 x 512) and encodes each
   JPEG on the card with nvjpeg's encoder (quality 92, 4:2:0): encode ms an
   image; each JPEG decoded back by nvjpeg against the re-rendered pixels
   (mean and max absolute error, within NVJPEG_ROUNDTRIP_BOUND); then
   ``scripts/three_stage.py`` over every stage (1, gate, 2, 3, 4, 5) with
   one detector epoch (ResNet-50, bf16), 10 captioner steps and no mAP
   gate, each CLI a subprocess on the card: each stage's exit code, seconds
   and the launches its processes report (A in the CBS leg, C and its
   backward in stage 1, C and D in stages 1, gate and 2), the AP50 and
   mAP; then each kernel on the inputs of its first launch in each step's
   process (saved under SSC_KERNEL_INPUTS: A at the CBS leg's rows and the
   world's vocabulary, C and its backward on the 384 x 512 ResNet-50 map
   and the training RoIs, D at the RPN's 8 x 9,216 anchors and the
   extraction's calls) against its plain version under TOL, ROI_TOL,
   ROI_BWD_TOL and no NMS mismatch, with its ms there; it fails unless
   every stage exits 0, each of A, C, C's backward and D launched and was
   checked, and every check agrees;

then the ``{"kernels": [...]}`` summary (kernel A twice: its bf16 route,
with the launches of both routes, and its f32 route, ``vocab_topk_lse_f32``,
with those of the f32 decode; the attention kernel twice, ``butd_attention``
for bf16, with the launches of the bf16 prehead decode and the workflow's,
and ``butd_attention_f32``, with those of the f32 prehead decode), the card's
name and power limit from
``nvidia-smi``, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Exits non-zero at once without a GPU.
``python3 chip_smoke.py --split-readings SEED ...`` runs only the build and
``decode_split`` at each seed (the readings its bounds are set from);
``python3 chip_smoke.py --tp-readings`` runs only the ``tp`` part;
``python3 chip_smoke.py --pipeline`` only the build and ``pipeline``;
``python3 chip_smoke.py --decode-f32`` only the build and the f32 decode
rows; ``python3 chip_smoke.py --attention`` only the build and the
attention rows.
``python3 chip_smoke.py --pipeline-readings`` runs the build and the
workflow alone at make_world's defaults (800 / 100 / 100 images) and
three_stage.sh's detector knobs (16 epochs, ResNet-50), the captioner cut
to 2,000 steps: stage seconds, AP50 and mAP beside the JAX run's, the
style margins and the baselines (reported, not gated);
``--pipeline-readings DIR`` also copies the run's records to ``DIR``.
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
from style_seqcvae_tpu_torch.data.image_encode import encode_jpeg
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
    FSMTables,
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
from style_seqcvae_tpu_torch.parallel import distributed_worker as dworker
from style_seqcvae_tpu_torch.parallel.mesh import make_mesh
from style_seqcvae_tpu_torch.parallel.multihost import free_port
from style_seqcvae_tpu_torch.models import attention as attention_mod
from style_seqcvae_tpu_torch.ops.kernels import (
    KERNEL_INPUTS_ENV,
    _build,
    butd_attention,
    nms,
    roi_align,
    topk_lse,
    vocab_topk_lse,
)
from style_seqcvae_tpu_torch.scripts import eval as eval_cli
from style_seqcvae_tpu_torch.scripts import eval_detections as eval_detections_cli
from style_seqcvae_tpu_torch.scripts import extract_features as extract_cli
from style_seqcvae_tpu_torch.scripts import inference as cli
from style_seqcvae_tpu_torch.scripts import load_test
from style_seqcvae_tpu_torch.scripts import make_world as make_world_cli
from style_seqcvae_tpu_torch.scripts import train as train_cli
from style_seqcvae_tpu_torch.scripts import three_stage as three_stage_cli
from style_seqcvae_tpu_torch.scripts.time_detector import train_rois
from style_seqcvae_tpu_torch.scripts import train_detector as train_detector_cli
from style_seqcvae_tpu_torch.serving import make_serve_fn
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD
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
from style_seqcvae_tpu_torch.utils.visualize import vis_image_detections
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
# config 3's f32 decode: prehead takes its logsumexp from kernel A and its
# exception logits from a small product of their own, raw both from the
# materialised logits, so the scores differ in the last bits and a near tie
# may flip; at least 99% of the best captions must be identical
F32_DECODE_AGREE_MIN = 0.99
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

# the three-stage workflow (scripts/three_stage.py) on a world that
# make_world renders on the card (JPEG through nvjpeg): the JAX test's world
# size (tests/test_make_world.py) at the workflow's 384 x 512, and knobs
# small enough for the smoke run (one detector epoch, 10 captioner steps, no
# mAP gate: the AP50 of one epoch is printed, not judged)
PIPE_WORLD = dict(train=40, val=6, test=6, senticap=12, seed=3)
PIPE_KNOBS = dict(det_epochs=1, cap_iters=10, map_gate=0.0)
# --pipeline-readings: make_world's own defaults and three_stage.sh's
# detector knobs (16 epochs, ResNet-50, its learning rate and decay), the
# captioner cut from 20,000 steps to 2,000 (~4 minutes on the card); every
# image's round trip would re-render 1,000 scenes on the host, so the first
# 60 are checked
READINGS_WORLD = dict(train=800, val=100, test=100, senticap=100, seed=0)
READINGS_KNOBS = dict(det_epochs=16, cap_iters=2000, map_gate=0.0)
READINGS_ROUNDTRIP = 60
# the JAX run's figures beside which the readings are reported
# (runs/pipeline3/detection_map.json; tests/test_pipeline_artifacts.py's gates)
JAX_PIPELINE_MAP = {"AP50": 0.7153959994679204, "mAP": 0.4565194270737201}
JAX_PIPELINE_GATES = {"AP50": 0.5, "mAP": 0.25, "pos_margin": 0.30, "neg_margin": 0.30,
                      "model mean B4": 0.05, "mean B4 over random": 1.2,
                      "mean cider over random": 1.2, "grounding_P over random": 1.4}
# nvjpeg's encode (quality 92, 4:2:0) decoded back by nvjpeg, against the
# rendered pixels: bounds set from readings (H100, the 52 smoke images:
# mean 5.04, worst image 5.52, max 194; the readings world's first 60: mean
# 5.04, worst 5.85, max 195; PIL's own quality-92 round trip of the smoke
# images: mean 4.80, max 153; the scenes carry per-pixel noise)
NVJPEG_ROUNDTRIP_BOUND = {"mean": 6.0, "max": 230.0}

SOURCES = {
    # kernel A's two routes: bf16 on the tensor cores, f32 on the CUDA cores
    "vocab_topk_lse": ("style_seqcvae_tpu_torch/csrc/vocab_topk_lse_sm90.cu",
                       "style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py:113"),
    "vocab_topk_lse_f32": ("style_seqcvae_tpu_torch/csrc/vocab_topk_lse.cu",
                           "style_seqcvae_tpu/ops/pallas/vocab_topk_lse.py:113"),
    "topk_lse": ("style_seqcvae_tpu_torch/csrc/topk_lse.cu",
                 "style_seqcvae_tpu/ops/pallas/topk_lse.py:76"),
    "roi_align": ("style_seqcvae_tpu_torch/csrc/roi_align.cu",
                  "style_seqcvae_tpu/ops/pallas/roi_align.py:92"),
    **{site: ("style_seqcvae_tpu_torch/csrc/nms.cu", "style_seqcvae_tpu/ops/pallas/nms.py:58")
       for site in NMS_CALLS},
    # no TPU kernel: JAX leaves the attention to XLA
    **{name: ("style_seqcvae_tpu_torch/csrc/butd_attention.cu",
              "none: style_seqcvae_tpu/models/attention.py:54 (XLA's add, tanh, product and "
              "masked softmax)") for name in ("butd_attention", "butd_attention_f32")},
    # no TPU kernel: the VJP of JAX's XLA gather RoIAlign, which its
    # detector training differentiates (faster_rcnn.py:143)
    "roi_align_backward": ("style_seqcvae_tpu_torch/csrc/roi_align.cu",
                           "style_seqcvae_tpu/ops/roi_align.py:51 (VJP of the XLA gather, "
                           "reached from style_seqcvae_tpu/models/detector/faster_rcnn.py:143)"),
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
    extra = {"plan": vocab_topk_lse.plan(R, V, E + (-E % 8), k, x.dtype)}
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
    and kernel A's f32 row for the summary line."""
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
            elif name == "vocab_topk_lse":
                out["vocab_topk_lse_f32"] = row
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
    """The launches of the selection kernels A and B and of the attention
    kernel, which every decode step without a gradient launches once."""
    return {"vocab_topk_lse": vocab_topk_lse.launches, "topk_lse": topk_lse.launches,
            "butd_attention": butd_attention.launches}


def reset_selection_counts() -> None:
    vocab_topk_lse.launches = 0
    topk_lse.launches = 0
    butd_attention.launches = 0


def decode_expected(selection_kernel=None) -> dict:
    """:func:`selection_counts` after one decode of STEPS steps: the
    selection kernel ``selection_kernel`` (if any) once a step after the
    first, the attention kernel once a step."""
    return {"vocab_topk_lse": STEPS - 1 if selection_kernel == "vocab_topk_lse" else 0,
            "topk_lse": STEPS - 1 if selection_kernel == "topk_lse" else 0,
            "butd_attention": STEPS}


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
        expected = decode_expected(kernel_of.get(selection))
        check_decode_output(f"decode ({selection})", best, best_lp, [N_Z, BATCH, STEPS],
                            counts, expected,
                            {"phase": "decode", "selection": selection,
                             "best_lp_min": best_lp.min().item(), "first_run_s": first_s,
                             "warm_run_s": warm_s, "captions_per_s": BATCH * N_Z / warm_s})
        if selection in kernel_of:
            launches[kernel_of[selection]] = counts[kernel_of[selection]]
        if selection == "prehead":
            # the bf16 cell's path: the attention kernel's entry counts this run
            launches["butd_attention"] = counts["butd_attention"]
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


def phase_decode_f32(dev: torch.device) -> dict:
    """The decode that the inference CLI runs by default (no --bf16): config
    3's grid with f32 parameters and features, CBS with the "prehead"
    selection (kernel A's f32 route, 19 launches; the attention kernel's
    f32 route, 20) on the decode phase's seeded noise, timed first and
    warm; then the same decode through "raw" (no selection kernel), whose
    best captions it must match for nearly every (z, image). Returns the
    f32 routes' launches in the timed prehead run, keyed for the kernels
    line."""
    cfg = decode_cfg()
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.float32)
    feats, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    harness = DecodeHarness(params, cfg, device=dev)
    best_by_sel, row_by_sel, launches = {}, {}, {}
    for selection in ("prehead", "raw"):
        reset_selection_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        best, best_lp = harness.decode_cbs(feats, sentiment, None, tables, N_CONSTRAINTS,
                                           torch.Generator(device=dev).manual_seed(7), N_Z,
                                           selection=selection)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = selection_counts()
        t0 = time.time()
        harness.decode_cbs(feats, sentiment, None, tables, N_CONSTRAINTS,
                           torch.Generator(device=dev).manual_seed(7), N_Z, selection=selection)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        expected = decode_expected("vocab_topk_lse" if selection == "prehead" else None)
        row = {"phase": "decode", "selection": selection, "dtype": "float32",
               "best_lp_min": best_lp.min().item(), "first_run_s": first_s,
               "warm_run_s": warm_s, "captions_per_s": BATCH * N_Z / warm_s}
        check_decode_output(f"decode ({selection}, f32)", best, best_lp, [N_Z, BATCH, STEPS],
                            counts, expected, row)
        if selection == "prehead":
            launches = {"vocab_topk_lse_f32": counts["vocab_topk_lse"],
                        "butd_attention_f32": counts["butd_attention"]}
        best_by_sel[selection] = best
    identical = (best_by_sel["prehead"] == best_by_sel["raw"]).all(dim=-1).float().mean().item()
    emit({"phase": "decode_compare", "dtype": "float32", "prehead_vs_raw_identical": identical,
          "need": F32_DECODE_AGREE_MIN})
    if identical < F32_DECODE_AGREE_MIN:
        fail(f"the f32 prehead decode matches raw on {identical:.4f} of its best captions")
    del harness, params
    torch.cuda.empty_cache()
    return launches


def card_inputs(dev: torch.device, seed: int):
    """Config 3's decode inputs on the card (features, sentiment, padded
    tables, constraint counts, z-noise shared by a z-sample's beams), as the
    benchmark's cells hand them to ``decode_cbs``."""
    feats, sentiment, tables = decode_setup(decode_cfg(), BATCH, N_Z, BOXES, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.from_numpy(feats).to(dev), torch.from_numpy(sentiment).to(dev),
            FSMTables(*[torch.from_numpy(np.asarray(t)).to(dev) for t in tables]),
            torch.full((BATCH,), N_CONSTRAINTS, device=dev),
            torch.randn((N_Z, STEPS, BATCH, 1, 1, Z), generator=gen, device=dev))


def phase_sync_free(dev: torch.device) -> None:
    """``decode_cbs`` at config 3's widths in bf16 and f32, through each
    selection, under ``torch.cuda.set_sync_debug_mode("error")`` (a
    host-device sync raises): on inputs already on the card, as the
    benchmark's cells hand them, and on inputs that arrive on the host
    (copied through pinned memory); the launches of A, B and the attention
    kernel in the first, as their wrappers count them, and its ms (CUDA
    events around 3 decodes, after one outside the mode)."""
    cfg = decode_cfg()
    for dtype in (torch.bfloat16, torch.float32):
        params = init_captioner(cfg, seed=0, device=dev, dtype=dtype)
        harness = DecodeHarness(params, cfg, device=dev)
        on_card = card_inputs(dev, 1)
        feats, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=3)
        on_host = (feats, sentiment, tables, N_CONSTRAINTS,
                   np.random.RandomState(3).randn(N_Z, STEPS, BATCH, 1, 1, Z).astype(np.float32))
        for selection in SELECTIONS:
            kernel = {"prehead": "vocab_topk_lse", "fused": "topk_lse"}.get(selection)

            def run(x):
                return harness.decode_cbs(x[0], x[1], None, x[2], x[3], x[4], N_Z,
                                          selection=selection)

            run(on_card)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                reset_selection_counts()
                best, best_lp = run(on_card)
                counts = selection_counts()
                run(on_host)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            row = {"phase": "sync_free", "dtype": str(dtype).split(".")[-1],
                   "selection": selection, "sync_debug_mode": "error",
                   "decode_ms": time_ms(lambda: run(on_card), reps=3)}
            check_decode_output(f"sync_free ({selection}, {dtype})", best, best_lp,
                                [N_Z, BATCH, STEPS], counts, decode_expected(kernel), row)
        del harness, params
        torch.cuda.empty_cache()


# the BUTD attention kernel (csrc/butd_attention.cu): (images, rows an
# image, boxes, width) at the cells' decode (16 images x 20 z x 8 states x
# beam 5 over 100 boxes) and at one serve request over 37 real boxes of 100
ATTN_SHAPES = {"decode": (BATCH, N_Z * STATES * BEAM, BOXES, P),
               "serve": (1, N_Z * STATES * BEAM, BOXES, P)}
# further shapes held to the plain version: ragged boxes and rows, one box
# at P 100, boxes past one tile (150), odd bf16 rows (P 101: 2-byte copies)
ATTN_EDGE_SHAPES = [(3, 40, 37, 768), (2, 7, 1, 100), (2, 33, 150, 768), (2, 9, 37, 101)]
# H100 SXM rates at 1.98 GHz over 132 SMs: the special function
# unit's 16 results a clock per SM, the FP32 lanes' 128
SFU_PER_S = 132 * 16 * 1.98e9
FP32_LANES_PER_S = 132 * 128 * 1.98e9
# per (row, box, width) element: bf16 one tanh.approx.f32 on the SFU, the
# add and the FMA; f32 tanhf (ex2 and a reciprocal on the SFU, ~10 FP32
# operations), the add and the FMA
ATTN_SFU_PER_ELEM = {torch.bfloat16: 1, torch.float32: 2}
ATTN_FP32_PER_ELEM = {torch.bfloat16: 2, torch.float32: 12}
# f32: the kernel's tanh is tanhf, the composite's; its P-long sums run in
# another order than cuBLAS's matvec (a few 1e-7 on logits of |l| < 1) and
# its softmax sums 100 exponentials in another order. bf16: its f32 logits
# against the plain arithmetic in f32 on the same bf16 inputs differ by
# tanh.approx.f32's error (relative ~2^-11) summed over P; its bf16
# weights round once, the composite's after each op. Readings on an H100
# over these shapes: f32 weights 7.5e-8, logits 1.5e-6; bf16 logits 7.0e-6,
# weights 9.8e-4 (one bf16 ulp at 1/4). The bf16 weights' limit lies
# above that reading and well under a typical weight (about 0.01 at 100
# boxes, 0.007 at 150)
ATTN_TOL = {torch.float32: {"weights": 1e-5, "logits": 1e-5},
            torch.bfloat16: {"weights": 1.5e-3, "logits": 1e-4}}
# the f32 kernel's tanh against tanhf (PyTorch's tanh) over a sweep
ATTN_TANH_TOL = 2e-7


def attention_inputs(gen: torch.Generator, dev, dtype, B: int, rpi: int, N: int, Pw: int,
                     ragged: bool):
    """Seeded kernel inputs at the decode's scales (proj_query ~ 0.3, the
    projected boxes ~ 0.6, w_attend U(±1/sqrt(P))); a ragged mask keeps a
    random 1..N boxes an image and none of the last image's."""
    q = (0.3 * torch.randn(B * rpi, Pw, generator=gen, device=dev)).to(dtype)
    pv = (0.6 * torch.randn(B, N, Pw, generator=gen, device=dev)).to(dtype)
    w = ((2 * torch.rand(Pw, generator=gen, device=dev) - 1) / Pw ** 0.5).to(dtype)
    mask = torch.ones(B, N, dtype=torch.bool, device=dev)
    if ragged:
        real = torch.randint(1, N + 1, (B, 1), generator=gen, device=dev)
        mask = torch.arange(N, device=dev) < real
        if B > 1:
            mask[-1] = False
    return q, pv, w, mask


def attention_row(name: str, dtype, shape, gen, dev, ragged: bool, timed: bool) -> dict:
    """The kernel against its plain version on one shape: weights, f32
    logits (against the plain arithmetic in f32 on the same inputs), masked
    boxes and fully masked rows exactly 0, two launches bit-equal; with
    ``timed``, its time by CUDA graph, the plain version's and the bound."""
    B, rpi, N, Pw = shape
    q, pv, w, mask = attention_inputs(gen, dev, dtype, B, rpi, N, Pw, ragged)
    got, logits = butd_attention.butd_attention_logits(q, pv, w, mask)
    again = butd_attention.butd_attention(q, pv, w, mask)
    want = butd_attention.butd_attention_plain(q, pv, w, mask)
    want_logits = torch.matmul((q.float().reshape(B, rpi, 1, Pw) + pv.float()[:, None]).tanh(),
                               w.float()).reshape(B * rpi, N)
    keep = mask.repeat_interleave(rpi, dim=0)
    torch.cuda.synchronize()
    row = {"phase": "kernel", "name": "butd_attention", "case": name,
           "dtype": str(dtype).split(".")[-1], "images": B, "rows": B * rpi, "boxes": N,
           "width": Pw, "ragged": ragged,
           "plan": butd_attention.plan(B, rpi, N, Pw, dtype),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "max_abs_err_logits": (logits - want_logits)[keep].abs().max().item()
           if keep.any() else 0.0,
           "masked_zero": bool((got[~keep] == 0).all()),
           "deterministic": bool(torch.equal(got, again)),
           "tolerance": ATTN_TOL[dtype]}
    del want, want_logits
    if timed:
        kernel = lambda: butd_attention.butd_attention(q, pv, w, mask)  # noqa: E731
        plain = lambda: butd_attention.butd_attention_plain(q, pv, w, mask)  # noqa: E731
        ms, rng_ = graph_ms_range(kernel)
        elems = B * rpi * N * Pw
        size = q.element_size()
        t = {"sfu": elems * ATTN_SFU_PER_ELEM[dtype] / SFU_PER_S * 1e3,
             "fp32_lanes": elems * ATTN_FP32_PER_ELEM[dtype] / FP32_LANES_PER_S * 1e3,
             "bytes": ((B * rpi * Pw + B * N * Pw + Pw + B * rpi * N) * size + B * N)
             / HBM_BYTES_PER_S * 1e3}
        by = max(t, key=t.get)
        row.update(kernel_ms=ms, kernel_ms_range=rng_, plain_ms=time_ms(plain, 2),
                   bound_ms=t[by], bound_by=by, bounds_ms=t, bound_ratio=ms / t[by],
                   # no single PyTorch call computes the attention
                   library_ms=None)
    emit(row)
    tol = ATTN_TOL[dtype]
    if not (row["max_abs_err"] <= tol["weights"] and row["max_abs_err_logits"] <= tol["logits"]
            and row["masked_zero"] and row["deterministic"]):
        fail(f"butd_attention ({name}, {row['dtype']}) disagrees with its plain version: {row}")
    return row


def attention_decode_check(dev: torch.device) -> int:
    """Config 3's f32 CBS decode (prehead) through the kernel, then on the
    same inputs and noise with the routing's kernel call swapped for the
    composite (the plain version): the share of identical best captions
    and the largest log-prob gap where identical; returns the kernel's
    launches in the first decode (one a step)."""
    cfg = decode_cfg()
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.float32)
    feats, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    harness = DecodeHarness(params, cfg, device=dev)

    def decode():
        return harness.decode_cbs(feats, sentiment, None, tables, N_CONSTRAINTS,
                                  torch.Generator(device=dev).manual_seed(7), N_Z,
                                  selection="prehead")

    before = butd_attention.launches
    best, lp = decode()
    torch.cuda.synchronize()
    launches = butd_attention.launches - before
    attention_mod.butd_attention = butd_attention.butd_attention_plain
    try:
        best_c, lp_c = decode()
        torch.cuda.synchronize()
    finally:
        attention_mod.butd_attention = butd_attention.butd_attention
    same = (best == best_c).all(dim=-1)
    identical = same.float().mean().item()
    lp_gap = (lp - lp_c)[same].abs().max().item() if same.any() else None
    emit({"phase": "attention_decode", "dtype": "float32", "launches": launches,
          "expected_launches": STEPS, "kernel_vs_composite_identical": identical,
          "lp_max_abs_diff_identical": lp_gap, "need": F32_DECODE_AGREE_MIN})
    if launches != STEPS:
        fail(f"attention_decode: {launches} kernel launches in a decode, expected {STEPS}")
    if identical < F32_DECODE_AGREE_MIN:
        fail(f"attention_decode: the kernel's f32 decode matches the composite's on "
             f"{identical:.4f} of its best captions")
    del harness, params
    torch.cuda.empty_cache()
    return launches


def attention_train_launches(dev: torch.device) -> int:
    """The kernel's launches in one f32 training step at config 2's widths
    (batch 8): the step needs the gradient, so the composite runs."""
    cfg = train_cfg()
    params = init_captioner(cfg, seed=0, device=dev)
    config = Config(config_override=ACTIVE_OVERRIDES)
    state = create_train_state(params, config, cfg, seed=1, device=dev)
    batch = train_batch(cfg, 8, BOXES, seed=8, dev=dev)
    before = butd_attention.launches
    make_train_step(cfg, config.MODEL.KLD_WEIGHT)(state, batch)
    torch.cuda.synchronize()
    launches = butd_attention.launches - before
    emit({"phase": "attention_train", "launches": launches, "expected_launches": 0})
    if launches:
        fail(f"attention_train: a training step launched the kernel {launches} times")
    return launches


def phase_attention(dev: torch.device) -> dict:
    """The BUTD attention kernel: rows at the cells' decode shape in f32 and
    bf16 and at a serve request's (timed), the edge shapes, the f32 tanh
    against tanhf over a sweep, then the decode check and a training
    step's launches. Returns the decode row of each dtype, keyed for the
    kernels line."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape in ATTN_SHAPES.items():
            row = attention_row(name, dtype, shape, gen, dev, ragged=name == "serve", timed=True)
            if name == "decode":
                rows["butd_attention" if dtype == torch.bfloat16 else "butd_attention_f32"] = row
        for shape in ATTN_EDGE_SHAPES:
            attention_row("edge", dtype, shape, gen, dev, ragged=True, timed=False)
    # tanh over [-12, 12] and its special values through a one-box,
    # width-1 call with w = 1 and zero boxes: the logits are the tanh
    x = torch.cat([torch.linspace(-12, 12, 1 << 20, device=dev),
                   torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1e-4, 0.55, 0.6, 0.625, 9.0, 9.1,
                                 float("inf"), float("-inf")], device=dev)])
    x = torch.cat([x, x * 1e-3])[:, None].contiguous()
    _, got = butd_attention.butd_attention_logits(
        x, torch.zeros(1, 1, 1, device=dev), torch.ones(1, device=dev),
        torch.ones(1, 1, dtype=torch.bool, device=dev))
    tanh_err = (got[:, 0] - torch.tanh(x[:, 0])).abs().max().item()
    emit({"phase": "attention_tanh", "values": x.shape[0], "max_abs_err_vs_tanhf": tanh_err,
          "tolerance": ATTN_TANH_TOL})
    if not tanh_err <= ATTN_TANH_TOL:
        fail(f"attention_tanh: the f32 kernel's tanh is {tanh_err} off tanhf")
    attention_decode_check(dev)
    attention_train_launches(dev)
    return rows


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
                        decode_expected(),
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
                        decode_expected(),
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
                            decode_expected(),
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
        expected = decode_expected("vocab_topk_lse" if selection == "prehead" else None)
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
    for mod in (*KERNELS.values(), butd_attention):
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
    counts["butd_attention"] = butd_attention.launches
    expected = {"vocab_topk_lse": 0, "topk_lse": STEPS - 1, "roi_align": 1, "nms": 2,
                "nms_rpn": 1, "nms_per_class": 1, "butd_attention": STEPS}
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


def profile_steps(fn, n: int, top: int = 0) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: the card's kernel and
    copy time a call, their count and the host's kernel-launch calls (None
    where the trace holds no device events); with ``top``, the ``top``
    device events by total time, ms a call."""
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
    out = {"device_ms_per_step": sum(e.time_range.elapsed_us() for e in evs) / 1e3 / n,
           "device_ops_per_step": len(evs) / n, "kernel_launch_calls_per_step": launches / n}
    if top:
        by_name: dict = {}
        for e in evs:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        out["top_device_ms_per_step"] = {k[:90]: v for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]}
    return out


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


# detector training (scripts/train_detector.py at the reference's res101
# run): ResNet-101 C4, 81 classes, 196 attributes, 4 images a step on the
# 640 x 1024 canvas (600 x 1000 images: scale 600, max 1,000), 12,000
# candidates into the RPN's NMS and 2,000 out, 128 RoIs an image
DT_BATCH, DT_CANVAS, DT_IMAGE = 4, (640, 1024), (600, 1000)
DT_CLASSES, DT_ATTS, DT_GT = 81, 196, 8
DT_PRE, DT_POST, DT_THRESH, DT_ROIS = 12000, 2000, 0.7, 128
DT_C4 = (DT_BATCH, 40, 64, 1024)
DT_STEPS, DT_TIMED = 8, 5
# the RoIAlign backward gathers each pixel's f32 sum in a fixed order (RoIs,
# row bins, column bins) and merges a bin's samples per pixel before
# weighting: a few ulps of the largest gradient from autograd of the plain
# version; in bf16 both round their f32 sums once (one bf16 ulp, 2^-8 of
# the largest). Two launches must be equal to the bit.
ROI_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# f32 operations per grad_out element: 16 corner products and adds at S = 2,
# and the 1 / S^2 scale
ROI_BWD_OPS_PER_GRAD = 33
# the workflow's stage 1 (ResNet-50, 8 images of 384 x 512 a step, 128 RoIs
# an image): C4 map and RoIs of its backward
WF_C4, WF_IMAGE = (8, 24, 32, 1024), (384, 512)
# the train CLI on the JPEG fixtures: 8 images of 480 x 640, 2 a step, one
# epoch; then the extract CLI from its checkpoint at --thresh 0 (4 steps
# leave every class below extract_cli's 0.013, so that eval_detections
# scores every detection) and eval_detections
DT_CLI_IMAGES, DT_CLI_IMS = 8, 2
# the VGG16 variants: config 5's canvas, 2 images, 2 training steps each
VARIANT_BATCH, VARIANT_TRAIN_STEPS = 2, 2


def train_detector_cfg(backbone: str = "resnet", pooling_mode: str = "align",
                       num_att_classes: int = DT_ATTS) -> DetectorConfig:
    """The train CLI's DetectorConfig from the DET defaults (12,000 / 2,000
    / 0.7, 128 RoIs) at 81 classes."""
    D = Config().DET
    cfg = train_detector_cli.detector_config(D, DT_CLASSES, num_att_classes, DET_DEPTH, False)
    return cfg._replace(backbone=backbone, pooling_mode=pooling_mode)


def train_detector_batch(dev: torch.device, batch: int, canvas, image, n_atts: int,
                         seed: int) -> dict:
    """A fixed synthetic batch: mean-subtracted pixel-scale images on the
    canvas, DT_GT boxes an image with classes and attributes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.zeros((batch,) + tuple(canvas) + (3,), device=dev)
    h, w = (int(v) for v in image)
    images[:, :h, :w] = torch.randn(batch, h, w, 3, generator=gen, device=dev) * 50.0
    xy = torch.rand(batch, DT_GT, 2, generator=gen, device=dev) * torch.tensor(
        [w * 0.6, h * 0.6], device=dev)
    wh = torch.rand(batch, DT_GT, 2, generator=gen, device=dev) * torch.tensor(
        [w * 0.4, h * 0.4], device=dev) + 24.0
    cls = torch.randint(1, DT_CLASSES, (batch, DT_GT, 1), generator=gen, device=dev).float()
    return {"images": images,
            "im_info": torch.tensor([[float(h), float(w), 1.0]] * batch, device=dev),
            "gt_boxes": torch.cat([xy, xy + wh, cls], dim=-1),
            "num_gt": torch.full((batch,), DT_GT, device=dev),
            "gt_atts": (torch.rand(batch, DT_GT, max(n_atts, 1), generator=gen,
                                   device=dev) > 0.9).float(),
            "att_counts": torch.randint(1, 500, (max(n_atts, 1),), generator=gen,
                                        device=dev).float()}


def roi_backward_row(gen: torch.Generator, dev: torch.device, rois: torch.Tensor, shape,
                     dtype: torch.dtype, kw: dict, **extra) -> dict:
    """The RoIAlign backward kernel on a seeded grad_out for ``rois`` and
    features of ``shape``: against autograd of the plain version (error
    relative to the largest gradient), a second launch compared bit for bit,
    its time and bound. Emits the row and fails on either check."""
    R = rois.shape[0]
    size = torch.tensor([], dtype=dtype).element_size()
    grad_out = torch.randn(R, det.POOLING_SIZE, det.POOLING_SIZE, shape[-1], generator=gen,
                           device=dev).to(dtype)

    def kernel():
        return roi_align.roi_align_backward(grad_out, rois, shape, **kw)

    def plain():
        return roi_align.roi_align_backward_plain(grad_out, rois, shape, dtype, **kw)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    deterministic = torch.equal(got.view(bits), again.view(bits))
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    n_grad = grad_out.numel()
    kernel_ms, kernel_range = time_ms_range(kernel)
    row = {"phase": "kernel", "name": "roi_align_backward",
           "dtype": str(dtype).split(".")[-1], "features": list(shape), "rois": R, **extra,
           "max_abs_err": err, "max_grad": scale, "rel_err": err / scale,
           "tolerance_rel_to_max": ROI_BWD_TOL[dtype], "deterministic": deterministic,
           "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
           "plain_ms": time_ms(plain, 2),
           # no PyTorch call computes RoIAlign or its gradient (no torchvision)
           "library_ms": None,
           # grad_out read once, grad_features written once
           **bound(n_grad * size + rois.numel() * 4 + int(np.prod(shape)) * size,
                   ROI_BWD_OPS_PER_GRAD * n_grad, PEAK_OPS[torch.float32])}
    row["bound_ratio"] = kernel_ms / row["bound_ms"]
    emit(row)
    if not err <= ROI_BWD_TOL[dtype] * scale or not scale > 0:
        fail(f"roi_align_backward ({row['dtype']}) disagrees with autograd of the plain "
             f"version: {row}")
    if not deterministic:
        fail(f"roi_align_backward ({row['dtype']}): two launches on the same inputs differ")
    return row


def phase_detector_train_kernels(dev: torch.device) -> dict:
    """Kernel C and its backward kernel against the plain RoIAlign and its
    autograd at the training shapes (f32 and bf16), and kernel D at the
    RPN's training call (4 x 12,000, 0.7, 2,000 kept) against its plain
    version. Returns the summary row of the backward (f32)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    rois = train_rois(gen, DT_BATCH, DT_IMAGE)
    R = rois.shape[0]
    kw = dict(spatial_scale=1.0 / det.FEAT_STRIDE, pooled_height=det.POOLING_SIZE,
              pooled_width=det.POOLING_SIZE, sampling_ratio=2)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        n_feat = int(np.prod(DT_C4))
        n_out = R * det.POOLING_SIZE * det.POOLING_SIZE * DT_C4[-1]
        feats = torch.randn(DT_C4, generator=gen, device=dev).to(dtype)
        got = roi_align.roi_align(feats, rois, **kw)
        want = roi_align.roi_align_plain(feats, rois, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        atol, rtol = ROI_TOL[dtype]
        within = bool((err <= atol + rtol * want.float().abs()).all())
        kernel_ms, kernel_range = time_ms_range(lambda: roi_align.roi_align(feats, rois, **kw))
        row = {"phase": "kernel", "name": "roi_align_train", "dtype": str(dtype).split(".")[-1],
               "features": list(DT_C4), "rois": R, "max_abs_err": err.max().item(),
               "tolerance": {"atol": atol, "rtol": rtol}, "within_tolerance": within,
               "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
               "plain_ms": time_ms(lambda: roi_align.roi_align_plain(feats, rois, **kw), 2),
               "library_ms": None,
               **bound(n_feat * size + rois.numel() * 4 + n_out * size,
                       ROI_OPS_PER_OUT * n_out, PEAK_OPS[torch.float32])}
        emit(row)
        if not within:
            fail(f"roi_align ({row['dtype']}) disagrees with its plain version at the training "
                 f"shapes: {row}")
        del feats, got, want, err

        row = roi_backward_row(gen, dev, rois, DT_C4, dtype, kw)
        if dtype == torch.float32:
            out["roi_align_backward"] = row
    # on the workflow's stage-1 shapes (PR 21's 0.280-0.283 ms there)
    roi_backward_row(gen, dev, train_rois(gen, WF_C4[0], WF_IMAGE), WF_C4,
                     torch.bfloat16, kw, inputs="the workflow's stage 1 (ResNet-50, 8 images "
                     "of 384 x 512)")

    boxes, scores = seeded_nms_inputs(gen, dev, DT_BATCH, DT_PRE, True)
    got = nms.nms(boxes, scores, DT_THRESH, max_out=DT_POST, presorted=True)
    want = nms.nms_plain(boxes, scores, DT_THRESH, max_out=DT_POST, presorted=True)
    torch.cuda.synchronize()
    mismatches = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
    kernel_ms, kernel_range = time_ms_range(
        lambda: nms.nms(boxes, scores, DT_THRESH, max_out=DT_POST, presorted=True))
    words = -(-DT_PRE // 64)
    emit({"phase": "kernel", "name": "nms_rpn_train", "groups": DT_BATCH, "boxes": DT_PRE,
          "threshold": DT_THRESH, "max_out": DT_POST, "mismatches": mismatches,
          "kept_per_group": got[1].sum(dim=1).float().mean().item(),
          "bitmask_mb": DT_BATCH * DT_PRE * words * 8 / 1e6,
          "scan_smem_bytes": _build.library().ssc_nms_scan_smem_bytes(words),
          "kernel_ms": kernel_ms, "kernel_ms_range": kernel_range,
          "plain_ms": time_ms(lambda: nms.nms_plain(boxes, scores, DT_THRESH, max_out=DT_POST,
                                                    presorted=True), 1, warmup=0),
          "library_ms": None,
          **bound(boxes.numel() * 4 + DT_BATCH * (DT_POST * 4 + DT_PRE),
                  NMS_OPS_PER_PAIR * DT_BATCH * DT_PRE * (DT_PRE - 1) / 2,
                  PEAK_OPS[torch.float32]),
          "bound_note": NMS_BOUND_NOTE})
    if mismatches:
        fail(f"nms at the RPN's training call: {mismatches} entries differ from the plain "
             "version")
    return out


def detector_counts() -> dict:
    return {"roi_align": roi_align.launches, "roi_align_backward": roi_align.backward_launches,
            "nms": nms.launches}


def reset_detector_counts() -> None:
    roi_align.launches = roi_align.backward_launches = nms.launches = 0
    nms.launches_by_shape.clear()


def train_detector_row(dev, cfg, batch, bf16: bool, steps: int, timed: int, phase: str,
                       extra: dict, profiled: bool = False) -> dict:
    """``steps`` training steps of ``cfg`` on a fixed batch from a fresh
    seeded init: ms a step (the median of the last ``timed``), images/s,
    peak memory, the losses, the kernels' launches a step; with
    ``profiled``, the card's time a step, its busy share and its largest
    kernels from a profiler trace of 2 more steps (not counted)."""
    gc.collect()
    torch.cuda.empty_cache()
    params = init_detector(cfg, seed=0, device=dev)
    opt = DetectorSGD(params, lr=1e-3, momentum=0.9, weight_decay=1e-4, steps_per_epoch=100)
    step = train_detector_cli.make_train_step(cfg, opt, bf16)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_detector_counts()
    ms = timed_steps(lambda: losses.append(step(params, batch, gen)), steps)
    counts = detector_counts()
    med, rng_ = median_range(ms[-timed:])
    prof = {}
    if profiled:
        prof = profile_steps(lambda: step(params, batch, gen), 2, top=8)
        busy = prof["device_ms_per_step"]
        prof["device_busy_share"] = None if busy is None else busy / med
    total = [x["total"].item() for x in losses]
    finite = all(bool(torch.isfinite(v).all()) for x in losses for v in x.values())
    row = {"phase": phase, **extra, "dtype": "bf16" if bf16 else "f32",
           "batch": batch["images"].shape[0], "canvas": list(batch["images"].shape[1:3]),
           "steps": steps, "first_step_ms": ms[0], "step_ms": med, "step_ms_range": rng_,
           "images_per_s": batch["images"].shape[0] / med * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first": total[0], "loss_last": total[-1], "losses_finite": finite,
           "last_losses": {k: v.item() for k, v in losses[-1].items()},
           "launches_per_step": {k: v / steps for k, v in counts.items()}, **prof}
    emit(row)
    if not finite:
        fail(f"{phase}: a loss is not finite: {total}")
    del params, opt, step
    return row


def phase_detector_train(dev: torch.device) -> dict:
    """The training step at full width (ResNet-101, 81 classes, 196
    attributes, 4 images on 640 x 1024, 12,000 / 2,000, 128 RoIs), f32 with
    TF32 off, then bf16 compute; each step must launch C, its backward and
    D once. Returns the launches."""
    cfg = train_detector_cfg()
    batch = train_detector_batch(dev, DT_BATCH, DT_CANVAS, DT_IMAGE, DT_ATTS, seed=5)
    launches = {"roi_align": 0, "roi_align_backward": 0, "nms_rpn": 0}
    for bf16 in (False, True):
        row = train_detector_row(dev, cfg, batch, bf16, DT_STEPS, DT_TIMED, "detector_train",
                                 {"depth": DET_DEPTH, "classes": DT_CLASSES,
                                  "attributes": DT_ATTS, "rpn": [DT_PRE, DT_POST],
                                  "rois_per_image": DT_ROIS}, profiled=True)
        per_step = row["launches_per_step"]
        if per_step != {"roi_align": 1.0, "roi_align_backward": 1.0, "nms": 1.0}:
            fail(f"detector_train: launches a step {per_step}, expected one of C, its "
                 "backward and D")
        launches["roi_align"] += DT_STEPS
        launches["roi_align_backward"] += DT_STEPS
        launches["nms_rpn"] += DT_STEPS
    return launches


def phase_train_detector_cli(dev: torch.device) -> dict:
    """The train CLI (``python -m style_seqcvae_tpu_torch.scripts.train_detector``)
    on 8 JPEG fixtures (ResNet-101, 2 images a step, one epoch), then the
    extract CLI from its checkpoint with --detections-output, then
    eval_detections with --vis-dir (nvjpeg decodes, every box drawn), each
    PNG held to the port's drawing of that image's nvjpeg pixels. Returns
    the launches."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        inst_all, image_root, attribs = write_extract_world(root / "world")
        data = json.loads(Path(inst_all).read_text())
        keep = [im for im in data["images"] if im["file_name"].endswith(".jpg")][:DT_CLI_IMAGES]
        ids = {im["id"] for im in keep}
        data.update(images=keep, annotations=[a for a in data["annotations"]
                                              if a["image_id"] in ids])
        inst = root / "instances_train.json"
        inst.write_text(json.dumps(data))
        ser = root / "det"
        reset_detector_counts()
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = train_detector_cli.main([
                "--instances-json", str(inst), "--image-root", image_root,
                "--attribs-dir", attribs, "--serialization-dir", str(ser), "--epochs", "1",
                "--ims-per-batch", str(DT_CLI_IMS), "--depth", str(DET_DEPTH),
                "--config-override", "DET.TRAIN.DISPLAY", "1"], stats=stats)
        wall = time.perf_counter() - t0
        train_counts = detector_counts()
        rows = [json.loads(line) for line in (ser / "metrics.jsonl").read_text().splitlines()]
        steps = DT_CLI_IMAGES // DT_CLI_IMS
        finite = all(np.isfinite(r["total"]) for r in rows)

        reset_detector_counts()
        dets = root / "dets.json"
        with contextlib.redirect_stdout(printed):
            xrc = extract_cli.main([
                "--instances-json", str(inst), "--image-root", image_root,
                "--attribs-dir", attribs, "--checkpoint-path", str(ser / "detector_epoch_1"),
                "--output", str(root / "f.h5"), "--detections-output", str(dets),
                "--batch-size", str(DT_CLI_IMAGES), "--depth", str(DET_DEPTH),
                "--thresh", "0.0"])
            result = {}
            vis = root / "vis"
            erc = eval_detections_cli.main([
                "--detections", str(dets), "--instances-json", str(inst), "--vis-dir", str(vis),
                "--image-root", image_root, "--vis-thresh", "0.0"], stats=result)
        extract_counts = detector_counts()
        drawn = check_drawn_detections(dev, json.loads(dets.read_text()), data, image_root, vis)
        emit({"phase": "train_detector_cli", "rc": rc, "images": DT_CLI_IMAGES,
              "ims_per_batch": DT_CLI_IMS, "steps": stats["steps"], "wall_s": wall,
              "step_ms": stats["step_ms"], "data_ms": stats["data_ms"],
              "load_s": stats["load_s"], "metrics_rows": len(rows), "losses_finite": finite,
              "total_first": rows[0]["total"] if rows else None,
              "total_last": rows[-1]["total"] if rows else None,
              "train_launches": train_counts, "extract_rc": xrc, "eval_rc": erc,
              "extract_launches": extract_counts,
              "detections": len(json.loads(dets.read_text())),
              "mAP": result.get("mAP"), "AP50": result.get("AP50"),
              "AP75": result.get("AP75"), "vis_written": result.get("vis_written"),
              "vis_missing": result.get("vis_missing"), **drawn,
              **{f"vis_{k[:-2]}_ms_an_image": 1e3 * result[k] / max(result["vis_written"], 1)
                 for k in ("decode_s", "draw_s", "encode_s") if k in result},
              "note": "4 steps from a random init: a near-zero mAP is expected"})
        want_train = {"roi_align": steps, "roi_align_backward": steps, "nms": steps}
        if rc != 0 or xrc != 0 or erc != 0 or stats["steps"] != steps or not finite \
                or len(rows) != steps:
            fail(f"train_detector_cli: rc {rc}, extract rc {xrc}, eval rc {erc}, "
                 f"{stats['steps']} steps, {len(rows)} metric rows, finite {finite}")
        if train_counts != want_train:
            fail(f"train_detector_cli launches {train_counts}, expected {want_train}")
        if extract_counts != {"roi_align": 1, "roi_align_backward": 0, "nms": 1}:
            fail(f"train_detector_cli: the extract run's launches {extract_counts}")
        if drawn["vis_problems"]:
            fail(f"train_detector_cli: drawing the detections: {drawn['vis_problems']}")
    return {"roi_align": steps + 1, "roi_align_backward": steps, "nms_rpn": steps + 1}


def check_drawn_detections(dev: torch.device, dets: list, instances: dict, image_root: str,
                           vis: Path) -> dict:
    """Hold ``eval_detections --vis-dir``'s PNGs (decoded by the port) to
    ``vis_image_detections`` of each image's nvjpeg pixels at threshold 0:
    one PNG per image with detections, equal to the pixel, and at least one
    box drawn on each. Returns counts and the problems found."""
    ids = {c["id"]: c["name"] for c in instances["categories"]}
    names = [ids.get(i, str(i)) for i in range(max(ids) + 1)]
    files = {im["id"]: im["file_name"] for im in instances["images"]}
    by_image = {}
    for d in dets:
        by_image.setdefault(d["image_id"], []).append(d)
    pngs = sorted(p.name for p in vis.iterdir()) if vis.is_dir() else []
    problems = []
    if pngs != sorted(f"{i}.png" for i in by_image):
        problems.append(f"PNGs {pngs} for the images {sorted(by_image)}")
    equal = above = 0
    for image_id, img_dets in sorted(by_image.items()):
        path = vis / f"{image_id}.png"
        if not path.is_file():
            continue
        data = (Path(image_root) / files[image_id]).read_bytes()
        if image_decode.sniff_format(data) != "JPEG":
            problems.append(f"{files[image_id]} is not a JPEG")
        rgb = image_decode.decode_image_bgr(data, dev).flip(-1).to(torch.uint8).cpu().numpy()
        boxes = np.asarray([[d["bbox"][0], d["bbox"][1], d["bbox"][0] + d["bbox"][2],
                             d["bbox"][1] + d["bbox"][3]] for d in img_dets], np.float32)
        scores = np.asarray([d["score"] for d in img_dets], np.float32)
        labels = np.asarray([d["category_id"] for d in img_dets])
        want = vis_image_detections(rgb, boxes, scores, labels, names, thresh=0.0)
        got = image_decode.decode_image_bgr(path.read_bytes(), "cpu").flip(-1).to(
            torch.uint8).numpy()
        equal += int(np.array_equal(got, want))
        above += int((scores > 0).sum())
        if not np.array_equal(got, want):
            problems.append(f"{path.name}: {int((got != want).any(-1).sum())} pixels differ")
        if np.array_equal(got, rgb):
            problems.append(f"{path.name}: nothing drawn")
    return {"vis_images_with_detections": len(by_image), "vis_png_equal": equal,
            "vis_detections_above_0": above, "vis_problems": problems}


def phase_detector_variants(dev: torch.device) -> dict:
    """VGG16 (no attribute head) with align, pool and crop: one inference
    forward at config 5's canvas on 2 images, and 2 training steps. Returns
    the launches (align only runs kernel C and its backward)."""
    launches = {"roi_align": 0, "roi_align_backward": 0, "nms_rpn": 0, "nms_per_class": 0}
    batch = train_detector_batch(dev, VARIANT_BATCH, CANVAS, IM_INFO[:2], 0, seed=7)
    for mode in ("align", "pool", "crop"):
        cfg = train_detector_cfg("vgg16", mode, num_att_classes=0)
        gc.collect()
        torch.cuda.empty_cache()
        params = init_detector(cfg, seed=0, device=dev)
        im_info = batch["im_info"]
        with torch.inference_mode():
            detector_forward_test(params, cfg, batch["images"], im_info)      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_detector_counts()
            t0 = time.perf_counter()
            out = detector_forward_test(params, cfg, batch["images"], im_info)
            torch.cuda.synchronize()
            infer_ms = (time.perf_counter() - t0) * 1e3
        infer_counts = detector_counts()
        finite = bool(torch.isfinite(out["pooled_feat"].float()).all())
        emit({"phase": "detector_variants_infer", "backbone": "vgg16", "pooling_mode": mode,
              "batch": VARIANT_BATCH, "canvas": list(CANVAS), "ms": infer_ms,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "pooled_feat": list(out["pooled_feat"].shape), "finite": finite,
              "launches": infer_counts})
        if not finite or out["pooled_feat"].shape[-1] != 4096:
            fail(f"detector_variants: the vgg16 {mode} forward is bad")
        want = {"roi_align": int(mode == "align"), "roi_align_backward": 0, "nms": 1}
        if infer_counts != want:
            fail(f"detector_variants: vgg16 {mode} forward launches {infer_counts}, "
                 f"expected {want}")
        del params, out
        row = train_detector_row(dev, cfg, batch, False, VARIANT_TRAIN_STEPS,
                                 VARIANT_TRAIN_STEPS, "detector_variants_train",
                                 {"backbone": "vgg16", "pooling_mode": mode})
        align = float(mode == "align")
        want = {"roi_align": align, "roi_align_backward": align, "nms": 1.0}
        if row["launches_per_step"] != want:
            fail(f"detector_variants: vgg16 {mode} training launches "
                 f"{row['launches_per_step']}, expected {want}")
        launches["roi_align"] += infer_counts["roi_align"] + int(align) * VARIANT_TRAIN_STEPS
        launches["roi_align_backward"] += int(align) * VARIANT_TRAIN_STEPS
        launches["nms_rpn"] += 1 + VARIANT_TRAIN_STEPS
    return launches


# data parallelism (ROADMAP A10) on the one card: config 3's decode grid
# split over the card listed twice, and two ranks sharing the card over gloo
# (NCCL refuses two ranks on one GPU), each held to one process on the whole
# batch; then the train CLI as a one-rank NCCL group. Single-card numbers:
# no scaling is measured or implied.
SPLIT_SEED = 11
# the search step (1 .. STEPS - 1) whose kernel inputs each chunk's check reads
SPLIT_PROBE_STEP = 10
# How far the split may move from the unsplit decode, each bound set from
# readings at seeds 11-16 with both selections (PERF.md, section 6), and each
# broken by the control (the split fed its chunks' noise swapped): in f32 at
# least SPLIT_F32_IDENTICAL of the captions identical, their log-probs
# within rtol 1e-5 (sound 0.994-1.0 identical, within 7.4e-7; control 0.0);
# in bf16, where most captions flip, the median per-caption |best log-prob
# difference| at most SPLIT_BF16_MEDIAN_LP_ATOL nats (sound 0.39-0.75,
# control 1.45-1.67; the largest differences overlap: sound up to 6.7,
# control 6.3-11.3, so no per-caption bound separates them)
SPLIT_F32_IDENTICAL = 0.98
SPLIT_BF16_MEDIAN_LP_ATOL = 1.0
DDP_TIMEOUT = 300.0
DDP_CAPTIONER_RTOL = 1e-5
DDP_DETECTOR_RTOL = 1e-3
NCCL_ITERS = 4
# tensor parallelism (ROADMAP A10.2) on the one card: config 2's widths as
# (num_data, num_model, global rows) meshes of ranks sharing the card over
# gloo, each held to one process on the same rows; TP_STEPS steps with the
# clip at TP_CLIP (the pre-clip norms read 34-44) and the decoder LSTM
# training at step 2. TP_RTOL bounds the metrics' and the leaves' relative
# error, set from the first readings (``--tp-readings``, PERF.md section 6:
# metrics 0 at 1 x 2 and within 6.7e-8 at 2 x 2, leaves within 2.8e-8);
# the leaves held whole over the model axis must be bit-equal across each
# model group.
TP_MESHES = ((1, 2, 150), (2, 2, 100))
TP_STEPS = 2
TP_CLIP = "1.0"
TP_RTOL = 1e-5


@contextlib.contextmanager
def chunk_kernel_inputs(step: int):
    """A spy around the search's calls of A and B: yields, per kernel, a
    copy of the arguments of each chunk's call at search step ``step``
    (STEPS - 1 calls a chunk, the chunks in turn); the kernels still run."""
    real = {"vocab_topk_lse": cbs_fast.matmul_top_k_with_lse,
            "topk_lse": cbs_fast.top_k_with_lse}
    got = {name: [] for name in real}
    seen = dict.fromkeys(real, 0)

    def spy(name):
        def call(*args):
            if seen[name] % (STEPS - 1) == step - 1:
                got[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            seen[name] += 1
            return real[name](*args)
        return call

    cbs_fast.matmul_top_k_with_lse = spy("vocab_topk_lse")
    cbs_fast.top_k_with_lse = spy("topk_lse")
    try:
        yield got
    finally:
        cbs_fast.matmul_top_k_with_lse = real["vocab_topk_lse"]
        cbs_fast.top_k_with_lse = real["topk_lse"]


def lp_diff_quantiles(lp: torch.Tensor, lp0: torch.Tensor) -> dict:
    """Quantiles of the per-caption |best log-prob difference| in nats."""
    d = (lp.float() - lp0.float()).abs().flatten()
    qs = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99, 1.0], device=d.device)).tolist()
    return dict(zip(("p50", "p90", "p99", "max"), qs))


def split_reading(dtype: str, best, lp, best0, lp0) -> dict:
    """A split decode's (best, lp) against the unsplit (best0, lp0): the
    identical share, the log-probs' largest relative difference where the
    captions are identical, the quantiles of the per-caption difference, and
    whether the dtype's gate holds."""
    same = (best == best0).all(dim=-1)
    share = same.float().mean().item()
    rel = (lp - lp0).abs() / lp0.abs().clamp_min(1.0)
    lp_err = rel[same].max().item() if same.any() else None
    diffs = lp_diff_quantiles(lp, lp0)
    if dtype == "f32":
        ok = share >= SPLIT_F32_IDENTICAL and lp_err is not None and lp_err <= 1e-5
    else:
        ok = diffs["p50"] <= SPLIT_BF16_MEDIAN_LP_ATOL
    return {"identical_captions": share, "lp_max_rel_err_identical": lp_err,
            "lp_abs_diff": diffs, "gate_holds": ok}


def phase_decode_split(dev: torch.device, decode_state, seed: int = SPLIT_SEED) -> dict:
    """Config 3's CBS decode through prehead and fused on a mesh of the card
    listed twice: z splits 2 x 10, the chunks run in turn in the card's
    worker thread. Held three ways:

    * each chunk, exactly: the split decode must equal, bit for bit, the
      unsplit harness run on each chunk's z slice of the same noise (the
      same shapes through the same kernels), so a chunk fed another chunk's
      noise, rows or tables fails; a one-device mesh (one chunk of the whole
      grid) must equal the unsplit decode exactly;
    * each kernel at the chunk's shape: A or B on the 6,400 rows of each
      chunk's call at search step SPLIT_PROBE_STEP, against its plain
      version under TOL;
    * against the unsplit decode: a chunk's GEMMs have half the rows, and
      cuBLAS picks its kernels by shape, so near ties of the random-weight
      model's flat distributions flip. In f32 at least SPLIT_F32_IDENTICAL
      of the captions must be identical, their log-probs within rtol 1e-5;
      in bf16 the median per-caption |best log-prob difference| at most
      SPLIT_BF16_MEDIAN_LP_ATOL; a control (the split fed its chunks'
      noise swapped) must fail its dtype's gate.

    A or B launch STEPS - 1 times a chunk. The counters are reset before
    each decode's first run and read after its second (timed) one. Returns
    the launches of every split, one-chunk and unsplit run."""
    harness, sentiment, tables = decode_state
    cfg = harness.cfg
    feats, _, _ = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    mesh = make_mesh(2, 1, [dev, dev])
    half = N_Z // 2
    halves = [slice(0, half), slice(half, N_Z)]
    kernel_of = {"prehead": "vocab_topk_lse", "fused": "topk_lse"}
    launches = {kname: 0 for kname in kernel_of.values()}
    for dtype, plain in (("bf16", harness),
                         ("f32", DecodeHarness(init_captioner(cfg, seed=0, device=dev), cfg,
                                               device=dev))):
        split = DecodeHarness(plain.params, cfg, mesh=mesh)
        whole = DecodeHarness(plain.params, cfg, mesh=make_mesh(1, 1, [dev]))
        # the noise the split draws from the seeded generator (the unsplit order)
        noise = split._drawn_noise(torch.Generator(device=dev).manual_seed(seed), N_Z,
                                   BATCH, (1, 1), (tables.default_dest.shape[2], BEAM),
                                   torch.float32)[0]
        swapped = torch.cat([noise[halves[1]], noise[halves[0]]])
        for selection, kernel in kernel_of.items():
            def decode(h, src=None, tbl=tables, n_z=N_Z):
                if src is None:
                    src = torch.Generator(device=dev).manual_seed(seed)
                return h.decode_cbs(feats, sentiment, None, tbl, N_CONSTRAINTS, src, n_z,
                                    selection=selection)

            out, probe = {}, {}
            for name, h, chunks in (("unsplit", plain, 1), ("split", split, 2),
                                    ("one_chunk", whole, 1)):
                reset_selection_counts()
                spy = (chunk_kernel_inputs(SPLIT_PROBE_STEP) if name == "split"
                       else contextlib.nullcontext({}))
                with spy as got:
                    best, lp = decode(h)
                probe.update(got)
                torch.cuda.synchronize()
                t0 = time.time()
                decode(h)
                torch.cuda.synchronize()
                seconds = time.time() - t0
                n = selection_counts()[kernel]
                launches[kernel] += n
                out[name] = (best, lp, n, seconds, 2 * chunks * (STEPS - 1))
            (b0, lp0, _, s0, _), (b1, lp1, _, s1, _) = out["unsplit"], out["split"]
            b2, lp2 = out["one_chunk"][:2]
            # not counted: the references and the control
            refs = [decode(plain, noise[zs], FSMTables(*[t[zs] for t in tables]), half)
                    for zs in halves]
            chunks_exact = bool(torch.equal(torch.cat([r[0] for r in refs]), b1)
                                and torch.equal(torch.cat([r[1] for r in refs]), lp1))
            one_chunk_exact = bool(torch.equal(b2, b0) and torch.equal(lp2, lp0))
            reading = split_reading(dtype, b1, lp1, b0, lp0)
            control = split_reading(dtype, *decode(split, swapped), b0, lp0)
            emit({"phase": "multigpu", "part": "decode_split", "dtype": dtype,
                  "selection": selection, "mesh": [str(d) for d in mesh.devices],
                  "split": [half, N_Z - half], "chunks_exact": chunks_exact,
                  "one_chunk_exact": one_chunk_exact, **reading,
                  "mean_best_lp": [lp0.mean().item(), lp1.mean().item()],
                  "control": control,
                  "gate": ({"identical_min": SPLIT_F32_IDENTICAL, "lp_rtol": 1e-5}
                           if dtype == "f32" else {"p50_atol": SPLIT_BF16_MEDIAN_LP_ATOL}),
                  "launches": {name: o[2] for name, o in out.items()},
                  "launches_expected": {name: o[4] for name, o in out.items()},
                  "unsplit_s": s0, "split_s": s1, "split_captions_per_s": BATCH * N_Z / s1,
                  "unsplit_captions_per_s": BATCH * N_Z / s0,
                  "note": "one card listed twice: the chunks run in turn; no scaling"})
            if not chunks_exact:
                fail(f"decode_split ({dtype}, {selection}): the split differs from the "
                     f"unsplit harness on each chunk's z slice of the same noise")
            if not one_chunk_exact:
                fail(f"decode_split ({dtype}, {selection}): a one-chunk split differs from "
                     f"the unsplit decode")
            if not reading["gate_holds"] or control["gate_holds"]:
                fail(f"decode_split ({dtype}, {selection}): the split {reading} and the "
                     f"control {control} against the unsplit decode")
            wrong = {name: (o[2], o[4]) for name, o in out.items() if o[2] != o[4]}
            if wrong:
                fail(f"decode_split ({dtype}, {selection}): {kernel} launches "
                     f"(counted, expected) {wrong}")
            # each kernel on its chunks' own inputs at the probed step
            if len(probe[kernel]) != 2:
                fail(f"decode_split ({dtype}, {selection}): {len(probe[kernel])} chunk "
                     f"inputs of {kernel} caught, expected 2")
            for i, args in enumerate(probe[kernel]):
                case = (vocab_case(args[0], args[1], args[2]) if kernel == "vocab_topk_lse"
                        else topk_case(args[0], args[1]))
                rows = args[0].shape[0]
                if rows != BATCH * half * STATES * BEAM:
                    fail(f"decode_split: chunk {i}'s {kernel} input has {rows} rows")
                kernel_row(kernel, case, args[0].dtype,
                           {"rows": rows, "vocab": V, "k": args[-1],
                            "width": args[0].shape[1] if kernel == "vocab_topk_lse" else None,
                            "part": "decode_split_chunk", "chunk": i,
                            "search_step": SPLIT_PROBE_STEP, "selection": selection})
            probe.clear()
    return launches


def ddp_rows(ranks: list, key: str) -> None:
    """Two ranks, agreeing on the global ``key``."""
    for r in ranks:
        if r["process_count"] != 2 or r[key] != ranks[0][key]:
            fail(f"ddp: the ranks disagree on {key} or are not two: {ranks}")


def phase_ddp_captioner(dev: torch.device) -> dict:
    """Config 2's widths, a global batch of 150 (75 a rank), f32, 3 steps:
    two ranks on the card over gloo against one process on the 150 rows
    (the same init, batch and z-noise: each rank keeps its rows of the
    global draw): loss and the params' squared norm within
    DDP_CAPTIONER_RTOL; ms a step per rank and the gradient sum's ms."""
    spec = dworker.captioner_spec("full")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = dworker.launch_two_process_run({"captioner": spec}, device=str(dev),
                                           backend="gloo", timeout=DDP_TIMEOUT)
    launch_s = time.time() - t0
    one = dworker.run_payloads({"captioner": spec}, dev)
    ranks, one = [dict(r, **r["captioner"]) for r in ranks], dict(one, **one["captioner"])
    ddp_rows(ranks, "metrics")
    loss_err = max(abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in ranks)
    norm_err = abs(ranks[0]["param_norm_sq"] - one["param_norm_sq"]) / one["param_norm_sq"]
    emit({"phase": "multigpu", "part": "ddp_captioner", "backend": "gloo",
          "devices": [r["device"] for r in ranks], "global_batch": spec["batch"],
          "per_rank": spec["batch"] // 2, "steps": spec["steps"],
          "losses_ranks": [m["loss"] for m in ranks[0]["metrics"]],
          "losses_one": [m["loss"] for m in one["metrics"]], "loss_rel_err": loss_err,
          "param_norm_sq_rel_err": norm_err, "rtol": DDP_CAPTIONER_RTOL,
          "step_ms_ranks": [r["step_ms"] for r in ranks], "step_ms_one": one["step_ms"],
          "allreduce_ms_ranks": [r["allreduce_ms"] for r in ranks],
          "launch_wall_s": launch_s, "launches_ranks": [r["launches"] for r in ranks],
          "note": "two ranks share one card: no scaling"})
    if loss_err > DDP_CAPTIONER_RTOL or norm_err > DDP_CAPTIONER_RTOL:
        fail(f"ddp_captioner: two ranks off one process by {loss_err:.3g} (loss), "
             f"{norm_err:.3g} (params)")
    if any(any(r["launches"].values()) for r in ranks):
        fail(f"ddp_captioner: a kernel ran in a training step: {ranks[0]['launches']}")
    return {}


def phase_ddp_detector(dev: torch.device) -> dict:
    """ResNet-101 (81 classes, 196 attributes, the DET defaults), 2 steps at
    2 + 2 images on 640 x 1024, f32: two ranks on the card over gloo
    against one process on the 4 images with the same draws; every loss of
    every step within DDP_DETECTOR_RTOL (the backward's f32 atomics are
    unordered, and the backbone's convolutions at 2 and 4 images may sum in
    other orders); C, its backward and D launch once a step on each rank
    and in the one process. Returns the launches that the ranks report and
    the one process's, as counted."""
    spec = dworker.detector_spec("full")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = dworker.launch_two_process_run({"detector": spec}, device=str(dev),
                                           backend="gloo", timeout=DDP_TIMEOUT)
    launch_s = time.time() - t0
    reset_kernel_counts()
    reset_detector_counts()
    one = dworker.run_payloads({"detector": spec}, dev)
    ranks, one = [dict(r, **r["detector"]) for r in ranks], dict(one, **one["detector"])
    ddp_rows(ranks, "det_losses")
    errs = {name: max(abs(r["det_losses"][s][name] - one["det_losses"][s][name])
                      / max(abs(one["det_losses"][s][name]), 1e-6)
                      for r in ranks for s in range(spec["steps"]))
            for name in one["det_losses"][0]}
    want = {"roi_align": spec["steps"], "roi_align_backward": spec["steps"],
            "nms": spec["steps"], "vocab_topk_lse": 0, "topk_lse": 0}
    emit({"phase": "multigpu", "part": "ddp_detector", "backend": "gloo",
          "devices": [r["device"] for r in ranks], "images": [2, 2],
          "canvas": spec["image_hw"], "steps": spec["steps"],
          "losses_ranks": ranks[0]["det_losses"], "losses_one": one["det_losses"],
          "loss_rel_err": errs, "rtol": DDP_DETECTOR_RTOL,
          "step_ms_ranks": [r["det_step_ms"] for r in ranks], "step_ms_one": one["det_step_ms"],
          "launches_ranks": [r["launches"] for r in ranks], "launches_one": one["launches"],
          "launch_wall_s": launch_s, "note": "two ranks share one card: no scaling"})
    if max(errs.values()) > DDP_DETECTOR_RTOL:
        fail(f"ddp_detector: two ranks off one process: {errs}")
    for r in ranks + [one]:
        if r["launches"] != want:
            fail(f"ddp_detector: launches {r['launches']}, expected {want} a process")
    runs = ranks + [one]
    return {"roi_align": sum(r["launches"]["roi_align"] for r in runs),
            "roi_align_backward": sum(r["launches"]["roi_align_backward"] for r in runs),
            "nms_rpn": sum(r["launches"]["nms"] for r in runs)}


def phase_nccl_world1(dev: torch.device) -> None:
    """The train CLI (config 2's published widths, train_cli's world) as a
    one-rank NCCL process group under SSC_COORDINATOR, a subprocess: its
    losses must equal the plain run's, step for step."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cfg = write_train_cli_world(root / "world")
        plain = train_cli_run(cfg, root / "plain", ["--max-iterations", str(NCCL_ITERS)],
                              every=NCCL_ITERS)
        env = dict(os.environ, SSC_COORDINATOR=f"localhost:{free_port()}",
                   SSC_NUM_PROCESSES="1", SSC_PROCESS_ID="0")
        t0 = time.time()
        res = subprocess.run([sys.executable, "-m", "style_seqcvae_tpu_torch.scripts.train",
                              "--config", str(cfg), "--serialization-dir", str(root / "nccl"),
                              "--checkpoint-every", str(NCCL_ITERS),
                              "--max-iterations", str(NCCL_ITERS)],
                             env=env, capture_output=True, text=True, timeout=DDP_TIMEOUT)
        wall = time.time() - t0
        losses = {name: [json.loads(line)["loss"] for line in
                         (root / name / "metrics.jsonl").read_text().splitlines()]
                  for name in ("plain", "nccl") if (root / name / "metrics.jsonl").exists()}
        emit({"phase": "multigpu", "part": "nccl_world1", "backend": "nccl",
              "iterations": NCCL_ITERS, "rc": res.returncode, "losses": losses,
              "plain_wall_s": plain["wall_s"], "nccl_wall_s": wall})
        if res.returncode != 0:
            fail(f"nccl_world1: the train CLI failed:\n{res.stdout[-2000:]}{res.stderr[-2000:]}")
        if losses.get("nccl") != losses.get("plain") or len(losses["plain"]) != NCCL_ITERS:
            fail(f"nccl_world1: losses differ from the plain run: {losses}")


def leaf_rel_errs(got: Path, want: Path) -> dict:
    """Per leaf of two ``.npz`` trees: ‖got - want‖ / ‖want‖."""
    a, b = dict(np.load(got)), dict(np.load(want))
    if a.keys() != b.keys():
        fail(f"the leaves differ: {sorted(set(a) ^ set(b))}")
    return {k: float(np.linalg.norm(a[k] - b[k]) / max(np.linalg.norm(b[k]), 1e-12))
            for k in b}


def phase_tp(dev: torch.device) -> None:
    """Tensor parallelism at config 2's widths (V 10,500, E 600 tied, H 900,
    P 768, z 150, F 2,048, 100 boxes, 20 tokens), f32 with TF32 off: each
    mesh of TP_MESHES as ranks sharing the card over gloo, TP_STEPS steps,
    against one process on the same rows and init: every step's metrics and
    pre-clip norm, and every leaf (gathered whole), within TP_RTOL; the
    leaves held whole over the model axis bit-equal across each model
    group; no kernel launched. Prints ms a step per rank, ms of the step's
    tensor-parallel collectives per rank (CUDA events around each), their
    count, and the peak memory per rank against one process's."""
    overrides = ["OPTIM.NUM_ITERATIONS", "100", "OPTIM.CLIP_GRADIENTS", TP_CLIP,
                 "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        for n_data, n_model, rows in TP_MESHES:
            n = n_data * n_model
            spec = dworker.captioner_spec("full", batch=rows, steps=TP_STEPS,
                                          num_model=n_model, overrides=overrides,
                                          save=str(Path(tmp) / "ranks.npz"))
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.time()
            ranks = dworker.launch_ranks(n, {"tp": spec}, device=str(dev), backend="gloo",
                                         timeout=DDP_TIMEOUT)
            launch_s = time.time() - t0
            # this process's counters hold the earlier phases' launches
            before = dworker.kernel_launches()
            one = dworker.run_payloads({"tp": dict(spec, num_model=1,
                                                   save=str(Path(tmp) / "one.npz"))}, dev)
            launches = [r["launches"] for r in ranks] + [
                {k: n - before[k] for k, n in one["launches"].items()}]
            ranks, one = [r["tp"] for r in ranks], one["tp"]
            metric_err = {k: max(abs(r["metrics"][s][k] - one["metrics"][s][k])
                                 / abs(one["metrics"][s][k])
                                 for r in ranks for s in range(TP_STEPS))
                          for k in ("loss", "reconstr_loss", "kld_loss", "grad_norm")}
            leaf_err = leaf_rel_errs(Path(tmp) / "ranks.npz", Path(tmp) / "one.npz")
            worst = max(leaf_err, key=leaf_err.get)
            mismatches = sorted({p for r in ranks for p in r["replicated_mismatches"]})
            emit({"phase": "multigpu", "part": "tp", "backend": "gloo", "mesh": [n_data, n_model],
                  "devices": str(dev), "global_batch": rows, "steps": TP_STEPS,
                  "losses_ranks": [m["loss"] for m in ranks[0]["metrics"]],
                  "losses_one": [m["loss"] for m in one["metrics"]],
                  "grad_norms": [m["grad_norm"] for m in one["metrics"]], "clip": TP_CLIP,
                  "metric_rel_err": metric_err, "leaf_rel_err_max": leaf_err[worst],
                  "leaf_worst": worst, "rtol": TP_RTOL, "replicated_mismatches": mismatches,
                  "step_ms_ranks": [r["step_ms"] for r in ranks], "step_ms_one": one["step_ms"],
                  "collective_ms_ranks": [r["collective_ms"] for r in ranks],
                  "collectives_a_step": ranks[0]["collectives"][-1],
                  "peak_mem_mib_ranks": [r["peak_mem_bytes"] / 2 ** 20 for r in ranks],
                  "peak_mem_mib_one": one["peak_mem_bytes"] / 2 ** 20,
                  "launch_wall_s": launch_s, "note": "ranks share one card: no scaling"})
            if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
                fail(f"tp {n_data}x{n_model}: the ranks disagree on the global metrics")
            if max(metric_err.values()) > TP_RTOL or leaf_err[worst] > TP_RTOL:
                fail(f"tp {n_data}x{n_model}: off one process by {metric_err} (metrics), "
                     f"{leaf_err[worst]:.3g} ({worst})")
            if mismatches:
                fail(f"tp {n_data}x{n_model}: replicated leaves differ across a model group: "
                     f"{mismatches}")
            if any(any(c.values()) for c in launches):
                fail(f"tp {n_data}x{n_model}: a kernel ran in a training step: {launches}")


def phase_multigpu(dev: torch.device, decode_state) -> dict:
    """``decode_split``, ``ddp_captioner``, ``ddp_detector``, ``nccl_world1``
    and ``tp``; returns the launches of the split decodes and the
    detector's ranks."""
    launches = phase_decode_split(dev, decode_state)
    phase_ddp_captioner(dev)
    launches.update(phase_ddp_detector(dev))
    phase_nccl_world1(dev)
    phase_tp(dev)
    return launches


def render_world_on_card(out: Path, world: dict) -> dict:
    """make_world as a user runs it, the images JPEG-encoded on the card:
    its stats (images, host render seconds, encode seconds), after one
    encode of a blank image (``encode_first_ms``: the library's load and
    the encoder's set-up), so that ``encode_s`` is the steady state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_jpeg(torch.zeros((384, 512, 3), dtype=torch.uint8, device="cuda"))
    stats = {"encode_first_ms": 1e3 * (time.perf_counter() - t0)}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = make_world_cli.main(["--out-dir", str(out), "--num-train", str(world["train"]),
                                  "--num-val", str(world["val"]), "--num-test",
                                  str(world["test"]), "--senticap-train",
                                  str(world["senticap"]), "--seed", str(world["seed"])],
                                 stats=stats)
    if rc != 0:
        fail(f"make_world exited {rc}: {printed.getvalue()[-2000:]}")
    return stats


def jpeg_roundtrip(world_dir: Path, world: dict, dev: torch.device, limit: int) -> dict:
    """The first ``limit`` images (make_world's order: train, val, test)
    decoded back by nvjpeg against the pixels re-rendered from the same
    RandomState stream."""
    rng = np.random.RandomState(world["seed"])
    files = [im["file_name"] for split in ("train", "val", "test") for im in json.loads(
        (world_dir / f"instances_{split}.json").read_text())["images"]][:limit]
    means, maxes, sizes = [], [], []
    for name in files:
        img, _ = make_world_cli.render_image(rng, 384, 512, make_world_cli.sample_scene(
            rng, 384, 512))
        data = (world_dir / "images" / name).read_bytes()
        got = image_decode.decode_jpeg(data, dev).cpu().numpy()[:, :, ::-1]
        diff = np.abs(got.astype(np.float32) - img.astype(np.float32))
        means.append(float(diff.mean()))
        maxes.append(float(diff.max()))
        sizes.append(len(data))
    return {"images": len(files), "mean_abs_err": float(np.mean(means)),
            "worst_image_mean_abs_err": max(means), "max_abs_err": max(maxes),
            "mean_bytes": float(np.mean(sizes)), "bound": NVJPEG_ROUNDTRIP_BOUND}


def run_three_stage(world_dir: Path, run_dir: Path, knobs: dict, log: Path,
                    inputs: Path) -> dict:
    """scripts/three_stage.py over every stage, each CLI a subprocess on the
    card that saves each kernel's inputs at its first launch under
    ``inputs/<step>/``; its output goes to ``log``. Returns its stats
    (``RUN/three_stage.json``) and its exit code."""
    printed = io.StringIO()
    os.environ[KERNEL_INPUTS_ENV] = str(inputs)
    try:
        with contextlib.redirect_stdout(printed):
            rc = three_stage_cli.main(["--world", str(world_dir), "--run", str(run_dir),
                                       "--det-epochs", str(knobs["det_epochs"]),
                                       "--cap-iters", str(knobs["cap_iters"]),
                                       "--map-gate", str(knobs["map_gate"])])
    finally:
        del os.environ[KERNEL_INPUTS_ENV]
    log.write_text(printed.getvalue())
    summary = run_dir / "three_stage.json"
    stats = json.loads(summary.read_text()) if summary.exists() else {"stages": {}}
    stats["rc"] = rc
    return stats


def check_recorded(name: str, args: dict, dev: torch.device) -> dict:
    """Kernel ``name`` on the inputs a workflow process gave it at its first
    launch (``ops/kernels::record_inputs``), against its plain version on
    the card under the kernel phases' tolerances: TOL for A, ROI_TOL for C,
    ROI_BWD_TOL for C's backward, no mismatch for D. Its row, with
    ``ok`` and the kernel's ms on these inputs."""
    a = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    row = {"phase": "pipeline_kernel", "name": name}
    if name == "vocab_topk_lse":
        row.update(x=list(a["x"].shape), emb=list(a["emb"].shape), k=a["k"],
                   dtype=str(a["x"].dtype).split(".")[-1])

        def run():
            return vocab_topk_lse.matmul_top_k_with_lse(a["x"], a["emb"], a["k"])

        got = run()
        want = vocab_topk_lse.matmul_top_k_with_lse_plain(a["x"], a["emb"], a["k"])
        torch.cuda.synchronize()
        vals_err = (got[0] - want[0]).abs().max().item()
        lse_err = (got[2] - want[2]).abs().max().item()
        agree = (got[1] == want[1]).float().mean().item()
        tol = TOL[name]
        row.update(max_abs_err_vals=vals_err, max_abs_err_lse=lse_err, idx_agree=agree,
                   tolerance=tol, ok=vals_err <= tol["vals"] and lse_err <= tol["lse"]
                   and agree >= tol["idx_agree"])
    elif name in ("roi_align", "roi_align_backward"):
        kw = dict(spatial_scale=a["spatial_scale"], pooled_height=a["pooled"],
                  pooled_width=a["pooled"], sampling_ratio=a["sampling_ratio"])
        if name == "roi_align":
            dtype = a["features"].dtype

            def run():
                return roi_align.roi_align(a["features"], a["rois"], **kw)

            want = roi_align.roi_align_plain(a["features"], a["rois"], **kw)
            row.update(features=list(a["features"].shape))
        else:
            dtype, shape = a["grad_out"].dtype, a["features_shape"]

            def run():
                return roi_align.roi_align_backward(a["grad_out"], a["rois"], shape, **kw)

            want = roi_align.roi_align_backward_plain(a["grad_out"], a["rois"], shape, dtype,
                                                      **kw)
            row.update(features=list(shape))
        got = run()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        row.update(rois=a["rois"].shape[0], dtype=str(dtype).split(".")[-1],
                   max_abs_err=err.max().item())
        if name == "roi_align":
            atol, rtol = ROI_TOL[dtype]
            row.update(tolerance={"atol": atol, "rtol": rtol},
                       ok=bool((err <= atol + rtol * want.float().abs()).all()))
        else:
            scale = want.float().abs().max().item()
            row.update(max_grad=scale, tolerance_rel_to_max=ROI_BWD_TOL[dtype],
                       ok=scale > 0 and row["max_abs_err"] <= ROI_BWD_TOL[dtype] * scale)
    elif name == "nms":
        kw = dict(max_out=a["max_out"], presorted=a["presorted"])

        def run():
            return nms.nms(a["boxes"], a["scores"], a["threshold"], **kw)

        got = run()
        want = nms.nms_plain(a["boxes"], a["scores"], a["threshold"], **kw)
        torch.cuda.synchronize()
        mismatches = int(sum((x != y).sum() for x, y in zip(got, want)))
        row.update(groups=a["boxes"].shape[0], boxes=a["boxes"].shape[1],
                   threshold=a["threshold"], **kw,
                   kept_per_group=got[1].sum(dim=1).float().mean().item(),
                   mismatches=mismatches, ok=mismatches == 0)
    else:
        raise ValueError(f"no check for kernel {name!r}")
    row["kernel_ms"], row["kernel_ms_range"] = time_ms_range(run)
    return row


def check_pipeline_inputs(inputs: Path, dev: torch.device) -> dict:
    """Every kernel input that a workflow step recorded, checked by
    :func:`check_recorded`; fails on a disagreement. Returns the number of
    checks of each kernel."""
    checked = {}
    for path in sorted(inputs.glob("*/*.pt")):
        name = path.stem
        row = {"step": path.parent.name, **check_recorded(name, torch.load(path), dev)}
        emit(row)
        if not row["ok"]:
            fail(f"pipeline: {name} disagrees with its plain version on the inputs of "
                 f"step {row['step']}: {row}")
        checked[name] = checked.get(name, 0) + 1
    return checked


def pipeline_launches(stats: dict) -> dict:
    """The stages' processes' launches, summed, under the kernels line's
    names: every D call of the workflow is the RPN's (the extract CLI's
    per-class NMS is numpy)."""
    out = {"vocab_topk_lse": 0, "topk_lse": 0, "roi_align": 0, "roi_align_backward": 0,
           "nms_rpn": 0, "butd_attention": 0}
    for stage in stats["stages"].values():
        for name, n in stage["launches"].items():
            out["nms_rpn" if name == "nms" else name] += n
    return out


def phase_pipeline(dev: torch.device) -> dict:
    """The user's workflow on the card: make_world (JPEG through nvjpeg's
    encoder), each JPEG decoded back by nvjpeg against the rendered pixels,
    then three_stage.py over stages 1, gate, 2, 3, 4 and 5 at small knobs.
    Returns the stages' launches."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        wstats = render_world_on_card(root / "world", PIPE_WORLD)
        world_s = time.perf_counter() - t0
        trip = jpeg_roundtrip(root / "world", PIPE_WORLD, dev, wstats["images"])
        emit({"phase": "pipeline_world", "images": wstats["images"], "wall_s": world_s,
              "render_s": wstats["render_s"], "encode_first_ms": wstats["encode_first_ms"],
              "encode_ms_per_image": 1e3 * wstats["encode_s"] / wstats["images"],
              "encoder": "nvjpeg (libnvjpeg, CUDA toolkit), quality 92, 4:2:0",
              "roundtrip": trip})
        if not (trip["mean_abs_err"] <= NVJPEG_ROUNDTRIP_BOUND["mean"]
                and trip["max_abs_err"] <= NVJPEG_ROUNDTRIP_BOUND["max"]):
            fail(f"pipeline: nvjpeg's round trip outside its bound: {trip}")
        stats = run_three_stage(root / "world", root / "run", PIPE_KNOBS, root / "run.log",
                                root / "inputs")
        launches = pipeline_launches(stats)
        dmap = json.loads((root / "run" / "detection_map.json").read_text()) \
            if (root / "run" / "detection_map.json").exists() else {}
        for name, st in stats["stages"].items():
            emit({"phase": "pipeline_stage", "stage": name, "rc": st["rc"],
                  "seconds": st["seconds"], "launches": st["launches"],
                  "steps": [{"name": x["name"], "rc": x["rc"], "seconds": x["seconds"]}
                            for x in st["steps"]]})
        emit({"phase": "pipeline", "knobs": PIPE_KNOBS, "world": PIPE_WORLD, "rc": stats["rc"],
              "stages_run": list(stats["stages"]), "AP50": dmap.get("AP50"),
              "mAP": dmap.get("mAP"), "launches": launches,
              "note": "one detector epoch and 10 captioner steps: quality is not judged"})
        if stats["rc"] != 0 or list(stats["stages"]) != list(three_stage_cli.STAGES):
            fail(f"pipeline: three_stage exited {stats['rc']} after stages "
                 f"{list(stats['stages'])}: {(root / 'run.log').read_text()[-3000:]}")
        missing = [k for k in ("vocab_topk_lse", "roi_align", "roi_align_backward", "nms_rpn")
                   if launches[k] < 1]
        if missing:
            fail(f"pipeline: kernels {missing} never launched in the workflow: {launches}")
        # each kernel held to its plain version on the workflow's own inputs
        checked = check_pipeline_inputs(root / "inputs", dev)
        unchecked = [k for k in ("vocab_topk_lse", "roi_align", "roi_align_backward", "nms")
                     if not checked.get(k)]
        emit({"phase": "pipeline_kernels", "checked": checked})
        if unchecked:
            fail(f"pipeline: no recorded inputs of {unchecked} to check: {checked}")
    return launches


def pipeline_readings(dev: torch.device, records: str | None) -> int:
    """``python3 chip_smoke.py --pipeline-readings [DIR]``: the workflow at
    the world's and the detector's own defaults (READINGS_*), its figures
    beside the JAX run's; the run's records (its log, three_stage.json, the
    reports, both metrics.jsonl) are copied to ``DIR`` when one is given."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out = Path(records) if records else root / "records"
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        wstats = render_world_on_card(root / "world", READINGS_WORLD)
        world_s = time.perf_counter() - t0
        trip = jpeg_roundtrip(root / "world", READINGS_WORLD, dev, READINGS_ROUNDTRIP)
        emit({"phase": "pipeline_readings_world", "images": wstats["images"], "wall_s": world_s,
              "render_s": wstats["render_s"], "encode_first_ms": wstats["encode_first_ms"],
              "encode_ms_per_image": 1e3 * wstats["encode_s"] / wstats["images"],
              "roundtrip": trip})
        stats = run_three_stage(root / "world", root / "run", READINGS_KNOBS,
                                out / "three_stage.log", root / "inputs")
        checked = check_pipeline_inputs(root / "inputs", dev)
        run = root / "run"
        for name in ("three_stage.json", "detection_map.json", "eval_baselines.json",
                     "style_report.json", "eval_neutral.json", "eval_pos.json",
                     "eval_neg.json", "captioner_config.yml"):
            if (run / name).exists():
                shutil.copy(run / name, out / name)
        for src, dst in (("detector/metrics.jsonl", "detector_metrics.jsonl"),
                         ("captioner/metrics.jsonl", "captioner_metrics.jsonl")):
            if (run / src).exists():
                shutil.copy(run / src, out / dst)

        def read(name):
            return json.loads((run / name).read_text()) if (run / name).exists() else {}

        dmap, base, style = (read("detection_map.json"), read("eval_baselines.json"),
                             read("style_report.json"))
        keys = ("mean B4", "B4", "mean cider", "cider", "grounding_P", "grounding_R")
        emit({"phase": "pipeline_readings", "rc": stats["rc"], "knobs": READINGS_KNOBS,
              "world": READINGS_WORLD,
              "cut": "CAP_ITERS 20,000 (three_stage.sh's default) -> 2,000",
              "stage_seconds": {k: v["seconds"] for k, v in stats["stages"].items()},
              "stage_rc": {k: v["rc"] for k, v in stats["stages"].items()},
              "launches": pipeline_launches(stats), "kernel_inputs_checked": checked,
              "AP50": dmap.get("AP50"), "mAP": dmap.get("mAP"), "jax_run": JAX_PIPELINE_MAP,
              "control": style.get("control"),
              "baselines": {s: {k: base[s].get(k) for k in keys} for s in base},
              "jax_gates_reported_not_gated": JAX_PIPELINE_GATES})
    print_card()
    return 0 if stats["rc"] == 0 else 1


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def split_readings(dev: torch.device, seeds) -> int:
    """``python3 chip_smoke.py --split-readings SEED ...``: the build, then
    ``decode_split`` at each seed, alone: the readings its bounds are set
    from, then the card's line (no other phase, no summary lines)."""
    phase_build()
    cfg = decode_cfg()
    params = init_captioner(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    _, sentiment, tables = decode_setup(cfg, BATCH, N_Z, BOXES, seed=0)
    state = (DecodeHarness(params, cfg, device=dev), sentiment, tables)
    for seed in seeds:
        emit({"phase": "split_readings", "seed": seed})
        phase_decode_split(dev, state, seed)
    print_card()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    if sys.argv[1:2] == ["--split-readings"]:
        return split_readings(dev, [int(a) for a in sys.argv[2:]] or [SPLIT_SEED])
    if sys.argv[1:] == ["--tp-readings"]:
        phase_tp(dev)
        print_card()
        return 0
    if sys.argv[1:] == ["--pipeline"]:
        phase_build()
        phase_pipeline(dev)
        print_card()
        return 0
    if sys.argv[1:] == ["--sync-free"]:
        phase_build()
        phase_sync_free(dev)
        print_card()
        return 0
    if sys.argv[1:] == ["--decode-f32"]:
        phase_build()
        phase_decode_f32(dev)
        print_card()
        return 0
    if sys.argv[1:] == ["--attention"]:
        phase_build()
        phase_attention(dev)
        print_card()
        return 0
    if sys.argv[1:2] == ["--pipeline-readings"] and len(sys.argv) <= 3:
        phase_build()
        return pipeline_readings(dev, sys.argv[2] if len(sys.argv) == 3 else None)

    phase_build()
    # selection width from the decode's own padded tables: pnbs + E
    _, _, tables = decode_setup(CaptionerConfig(vocab_size=V), 1, 1, 1, seed=0)
    k = BEAM // 2 + tables.exc_token.shape[-1]
    rows = phase_kernels(k, dev)
    phase_agree(dev)
    launches, decode_state = phase_decode(dev)
    # the decode that the inference CLI runs by default: the f32 routes of
    # kernel A and of the attention kernel, whose summary entries count
    # this run's launches; A's own entry counts the wrapper's launches of
    # both routes, the attention's bf16 entry the bf16 prehead decode's
    launches.update(phase_decode_f32(dev))
    launches["vocab_topk_lse"] += launches["vocab_topk_lse_f32"]
    # the decode with no host-device sync, on inputs on the card and on the host
    phase_sync_free(dev)
    # the attention kernel's rows, its f32 decode against the composite and
    # a training step's launches (none)
    rows.update(phase_attention(dev))
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
    # detector training after every earlier path, so that those run as
    # before: the backward kernel's and D's training call's checks, then
    # the training step, the train CLI and the VGG16 variants, whose
    # launches add to C's, the backward's and D's RPN counts
    det_rows.update(phase_detector_train_kernels(dev))
    launches["roi_align_backward"] = 0
    new_launches += [phase_detector_train(dev), phase_train_detector_cli(dev),
                     phase_detector_variants(dev)]
    # data parallelism after every earlier path, so that those run as
    # before: the split decodes' and the detector ranks' launches add to
    # A's, B's, C's, the backward's and D's RPN counts
    new_launches.append(phase_multigpu(dev, decode_state))
    # the user's workflow last, so that every earlier path runs as before:
    # its stages' processes' launches add to A's, C's, the backward's and
    # D's RPN counts
    new_launches.append(phase_pipeline(dev))
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
    print_card()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
