"""Train the Faster R-CNN detector with its attribute head (counterpart of
the JAX package's ``scripts/train_detector.py``, a mirror of
frcnn/trainval_net.py).

    python -m style_seqcvae_tpu_torch.scripts.train_detector \\
        --instances-json instances.json --image-root images/ \\
        --serialization-dir runs/det [--epochs N] [--ims-per-batch B] \\
        [--bf16-compute] [--remat] [--unfreeze-backbone] [--cpu]

The loop is the JAX CLI's: each epoch shuffles the images with Python's
``random`` (seeded ``--seed``), loads each one, flips it with probability
0.5 (before the resize, as boxes are in the original image's coordinates),
resizes it to DET.TRAIN.SCALES[0] / MAX_SIZE and files it under its canvas
(``canvas_for``: landscape or portrait); a canvas that holds
``--ims-per-batch`` × K images runs K SGD steps (``--steps-per-dispatch K``,
the same steps and draws as K = 1), and at the epoch's end the leftovers run
as single steps, the last partial group padded with its last image. The
loss is ``detector_forward_train``'s total (rpn_cls + rpn_box + rcnn_cls +
0.5 · rcnn_cls_atts + rcnn_box); the optimizer ``DetectorSGD`` (the
reference's bias rules, epoch-stepped decay, optional clipping). Every
DET.TRAIN.DISPLAY steps the losses go to ``metrics.jsonl`` (with
StepTimer's ``data_ms`` and ``step_ms``) and to stdout; each epoch ends
with the checkpoint ``detector_epoch_N``, a directory whose ``state.npz``
holds ``params/…`` (the JAX tree's layout) and ``opt_state/…``, which the
port's extract CLI reads as ``--checkpoint-path DIR/detector_epoch_N``.

Images are decoded on the device (JPEG by nvjpeg on the card), flipped and
resized there. Parameters are ``init_detector``'s, seeded ``--seed`` (not
JAX's PRNGKey draws); the sampling's uniforms come from a
``torch.Generator`` seeded ``--seed + 1``. ``--bf16-compute`` runs the
forward and backward in bfloat16 on f32 master parameters. It runs on
``cuda`` unless ``--cpu`` is given, and raises without a GPU.

Data parallel (``parallel/``), as the captioner's train CLI: under a
launcher (torchrun or the ``SSC_*`` environment) ``--num-data`` is -1 or the
world size, and in a plain run ``--num-data N`` above 1 starts N ranks on
this machine. ``--ims-per-batch`` must divide by the ranks. Every rank
walks the same shuffle, flips and canvas buckets, loads only its
contiguous block of each step's images, draws the global step's uniforms
and keeps its images' draws; the losses divide by global counts and the
gradients are summed before the clip, so the steps are one process's on
the whole batch. Rank 0 writes the checkpoints and ``metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.detection import (
    CocoDetectionDataset,
    canvas_for,
    flip_record,
    load_image_bgr,
    make_batch,
    prepare_image,
)
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import (
    DetectorConfig,
    detector_forward_train,
    init_detector,
)
from style_seqcvae_tpu_torch.models.detector.rpn import RPNConfig
from style_seqcvae_tpu_torch.models.detector.targets import ProposalTargetConfig
from style_seqcvae_tpu_torch.ops.kernels import report_launches
from style_seqcvae_tpu_torch.parallel.collectives import reduce_gradients, reduce_scalars
from style_seqcvae_tpu_torch.parallel.mesh import Mesh, make_mesh
from style_seqcvae_tpu_torch.parallel.multihost import (
    maybe_initialize_distributed,
    process_index,
    run_local_ranks,
)
from style_seqcvae_tpu_torch.training.checkpointing import write_checkpoint
from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD
from style_seqcvae_tpu_torch.utils.logging import MetricsWriter, StepTimer, device_sync
from style_seqcvae_tpu_torch.weights import cast_floats, named_leaves, to_jax_detector_params

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--instances-json", required=True, action="append", nargs="+",
                    help="COCO instances json; repeat the flag (or pass several paths) to "
                         "train on the union of datasets")
parser.add_argument("--image-root", default="")
parser.add_argument("--senticap-json", default="",
                    help="senticap json; its TEST images are excluded from training")
parser.add_argument("--attribs-dir", default="", help="COCO-Attributes pickles dir")
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument("--serialization-dir", default="checkpoints/detector")
parser.add_argument("--epochs", type=int, default=10)
parser.add_argument("--steps-per-epoch", type=int, default=0, help="0 = dataset length")
parser.add_argument("--canvas", type=int, nargs=2, default=[640, 1024])
parser.add_argument("--ims-per-batch", type=int, default=1,
                    help="images per SGD step, grouped by canvas orientation")
parser.add_argument("--bf16-compute", action="store_true",
                    help="bfloat16 forward and backward with float32 master params")
parser.add_argument("--num-data", type=int, default=1,
                    help="data-parallel ranks over --ims-per-batch: under a launcher -1 or "
                         "the world size; in a plain run N > 1 starts N ranks on this "
                         "machine")
parser.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K optimizer steps per filled canvas bucket of K · ims-per-batch "
                         "images, run in turn: the same steps and draws as K = 1")
parser.add_argument("--unfreeze-backbone", action="store_true",
                    help="train conv1 / layer1 / the BatchNorm affine too (from-scratch runs)")
parser.add_argument("--depth", type=int, default=101, choices=[50, 101])
parser.add_argument("--lr-decay-epochs", type=int, default=4,
                    help="decay the lr by DET.TRAIN.GAMMA every N epochs")
parser.add_argument("--remat", action="store_true",
                    help="recompute the backbone's bottlenecks in the backward (less "
                         "activation memory)")
parser.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the GPU")
parser.add_argument("--seed", type=int, default=3)


def detector_config(D, num_classes: int, n_attribs: int, depth: int, remat: bool
                    ) -> DetectorConfig:
    """The JAX CLI's ``DetectorConfig`` from the ``DET`` tree."""
    return DetectorConfig(
        num_classes=num_classes, num_att_classes=n_attribs, depth=depth,
        pooling_mode=D.POOLING_MODE, anchor_scales=tuple(D.ANCHOR_SCALES),
        anchor_ratios=tuple(D.ANCHOR_RATIOS),
        rpn=RPNConfig(
            anchor_scales=tuple(D.ANCHOR_SCALES), pre_nms_top_n=D.TRAIN.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=D.TRAIN.RPN_POST_NMS_TOP_N, nms_thresh=D.TRAIN.RPN_NMS_THRESH,
            rpn_batch_size=D.TRAIN.RPN_BATCHSIZE, fg_fraction=D.TRAIN.RPN_FG_FRACTION,
            positive_overlap=D.TRAIN.RPN_POSITIVE_OVERLAP,
            negative_overlap=D.TRAIN.RPN_NEGATIVE_OVERLAP),
        pt=ProposalTargetConfig(
            rois_per_image=D.TRAIN.BATCH_SIZE, fg_fraction=D.TRAIN.FG_FRACTION,
            fg_thresh=D.TRAIN.FG_THRESH, bg_thresh_hi=D.TRAIN.BG_THRESH_HI,
            bg_thresh_lo=D.TRAIN.BG_THRESH_LO,
            bbox_normalize_means=tuple(D.TRAIN.BBOX_NORMALIZE_MEANS),
            bbox_normalize_stds=tuple(D.TRAIN.BBOX_NORMALIZE_STDS), num_classes=num_classes),
        att_loss_weight=D.ATT_LOSS_WEIGHT, remat=remat)


def make_train_step(det_cfg: DetectorConfig, opt: DetectorSGD, bf16: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """One SGD step: ``step(params, batch, draws)`` runs the training
    forward (in bf16 on a cast of the f32 ``params`` under ``bf16``), the
    backward and ``opt``; returns the detached losses. ``draws``: a
    ``TrainDraws`` or a ``torch.Generator``. Under ``mesh`` the batch is
    this rank's block of images, the gradients are summed over the ranks
    before ``opt`` clips them, and the returned losses are the global
    ones."""
    group = None if mesh is None else mesh.data_group

    def step(params: Dict[str, Any], batch: Dict[str, torch.Tensor], draws) -> Dict[str, Any]:
        if bf16:
            compute = cast_floats(params, torch.bfloat16)
            batch = dict(batch, images=batch["images"].to(torch.bfloat16))
        else:
            compute = params
        losses = detector_forward_train(compute, det_cfg, batch, draws, group=group)
        losses["total"].backward()
        if group is not None:
            reduce_gradients([p for _, p in opt.named], group)
            losses = reduce_scalars(losses, group)
        opt.apply()
        return {k: v.detach() for k, v in losses.items()}

    return step


def checkpoint_arrays(params: Dict[str, Any], opt: DetectorSGD) -> Dict[str, np.ndarray]:
    """``params/…`` and ``opt_state/…`` in the JAX tree's layout (conv
    kernels HWIO)."""
    flat = {f"params/{k}": v for k, v in named_leaves(to_jax_detector_params(params))}
    for path, t in opt.trace.items():
        t = t.detach().cpu()
        flat[f"opt_state/trace/{path}"] = (t.permute(2, 3, 1, 0) if t.dim() == 4
                                           else t).contiguous().numpy()
    flat["opt_state/step"] = np.asarray(opt.step, np.int32)
    return flat


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code. ``stats``, when given, receives ``steps``, ``epochs``,
    ``checkpoints`` (paths), ``load_s`` (reading, decoding, flipping and
    resizing this rank's images), ``wall_s`` and StepTimer's ``data_ms`` and
    ``step_ms`` (host milliseconds a step, each step synchronised); a plain
    run that starts its ranks receives ``ranks`` only."""
    argv = sys.argv[1:] if argv is None else list(argv)
    _A = parser.parse_args(argv)
    device_arg = "cpu" if _A.cpu else None
    resolve_device(device_arg)
    mesh = None
    if maybe_initialize_distributed(device_arg):
        mesh = make_mesh(_A.num_data, 1, [device_arg] if _A.cpu else None)
    elif _A.num_data > 1:
        if max(_A.ims_per_batch, 1) % _A.num_data:
            raise ValueError(f"--ims-per-batch {_A.ims_per_batch} must be divisible by the "
                             f"data-parallel size {_A.num_data}")
        run_local_ranks("style_seqcvae_tpu_torch.scripts.train_detector", argv, _A.num_data,
                        device_arg)
        if stats is not None:
            stats.update(ranks=_A.num_data)
        return 0
    elif _A.num_data not in (-1, 1):
        raise ValueError(f"--num-data {_A.num_data}: pass -1, 1 or a number of ranks")
    device = mesh.device if mesh is not None else resolve_device(device_arg)
    world = 1 if mesh is None else mesh.world_size
    rank = process_index()
    t_start = time.perf_counter()
    _C = Config(config_override=_A.config_override)
    D = _C.DET
    random.seed(_A.seed)
    np.random.seed(_A.seed)

    instances = [p for group in _A.instances_json for p in group]
    dataset = CocoDetectionDataset(instances, _A.image_root, _A.senticap_json, _A.attribs_dir)
    print(f"{len(dataset)} training images ({len(instances)} instance "
          f"json{'s' if len(instances) > 1 else ''}), "
          f"{dataset.num_classes} classes, {dataset.n_attribs} attributes")
    det_cfg = detector_config(D, dataset.num_classes, dataset.n_attribs, _A.depth, _A.remat)
    params = init_detector(det_cfg, seed=_A.seed, device=device)
    steps_per_epoch = _A.steps_per_epoch or len(dataset)
    ims = max(_A.ims_per_batch, 1)
    # the lr decays by epoch: an epoch is ceil(images / ims_per_batch) steps
    opt = DetectorSGD(
        params, lr=D.TRAIN.LEARNING_RATE, momentum=D.TRAIN.MOMENTUM,
        weight_decay=D.TRAIN.WEIGHT_DECAY, double_bias=D.TRAIN.DOUBLE_BIAS,
        bias_decay=D.TRAIN.BIAS_DECAY, steps_per_epoch=-(-steps_per_epoch // ims),
        freeze_backbone=not _A.unfreeze_backbone, lr_decay_step_epochs=_A.lr_decay_epochs,
        gamma=D.TRAIN.GAMMA, clip_norm=D.TRAIN.CLIP_GRADIENTS)
    att_counts = torch.as_tensor(
        dataset.att_counts if dataset.att_counts is not None
        else np.ones((max(dataset.n_attribs, 1),), np.float32), dtype=torch.float32,
        device=device)
    if ims % world:
        raise ValueError(f"--ims-per-batch {ims} must be divisible by the data-parallel size "
                         f"{world}")
    per_rank = ims // world
    train_step = make_train_step(det_cfg, opt, _A.bf16_compute, mesh)
    generator = torch.Generator(device=device).manual_seed(_A.seed + 1)

    os.makedirs(_A.serialization_dir, exist_ok=True)
    writer = MetricsWriter(_A.serialization_dir)
    timer = StepTimer()
    order = list(range(len(dataset)))
    K = max(_A.steps_per_dispatch, 1)
    step_count = 0
    load_s = 0.0
    checkpoints: List[str] = []

    def make_one(items, canvas):
        """This rank's block of a group of ``(record, flipped)`` items padded
        to ``ims`` with its last: each image loaded, flipped where drawn
        (before the resize: boxes are in the original image's coordinates)
        and resized, then batched."""
        nonlocal load_s
        while len(items) < ims:
            items.append(items[-1])
        recs, imgs, scales = [], [], []
        for rec, flipped in items[rank * per_rank:(rank + 1) * per_rank]:
            t0 = time.perf_counter()
            img = load_image_bgr(rec["file_name"], device)
            if flipped:
                rec, img = flip_record(rec, img)
            img, scale = prepare_image(img, D.TRAIN.SCALES[0], D.TRAIN.MAX_SIZE)
            load_s += time.perf_counter() - t0
            recs.append(rec)
            imgs.append(img)
            scales.append(scale)
        batch = make_batch(recs, imgs, scales, canvas, D.MAX_NUM_GT_BOXES,
                           max(dataset.n_attribs, 1))
        batch["att_counts"] = att_counts
        return batch

    def display(epoch, losses, window=1):
        # any step of the window at a DISPLAY multiple: the window's last losses
        if any(s % D.TRAIN.DISPLAY == 0 for s in range(step_count - window + 1,
                                                       step_count + 1)):
            vals = {n: device_sync(v) for n, v in losses.items()}
            writer.scalars(step_count, {**vals, **timer.summary()})
            if rank == 0:
                print(f"e{epoch} s{step_count}: "
                      + " ".join(f"{n}={v:.4f}" for n, v in vals.items()))

    def run_steps(epoch, canvas, items, k):
        """``k`` SGD steps in turn over ``k`` groups of up to ``ims``
        same-canvas images."""
        nonlocal step_count
        for i in range(k):
            with timer.phase("data"):
                batch = make_one(items[i * ims:(i + 1) * ims], canvas)
            with timer.phase("step"):
                losses = train_step(params, batch, generator)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            step_count += 1
        display(epoch, losses, window=k)

    for epoch in range(1, _A.epochs + 1):
        random.shuffle(order)
        buckets: Dict[tuple, list] = {}
        for idx in order[:steps_per_epoch]:
            rec = dataset.record(idx)
            flipped = bool(D.TRAIN.USE_FLIPPED and random.random() < 0.5)
            canvas = canvas_for(rec, tuple(_A.canvas))
            buckets.setdefault(canvas, []).append((rec, flipped))
            if len(buckets[canvas]) == ims * K:
                run_steps(epoch, canvas, buckets.pop(canvas), K)
        # leftovers: full groups as single steps, the last partial group padded
        for canvas, items in sorted(buckets.items()):
            for i in range(0, len(items), ims):
                run_steps(epoch, canvas, items[i:i + ims], 1)
        path = os.path.join(_A.serialization_dir, f"detector_epoch_{epoch}")
        write_checkpoint(path, checkpoint_arrays(params, opt))
        checkpoints.append(path)
    writer.close()
    if stats is not None:
        summary = timer.summary()
        stats.update(steps=step_count, epochs=_A.epochs, checkpoints=checkpoints,
                     data_ms=summary.get("data_ms", 0.0), step_ms=summary.get("step_ms", 0.0),
                     load_s=load_s,
                     wall_s=time.perf_counter() - t_start)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(report_launches(main()))
