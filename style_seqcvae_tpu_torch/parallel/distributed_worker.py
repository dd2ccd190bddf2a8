"""Real multi-process runs of the data- and tensor-parallel layers
(counterpart of ``style_seqcvae_tpu/parallel/distributed_worker.py``).

This module is both

* a **worker** (``python -m style_seqcvae_tpu_torch.parallel.distributed_worker
  --out r.json --payloads captioner,detector --spec-dir D [--device cuda:0]
  [--backend gloo]``) that joins the process group through
  ``maybe_initialize_distributed`` (the ``SSC_*`` environment), runs each
  payload on its rows of a deterministic global batch (the captioner's
  ``d::num_data`` stride of its data index, as the train CLI's
  ``process_shard`` gives them; the detector's contiguous block of images,
  ``mesh.local_rows``, as the detector train CLI loads them) and writes
  the global results as JSON, one entry a payload; and
* a **launcher** (:func:`launch_ranks`, :func:`launch_two_process_run`)
  that starts such workers on this machine and collects their results.

The payloads run unchanged in one process, on the whole batch, which is
what the ranks are held to:

* ``captioner``: train steps of the captioner or, with ``family``
  ``"baseline"``, of the baseline, on a ``(num_data, num_model)`` mesh of
  the ranks (the spec's ``num_model``; ``fsdp`` shards the FSDP leaves
  over the data axis), with the checkpoint hooks of JAX's worker as spec
  entries: ``ckpt_dir`` (a ``CheckpointManager`` directory),
  ``ckpt_restore`` (a checkpoint restored into the state before the
  steps: a one-process save restored by the ranks, or the reverse) and
  ``ckpt_save`` (saved after the steps); ``steps`` 0 restores and reports
  only. JAX's worker takes ``num_model=2`` at four or more devices;
  :func:`captioner_spec` leaves the choice to the caller;
* ``detector``: SGD steps of the detector (the train CLI's step, with the
  global loss denominators and the gradient sum).

A spec (``captioner_spec`` / ``detector_spec``, a JSON file
``<name>.json`` in ``--spec-dir``; its ``payload`` names the function,
default the name) gives the model, the global batch size, the steps and,
optionally, ``.npz`` files of the initial parameters in the JAX tree's
layout, the global batch and the noise (the captioner's (steps, T+1, B, z)
z-noise, the detector's (steps, B, ...) uniforms), each rank slicing its
rows, a path where rank 0 saves the final parameters (gathered whole) and
a directory where every rank saves its own blocks (``save_local``,
``rank<r>.npz``). Without them the parameters come from a seeded init on
the device and the batch from a seeded numpy generator, identical in every
process; the noise then comes from the generators, the global draw sliced
per data index.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

# the JAX worker's tiny captioner, and config 2's published widths
_TINY_CAPTIONER = dict(vocab_size=64, image_feature_size=16, embedding_size=8, hidden_size=6,
                       attention_projection_size=4, z_space=4, sentiment_vae=1,
                       simple_vae=False, max_caption_length=6)
_FULL_CAPTIONER = dict(vocab_size=10500, image_feature_size=2048, embedding_size=600,
                       hidden_size=900, attention_projection_size=768, z_space=150,
                       sentiment_vae=1, simple_vae=False, max_caption_length=20)


def captioner_spec(size: str = "tiny", **kw) -> Dict[str, Any]:
    """``tiny``: the JAX worker's payload (16 rows); ``full``: config 2's
    widths at a global batch of 150 over 100 boxes, 3 steps. The cvae
    family on a data axis alone; ``kw`` overrides any entry (``family``,
    ``num_model``, ``fsdp``, the checkpoint hooks, ...)."""
    if size == "tiny":
        spec = dict(model=_TINY_CAPTIONER, batch=16, boxes=4, steps=1,
                    overrides=["MODEL.EMBEDDING_SIZE", "8", "OPTIM.NUM_ITERATIONS", "100"])
    elif size == "full":
        spec = dict(model=_FULL_CAPTIONER, batch=150, boxes=100, steps=3,
                    overrides=["OPTIM.NUM_ITERATIONS", "100"])
    else:
        raise ValueError(f"size must be 'tiny' or 'full', got {size!r}")
    spec.update(payload="captioner", family="cvae", num_model=1, fsdp=False, seed=0,
                params=None, batch_npz=None, eps=None, save=None, save_local=None,
                ckpt_dir=None, ckpt_restore=None, ckpt_save=None)
    spec.update(kw)
    return spec


def detector_spec(size: str = "tiny", **kw) -> Dict[str, Any]:
    """``tiny``: ResNet-50 at 5 classes and 6 attributes, 4 images of 64 ×
    96; ``full``: the train CLI's ResNet-101 (81 classes, 196 attributes,
    the DET defaults) at 4 images on 640 × 1024, 2 steps. ``kw`` overrides
    any entry."""
    if size == "tiny":
        spec = dict(model=dict(num_classes=5, num_att_classes=6, depth=50,
                               anchor_scales=[1, 2, 4],
                               # more anchors sampled than labelled: the
                               # images' anchor counts differ
                               rpn=dict(pre_nms_top_n=200, post_nms_top_n=48,
                                        rpn_batch_size=256),
                               pt=dict(rois_per_image=16, num_classes=5, fg_thresh=0.25,
                                       bg_thresh_hi=0.25)),
                    batch=4, image_hw=[64, 96], steps=1)
    elif size == "full":
        spec = dict(model=None, batch=4, image_hw=[640, 1024], steps=2)
    else:
        raise ValueError(f"size must be 'tiny' or 'full', got {size!r}")
    spec.update(payload="detector", seed=2, params=None, batch_npz=None, draws=None, save=None,
                optimizer=dict(lr=1e-2, momentum=0.9, weight_decay=1e-4, clip_norm=10.0))
    spec.update(kw)
    return spec


def _detector_config(spec):
    from style_seqcvae_tpu_torch.config import Config
    from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig
    from style_seqcvae_tpu_torch.models.detector.rpn import RPNConfig
    from style_seqcvae_tpu_torch.models.detector.targets import ProposalTargetConfig
    from style_seqcvae_tpu_torch.scripts.train_detector import detector_config

    m = spec["model"]
    if m is None:
        return detector_config(Config().DET, 81, 196, 101, False)
    m = dict(m)
    rpn, pt = RPNConfig(**m.pop("rpn")), ProposalTargetConfig(**m.pop("pt"))
    return DetectorConfig(rpn=rpn, pt=pt, **{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in m.items()})


def caption_batch(model: Dict[str, Any], batch: int, boxes: int, seed: int
                  ) -> Dict[str, np.ndarray]:
    """A seeded global captioner batch: features with padding boxes,
    captions of 3 to T tokens padded with the pad index, sentiment ±1."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, boxes, model["image_feature_size"]).astype(np.float32)
    feats[:, boxes - max(boxes // 10, 1):] = 0.0
    T = model["max_caption_length"]
    toks = rng.randint(2, model["vocab_size"], (batch, T)).astype(np.int32)
    for i, n in enumerate(rng.randint(min(3, T), T + 1, batch)):
        toks[i, n:] = 0
    return {"image_features": feats, "caption_tokens": toks,
            "sentiment": rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)}


def detector_batch(batch: int, image_hw: Sequence[int], num_classes: int, num_atts: int,
                   seed: int, max_gt: int = 6) -> Dict[str, np.ndarray]:
    """A seeded global detector batch whose images differ in size, in their
    number of boxes (the first half 1 or 2, the second ``max_gt``) and in
    their attributes (the second half has none), so that the ranks' anchor,
    foreground and attribute counts differ."""
    rng = np.random.RandomState(seed)
    H, W = image_hw
    images = np.zeros((batch, H, W, 3), np.float32)
    im_info = np.zeros((batch, 3), np.float32)
    gt = np.zeros((batch, max_gt, 5), np.float32)
    num_gt = np.zeros((batch,), np.int32)
    atts = np.zeros((batch, max_gt, max(num_atts, 1)), np.float32)
    for i in range(batch):
        h, w = H - 8 * (i % 3), W - 16 * (i % 2)
        images[i, :h, :w] = rng.randn(h, w, 3) * 50.0
        im_info[i] = [h, w, 1.0]
        n = 1 + i % 2 if i < batch // 2 else max_gt
        xy = rng.rand(n, 2) * [w * 0.6, h * 0.6]
        wh = rng.rand(n, 2) * [w * 0.4, h * 0.4] + min(h, w) / 6
        gt[i, :n, :2], gt[i, :n, 2:4] = xy, np.minimum(xy + wh, [w - 1, h - 1])
        gt[i, :n, 4] = rng.randint(1, num_classes, n)
        num_gt[i] = n
        if i < batch // 2:
            atts[i, :n] = rng.rand(n, atts.shape[-1]) > 0.6
    counts = rng.randint(1, 50, (max(num_atts, 1),)).astype(np.float32)
    return dict(images=images, im_info=im_info, gt_boxes=gt, num_gt=num_gt, gt_atts=atts,
                att_counts=counts)


def _norm_sq(tree) -> float:
    from style_seqcvae_tpu_torch.weights import named_leaves

    return float(sum(float((t.detach().double() ** 2).sum()) for _, t in named_leaves(tree)))


def _synced_ms(fn, dev: torch.device) -> tuple:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _allreduce_ms(grads: List[torch.Tensor], group, dev: torch.device,
                  reps: int = 3) -> Optional[float]:
    """The median time of the bucketed gradient sum on copies of the last
    step's gradients (CUDA events on the card, the host clock on the CPU)."""
    from style_seqcvae_tpu_torch.parallel.collectives import all_reduce_sum_

    if group is None or not grads:
        return None
    ms = []
    for _ in range(reps):
        copies = [g.clone() for g in grads]
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            all_reduce_sum_(copies, group)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            ms.append(_synced_ms(lambda: all_reduce_sum_(copies, group), dev)[1])
    return sorted(ms)[len(ms) // 2]


def _mesh(dev: torch.device, num_model: int = 1):
    from style_seqcvae_tpu_torch.parallel.mesh import make_mesh
    from style_seqcvae_tpu_torch.parallel.multihost import process_count

    if process_count() > 1:
        return make_mesh(-1, num_model, [dev])
    if num_model != 1:
        raise ValueError(f"num_model {num_model} needs a process group of its ranks")
    return None


def _replicated_mismatches(state) -> List[str]:
    """The leaves held whole over the model axis whose values differ from
    those of another rank of this rank's model group (bit for bit)."""
    from style_seqcvae_tpu_torch.parallel.collectives import all_gather
    from style_seqcvae_tpu_torch.parallel.mesh import MODEL_AXIS
    from style_seqcvae_tpu_torch.weights import named_leaves

    mesh = state.mesh
    if mesh is None or mesh.model_group is None:
        return []
    bad = []
    for path, t in named_leaves(state.params):
        if MODEL_AXIS in state.specs[path]:
            continue
        copies = all_gather(t.detach()[None], mesh.model_group, 0)
        if not all(torch.equal(c, copies[0]) for c in copies):
            bad.append(path)
    return bad


def run_captioner_payload(spec: Dict[str, Any], device: Union[str, torch.device]
                          ) -> Dict[str, Any]:
    """The captioner's (or the baseline's) train steps on this rank's rows
    of the spec's global batch; returns the global metrics and the
    gradient norm before the clip of every step, the params' squared norm
    (whole leaves), host ms a step, the gradient sum's ms, the leaves held
    whole over the model axis that differ across the model group, and, on
    the card, the peak memory it added to what the caller held; with a
    model axis, the tensor-parallel collectives' count and ms a step."""
    from style_seqcvae_tpu_torch.config import Config
    from style_seqcvae_tpu_torch.models.baseline import init_baseline
    from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from style_seqcvae_tpu_torch.parallel import tensor_parallel
    from style_seqcvae_tpu_torch.parallel.mesh import gather_params, shard_batch
    from style_seqcvae_tpu_torch.parallel.multihost import process_index, rank_device
    from style_seqcvae_tpu_torch.training.checkpointing import CheckpointManager
    from style_seqcvae_tpu_torch.training.trainer import (
        create_train_state,
        make_baseline_train_step,
        make_train_step,
    )
    from style_seqcvae_tpu_torch.weights import (
        from_jax_params,
        load_params_npz,
        save_params_npz,
    )

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)       # what the caller already holds
    cfg = CaptionerConfig(**spec["model"])
    config = Config(config_override=spec["overrides"])
    baseline = spec["family"] == "baseline"
    if spec["params"]:
        params = from_jax_params(load_params_npz(spec["params"]), device=dev)
    else:
        init = init_baseline if baseline else init_captioner
        params = init(cfg, seed=spec["seed"], device=dev)
    mesh = _mesh(dev, spec["num_model"])
    state = create_train_state(params, config, cfg, seed=spec["seed"] + 1, device=dev,
                               mesh=mesh, shard_params_over_data=spec["fsdp"])
    del params
    step = (make_baseline_train_step(cfg, mesh=mesh) if baseline
            else make_train_step(cfg, config.MODEL.KLD_WEIGHT, mesh=mesh))

    B = spec["batch"]
    global_batch = (dict(np.load(spec["batch_npz"])) if spec["batch_npz"]
                    else caption_batch(spec["model"], B, spec["boxes"], spec["seed"]))
    n_data, d = (1, 0) if mesh is None else (mesh.num_data, mesh.data_index)
    if B % n_data:
        raise ValueError(f"{B} rows do not divide over {n_data} data indices")
    rows = slice(d, None, n_data)
    local = {k: v[rows] for k, v in global_batch.items()}
    batch = shard_batch(mesh, local) if mesh else {k: torch.from_numpy(v).to(dev)
                                                    for k, v in local.items()}
    eps = None if not spec["eps"] else torch.from_numpy(np.load(spec["eps"])["eps"])

    mgr = CheckpointManager(spec["ckpt_dir"], keep=0) if spec["ckpt_dir"] else None
    if mgr is not None and spec["ckpt_restore"]:
        state = mgr.restore(spec["ckpt_restore"], state)

    metrics, step_ms, coll_ms, coll_counts = [], [], [], []
    for s in range(spec["steps"]):
        kw = {} if baseline else {"eps": None if eps is None else eps[s][:, rows].to(dev)}
        with tensor_parallel.traced() as trace:
            (state, m), ms = _synced_ms(lambda: step(state, batch, **kw), dev)
        metrics.append(dict({k: float(v) for k, v in m.items()},
                            grad_norm=float(state.grad_norm)))
        step_ms.append(ms)
        coll_ms.append(trace.ms())
        coll_counts.append(trace.counts)
    whole = state.params if mesh is None else gather_params(mesh, state.params, state.specs)
    out = {"param_norm_sq": _norm_sq(whole), "opt_step": state.step,
           "metrics": metrics, "step_ms": step_ms,
           "allreduce_ms": _allreduce_ms([p.grad for _, p in state.tx.named
                                          if p.grad is not None],
                                         None if mesh is None else mesh.data_group, dev),
           "replicated_mismatches": _replicated_mismatches(state),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev) - held
                              if dev.type == "cuda" else None)}
    if mesh is not None and mesh.num_model > 1:
        out.update(collective_ms=coll_ms, collectives=coll_counts)
    if metrics:
        out.update(metrics[-1])
    if mgr is not None and spec["ckpt_save"]:
        mgr.save(state, spec["ckpt_save"])
    if spec["save"] and process_index() == 0:
        save_params_npz(whole, spec["save"])
    if spec["save_local"]:
        os.makedirs(spec["save_local"], exist_ok=True)
        save_params_npz(state.params, os.path.join(spec["save_local"],
                                                   f"rank{process_index()}.npz"))
    return out


def run_detector_payload(spec: Dict[str, Any], device: Union[str, torch.device]
                         ) -> Dict[str, Any]:
    """The detector's SGD steps on this process's images of the spec's
    global batch; returns the global losses of every step, the params'
    squared norm and host ms a step."""
    from style_seqcvae_tpu_torch.models.detector.faster_rcnn import TrainDraws, init_detector
    from style_seqcvae_tpu_torch.parallel.mesh import (
        local_rows,
        replicate,
        shard_detector_batch,
    )
    from style_seqcvae_tpu_torch.parallel.multihost import process_index, rank_device
    from style_seqcvae_tpu_torch.scripts.train_detector import make_train_step
    from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD
    from style_seqcvae_tpu_torch.weights import (
        from_jax_detector_params,
        load_params_npz,
        save_params_npz,
        to_jax_detector_params,
    )

    dev = rank_device(device)
    cfg = _detector_config(spec)
    if spec["params"]:
        params = from_jax_detector_params(load_params_npz(spec["params"]), device=dev)
    else:
        params = init_detector(cfg, seed=spec["seed"], device=dev)
    mesh = _mesh(dev)
    if mesh is not None:
        replicate(mesh, params)
    opt = DetectorSGD(params, **spec["optimizer"])
    step = make_train_step(cfg, opt, mesh=mesh)

    B = spec["batch"]
    global_batch = (dict(np.load(spec["batch_npz"])) if spec["batch_npz"]
                    else detector_batch(B, spec["image_hw"], cfg.num_classes,
                                        cfg.num_att_classes, spec["seed"] + 1))
    rows = local_rows(B)
    local = {k: (v if k == "att_counts" else v[rows]) for k, v in global_batch.items()}
    batch = (shard_detector_batch(mesh, local) if mesh
             else {k: torch.from_numpy(v).to(dev) for k, v in local.items()})
    if spec["draws"]:
        d = np.load(spec["draws"])
        draws = [TrainDraws(*[torch.from_numpy(d[f][s][rows]).to(dev)
                              for f in TrainDraws._fields]) for s in range(spec["steps"])]
    else:
        gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
        draws = [gen] * spec["steps"]

    losses, step_ms = [], []
    for s in range(spec["steps"]):
        ls, ms = _synced_ms(lambda: step(params, batch, draws[s]), dev)
        losses.append({k: float(v) for k, v in ls.items()})
        step_ms.append(ms)
    if spec["save"] and process_index() == 0:
        save_params_npz(to_jax_detector_params(params), spec["save"])
    return {"det_losses": losses, "det_loss": losses[-1]["total"],
            "det_param_norm_sq": _norm_sq(params), "det_step_ms": step_ms}


PAYLOADS = {"captioner": run_captioner_payload, "detector": run_detector_payload}
SPECS = {"captioner": captioner_spec, "detector": detector_spec}


def kernel_launches() -> Dict[str, int]:
    """This process's launch counters of the port's CUDA kernels."""
    from style_seqcvae_tpu_torch.ops.kernels import nms, roi_align, topk_lse, vocab_topk_lse

    return {"vocab_topk_lse": vocab_topk_lse.launches, "topk_lse": topk_lse.launches,
            "roi_align": roi_align.launches,
            "roi_align_backward": roi_align.backward_launches, "nms": nms.launches}


def run_payloads(specs: Dict[str, Dict[str, Any]], device: Union[str, torch.device]
                 ) -> Dict[str, Any]:
    from style_seqcvae_tpu_torch.parallel.multihost import process_count, process_index

    """Run each spec's payload in turn; the results by the specs' names,
    beside this process's place and its kernels' launch counters."""
    out: Dict[str, Any] = {"process_index": process_index(),
                           "process_count": process_count(), "device": str(device)}
    for name, spec in specs.items():
        out[name] = PAYLOADS[spec.get("payload", name)](spec, device)
    out["launches"] = kernel_launches()
    return out


def launch_two_process_run(payloads: Union[Sequence[str], Dict[str, Dict[str, Any]]] = (
        "captioner",), device: str = "cpu", backend: Optional[str] = None,
        timeout: float = 300.0, out_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """:func:`launch_ranks` with two ranks."""
    return launch_ranks(2, payloads, device, backend, timeout, out_dir)


def launch_ranks(n: int, payloads: Union[Sequence[str], Dict[str, Dict[str, Any]]] = (
        "captioner",), device: str = "cpu", backend: Optional[str] = None,
        timeout: float = 300.0, out_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Start ``n`` workers as ranks 0 … n-1 of a process group on this
    machine (``SSC_*`` environment on a free port), all on ``device`` (the
    CPU, or one card for every rank, which needs ``backend="gloo"``), and
    run ``payloads`` (names with their tiny specs, or name → spec). Returns
    the results, rank 0 first. Raises when a worker fails or one outlives
    ``timeout`` seconds (all are then killed)."""
    from style_seqcvae_tpu_torch.parallel.multihost import free_port

    specs = (dict(payloads) if isinstance(payloads, dict)
             else {name: SPECS[name]() for name in payloads})
    out_dir = out_dir or tempfile.mkdtemp(prefix="ssc_dist_")
    os.makedirs(out_dir, exist_ok=True)
    for name, spec in specs.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(spec, f)
    repo_root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    port = free_port()
    procs, outs, logs = [], [], []
    try:
        for rank in range(n):
            outs.append(os.path.join(out_dir, f"worker{rank}.json"))
            logs.append(os.path.join(out_dir, f"worker{rank}.log"))
            wenv = dict(os.environ)
            wenv.update(SSC_COORDINATOR=f"localhost:{port}", SSC_NUM_PROCESSES=str(n),
                        SSC_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
            cmd = [sys.executable, "-m", "style_seqcvae_tpu_torch.parallel.distributed_worker",
                   "--out", outs[-1], "--payloads", ",".join(specs), "--spec-dir", out_dir,
                   "--device", device] + (["--backend", backend] if backend else [])
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=repo_root, env=wenv, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                        # a failed rank: the others would wait for it
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(cmd, timeout)
            time.sleep(0.05)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"a distributed worker outlived its {timeout} s "
                           f"(logs in {out_dir})") from None
    finally:
        killed = set()
        for rank, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(rank)
    # the ranks that failed on their own first, then those stopped here
    for rank in sorted(range(n), key=lambda r: r in killed):
        if procs[rank].returncode != 0:
            with open(logs[rank]) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"distributed worker {rank} failed "
                               f"rc={procs[rank].returncode}:\n{tail}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--payloads", default="captioner")
    ap.add_argument("--spec-dir", default="",
                    help="directory of <payload>.json specs (default: the tiny specs)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (default nccl on CUDA, gloo on CPU)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from style_seqcvae_tpu_torch.parallel.multihost import maybe_initialize_distributed

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(args.device, backend=args.backend)
    specs = {}
    for name in [p for p in args.payloads.split(",") if p]:
        path = os.path.join(args.spec_dir, f"{name}.json") if args.spec_dir else ""
        if path:
            with open(path) as f:
                specs[name] = json.load(f)
        else:
            specs[name] = SPECS[name]()
    try:
        result = run_payloads(specs, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    print("distributed worker done:", json.dumps(result))


if __name__ == "__main__":
    main()
