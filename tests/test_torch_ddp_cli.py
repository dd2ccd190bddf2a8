"""The CLIs' ``--num-data`` on the CPU: ``--num-data 2`` against
``--num-data 1``.

* The train CLI (two gloo ranks it starts itself, BATCH_SIZE 4 as 2 + 2
  rows by ``process_shard``): ``metrics.jsonl``'s losses rtol 1e-5 and the
  final checkpoint's every parameter within 1e-5 of its leaf's norm. The
  6 steps stay inside the first epoch: the world's 363 captions are odd, so
  no even global batch divides them, and past an epoch the ranks drift out
  of phase as JAX's (``tests/test_torch_parallel.py::
  test_process_shard_drift_mirrors_jax``).
* The detector train CLI (2 images a step as 1 + 1): the losses rtol 1e-5
  and the epoch's checkpoint within 1e-5 of each leaf's norm.
* The inference CLI (2 CPU entries of a decode mesh; 3 z-samples, so the
  groups of 4 images split by batch and the tail group of 3 decodes whole):
  the predictions JSON byte-equal, for CBS, the grounded CBS and a sampler.

The train CLIs run as ``python -m`` in a session of their own, killed with
their ranks at ``TIMEOUT``; the inference CLI, one process, runs in this
one.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_seqcvae_tpu_torch.scripts import inference as inference_cli
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.weights import named_leaves
from tests.test_torch_datasets import write_world
from tests.test_torch_images import write_detection_world
from tests.test_torch_train_data import write_train_world

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240.0
LOSS_RTOL = 1e-5
PARAM_REL = 1e-5


def _cli(module, *args):
    """``python -m module args`` with its ranks in a process group of its
    own, all killed when it outlives ``TIMEOUT``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    for k in ("SSC_COORDINATOR", "SSC_MULTIHOST", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        env.pop(k, None)
    p = subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"{module} {args} outlived {TIMEOUT} s")
    assert p.returncode == 0, out[-3000:]
    return out


def _losses(path, names):
    return [[json.loads(line)[n] for n in names] for line in open(path)]


def _assert_close_params(a, b):
    a, b = dict(named_leaves(a)), dict(named_leaves(b))
    assert a.keys() == b.keys()
    for path, want in b.items():
        err = np.linalg.norm(a[path] - want) / max(np.linalg.norm(want), 1e-12)
        assert err <= PARAM_REL, f"{path}: off by {err:.3g}"


def test_train_cli_two_ranks_equal_one(tmp_path):
    cfg = write_train_world(tmp_path / "w", iterations=6, batch=4)
    runs = {}
    for n in (1, 2):
        ser = tmp_path / f"r{n}"
        _cli("style_seqcvae_tpu_torch.scripts.train", "--config", cfg, "--serialization-dir",
             ser, "--cpu", "--num-data", n, "--config-override", "PRINT_EVERY_N_BATCHES", "1")
        runs[n] = (_losses(ser / "metrics.jsonl", ("loss", "reconstr_loss", "kld_loss")),
                   read_checkpoint(str(ser / "checkpoint_6")))
    (l1, c1), (l2, c2) = runs[1], runs[2]
    assert len(l1) == len(l2) == 6
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    _assert_close_params(c2["params"], c1["params"])
    assert int(c2["opt_state"]["step"]) == 6


def test_detector_cli_two_ranks_equal_one(tmp_path):
    inst, images, attribs, _ = write_detection_world(tmp_path / "w", n_images=4, hw=(72, 96))
    names = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "rcnn_cls_atts", "total")
    runs = {}
    for n in (1, 2):
        ser = tmp_path / f"r{n}"
        _cli("style_seqcvae_tpu_torch.scripts.train_detector", "--instances-json", inst,
             "--image-root", images, "--attribs-dir", attribs, "--serialization-dir", ser,
             "--epochs", "1", "--ims-per-batch", "2", "--canvas", "96", "128", "--depth", "50",
             "--seed", "3", "--cpu", "--num-data", n, "--config-override",
             "DET.TRAIN.SCALES", "[96]", "DET.TRAIN.MAX_SIZE", "128",
             "DET.TRAIN.RPN_PRE_NMS_TOP_N", "300", "DET.TRAIN.RPN_POST_NMS_TOP_N", "40",
             "DET.TRAIN.BATCH_SIZE", "16", "DET.ANCHOR_SCALES", "[1,2,4]",
             "DET.TRAIN.DISPLAY", "1")
        runs[n] = (_losses(ser / "metrics.jsonl", names),
                   read_checkpoint(str(ser / "detector_epoch_1")))
    (l1, c1), (l2, c2) = runs[1], runs[2]
    assert len(l1) == len(l2) == 2 and np.all(np.asarray(l1)[:, -1] > 0)
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    _assert_close_params(c2["params"], c1["params"])


@pytest.mark.parametrize("kind,extra", [("simple_attributes", ()), ("grounded", ()),
                                        ("sentiment", ("--sampler", "topk"))])
def test_inference_cli_two_devices_byte_equal(tmp_path, kind, extra):
    cfg = write_world(tmp_path, kind)
    out = {}
    for n in (1, 2):
        out[n] = tmp_path / f"p{n}.json"
        stats = {}
        assert inference_cli.main(["--config", str(cfg), "--output-path", str(out[n]), "--cpu",
                                   "--batch-images", "4", "--max-images", "7", "--num-data",
                                   str(n), *extra], stats=stats) == 0
        assert stats["images"] == 7 and stats["fallbacks"] == (7 if kind == "grounded" else 0)
    assert out[2].read_bytes() == out[1].read_bytes()
    assert len(json.loads(out[1].read_text())) == 21
