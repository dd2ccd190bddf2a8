"""The port's detector training CLI (``scripts/train_detector.py``) and
detection evaluation CLI (``scripts/eval_detections.py``) against the JAX
CLIs (loaded as modules and unchanged), and alone.

* Both train CLIs in-process on one small PNG world (4 landscape images of
  72 × 96 on a 96 × 128 canvas, 2 a step, ResNet-50, anchor scales (1, 2,
  4), 300 / 40 proposals, 16 RoIs an image, DISPLAY 1), the port's
  ``init_detector`` patched to JAX's ``PRNGKey(seed)`` init and its train
  step handed the uniforms JAX draws from its step keys: the per-step losses
  in ``metrics.jsonl`` within rtol 1e-4 (f32 sums in other orders,
  compounded by SGD over the run). The shuffle and the flips are Python's
  ``random`` on both sides.
* The port CLI alone: ``--steps-per-dispatch 2`` equal to the plain run
  bit for bit; the checkpoint loads (``load_detector_params``) and feeds the
  port's extract CLI (``--detections-output``), whose detections the port's
  ``eval_detections`` scores; the refusal of ``--num-data 2``.
* ``eval_detections``: the port's output JSON equal to the JAX CLI's
  (1e-12) on one detections file; the refusal of ``--vis-dir``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.scripts import eval_detections as TE
from style_seqcvae_tpu_torch.scripts import extract_features as TX
from style_seqcvae_tpu_torch.scripts import train_detector as P
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.weights import (
    from_jax_detector_params,
    load_detector_params,
    named_leaves,
)
from tests.test_torch_detector_train import jax_train_draws
from tests.test_torch_images import write_detection_world

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load("jax_train_detector_cli", "train_detector.py")
JE = _load("jax_eval_detections_cli", "eval_detections.py")

METRIC_RTOL = 1e-4
SEED = 3
OVERRIDES = ["DET.TRAIN.SCALES", "[96]", "DET.TRAIN.MAX_SIZE", "128",
             "DET.TRAIN.RPN_PRE_NMS_TOP_N", "300", "DET.TRAIN.RPN_POST_NMS_TOP_N", "40",
             "DET.TRAIN.BATCH_SIZE", "16", "DET.ANCHOR_SCALES", "[1,2,4]",
             "DET.TRAIN.DISPLAY", "1"]
LOSSES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "rcnn_cls_atts", "total")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_detection_world(tmp_path_factory.mktemp("detworld"), n_images=4, hw=(72, 96))


def _args(world, ser, *extra):
    inst, images, attribs, _ = world
    return ["--instances-json", inst, "--image-root", images, "--attribs-dir", attribs,
            "--serialization-dir", str(ser), "--epochs", "1", "--ims-per-batch", "2",
            "--canvas", "96", "128", "--depth", "50", "--seed", str(SEED), "--cpu", *extra,
            "--config-override", *OVERRIDES]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _c4(n):
    """The C4 map's size for an input side of n (conv1, the ceil max-pool,
    two stride-2 stages)."""
    n = (n + 6 - 7) // 2 + 1
    n = -(-(n - 3) // 2) + 1
    return (n - 1) // 4 + 1


def test_port_cli_losses_match_jax_cli(world, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_detector.py", *_args(world, tmp_path / "jax")])
    J.main()

    def jax_init(cfg, seed, device):
        jcfg = jfr.DetectorConfig(num_classes=cfg.num_classes,
                                  num_att_classes=cfg.num_att_classes, depth=cfg.depth,
                                  anchor_scales=cfg.anchor_scales,
                                  anchor_ratios=cfg.anchor_ratios)
        tree = jit_init(jfr.init_detector, jcfg, jax.random.PRNGKey(seed))
        return from_jax_detector_params(jax.tree_util.tree_map(np.asarray, tree),
                                        device=device)

    key = jax.random.PRNGKey(SEED + 1)
    port_make_train_step = P.make_train_step

    def make_train_step(det_cfg, opt, bf16=False, mesh=None):
        step = port_make_train_step(det_cfg, opt, bf16, mesh)

        def with_jax_draws(params, batch, _generator):
            nonlocal key
            key, k = jax.random.split(key)
            b, h, w, _ = batch["images"].shape
            draws = jax_train_draws(k, b, _c4(h) * _c4(w) * det_cfg.num_anchors,
                                    det_cfg.rpn.post_nms_top_n, det_cfg.pt.rois_per_image)
            return step(params, batch, draws)

        return with_jax_draws

    monkeypatch.setattr(P, "init_detector", jax_init)
    monkeypatch.setattr(P, "make_train_step", make_train_step)
    stats = {}
    assert P.main(_args(world, tmp_path / "port"), stats=stats) == 0
    assert stats["steps"] == 2 and stats["step_ms"] > 0
    jrows = _rows(tmp_path / "jax" / "metrics.jsonl")
    trows = _rows(tmp_path / "port" / "metrics.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [1, 2]
    for j, t in zip(jrows, trows):
        for name in LOSSES:
            np.testing.assert_allclose(t[name], j[name], rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {t['step']} {name}")
    assert all(j["rcnn_box"] > 0 or j["step"] == 1 for j in jrows)


def test_port_cli_chained_checkpoint_extract_and_eval(world, tmp_path, capsys):
    plain, chained = tmp_path / "k1", tmp_path / "k2"
    assert P.main(_args(world, plain)) == 0
    assert P.main(_args(world, chained, "--steps-per-dispatch", "2")) == 0
    a = dict(named_leaves(read_checkpoint(str(plain / "detector_epoch_1"))))
    b = dict(named_leaves(read_checkpoint(str(chained / "detector_epoch_1"))))
    assert a.keys() == b.keys() and int(a["opt_state/step"]) == 2
    assert any(k.startswith("opt_state/trace/") for k in a)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    # the checkpoint loads, and the extract CLI reads it for detections
    params = load_detector_params(str(plain / "detector_epoch_1"), device="cpu")
    assert params["resnet"]["layer3"][0]["conv1"].shape == (256, 512, 1, 1)
    torch.testing.assert_close(params["cls_score"]["w"], torch.from_numpy(
        a["params/cls_score/w"]), rtol=0, atol=0)
    inst, images, attribs, _ = world
    dets = tmp_path / "dets.json"
    assert TX.main(["--instances-json", inst, "--image-root", images, "--attribs-dir", attribs,
                    "--checkpoint-path", str(plain / "detector_epoch_1"), "--depth", "50",
                    "--canvas", "96", "128", "--batch-size", "2", "--thresh", "0.0",
                    "--output", str(tmp_path / "f.h5"), "--detections-output", str(dets),
                    "--cpu", "--config-override", "DET.TEST.SCALES", "[96]",
                    "DET.TEST.MAX_SIZE", "128", "DET.ANCHOR_SCALES", "[1,2,4]",
                    "DET.TEST.RPN_PRE_NMS_TOP_N", "64", "DET.TEST.RPN_POST_NMS_TOP_N",
                    "12"]) == 0
    assert json.loads(dets.read_text())
    stats = {}
    capsys.readouterr()
    assert TE.main(["--detections", str(dets), "--instances-json", inst], stats=stats) == 0
    assert "AP50:" in capsys.readouterr().out
    assert 0.0 <= stats["mAP"] <= 1.0 and np.isfinite(stats["AP50"])


def test_port_cli_refuses_data_parallel(world, tmp_path):
    # data parallelism runs since it was ported (tests/test_torch_ddp.py); a
    # step's images must divide over the ranks, and a size must be one
    with pytest.raises(ValueError, match="divisible"):
        P.main(_args(world, tmp_path / "x", "--num-data", "2", "--ims-per-batch", "3"))
    with pytest.raises(ValueError, match="--num-data 0"):
        P.main(_args(world, tmp_path / "x", "--num-data", "0"))


def test_eval_detections_matches_jax_cli(world, tmp_path, monkeypatch):
    inst = world[0]
    gt = json.loads(Path(inst).read_text())
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        for _ in range(3):
            x, y, w, h = a["bbox"]
            j = rng.uniform(-6, 6, 4)
            dets.append({"image_id": a["image_id"],
                         "category_id": int(rng.choice([a["category_id"], 1, 2])),
                         "bbox": [x + j[0], y + j[1], max(w + j[2], 1), max(h + j[3], 1)],
                         "score": float(rng.rand())})
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    common = ["--detections", str(tmp_path / "dets.json"), "--instances-json", inst]
    monkeypatch.setattr(sys, "argv", ["eval_detections.py", *common, "--output",
                                      str(tmp_path / "jax.json")])
    JE.main()
    assert TE.main([*common, "--output", str(tmp_path / "port.json")]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got.keys() == want.keys() and got["AP_per_class"].keys() == want[
        "AP_per_class"].keys()
    assert 0 < want["mAP"] < 1
    for k in ("mAP", "AP50", "AP75"):
        assert abs(got[k] - want[k]) <= 1e-12, k
    for k, v in want["AP_per_class"].items():
        assert abs(got["AP_per_class"][k] - v) <= 1e-12, k
    with pytest.raises(SystemExit):
        TE.main([*common, "--vis-dir", str(tmp_path / "vis"), "--image-root", "x"])
