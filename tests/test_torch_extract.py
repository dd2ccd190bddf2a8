"""The port's host extraction (``models/detector/extract.py``'s
``select_detections`` and ``extraction_row``, ``ops/boxes.py::
bbox_overlaps``), the detector importers (``utils/torch_import.py``) and
the extract CLI (``scripts/extract_features.py``) against the JAX package,
f32 on the CPU.

The CLI test runs JAX's CLI in-process (``sys.argv`` patched) and the
port's on the same PNG world (ResNet-50, 96 × 128 canvases, ``--thresh
0.05``), the port's weights being JAX's ``PRNGKey(0)`` init handed over as
a ``.npz``. Both forwards sum in other orders, so the premises that make
the streams' order well defined are asserted first: no near-tie at the
RPN's pre-NMS cut, between a class's candidate scores, at the score
threshold, at the NMS threshold between a class's candidates, or at the
GT labels' IoU 0.5.
"""

import importlib.util
import json
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu import native
from style_seqcvae_tpu.models.detector import extract as jext
from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector.rpn import RPNConfig
from style_seqcvae_tpu.ops.boxes import bbox_overlaps as j_bbox_overlaps
from style_seqcvae_tpu.utils import torch_import as jti
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.detection import (
    CocoDetectionDataset,
    load_image_bgr,
    make_batch,
    prepare_image,
)
from style_seqcvae_tpu_torch.models.detector import extract as text
from style_seqcvae_tpu_torch.models.detector import faster_rcnn as tfr
from style_seqcvae_tpu_torch.models.detector import resnet as tres
from style_seqcvae_tpu_torch.models.detector import rpn as trpn
from style_seqcvae_tpu_torch.ops.boxes import bbox_overlaps
from style_seqcvae_tpu_torch.scripts import extract_features as tcli
from style_seqcvae_tpu_torch.utils import torch_import as tti
from style_seqcvae_tpu_torch.weights import (
    from_jax_detector_params,
    load_detector_params,
    save_params_npz,
    to_jax_detector_params,
)
from tests.test_torch_images import write_detection_world

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_extract_cli",
                                               ROOT / "scripts" / "extract_features.py")
JCLI = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JCLI)

# test_torch_detector.py's tolerances: activations 1e-5 of each tensor's
# largest value, decoded boxes (pixel coordinates through exp) 1e-3
REL_TOL = 1e-5
BOX_TOL = 1e-3
# the premises' margin: far above the few-ulp differences of the two forwards
TIE_GAP = 1e-5


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(initial=0.0), 1e-30))


def _selection_inputs(seed, P=40, C=5, A=6, agnostic=False):
    """Clustered boxes (NMS has work), scores with distinct values, pooled
    features, attribute scores, GT labels and GT attribute rows."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 80, (6, 2))
    c = centres[rng.randint(0, 6, P)] + rng.randn(P, 2) * 4
    wh = rng.uniform(8, 30, (P, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    k = 1 if agnostic else C
    pred = np.tile(boxes, (1, k)) + rng.randn(P, 4 * k).astype(np.float32)
    logits = rng.randn(P, C).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return dict(scores=scores.astype(np.float32), pred_boxes=pred.astype(np.float32),
                pooled_feat=rng.randn(P, 16).astype(np.float32),
                scores_atts=rng.rand(P, A).astype(np.float32),
                rois_label=rng.randint(0, C, P), gt_atts=(rng.rand(P, A) > 0.7).astype(np.float32))


SELECT_CASES = {
    "class_specific": dict(thresh=0.05, max_per_image=100),
    "class_agnostic": dict(thresh=0.05, max_per_image=100, class_agnostic=True),
    "nothing_above_thresh": dict(thresh=0.99, max_per_image=100),
    "cap": dict(thresh=0.05, max_per_image=10),
    "cap_with_ties": dict(thresh=0.05, max_per_image=2),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_detections_matches_jax(case):
    kw = SELECT_CASES[case]
    inputs = _selection_inputs(3, agnostic=kw.get("class_agnostic", False))
    if case == "cap_with_ties":
        # every class's best box scores 0.75 and all others less: the cap's
        # threshold score is shared by four classes' boxes, and >= keeps them
        s = inputs["scores"]
        best = s.argmax(axis=0)
        np.minimum(s, 0.7, out=s)
        for j in range(1, s.shape[1]):
            s[best[j], j] = 0.75
    want = jext.select_detections(**inputs, nms_thresh=0.3, **kw)
    got = text.select_detections(**inputs, nms_thresh=0.3, **kw)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    n = len(want["scores"])
    if case == "nothing_above_thresh":
        assert n == 0
    elif case == "cap_with_ties":
        assert n > kw["max_per_image"] and (want["scores"] == 0.75).sum() >= 4
    elif case == "cap":
        assert n == kw["max_per_image"]
    else:
        assert n > 10 and len(set(want["class_ids"].tolist())) > 1
    for with_gt in (True, False):
        sel = got if with_gt else {k: v for k, v in got.items()
                                   if k not in ("gt_labels", "gt_att_rows")}
        ref = want if with_gt else {k: v for k, v in want.items()
                                    if k not in ("gt_labels", "gt_att_rows")}
        for a, b in zip(text.extraction_row(sel, 0.3), jext.extraction_row(ref, 0.3)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bbox_overlaps_matches_jax_and_native():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 50, (30, 2))
    boxes = np.concatenate([a, a + rng.uniform(0, 40, (30, 2))], 1).astype(np.float32)
    b = rng.uniform(0, 50, (7, 2))
    query = np.concatenate([b, b + rng.uniform(0, 40, (7, 2))], 1).astype(np.float32)
    got = bbox_overlaps(torch.from_numpy(boxes), torch.from_numpy(query)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bbox_overlaps(boxes, query)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, native.iou_matrix(boxes, query), rtol=0, atol=1e-6)
    batched = bbox_overlaps(torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
                            torch.from_numpy(np.stack([query, query])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


# ---------------------------------------------------------------- importers


def _jwyang_state_dict(depth=50, num_classes=3, atts=4, anchors=12, seed=0):
    """A synthetic reference state dict (jwyang names, torch layouts) with
    every tensor random, shaped from the port's ResNet tree."""
    rng = np.random.RandomState(seed)
    tree = tres.init_resnet(torch.Generator().manual_seed(0), depth, device="cpu")
    sd = {}

    def conv(name, w):
        sd[name] = torch.from_numpy(rng.randn(*w.shape).astype(np.float32))

    def bn(prefix, n):
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{k}"] = torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5)

    conv("RCNN_base.0.weight", tree["conv1"])
    bn("RCNN_base.1", tree["conv1"].shape[0])
    prefixes = {1: "RCNN_base.4", 2: "RCNN_base.5", 3: "RCNN_base.6", 4: "RCNN_top.0"}
    for li in range(1, 5):
        for bi, block in enumerate(tree[f"layer{li}"]):
            p = f"{prefixes[li]}.{bi}"
            for i in (1, 2, 3):
                conv(f"{p}.conv{i}.weight", block[f"conv{i}"])
                bn(f"{p}.bn{i}", block[f"conv{i}"].shape[0])
            if "downsample" in block:
                conv(f"{p}.downsample.0.weight", block["downsample"]["conv"])
                bn(f"{p}.downsample.1", block["downsample"]["conv"].shape[0])
    for name, shape in (("RCNN_rpn.RPN_Conv", (512, 1024, 3, 3)),
                        ("RCNN_rpn.RPN_cls_score", (2 * anchors, 512, 1, 1)),
                        ("RCNN_rpn.RPN_bbox_pred", (4 * anchors, 512, 1, 1)),
                        ("RCNN_cls_score", (num_classes, 2048)),
                        ("RCNN_bbox_pred", (4 * num_classes, 2048)),
                        ("RCNN_cls_score_atts", (atts, 2048))):
        sd[name + ".weight"] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(rng.randn(shape[0]).astype(np.float32))
    return sd


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert torch.equal(got, want), path


def test_import_detector_state_dict_matches_jax(tmp_path):
    sd = _jwyang_state_dict()
    want = from_jax_detector_params(
        jax.tree_util.tree_map(np.asarray, jti.import_detector_state_dict(sd, depth=50)),
        device="cpu")
    got = tti.import_detector_state_dict(sd, depth=50, device="cpu")
    _assert_trees_equal(got, want)
    # the RPN's class channels: reference (2, A) → the port's (A, 2)
    ref = sd["RCNN_rpn.RPN_cls_score.bias"].numpy()
    np.testing.assert_array_equal(got["rpn"]["cls"]["b"][:2].numpy(), ref[[0, 12]])
    # a .pth through load_detector_params, and the .npz round trip
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, tmp_path / "det.pth")
    _assert_trees_equal(load_detector_params(str(tmp_path / "det.pth"), depth=50,
                                             device="cpu"), want)
    save_params_npz(to_jax_detector_params(got), str(tmp_path / "det.npz"))
    _assert_trees_equal(load_detector_params(str(tmp_path / "det.npz"), device="cpu"), want)
    with pytest.raises(ValueError, match="Orbax"):
        load_detector_params(str(tmp_path), device="cpu")

    resnet_sd = {k.replace("RCNN_base.0", "conv1").replace("RCNN_base.1", "bn1")
                 .replace("RCNN_base.4", "layer1").replace("RCNN_base.5", "layer2")
                 .replace("RCNN_base.6", "layer3").replace("RCNN_top.0", "layer4"): v
                 for k, v in sd.items() if k.startswith(("RCNN_base", "RCNN_top"))}
    want_resnet = from_jax_detector_params(
        {"resnet": jax.tree_util.tree_map(np.asarray,
                                          jti.import_resnet_state_dict(resnet_sd, depth=50))},
        device="cpu")["resnet"]
    _assert_trees_equal(tti.import_resnet_state_dict(resnet_sd, depth=50, device="cpu"),
                        want_resnet)
    _assert_trees_equal(want_resnet, want["resnet"])


# ---------------------------------------------------------------- the CLI


OVERRIDES = ["DET.TEST.SCALES", "[96]", "DET.TEST.MAX_SIZE", "128",
             "DET.TEST.RPN_PRE_NMS_TOP_N", "64", "DET.TEST.RPN_POST_NMS_TOP_N", "12"]
CLI_IMAGES, CLI_BATCH, THRESH = 8, 4, 0.05


def _gap_at(scores, k):
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)
    return np.inf if s.shape[-1] <= k else float((s[..., k - 1] - s[..., k]).min())


def _assert_premises(inst, image_root, attribs, npz):
    """The near-tie premises on the port's own forward of the CLI's batches."""
    C = Config(config_override=OVERRIDES)
    D = C.DET
    ds = CocoDetectionDataset(inst, image_root, "", attribs, exclude_senticap_test=False)
    cfg = tfr.DetectorConfig(num_classes=ds.num_classes, num_att_classes=ds.n_attribs, depth=50)
    params = load_detector_params(str(npz), device="cpu")
    recs = [ds.record(i) for i in range(CLI_IMAGES)]
    for b0 in range(0, CLI_IMAGES, CLI_BATCH):
        prepared = [prepare_image(load_image_bgr(r["file_name"], "cpu"), 96, 128)
                    for r in recs[b0:b0 + CLI_BATCH]]
        batch = make_batch(recs[b0:b0 + CLI_BATCH], [p[0] for p in prepared],
                           [p[1] for p in prepared], (96, 128), D.MAX_NUM_GT_BOXES,
                           ds.n_attribs)
        with torch.inference_mode():
            base = tres.backbone(params["resnet"], batch["images"])
            cls, _ = trpn.rpn_heads(params["rpn"], base)
            rpn_scores = torch.softmax(cls, dim=-1)[..., 1].reshape(CLI_BATCH, -1)
            assert _gap_at(rpn_scores.numpy(), 64) > TIE_GAP
            out = tfr.detector_forward_test(params, cfg, batch["images"], batch["im_info"],
                                            post_nms_top_n=12, pre_nms_top_n=64)
            pred = text.decode_boxes(out["rois"][..., 1:5], out["bbox_pred"], batch["im_info"],
                                     D.TRAIN.BBOX_NORMALIZE_STDS, D.TRAIN.BBOX_NORMALIZE_MEANS,
                                     batch["im_info"][:, 2], ds.num_classes)
            ious = bbox_overlaps(out["rois"][..., 1:5], batch["gt_boxes"][..., :4])
        for b in range(CLI_BATCH):
            n_gt = int(batch["num_gt"][b])
            assert (np.abs(ious[b, :, :n_gt].numpy() - 0.5) > TIE_GAP).all()
            scores = out["cls_prob"][b].numpy()
            assert (np.abs(scores - THRESH) > TIE_GAP).all()
            for j in range(1, ds.num_classes):
                s = np.sort(scores[:, j])
                assert (np.diff(s) > TIE_GAP).all(), f"class {j}'s scores are near-tied"
                cand = pred[b, :, 4 * j:4 * j + 4][torch.from_numpy(scores[:, j] > THRESH)]
                iou = bbox_overlaps(cand, cand).numpy()
                off = ~np.eye(len(cand), dtype=bool)
                assert (np.abs(iou[off] - D.TEST.NMS) > TIE_GAP).all()


def test_extract_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    inst, image_root, attribs, _ = write_detection_world(tmp_path / "world", corrupt=(CLI_IMAGES,))
    # the JAX CLI's detector and weights, handed to the port as a .npz
    ds = CocoDetectionDataset(inst, image_root, "", attribs, exclude_senticap_test=False)
    jcfg = jfr.DetectorConfig(num_classes=ds.num_classes, num_att_classes=ds.n_attribs, depth=50,
                              pooling_mode="align", anchor_scales=(4, 8, 16, 32),
                              anchor_ratios=(0.5, 1, 2), rpn=RPNConfig(anchor_scales=(4, 8, 16,
                                                                                      32)))
    jparams = jit_init(jfr.init_detector, jcfg, jax.random.PRNGKey(0))
    npz = tmp_path / "det.npz"
    save_params_npz(jax.tree_util.tree_map(np.asarray, jparams), str(npz))
    _assert_premises(inst, image_root, attribs, npz)

    common = ["--instances-json", inst, "--image-root", image_root, "--attribs-dir", attribs,
              "--canvas", "96", "128", "--batch-size", str(CLI_BATCH), "--max-images",
              str(CLI_IMAGES + 1), "--depth", "50", "--thresh", str(THRESH), "--cpu",
              "--config-override", *OVERRIDES]
    # the last listed image is the corrupt one: both CLIs write its zero row
    outs = {side: (tmp_path / f"{side}.h5", tmp_path / f"{side}.json") for side in ("jax", "port")}
    monkeypatch.setattr("sys.argv", ["extract_features.py", *common, "--output",
                                     str(outs["jax"][0]), "--detections-output",
                                     str(outs["jax"][1])])
    JCLI.main()
    jax_log = capsys.readouterr().out
    stats = {}
    assert tcli.main([*common, "--checkpoint-path", str(npz), "--output", str(outs["port"][0]),
                      "--detections-output", str(outs["port"][1])], stats=stats) == 0
    port_log = capsys.readouterr().out
    assert "(1 skipped)" in jax_log and "(1 skipped)" in port_log
    assert stats["images"] == CLI_IMAGES + 1 and stats["skipped"] == 1 and stats["batches"] == 2

    with h5py.File(outs["jax"][0], "r") as want, h5py.File(outs["port"][0], "r") as got:
        assert set(got.keys()) == set(want.keys())
        np.testing.assert_array_equal(got["image_id"][:], want["image_id"][:])
        np.testing.assert_array_equal(got["num_boxes"][:], want["num_boxes"][:])
        assert (want["num_boxes"][:CLI_IMAGES] > 1).all()
        for i in range(CLI_IMAGES + 1):
            np.testing.assert_array_equal(got["obj_atts"][i], want["obj_atts"][i])
            _close(got["features"][i], want["features"][i])
            _close(got["obj_atts_det"][i], want["obj_atts_det"][i])
        assert sum(len(want["obj_atts"][i]) for i in range(CLI_IMAGES)) > 0
        assert sum(len(want["obj_atts_det"][i]) for i in range(CLI_IMAGES)) > 0
        assert not want["features"][CLI_IMAGES].any()
    dets = [json.loads(p.read_text()) for p in (outs["jax"][1], outs["port"][1])]
    assert len(dets[0]) == len(dets[1]) > 0
    for a, b in zip(dets[1], dets[0]):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=REL_TOL)


def test_extract_cli_refuses_orbax_names(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["--instances-json", "x.json", "--checkpoint-path", str(tmp_path),
                   "--checkpoint-name", "detector_epoch_1", "--cpu"])
