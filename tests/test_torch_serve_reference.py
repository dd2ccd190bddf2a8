"""The port's serving chain as ``scripts/serve.py`` runs it
(``data/detection.py::prepare_image`` for each image, then
``serving.make_serve_fn``'s ``detect``, ``constrain``, ``caption``) against
the benchmark's plain references (``benchmark/reference/detector.py`` and
``captioner.py``) on the CPU, at a small size in f32 on seeded weights: a
ResNet-101 C4 detector on a narrow canvas with few proposals, a small
vocabulary. The benchmark's driver
(``benchmark/drivers/images_to_captions.py``) runs the chain as its timed
unit and measures the same gaps in its check, which these tests also show
failing on a broken proposal stage. Also the chain's spans
(``utils/tracing.py``) under ``torch.profiler``."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import generate_images, pipeline_spans
from benchmark.drivers import images_to_captions as drv
from benchmark.reference import detector as dref
from style_seqcvae_tpu_torch.data.detection import prepare_image
from style_seqcvae_tpu_torch.models.detector import resnet
from style_seqcvae_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 2024
# the cell's configuration with a small vocabulary, captioner and canvas:
# every width of the detector as published, fewer proposals and attributes,
# and anchors of 16 and 32 pixels, so that on the small canvas their boxes
# stay apart as the published anchors' do on the cell's
SMALL = dict(vocab_size=300, embedding_size=300, hidden_size=24, attention_projection_size=16,
             z_space=8, max_caption_length=6, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=24,
             max_boxes=16, image_target_size=120, image_max_size=200, num_att_classes=20,
             anchor_scales=[1, 2], num_anchors=6)
TRAFFIC = dict(dtype="float32", images_per_group=2, image_hw=[96, 128], image_cell=16,
               canvas_hw=[128, 160], n_z=3, check_units=2)


def _files():
    cfg = json.loads((ROOT / "benchmark/configs/frcnn_r101_ssc.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/images_groups_bf16.json").read_text())
    return {**cfg, **SMALL}, {**traffic, **TRAFFIC}


@pytest.fixture(scope="module")
def chain():
    """Two groups through the chain, the first once more under the
    profiler and the second with ``record_function`` replaced by a spy."""
    cfg, traffic = _files()
    d = drv.Driver(cfg, traffic, SEED, torch.device("cpu"))
    d.start()
    d.unit(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d.traced = d._serve(0)
    d.events = [e for e in prof.events() if e.name.startswith("ssc.")]
    d.entered = []
    real = torch.profiler.record_function
    torch.profiler.record_function = lambda name, *a, **k: d.entered.append(name) or real(name)
    try:
        d.unit(1)
    finally:
        torch.profiler.record_function = real
    return d


def test_the_c4_map_is_the_reference_backbones(chain):
    """101 layers of f32 convolutions, summed in other orders by the
    channels_last and the plain layout, and BN as a product with rsqrt
    against a division by sqrt: a few ulps of the map's largest value."""
    x = generate_images.images_groups(chain.traffic, chain.cfg, SEED, 0, torch.device("cpu"))
    canvas, _ = chain._canvases(x["images"])
    w = dref.make_weights(chain.cfg, drv.generate.sub_seed(SEED, generate_images.DETECTOR_WEIGHTS),
                          "cpu", torch.float32)
    with torch.inference_mode():
        got = resnet.backbone(chain.det_params["resnet"], canvas)
        want = dref.backbone(w, chain.cfg, canvas).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 8, 10, 1024)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5
    assert 0.3 < want.std().item() < 10.0            # unit order through the 101 layers


@pytest.fixture(scope="module")
def gaps(chain):
    chain.release()
    return chain.readings(2, ["program"], [])["program"]


def test_proposals_detections_and_constraints_are_the_references(gaps):
    """Discrete choices in f32: the same proposals (the reference's own RPN
    and NMS), the same detections on them (its per-class NMS and top
    detections) and the same constraint picks (its plain pick on the
    program's detections, with the same Gumbel draw)."""
    assert gaps["proposal_miss"] == 0.0
    assert gaps["detection_miss"] == 0.0
    assert gaps["constraint_mismatch"] == 0.0
    # what ties cannot break: no kept pair past the NMS threshold, the
    # reference's count kept, each proposal among the reference's best
    # (f32 log-odds of the same products, summed in other orders)
    assert gaps["proposal_overlap"] == 0.0 and gaps["proposal_short"] == 0.0
    assert gaps["proposal_rank_miss"] == 0.0


def test_features_scores_and_log_probs_are_the_references(gaps):
    """Continuous values in f32. Features: RoIAlign as bilinear taps against
    the reference's row and column weight products, then layer4; a few
    ulps of the image's largest feature. Scores: probabilities of products
    over 2,048, to ~1e-6. Log-probs: 6 steps of teacher forcing through the
    reference's step (its products unfolded), sums of log-softmax terms of
    order 10, to ~1e-4."""
    assert gaps["feat_gap"] < 1e-5
    assert gaps["score_gap"] < 1e-5
    assert gaps["lp_gap"] < 2e-4
    # the canvases: float64 taps against float64 products, one f32 ulp of
    # the largest mean-subtracted pixel (~150)
    assert gaps["canvas_gap"] <= 2 ** -16


def test_the_control_fails_where_the_program_passes(chain, gaps):
    """The reference in fp8 in the program's place: its features and
    log-probs miss by far more than the program's f32 rounding."""
    got = chain.readings(1, ["fp8"], [])["fp8"]
    assert got["feat_gap"] > 100 * max(gaps["feat_gap"], 1e-7)
    assert got["lp_gap"] > 100 * max(gaps["lp_gap"], 1e-6)
    assert got["canvas_gap"] > 100 * max(gaps["canvas_gap"], 1e-6)
    # greedy NMS's invariant and count hold at any precision
    assert got["proposal_overlap"] == 0.0 and got["proposal_short"] == 0.0


def _broken(chain, change):
    """The check's numbers of group 1's record with its proposals changed
    by ``change(rois, roi_valid)``, in place."""
    with torch.inference_mode():
        x = generate_images.images_groups(chain.traffic, chain.cfg, SEED, 1,
                                          torch.device("cpu"))
        w_det, w_cap = chain.reference_weights()
        rec = chain.program_record(1, x)
        change(rec["rois"], rec["roi_valid"])
        return chain.compare(w_det, w_cap, chain.reference_group(w_det, x), x, rec)


def test_the_check_sees_an_nms_that_keeps_overlapping_boxes(chain):
    def overlap(rois, valid):
        rois[:, 1] = rois[:, 0]                 # a box kept twice
    got = _broken(chain, overlap)
    assert got["overlap"][0] == 2 and got["short"] == [0, 2]


def test_the_check_sees_proposals_from_the_wrong_anchors(chain):
    def worst(rois, valid):
        # the image's lowest-scoring anchor boxes in the proposals' place
        ref = chain.reference_group(chain.reference_weights()[0], generate_images.images_groups(
            chain.traffic, chain.cfg, SEED, 1, torch.device("cpu")))
        for b in range(rois.shape[0]):
            low = ref["anchors"]["scores"][b].argsort()[:rois.shape[1]]
            rois[b, :, 1:5] = ref["anchors"]["boxes"][b][low]
    got = _broken(chain, worst)
    assert got["rank"][0] > got["rank"][1] / 2


def test_the_check_sees_an_nms_that_keeps_too_few(chain):
    def few(rois, valid):
        valid[0, 20:] = False
        rois[0, 20:] = 0.0
    assert _broken(chain, few)["short"] == [1, 2]


def test_the_records_are_the_captions_of_each_group(chain):
    r = chain.records[1]
    assert r["best"].shape == (3, 2, 6) and r["lp"].shape == (3, 2)
    assert r["features"].shape == (2, 16, 2048) and r["rois"].shape == (2, 24, 5)
    assert r["roi_valid"].shape == (2, 24) and r["roi_valid"][:, 0].all()
    # every image got detections, and its roi_index points at their RoIs
    assert r["valid"].any(dim=1).all()
    assert (r["roi_index"][~r["valid"]] == 0).all() and (r["roi_index"] < 24).all()


def test_the_chain_opens_each_span_once_with_its_parent(chain):
    got = Counter(e.name for e in chain.events)
    for name in tracing.SERVE_NAMES:
        # each image is prepared on its own, as serve.py prepares a request
        assert got[name] == (2 if name == tracing.PREPARE else 1), name
    assert got[tracing.DECODE_CBS] == 1
    parents = {e.name: e.cpu_parent.name if e.cpu_parent is not None else None
               for e in chain.events}
    for child in (tracing.DETECT_BACKBONE, tracing.DETECT_RPN, tracing.DETECT_ROI_HEAD,
                  tracing.DETECT_SELECT):
        assert parents[child] == tracing.DETECT
    for stage in (tracing.PREPARE, tracing.DETECT, tracing.CONSTRAIN, tracing.DECODE_CBS):
        assert not (parents[stage] or "").startswith("ssc.")


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(chain):
    plain, traced = chain.records[0], chain.traced
    assert torch.equal(plain["best"], traced["best"]) and torch.equal(plain["lp"], traced["lp"])
    assert torch.equal(plain["features"], traced["features"])


def test_no_range_is_opened_with_the_profiler_off(chain):
    # the port opens none; the benchmark's own decode span is ungated
    assert chain.entered == ["bench.decode"]
    assert tracing.span(tracing.DETECT) is tracing.span(tracing.PREPARE)


def test_the_readers_look_for_the_names_the_port_emits():
    assert pipeline_spans.NAMES == tracing.SERVE_NAMES
    assert (pipeline_spans.PREPARE, pipeline_spans.DETECT, pipeline_spans.BACKBONE,
            pipeline_spans.RPN, pipeline_spans.ROI_HEAD, pipeline_spans.SELECT,
            pipeline_spans.CONSTRAIN) == \
        (tracing.PREPARE, tracing.DETECT, tracing.DETECT_BACKBONE, tracing.DETECT_RPN,
         tracing.DETECT_ROI_HEAD, tracing.DETECT_SELECT, tracing.CONSTRAIN)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_the_reference_prepares_as_the_port(dtype):
    """``reference/detector.py::prepare`` (cv2's bilinear rule as two float64
    products) against the port's ``prepare_image`` (float64 taps) on odd
    sizes, upscaled and capped by the longer side: one f32 ulp."""
    imgs = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (3, 37, 53, 3))).to(dtype)
    for target, cap in ((60, 100), (60, 70)):
        canvas, info = dref.prepare(imgs, target, cap, (96, 96))
        for i in range(3):
            want, scale = prepare_image(imgs[i], target, cap)
            h, w = want.shape[:2]
            assert info[i].tolist() == pytest.approx([h, w, scale], rel=1e-7)
            assert (canvas[i, :h, :w] - want).abs().max() <= 2 ** -16
            assert not canvas[i, h:].any() and not canvas[i, :, w:].any()
