"""The images-to-captions cell's pieces on the CPU: the generator, the
weight maker's draws at a small size, the counts of kernels C and D against
hand counts, and the new readers on a hand-made Chrome trace (times in
microseconds)."""

import json

import pytest
import torch

from benchmark import core, flops_detector, generate_images, peaks, pipeline_spans, spans
from benchmark.drivers import images_to_captions as drv
from benchmark.tracing import Trace
from conftest import ROOT

SEED = 2 ** 31 + 4242
SMALL = dict(vocab_size=300, embedding_size=300, hidden_size=24, attention_projection_size=16,
             z_space=8, max_caption_length=6, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=24,
             max_boxes=16, image_target_size=120, image_max_size=200, num_att_classes=20)
TRAFFIC = dict(images_per_group=3, image_hw=[96, 128], image_cell=16, canvas_hw=[128, 160],
               n_z=4, check_units=2)


@pytest.fixture(scope="module")
def files():
    cfg = json.loads((ROOT / "benchmark/configs/frcnn_r101_ssc.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/images_groups_bf16.json").read_text())
    return {**cfg, **SMALL}, {**traffic, **TRAFFIC}


def test_the_same_seed_and_index_give_the_same_group(files):
    cfg, traffic = files
    cpu = torch.device("cpu")
    a = generate_images.images_groups(traffic, cfg, SEED, 3, cpu)
    b = generate_images.images_groups(traffic, cfg, SEED, 3, cpu)
    c = generate_images.images_groups(traffic, cfg, SEED, 4, cpu)
    assert a["images"].dtype == torch.uint8 and a["images"].shape == (3, 96, 128, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["images"], c["images"])
    assert a["gumbel"].shape == (4, 3, 3, 20) and a["noise"].shape == (4, 6, 3, 1, 1, 8)
    assert set(a["sentiment"].flatten().tolist()) <= {-1.0, 1.0}
    # structure, not noise: neighbouring pixels agree far better than
    # pixels far apart
    im = a["images"].float()
    near = (im[:, 1:] - im[:, :-1]).abs().mean()
    far = (im[:, 48:] - im[:, :48]).abs().mean()
    assert near < far / 3


def test_the_wordform_table(files):
    cfg, _ = files
    t = generate_images.wordform_table(cfg, SEED)
    used = t["tokens"][t["valid"]]
    assert t["tokens"].shape == (20, 2) and t["valid"][:, 0].all()
    assert len(set(used.tolist())) == used.size and used.min() >= 2 and used.max() < 300
    assert t["selectable"].all() and (t["canonical"] == range(20)).all()
    again = generate_images.wordform_table(cfg, SEED)
    assert (again["tokens"] == t["tokens"]).all()


def test_the_draws_give_detections_and_three_constraints(files):
    """The weight maker's heads: every image keeps detections above 0.05
    (the median at the cap) and gets all three constraints (f32 here: the
    draws, not the rounding, decide it)."""
    cfg, traffic = files
    d = drv.Driver(cfg, {**traffic, "dtype": "float32"}, SEED, torch.device("cpu"))
    d.start()
    d.unit(0)
    r = d.records[0]
    kept = r["valid"].sum(dim=1)
    assert (kept > 0).all() and kept.median() == cfg["max_boxes"]
    assert (r["scores"][r["valid"]] > cfg["score_thresh"]).all()
    assert ((r["att_ids"] >= 0).sum(dim=-1) == 3).float().mean() >= 0.9


def test_kernel_c_counts_by_hand():
    got = flops_detector.roi_align_call(2, 3, 4, 8, 5, 7, 2, "bfloat16")
    # the map 2·3·4·8 read once and 5·7·7·8 written once, 2 bytes each; a
    # multiply-add per corner (4), sample (2·2), bin (7·7), channel and RoI
    assert got == {"ops": 2.0 * 5 * 49 * 4 * 4 * 8, "bytes": 2.0 * (2 * 3 * 4 * 8 + 5 * 49 * 8),
                   "dtype": "float32"}
    # the bound of PERF.md's kernel table: (16, 38, 58, 1024), 4,800 RoIs
    c = flops_detector.roi_align_call(16, 38, 58, 1024, 4800, 7, 2, "float32")
    assert peaks.bound_s(c["ops"], c["bytes"], c["dtype"]) == pytest.approx(0.331e-3, rel=2e-3)


def test_kernel_d_counts_by_hand():
    got = flops_detector.nms_call(2, 70, 9)
    # 70 boxes: two mask words a row; rows 0-63 read both, rows 64-69 one
    assert got["ops"] == 15.0 * 2 * 70 * 69 / 2
    assert got["bytes"] == 2.0 * (8 * (64 * 2 + 6) + 16 * 70 + 4 * 9 + 70)
    rpn = flops_detector.nms_call(16, 6000, 300)
    per_class = flops_detector.nms_call(1280, 300, 300)
    assert peaks.bound_s(rpn["ops"], rpn["bytes"], "float32") == pytest.approx(0.0645e-3, rel=2e-3)
    assert peaks.bound_s(per_class["ops"], per_class["bytes"], "float32") == \
        pytest.approx(0.0129e-3, rel=5e-3)


def test_detector_counts_by_hand():
    cfg = dict(depth=101, num_anchors=12, num_classes=81, num_att_classes=196, pooling_size=7)
    got = flops_detector.detector_flops(cfg, 608, 928, 300)
    # the C4 map of a 608 × 928 canvas is 38 × 58
    assert flops_detector.backbone_flops(101, 608, 928)[1:] == (38, 58)
    assert got["rpn"] == 2 * 38 * 58 * (1024 * 512 * 9 + 512 * 72)
    # layer4 on 7 × 7 → 4 × 4: the first block's 1×1 (stride 2), 3×3, 1×1
    # and downsample, then two blocks of 2048 → 512 → 512 → 2048
    first = 2 * 16 * (1024 * 512 + 512 * 512 * 9 + 512 * 2048 + 1024 * 2048)
    rest = 2 * 2 * 16 * (2048 * 512 + 512 * 512 * 9 + 512 * 2048)
    assert got["roi_head"] == 300 * (first + rest + 2 * 2048 * (81 + 324 + 196))
    assert 150e9 < got["backbone"] < 158e9


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def launch(ts, corr):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def kernel(name, ts, dur, corr):
    return ev("kernel", name, ts, dur, tid=7, correlation=corr)


# two groups: prepare, detect (backbone, rpn, roi_head, select), constrain, decode
EVENTS = [span("bench.window", 0, 1000)]
for g, t0 in enumerate((0, 500)):
    c = 10 * g
    EVENTS += [
        span(pipeline_spans.PREPARE, t0 + 10, 20), launch(t0 + 12, c + 1),
        span(pipeline_spans.DETECT, t0 + 40, 200),
        span(pipeline_spans.BACKBONE, t0 + 45, 50), launch(t0 + 50, c + 2),
        span(pipeline_spans.RPN, t0 + 100, 40), launch(t0 + 110, c + 3),
        span(pipeline_spans.ROI_HEAD, t0 + 150, 40), launch(t0 + 160, c + 4),
        span(pipeline_spans.SELECT, t0 + 200, 30), launch(t0 + 210, c + 5),
        span(pipeline_spans.CONSTRAIN, t0 + 250, 20), launch(t0 + 255, c + 6),
        span(spans.DECODE, t0 + 280, 150), launch(t0 + 300, c + 7),
        kernel("prep", t0 + 14, 4, c + 1),
        kernel("conv", t0 + 52, 40, c + 2),
        kernel("nms_bitmask_kernel", t0 + 112, 6, c + 3),
        kernel("void roi_align_kernel<bf16, true>", t0 + 162, 8, c + 4),
        kernel("nms_scan_kernel<128>", t0 + 212, 2, c + 5),
        kernel("argmax", t0 + 257, 1, c + 6),
        kernel("gemm", t0 + 302, 100, c + 7),
    ]
COUNTERS = {"groups": 2,
            "pipeline_ops": {"bfloat16": 989e12 * 250e-6},
            "kernel_calls": {
                "roi_align": {"launches": 2, "ops": 0.0, "bytes": 3.35e12 * 4e-6,
                              "dtype": "float32"},
                "nms": [{"launches": 2, "ops": 67e12 * 1e-6, "bytes": 0.0, "dtype": "float32"},
                        {"launches": 2, "ops": 0.0, "bytes": 3.35e12 * 1e-6,
                         "dtype": "float32"}]}}


def read(name, events=EVENTS, counters=COUNTERS):
    run = core.Run(cell="frcnn_images_to_captions_bf16", unit_items="captions",
                   window_s=1000e-6, units=2, counters=counters,
                   trace=Trace(events) if events is not None else None)
    return core.reader(name)(run)


@pytest.mark.parametrize("name, want_us", [
    ("device_ms_per_group.backbone", 40),
    ("device_ms_per_group.rpn", 6),
    ("device_ms_per_group.roi_head", 8),
    ("device_ms_per_group.det_select", 2),
    ("device_ms_per_group.caption", 100),
])
def test_a_group_counts_the_kernels_launched_in_its_span(name, want_us):
    assert read(name) == pytest.approx(want_us * 1e-3)


def test_the_rooflines_and_shares():
    # C: 2 launches × 4 µs bound over 16 µs; D: 2 × (1 + 1) µs over 16 µs
    assert read("roi_align_roofline") == pytest.approx(50.0)
    assert read("nms_roofline") == pytest.approx(25.0)
    # busy 2 × (4 + 40 + 6 + 8 + 2 + 1 + 100) µs of 1000: the decode cells'
    # reader takes this cell's trace as it is
    assert read("device_idle.captions") == pytest.approx(100 * (1 - 322 / 1000))
    assert read("mfu.pipeline") == pytest.approx(25.0)


def test_the_stages_cover_every_kernel_of_the_groups():
    t = Trace(EVENTS)
    took = pipeline_spans.kernel_time_in(t, pipeline_spans.STAGES)
    assert took == pytest.approx(t.device_time(lambda n: True))


@pytest.mark.parametrize("name", ["device_ms_per_group.backbone", "device_ms_per_group.rpn",
                                  "device_ms_per_group.roi_head",
                                  "device_ms_per_group.det_select",
                                  "device_ms_per_group.caption", "roi_align_roofline",
                                  "nms_roofline"])
def test_nothing_to_read(name):
    # no trace; a trace without the program's spans or kernels (a parent
    # without them, a CPU run)
    assert read(name, events=None) is None
    bare = [span("bench.window", 0, 1000), launch(10, 1), kernel("gemm", 12, 5, 1)]
    assert read(name, events=bare) is None
    assert read(name, events=[span("bench.window", 0, 1000)]) is None


def test_the_decode_readers_take_the_counters_of_the_cell(files):
    """The driver counts the decode as the decode cells' driver does, so
    their readers (kernel A's roofline, the decode's MFU) read this cell."""
    cfg, traffic = files
    d = drv.Driver(cfg, {**traffic, "dtype": "float32"}, SEED, torch.device("cpu"))
    d.start()
    d.units = 2
    got = d.counters()
    assert got["decode_steps"] == 2 * cfg["max_caption_length"]
    assert got["model_ops"]["float32"] == 2 * flops_detector.decode_flops(cfg, traffic)
    a = got["kernel_calls"]["vocab_topk_lse"]
    assert a["launches"] == 0 and a["dtype"] == "float32"
    rows = 3 * 4 * 8 * cfg["beam_size"]
    assert a["ops"] == 2.0 * rows * cfg["vocab_size"] * cfg["embedding_size"]
    # 2 launches of a 1 µs bound over 8 µs of the kernel
    calls = {**COUNTERS, "model_ops": {"bfloat16": 989e12 * 100e-6},
             "kernel_calls": {"vocab_topk_lse": {"launches": 2, "ops": 989e12 * 1e-6,
                                                 "bytes": 0.0, "dtype": "bfloat16"}}}
    events = EVENTS + [launch(320, 99), kernel("vocab_topk_lse_sm90", 330, 8, 99)]
    assert read("vocab_topk_lse_roofline", events, calls) == pytest.approx(25.0)
    assert read("mfu.captions", events, calls) == pytest.approx(10.0)


def test_a_proposal_misses_by_the_score_of_its_nearest_anchor_boxes():
    boxes = torch.tensor([[0.0, 0, 99, 99], [4, 4, 103, 103], [200, 200, 299, 299],
                          [400, 0, 499, 99]])
    scores = torch.tensor([0.5, 0.9, 0.8, 0.1])
    # the 2nd best is 0.8; each proposal takes its own anchor's score,
    # however near a better one lies (the first box, 4 pixels off the second)
    assert drv.rank_misses(boxes[1:3], boxes, scores, 2) == 0
    assert drv.rank_misses(boxes[:1], boxes, scores, 2) == 1
    assert drv.rank_misses(boxes, boxes, scores, 2) == 2
    # RANK_MARGIN below the cut still counts as among the best
    assert drv.rank_misses(boxes[3:], boxes, torch.tensor([0.5, 0.9, 0.8, 0.795]), 2) == 0
    # a box off its anchor's by rounding still finds it; an anchor within
    # MATCH_SLACK more ties, and the better score counts
    assert drv.rank_misses(boxes[1:2] + 0.01, boxes, scores, 2) == 0
    twin = torch.cat([boxes, boxes[:1] + 0.3])
    assert drv.rank_misses(boxes[:1], twin, torch.cat([scores, torch.tensor([0.95])]), 2) == 0
    # a box far from every anchor takes the nearest (the last, 0.1)
    assert drv.rank_misses(torch.tensor([[430.0, 0, 529, 99]]), boxes, scores, 2) == 1
    assert drv.rank_misses(boxes[:0], boxes, scores, 2) == 0


def test_only_proposals_inside_the_image_are_ranked():
    info = torch.tensor([600.0, 800.0, 1.25])
    boxes = torch.tensor([[10.0, 10, 100, 100], [0, 10, 100, 100], [10, 10, 799, 100],
                          [10, 10, 100, 599], [10, 0, 100, 100], [1, 1, 798, 598]])
    assert drv.inner(boxes, info).tolist() == [True, False, False, False, False, True]
