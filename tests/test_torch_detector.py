"""The port's detector inference path against the JAX package, stage by
stage, at a tiny size (ResNet-50, 5 classes, 7 attributes, anchor scales
(2, 4), 64×96 canvases, pre-NMS 64, post-NMS 12), in f32 on the CPU. Both
sides get the same weights: random numpy leaves in the JAX layout, carried
over by ``from_jax_detector_params``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import detector_defaults
from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector import resnet as jres
from style_seqcvae_tpu.models.detector import rpn as jrpn
from style_seqcvae_tpu.models.detector.anchors import generate_anchors, shifted_anchors
from style_seqcvae_tpu.models.detector.extract import decode_boxes_jax
from style_seqcvae_tpu.models.detector.extract import (
    select_detections_device as j_select_detections_device,
)
from style_seqcvae_tpu_torch.models.detector import defaults
from style_seqcvae_tpu_torch.models.detector import faster_rcnn as tfr
from style_seqcvae_tpu_torch.models.detector import resnet as tres
from style_seqcvae_tpu_torch.models.detector import rpn as trpn
from style_seqcvae_tpu_torch.models.detector.extract import (
    decode_boxes,
    extract_device_features,
    select_detections_device,
)
from style_seqcvae_tpu_torch.weights import from_jax_detector_params

torch.set_num_threads(1)

B, H, W = 2, 64, 96
PRE, POST, MAXB = 64, 12, 6
TEST = defaults.InferenceConfig(rpn_pre_nms_top_n=PRE, rpn_post_nms_top_n=POST,
                                max_per_image=MAXB)
STDS, MEANS = TEST.bbox_normalize_stds, TEST.bbox_normalize_means

# f32 on both sides; XLA's and oneDNN's convolutions sum in other orders, so
# activations differ by a few ulps of their scale after 50 layers (measured
# ~3e-6 on a C4 map of max ~3): 1e-5 relative to each tensor's largest value.
REL_TOL = 1e-5
# decoded boxes are pixel coordinates up to ~100 formed through exp(): a
# few ulps of f32 at that scale.
BOX_TOL = 1e-3


_KW = dict(num_classes=5, num_att_classes=7, depth=50, anchor_scales=(2, 4),
           anchor_ratios=(0.5, 1.0, 2.0))
JCFG = jfr.DetectorConfig(**_KW)
TCFG = tfr.DetectorConfig(**_KW)


def _random_leaves(tree, seed):
    """Every leaf of the JAX params random: He-scaled convs (the stem folds
    in the pixel scale), BatchNorm statistics and affine away from the
    identity, nonzero conv3 (JAX's init zeroes it, which would hide the
    bottleneck's inner convs)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = [p.key for p in path if hasattr(p, "key")][-1]
        if leaf.ndim == 4:
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:3]))
            if leaf.shape[:3] == (7, 7, 3):
                std /= 57.6
            return (rng.randn(*leaf.shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            lo, hi = (0.5, 1.0) if name == "scale" else (0.5, 1.5)
            return rng.uniform(lo, hi, leaf.shape).astype(np.float32)
        if name in ("mean", "offset"):
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if name == "w":
            return (rng.randn(*leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.01).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _gap_at(scores, k):
    """Smallest gap, over rows, between the k-th and (k+1)-th largest score."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)
    return np.inf if s.shape[-1] <= k else float((s[..., k - 1] - s[..., k]).min())


@pytest.fixture(scope="module")
def ref():
    """The JAX reference forward and its intermediates, once per module."""
    init = jax.jit(jfr.init_detector, static_argnums=(1,))
    jparams = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), JCFG))
    jparams = _random_leaves(jparams, seed=1)
    rng = np.random.RandomState(2)
    images = (rng.rand(B, H, W, 3) * 255 - np.asarray(defaults.PIXEL_MEANS)).astype(np.float32)
    im_info = np.tile([float(H), float(W), 1.0], (B, 1)).astype(np.float32)

    @jax.jit
    def stages(p, im, info):
        base = jres.backbone(p["resnet"], im)
        cls, bbox = jrpn.rpn_heads(p["rpn"], base)
        anchors = jnp.asarray(shifted_anchors(
            base.shape[1], base.shape[2], 16, generate_anchors(16, JCFG.anchor_ratios,
                                                               JCFG.anchor_scales)))
        scores = jax.nn.softmax(cls, axis=-1)[..., 1].reshape(im.shape[0], -1)
        out = jfr.detector_forward_test(p, JCFG, im, info, post_nms_top_n=POST,
                                        pre_nms_top_n=PRE)
        return base, cls, bbox, anchors, scores, out

    base, cls, bbox, anchors, rpn_scores, out = jax.tree_util.tree_map(
        np.asarray, stages(jparams, jnp.asarray(images), jnp.asarray(im_info)))
    return dict(jparams=jparams, tparams=from_jax_detector_params(jparams, device="cpu"),
                images=images, im_info=im_info, base=base, cls=cls, bbox=bbox,
                anchors=anchors, rpn_scores=rpn_scores, out=out)


@partial(jax.jit, static_argnums=(2,))
def _jax_select(out, im_info, max_per_image=MAXB):
    """The JAX chain of the bench's end-to-end phase after the forward:
    per image decode_boxes_jax + select_detections_device."""
    def one_image(rois, bbox_pred, cls_prob, pooled, atts, info):
        pred = decode_boxes_jax(rois[:, 1:5], bbox_pred, info, STDS, MEANS, info[2],
                                JCFG.num_classes)
        return pred, j_select_detections_device(cls_prob, pred, pooled, atts, thresh=0.05,
                                                nms_thresh=0.3, max_per_image=max_per_image)

    return jax.vmap(one_image)(out["rois"], out["bbox_pred"], out["cls_prob"],
                               out["pooled_feat"], out["cls_prob_atts"], im_info)


def test_backbone_and_head_to_tail_match_jax(ref):
    """The stride on the 1×1 conv1, the ceil-mode stem pool, frozen BN and
    channels_last convolutions, against the JAX backbone."""
    tp = ref["tparams"]["resnet"]
    base = tres.backbone(tp, _t(ref["images"]))
    assert base.shape == ref["base"].shape == (B, 4, 6, 1024) and base.is_contiguous()
    _close(base.numpy(), ref["base"])

    pooled = np.random.RandomState(3).randn(5, 7, 7, 1024).astype(np.float32)
    want = np.asarray(jres.head_to_tail(ref["jparams"]["resnet"], jnp.asarray(pooled)))
    got = tres.head_to_tail(tp, _t(pooled))
    assert got.shape == (5, 2048)
    _close(got.numpy(), want)


def test_stem_pool_and_strides_on_odd_sizes(ref):
    """An odd canvas: ceil-mode pooling pads only at the end and "SAME" 1×1
    stride-2 convs keep ceil(H/2)."""
    im = np.random.RandomState(4).randn(1, 67, 99, 3).astype(np.float32) * 50
    want = np.asarray(jax.jit(jres.backbone)(ref["jparams"]["resnet"], jnp.asarray(im)))
    got = tres.backbone(ref["tparams"]["resnet"], _t(im))
    assert got.shape == want.shape
    _close(got.numpy(), want)


def test_rpn_heads_match_jax(ref):
    cls, bbox = trpn.rpn_heads(ref["tparams"]["rpn"], _t(ref["base"]))
    assert cls.shape == ref["cls"].shape == (B, 4, 6, 6, 2)
    assert bbox.shape == ref["bbox"].shape == (B, 4, 6, 6, 4)
    _close(cls.numpy(), ref["cls"])
    _close(bbox.numpy(), ref["bbox"])


def test_proposal_layer_matches_jax_on_its_heads(ref):
    """Fed JAX's own heads' outputs, the port keeps the same proposals in
    the same order: identical valid rows, rois equal to f32 rounding."""
    want = jax.tree_util.tree_map(np.asarray, jrpn.proposal_layer(
        jnp.asarray(ref["cls"]), jnp.asarray(ref["bbox"]), jnp.asarray(ref["anchors"]),
        jnp.asarray(ref["im_info"]), pre_nms_top_n=PRE, post_nms_top_n=POST,
        nms_thresh=0.7))
    rois, scores, valid = trpn.proposal_layer(
        _t(ref["cls"]), _t(ref["bbox"]), _t(ref["anchors"]), _t(ref["im_info"]),
        pre_nms_top_n=PRE, post_nms_top_n=POST, nms_thresh=0.7)
    np.testing.assert_array_equal(valid.numpy(), want[2])
    np.testing.assert_allclose(rois.numpy(), want[0], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(scores.numpy(), want[1], rtol=0, atol=1e-6)
    # pre < post: the -1 padding gives zero rows
    r2, s2, v2 = trpn.proposal_layer(
        _t(ref["cls"]), _t(ref["bbox"]), _t(ref["anchors"]), _t(ref["im_info"]),
        pre_nms_top_n=5, post_nms_top_n=POST, nms_thresh=0.7)
    assert (~v2[:, 5:]).all() and (r2[:, 5:, 1:] == 0).all() and (s2[:, 5:] == 0).all()
    np.testing.assert_array_equal(r2[:, :, 0].numpy(), np.arange(B)[:, None] + 0 * r2[:, :, 0].numpy())


def test_detector_forward_matches_jax(ref):
    # premise: the RPN's pre-NMS cut is not a near-tie that rounding could flip
    gap = _gap_at(ref["rpn_scores"], PRE)
    assert gap > 1e-5, f"JAX's RPN scores around the top-{PRE} cut are {gap} apart"
    with torch.inference_mode():
        got = tfr.detector_forward_test(ref["tparams"], TCFG, _t(ref["images"]),
                                        _t(ref["im_info"]), post_nms_top_n=POST,
                                        pre_nms_top_n=PRE)
    want = ref["out"]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    np.testing.assert_allclose(got["rois"].numpy(), want["rois"], rtol=0, atol=BOX_TOL)
    for key in ("cls_prob", "bbox_pred", "cls_prob_atts", "pooled_feat"):
        assert got[key].shape == want[key].shape, key
        _close(got[key].numpy(), want[key])


@pytest.mark.parametrize("thresh", [0.05, 0.1, 0.99])
def test_select_detections_matches_jax(ref, thresh):
    """Fed identical inputs, the batched selection picks what JAX's
    per-image selection picks (0.99: nothing survives, the all-ones row)."""
    out = ref["out"]
    pred = decode_boxes(_t(out["rois"][..., 1:5]), _t(out["bbox_pred"]), _t(ref["im_info"]),
                        STDS, MEANS, _t(ref["im_info"][:, 2]), TCFG.num_classes)
    jpred, _ = jax.tree_util.tree_map(np.asarray, _jax_select(out, ref["im_info"]))
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=0, atol=BOX_TOL)

    def one(i):
        return j_select_detections_device(
            jnp.asarray(out["cls_prob"][i]), jnp.asarray(jpred[i]),
            jnp.asarray(out["pooled_feat"][i]), jnp.asarray(out["cls_prob_atts"][i]),
            thresh=thresh, nms_thresh=0.3, max_per_image=MAXB)

    got = select_detections_device(_t(out["cls_prob"]), _t(jpred), _t(out["pooled_feat"]),
                                   _t(out["cls_prob_atts"]), thresh=thresh,
                                   nms_thresh=0.3, max_per_image=MAXB)
    for i in range(B):
        want = jax.tree_util.tree_map(np.asarray, one(i))
        assert set(got) == set(want) | {"roi_index"}
        for key in want:
            np.testing.assert_array_equal(got[key][i].numpy(), want[key], err_msg=key)
        # roi_index, the port's own output: the RoI each kept detection came from
        ok = got["valid"][i].numpy()
        rows = got["roi_index"][i].numpy()
        assert (rows[~ok] == 0).all()
        np.testing.assert_array_equal(got["features"][i].numpy()[ok],
                                      out["pooled_feat"][i][rows[ok]])
    if thresh == 0.99:
        assert not got["valid"].any() and (got["features"][:, 0] == 1).all()
    if thresh == 0.05:
        assert got["valid"].all()


def test_extract_device_features_matches_jax_chain(ref):
    """End to end from raw canvases, against the JAX chain of the bench's
    end-to-end phase (detector forward, then per image decode_boxes_jax and
    select_detections_device)."""
    _, jsel = jax.tree_util.tree_map(np.asarray, _jax_select(ref["out"], ref["im_info"]))
    # premises: neither the RPN's cut nor the selection's cut among the
    # per-class NMS survivors is a near-tie that rounding could flip
    assert _gap_at(ref["rpn_scores"], PRE) > 1e-5
    _, every = _jax_select(ref["out"], ref["im_info"], POST * (JCFG.num_classes - 1))
    survivors = np.where(np.asarray(every["valid"]), np.asarray(every["scores"]), -1.0)
    assert (survivors[:, MAXB] > 0).all(), "the selection's cut is not exercised"
    gap = _gap_at(survivors, MAXB)
    assert gap > 1e-5, f"JAX's detection scores around the top-{MAXB} cut are {gap} apart"

    got = extract_device_features(ref["tparams"], TCFG, ref["images"], ref["im_info"],
                                  max_boxes=MAXB + 2, test=TEST, device="cpu",
                                  dtype=torch.float32)
    assert got["features"].shape == (B, MAXB + 2, 2048)
    assert got["features"].dtype == torch.float32
    np.testing.assert_array_equal(got["valid"][:, :MAXB].numpy(), jsel["valid"])
    assert not got["valid"][:, MAXB:].any() and (got["features"][:, MAXB:] == 0).all()
    np.testing.assert_array_equal(got["class_ids"][:, :MAXB].numpy(), jsel["class_ids"])
    _close(got["features"][:, :MAXB].numpy(), jsel["features"])
    _close(got["scores"][:, :MAXB].numpy(), jsel["scores"])
    _close(got["att_scores"][:, :MAXB].numpy(), jsel["att_scores"])
    np.testing.assert_allclose(got["boxes"][:, :MAXB].numpy(), jsel["boxes"], rtol=0,
                               atol=BOX_TOL)
    bf = extract_device_features(ref["tparams"], TCFG, ref["images"], ref["im_info"],
                                 max_boxes=MAXB, test=TEST, device="cpu")
    assert bf["features"].dtype == torch.bfloat16
    assert torch.equal(bf["features"], got["features"][:, :MAXB].to(torch.bfloat16))


def test_from_jax_detector_params_layout(ref):
    """Same nesting and shapes as the port's own init, conv kernels
    HWIO → OIHW in channels_last memory, every other leaf unchanged."""
    jp, tp = ref["jparams"], ref["tparams"]
    mine = tfr.init_detector(TCFG, seed=0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(tp)[0]
    ml = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in ml]
    for (path, a), (_, b) in zip(jl, ml):
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(path)
    conv = tp["resnet"]["layer2"][0]["conv2"]
    assert conv.shape == (128, 128, 3, 3)
    assert conv.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(conv.permute(2, 3, 1, 0).numpy(),
                                  jp["resnet"]["layer2"][0]["conv2"])
    np.testing.assert_array_equal(tp["resnet"]["layer2"][0]["downsample"]["bn"]["var"].numpy(),
                                  jp["resnet"]["layer2"][0]["downsample"]["bn"]["var"])
    np.testing.assert_array_equal(tp["cls_score_atts"]["w"].numpy(), jp["cls_score_atts"]["w"])
    assert "downsample" not in tp["resnet"]["layer1"][1]
    half = from_jax_detector_params({"resnet": {"conv1": jp["resnet"]["conv1"]}},
                                    device="cpu", dtype=torch.bfloat16)
    assert half["resnet"]["conv1"].dtype == torch.bfloat16
    assert half["resnet"]["conv1"].shape == (64, 3, 7, 7)


def test_defaults_match_jax_config():
    """The copied constants equal the JAX package's ``DET`` tree."""
    D = detector_defaults()
    assert defaults.InferenceConfig() == defaults.InferenceConfig(
        rpn_pre_nms_top_n=D.TEST.RPN_PRE_NMS_TOP_N, rpn_post_nms_top_n=D.TEST.RPN_POST_NMS_TOP_N,
        rpn_nms_thresh=D.TEST.RPN_NMS_THRESH, nms_thresh=D.TEST.NMS,
        max_per_image=D.TEST.MAX_PER_IMAGE,
        bbox_normalize_means=tuple(D.TRAIN.BBOX_NORMALIZE_MEANS),
        bbox_normalize_stds=tuple(D.TRAIN.BBOX_NORMALIZE_STDS))
    assert defaults.PIXEL_MEANS == tuple(D.PIXEL_MEANS)
    assert (defaults.POOLING_MODE, defaults.POOLING_SIZE, defaults.FEAT_STRIDE) == (
        D.POOLING_MODE, D.POOLING_SIZE, D.FEAT_STRIDE)
    assert defaults.ANCHOR_SCALES == tuple(D.ANCHOR_SCALES)
    assert defaults.ANCHOR_RATIOS == tuple(D.ANCHOR_RATIOS)
    # since detector training is ported, the config has JAX's fields and
    # defaults, the RPN's and the RoI sampler's training settings included
    t, j = tfr.DetectorConfig(), jfr.DetectorConfig()
    assert tfr.DetectorConfig._fields == jfr.DetectorConfig._fields
    assert t.rpn._fields == j.rpn._fields and t.pt._fields == j.pt._fields
    assert tuple(t.rpn) == tuple(j.rpn) and tuple(t.pt) == tuple(j.pt)
    assert t._replace(rpn=None, pt=None) == tuple(j._replace(rpn=None, pt=None))


@pytest.mark.parametrize("change", [dict(backbone="vgg16"), dict(pooling_mode="crop"),
                                    dict(pooling_mode="pool")])
def test_unported_options_raise(change):
    """The options that raised before they were ported (VGG16, crop, pool)
    now initialise; VGG16 has no attribute head, as JAX's, and says so."""
    cfg = TCFG._replace(**change)
    if change.get("backbone") == "vgg16":
        with pytest.raises(ValueError, match="no attribute head"):
            tfr.init_detector(cfg, device="cpu")
        cfg = cfg._replace(num_att_classes=0)
    params = tfr.init_detector(cfg, device="cpu")
    assert ("vgg" in params) == (change.get("backbone") == "vgg16")
    assert from_jax_detector_params({"vgg": {}}, device="cpu") == {"vgg": {}}
