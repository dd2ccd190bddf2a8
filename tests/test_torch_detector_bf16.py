"""The detector's bf16 compute path against the JAX package's, on the CPU.

Both sides cast every f32 parameter to bf16 and run on bf16 images, as the
detector train CLI's ``--bf16-compute`` does (JAX ``scripts/train_detector.py``
``_compute_cast``; port ``weights.cast_floats``). Each stage is fed JAX's
output of the stage before it, so that rounding does not pile up from stage
to stage, and is checked in dtype and in value:

- one operation on bf16 operands (a convolution, a bottleneck, the RPN's
  heads, RoIAlign's cast) must give the same bf16 number in at least 99% of
  its elements. XLA and oneDNN both sum a convolution in f32 and round once;
  their sums differ in the last f32 bits, which moves an element across a
  bf16 rounding edge in about 0.1% of elements (measured 99.88-100%). A
  rounding taken at another place (a bias added inside the sum instead of
  after it) changes 50-60% of them;
- a chain of bf16 layers (the backbone, ResNet's layer4) within a few bf16
  ulps of the tensor's largest value: each flip above feeds the next layer;
- an f32 result (VGG16's fc6 / fc7, the class, box and attribute heads,
  which JAX computes with ``preferred_element_type=f32``) within 1e-5 of
  its largest value: the products of bf16 values are exact in f32, so only
  the order of the f32 sums differs.

The training step's losses and gradients are compared on proposals handed
to both sides (``proposal_layer`` replaced in both modules), so that the
RPN's near-tied scores, which bf16 makes common, cannot pick other RoIs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector import resnet as jres
from style_seqcvae_tpu.models.detector import rpn as jrpn
from style_seqcvae_tpu.models.detector import targets as jtargets
from style_seqcvae_tpu.models.detector import vgg as jvgg
from style_seqcvae_tpu.ops.roi_align import roi_align as j_roi_align
from style_seqcvae_tpu_torch.models.detector import faster_rcnn as tfr
from style_seqcvae_tpu_torch.models.detector import resnet as tres
from style_seqcvae_tpu_torch.models.detector import rpn as trpn
from style_seqcvae_tpu_torch.models.detector import targets as ttargets
from style_seqcvae_tpu_torch.models.detector import vgg as tvgg
from style_seqcvae_tpu_torch.models.detector.layers import conv_bias, linear_f32
from style_seqcvae_tpu_torch.ops.kernels import roi_align as t_roi_align
from style_seqcvae_tpu_torch.weights import cast_floats, from_jax_detector_params, named_leaves

torch.set_num_threads(1)

BF16 = jnp.bfloat16
B, H, W = 2, 64, 96
NC, NA = 5, 6
SCALES = (2, 4)
# one operation on bf16 operands: share of elements with the same bf16 value
MIN_BIT_EQUAL = 0.99
# a chain of bf16 layers: 8 ulps of bf16 (2^-8 each) of the largest value
CHAIN_TOL = 2.0 ** -5
# an f32 result of the same bf16 operands, summed in another order
F32_TOL = 1e-5
# the training losses in bf16: f32 heads on bf16 features whose rounding
# flips differ (measured up to 1.5e-4)
LOSS_RTOL = 2e-3
# bf16 gradients: JAX's own bf16 gradient lies 0-35% (by norm) from its f32
# gradient, its band. Two causes: XLA's CPU backend sums the transpose of
# each broadcast (a bias, a BatchNorm statistic) in bf16, where PyTorch sums
# in f32 (ResNet's layer4 bn3 leaves: the port's gradient lies within 1.3%
# of JAX's f32 one), and the bf16 rounding of the activations and of the
# gradients carried back through many layers, which both sides share (the
# first layers: within 3-17% of JAX's bf16 one). Each leaf of the port's
# must lie within BAND_FACTOR bands of each of JAX's two gradients (measured
# ratios <= 0.94), and within NEAR_FACTOR bands of the nearer one (measured
# <= 0.57), each plus GRAD_TOL of its norm (the forward's rounding flips,
# measured <= 0.4% where the band is 0). A gradient scaled by 0.7 or 1.3 at
# VGG16's first convolution (band 35%) lies within the band of JAX's bf16
# gradient but fails the other two checks.
BAND_FACTOR = 1.1
NEAR_FACTOR = 0.75
GRAD_TOL = 2e-2
RPN_KW = dict(pre_nms_top_n=200, post_nms_top_n=24, rpn_batch_size=64)
PT_KW = dict(rois_per_image=16, num_classes=NC, fg_thresh=0.25, bg_thresh_hi=0.25)
CASES = [("resnet", 50), ("resnet", 101), ("vgg16", 16)]


def _random_leaves(tree, seed):
    """Every JAX leaf random: He-scaled convs (the stem's folds in the pixel
    scale), BatchNorm away from the identity, nonzero conv3 (JAX's init
    zeroes it) and biases."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = [p.key for p in path if hasattr(p, "key")][-1]
        if leaf.ndim == 4:
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:3]))
            if leaf.shape[:3] in ((7, 7, 3), (3, 3, 3)):
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


def _configs(backbone, depth, **kw):
    common = dict(num_classes=NC, num_att_classes=NA if backbone == "resnet" else 0,
                  backbone=backbone, depth=depth if backbone == "resnet" else 50,
                  anchor_scales=SCALES, **kw)
    return (jfr.DetectorConfig(rpn=jrpn.RPNConfig(**RPN_KW),
                               pt=jtargets.ProposalTargetConfig(**PT_KW), **common),
            tfr.DetectorConfig(rpn=trpn.RPNConfig(**RPN_KW),
                               pt=ttargets.ProposalTargetConfig(**PT_KW), **common))


_CACHE = {}


def _case(backbone, depth):
    """JAX's f32 params (numpy), both sides' bf16 compute params, bf16
    images and im_info, built once per (backbone, depth)."""
    if (backbone, depth) not in _CACHE:
        jcfg, tcfg = _configs(backbone, depth)
        jp = jax.jit(jfr.init_detector, static_argnums=(1,))(jax.random.PRNGKey(0), jcfg)
        jp = _random_leaves(jax.tree_util.tree_map(np.asarray, jp), seed=1)
        rng = np.random.RandomState(2)
        images = (rng.rand(B, H, W, 3) * 255 - 110).astype(np.float32)
        _CACHE[backbone, depth] = dict(
            jcfg=jcfg, tcfg=tcfg, jp=jp,
            jb=jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(BF16), jp),
            tb=cast_floats(from_jax_detector_params(jp, device="cpu"), torch.bfloat16),
            images=images, im_info=np.array([[H, W, 1.0], [H - 8, W - 16, 1.0]], np.float32))
    return _CACHE[backbone, depth]


def _t(a):
    """A JAX or numpy array as a CPU tensor of the same dtype (bf16 through
    its exact f32 values)."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


def _bit_equal(got, want, what):
    assert _dtype(got) == str(want.dtype) == "bfloat16", what
    share = float((_np(got) == np.asarray(want, np.float32)).mean())
    assert share >= MIN_BIT_EQUAL, f"{what}: {share:.4f} of elements equal"


def _close(got, want, tol, what):
    assert _dtype(got) == str(want.dtype), (what, got.dtype, want.dtype)
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * np.abs(want).max(), f"{what}: {err} of {np.abs(want).max()}"


def _rois(seed, n):
    """n RoIs (batch index, x1, y1, x2, y2) inside the images."""
    rng = np.random.RandomState(seed)
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, B, n)
    xy = rng.uniform(0, 60, (n, 2))
    rois[:, 1:3] = xy
    rois[:, 3:5] = np.minimum(xy + rng.uniform(4, 40, (n, 2)), [W - 1, H - 1])
    return rois


@pytest.mark.parametrize("backbone,depth", CASES)
def test_backbone_bf16_matches_jax(backbone, depth):
    c = _case(backbone, depth)
    jm, tm, key = (jvgg, tvgg, "vgg") if backbone == "vgg16" else (jres, tres, "resnet")
    images = jnp.asarray(c["images"]).astype(BF16)
    want = jax.jit(jm.backbone)(c["jb"][key], images)
    with torch.no_grad():
        got = tm.backbone(c["tb"][key], _t(images))
    _close(got, want, CHAIN_TOL, "backbone")
    if backbone == "vgg16":
        # convolutions + bias, each on its own seeded input
        conv = jax.jit(jvgg._conv)
        for ci in (0, 1, 4, 12):
            p = c["jb"]["vgg"]["convs"][ci]
            x = jnp.asarray(np.random.RandomState(ci).randn(
                B, 16, 24, p["w"].shape[2])).astype(BF16)
            with torch.no_grad():
                got = conv_bias(_t(x).permute(0, 3, 1, 2), c["tb"]["vgg"]["convs"][ci])
            _bit_equal(got.permute(0, 2, 3, 1), conv(x, p), f"conv {ci}")
        return
    # the first bottleneck of each layer, on JAX's own input
    block = jax.jit(jres._bottleneck, static_argnums=(2,))
    for li, (ch, stride) in enumerate(((64, 1), (256, 2), (512, 2), (1024, 2)), start=1):
        x = jnp.asarray(np.random.RandomState(li).randn(B, 16, 24, ch)).astype(BF16)
        want = block(x, c["jb"]["resnet"][f"layer{li}"][0], stride)
        with torch.no_grad():
            got = tres._nhwc(tres._bottleneck(tres._nchw(_t(x)), c["tb"]["resnet"][
                f"layer{li}"][0], stride))
        _bit_equal(got, want, f"layer{li}[0]")


def _stage_inputs(c, backbone):
    """A seeded bf16 backbone map and RoIs, and JAX's pooled RoIs and
    head_to_tail features from them."""
    jm, key = (jvgg, "vgg") if backbone == "vgg16" else (jres, "resnet")
    ch = 512 if backbone == "vgg16" else 1024
    base = jnp.asarray(np.random.RandomState(3).randn(B, H // 16, W // 16, ch)).astype(BF16)
    rois = _rois(4, 12)
    pool = jax.jit(lambda f, r: j_roi_align(f, r, spatial_scale=1 / 16, pooled_height=7,
                                            pooled_width=7, sampling_ratio=2).astype(f.dtype))
    pooled = pool(base, jnp.asarray(rois))
    return base, rois, pooled, jax.jit(jm.head_to_tail)(c["jb"][key], pooled)


@pytest.mark.parametrize("stage", ["rpn_heads", "pooled", "head_to_tail", "heads"])
@pytest.mark.parametrize("backbone,depth", CASES)
def test_stage_bf16_matches_jax(backbone, depth, stage):
    """rpn_heads on a backbone map, RoIAlign's pooled RoIs, head_to_tail on
    JAX's pooled RoIs, and the class, box and attribute heads on JAX's
    head_to_tail features."""
    c = _case(backbone, depth)
    base, rois, j_pooled, j_feat = _stage_inputs(c, backbone)
    with torch.no_grad():
        if stage == "rpn_heads":
            j_cls, j_bbox = jax.jit(jrpn.rpn_heads)(c["jb"]["rpn"], base)
            t_cls, t_bbox = trpn.rpn_heads(c["tb"]["rpn"], _t(base))
            _bit_equal(t_cls, j_cls, "rpn cls")
            _bit_equal(t_bbox, j_bbox, "rpn bbox")
        elif stage == "pooled":
            got = t_roi_align.roi_align(_t(base).contiguous(), _t(rois), spatial_scale=1 / 16,
                                        pooled_height=7, pooled_width=7, sampling_ratio=2)
            _bit_equal(got.to(_t(base).dtype), j_pooled, "pooled RoIs")
        elif stage == "head_to_tail" and backbone == "vgg16":
            # fc6 and fc7 in f32: fc7 takes fc6's f32 output unrounded
            _close(tvgg.head_to_tail(c["tb"]["vgg"], _t(j_pooled)), j_feat, F32_TOL,
                   "head_to_tail")
        elif stage == "head_to_tail":
            # layer4's three bottlenecks, then the mean in f32 rounded once
            _close(tres.head_to_tail(c["tb"]["resnet"], _t(j_pooled)), j_feat, CHAIN_TOL,
                   "head_to_tail")
            got = tres._nhwc(tres._bottleneck(tres._nchw(_t(j_pooled)),
                                              c["tb"]["resnet"]["layer4"][0], 2))
            _bit_equal(got, jax.jit(jres._bottleneck, static_argnums=(2,))(
                j_pooled, c["jb"]["resnet"]["layer4"][0], 2), "layer4[0]")
        else:
            names = ["cls_score", "bbox_pred"] + (["cls_score_atts"] if backbone == "resnet"
                                                  else [])
            for name in names:
                want = jax.jit(jfr._linear)(c["jb"][name], j_feat)
                _close(linear_f32(c["tb"][name], _t(j_feat)), want, F32_TOL, name)


@pytest.mark.parametrize("backbone,depth", CASES)
def test_forward_test_bf16_dtypes_match_jax(backbone, depth):
    """The inference forward's every output in JAX's dtype and shape."""
    c = _case(backbone, depth)
    fwd = dict(post_nms_top_n=12, pre_nms_top_n=64, nms_thresh=0.7)
    images = jnp.asarray(c["images"]).astype(BF16)
    want = jax.jit(lambda p, x, i: jfr.detector_forward_test(p, c["jcfg"], x, i, **fwd))(
        c["jb"], images, jnp.asarray(c["im_info"]))
    with torch.no_grad():
        got = tfr.detector_forward_test(c["tb"], c["tcfg"], _t(images), _t(c["im_info"]), **fwd)
    assert set(got) == set(want)
    for name, w in want.items():
        assert _dtype(got[name]).replace("int64", "int32") == str(w.dtype), name
        assert tuple(got[name].shape) == w.shape, name


def _given_proposals(seed):
    """(rois, scores, valid) for every image: RoIs around random boxes,
    some on the ground truth, as the patched ``proposal_layer`` returns."""
    rng = np.random.RandomState(seed)
    n = RPN_KW["post_nms_top_n"]
    rois = np.zeros((B, n, 5), np.float32)
    for b in range(B):
        rois[b, :, 0] = b
        rois[b, :, 1:] = _rois(seed + b, n)[:, 1:]
    valid = np.ones((B, n), bool)
    valid[1, -4:] = False
    rois[~valid] = 0
    return rois, rng.rand(B, n).astype(np.float32), valid


def _train_batch():
    rng = np.random.RandomState(7)
    gt = np.zeros((B, 4, 5), np.float32)
    num_gt = np.array([3, 2], np.int32)
    props = _given_proposals(11)[0]
    for b in range(B):
        for g in range(num_gt[b]):
            # ground truth near a given proposal, so that RoIs turn foreground
            gt[b, g, :4] = props[b, g, 1:] + rng.uniform(-2, 2, 4)
            gt[b, g, 4] = 1 + g
    return dict(im_info=np.array([[H, W, 1.0], [H - 8, W - 16, 1.0]], np.float32),
                gt_boxes=gt, num_gt=num_gt,
                gt_atts=(rng.rand(B, 4, NA) > 0.5).astype(np.float32),
                att_counts=rng.randint(1, 50, (NA,)).astype(np.float32))


@pytest.mark.parametrize("backbone,depth", [("resnet", 50), ("vgg16", 16)])
def test_train_step_bf16_matches_jax(monkeypatch, backbone, depth):
    """One bf16 training step: the losses and every f32 master gradient,
    on given proposals and JAX's own sampling draws."""
    from test_torch_detector_train import jax_train_draws

    c = _case(backbone, depth)
    rois, scores, valid = _given_proposals(11)
    monkeypatch.setattr(jfr, "proposal_layer", lambda *a, **k: (
        jnp.asarray(rois), jnp.asarray(scores), jnp.asarray(valid)))
    monkeypatch.setattr(tfr, "proposal_layer", lambda *a, **k: (
        _t(rois), _t(scores), _t(valid)))
    batch = dict(_train_batch(), images=c["images"])
    if backbone == "vgg16":
        batch["gt_atts"] = batch["gt_atts"][..., :1]
    key = jax.random.PRNGKey(5)

    def loss_fn(p, dtype):
        cast = jax.tree_util.tree_map(lambda x: x.astype(dtype), p)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = jfr.detector_forward_train(cast, c["jcfg"], dict(b, images=b["images"].astype(
            dtype)), key)
        return losses["total"], losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=(1,))
    jp = jax.tree_util.tree_map(jnp.asarray, c["jp"])
    (_, jl), jg = grad_fn(jp, BF16)
    jg32 = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grad_fn(jp, jnp.float32)[1])))
    params = from_jax_detector_params(c["jp"], device="cpu")
    leaves = named_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    n_anchors = (H // 16) * (W // 16) * len(SCALES) * 3
    draws = jax_train_draws(key, B, n_anchors, RPN_KW["post_nms_top_n"],
                            PT_KW["rois_per_image"])
    tb = {k: _t(v) for k, v in batch.items()}
    tb["images"] = tb["images"].to(torch.bfloat16)
    losses = tfr.detector_forward_train(cast_floats(params, torch.bfloat16), c["tcfg"], tb,
                                        draws)
    losses["total"].backward()
    assert set(losses) == set(jl)
    for name, v in jl.items():
        assert _dtype(losses[name]) == str(v.dtype), name
        assert float(v) > 0, name                       # every loss is exercised
        np.testing.assert_allclose(losses[name].item(), float(v), rtol=LOSS_RTOL, err_msg=name)
    jgrads = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    bad = []
    for path, t in leaves:
        want = jgrads[path]
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        assert t.grad is None or t.grad.dtype == torch.float32, path
        if got.ndim == 4:                                   # OIHW → HWIO
            got = np.transpose(got, (2, 3, 1, 0))
        # relative to the leaf's norm: JAX's band, the port's distance from
        # JAX's bf16 and from JAX's f32 gradient
        norm = float(np.linalg.norm(want))
        band, err_bf16, err_f32 = (float(np.linalg.norm(a - b)) / norm for a, b in (
            (jg32[path], want), (got, want), (got, jg32[path])))
        print(f"{path}: band {band:.4f} from bf16 {err_bf16:.4f} from f32 {err_f32:.4f}")
        if not (err_bf16 <= BAND_FACTOR * band + GRAD_TOL
                and err_f32 <= BAND_FACTOR * band + GRAD_TOL
                and min(err_bf16, err_f32) <= NEAR_FACTOR * band + GRAD_TOL):
            bad.append((path, band, err_bf16, err_f32))
    assert not bad, bad
