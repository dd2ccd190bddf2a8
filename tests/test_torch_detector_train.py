"""The port's detector training path (``models/detector/{rpn,targets,
faster_rcnn}.py``, ``ops/boxes.py::bbox_transform``,
``training/detector_optimizer.py``, ``data/detection.py::flip_record``)
against the JAX package, f32 on the CPU.

Every draw is JAX's: the port takes the uniforms that JAX draws from its
keys (``faster_rcnn.py:250`` splits the step key into the anchor-target and
the RoI-sampling keys; ``rpn.py:191`` and ``targets.py:104`` split those
over the images, and each image's key into two), so the sampling is
compared exactly. The training forward runs at ResNet-50 (and VGG16), 5
classes, 6 attributes, anchor scales (1, 2, 4), two 64 × 96 images, 200 /
48 proposals, 16 RoIs an image; the RPN's class kernel is scaled by 30 so
that its scores are far apart (their order decides the proposals, and the
two forwards sum the convolutions in other orders). VGG16 has no
BatchNorm or residual path between its ReLUs and max-pools, so one ReLU
whose input sits within a few ulps of 0, or one near-tied pool window,
routes a gradient elsewhere; its check first asserts that both backbones
take the same decisions on its (seeded) images.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.data import detection as jdet
from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector import rpn as jrpn
from style_seqcvae_tpu.models.detector import targets as jtargets
from style_seqcvae_tpu.models.detector import vgg as jvgg
from style_seqcvae_tpu.models.detector.anchors import generate_anchors, shifted_anchors
from style_seqcvae_tpu.ops.boxes import bbox_transform as j_bbox_transform
from style_seqcvae_tpu.training.detector_optimizer import make_detector_optimizer
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.data import detection as tdet
from style_seqcvae_tpu_torch.models.detector import faster_rcnn as tfr
from style_seqcvae_tpu_torch.models.detector import rpn as trpn
from style_seqcvae_tpu_torch.models.detector import targets as ttargets
from style_seqcvae_tpu_torch.models.detector import vgg as tvgg
from style_seqcvae_tpu_torch.ops.boxes import bbox_transform
from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD
from style_seqcvae_tpu_torch.weights import from_jax_detector_params, named_leaves

torch.set_num_threads(1)

# the training forward: f32 losses through ~60 layers whose convolutions
# XLA and oneDNN sum in other orders (a few ulps of each activation)
LOSS_RTOL = 1e-5
# each leaf's gradient against JAX's, relative to the norm of JAX's
GRAD_TOL = 1e-4
B, H, W, G = 2, 64, 96, 4
NC, NA = 5, 6
SCALES = (1, 2, 4)
RPN_KW = dict(pre_nms_top_n=200, post_nms_top_n=48, rpn_batch_size=64)
# foreground from IoU 0.25: the tiny random detector's proposals then carry some
PT_KW = dict(rois_per_image=16, num_classes=NC, fg_thresh=0.25, bg_thresh_hi=0.25)


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniform_pairs(key, batch, n1, n2):
    """JAX's per-image draws: ``split(key, batch)``, each split in two, a
    uniform of ``n1`` and of ``n2`` values."""
    first, second = [], []
    for k in jax.random.split(key, batch):
        k1, k2 = jax.random.split(k)
        first.append(np.asarray(jax.random.uniform(k1, (n1,))))
        second.append(np.asarray(jax.random.uniform(k2, (n2,))))
    return _t(np.stack(first)), _t(np.stack(second))


def jax_train_draws(key, batch, anchors, proposals, rois):
    """The uniforms one ``detector_forward_train`` call of JAX draws from
    ``key``, as the port's ``TrainDraws``."""
    k_at, k_pt = jax.random.split(key)
    a_fg, a_bg = _uniform_pairs(k_at, batch, anchors, anchors)
    r_fg, r_bg = _uniform_pairs(k_pt, batch, proposals, rois)
    return tfr.TrainDraws(a_fg, a_bg, r_fg, r_bg)


def test_bbox_transform_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(-20, 300, (3, 50, 2))
    ex = np.concatenate([xy, xy + rng.uniform(0, 200, (3, 50, 2))], -1).astype(np.float32)
    xy = rng.uniform(-20, 300, (3, 50, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0, 200, (3, 50, 2))], -1).astype(np.float32)
    want = np.asarray(j_bbox_transform(jnp.asarray(ex), jnp.asarray(gt)))
    got = bbox_transform(_t(ex), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _gt(rng, batch, n_gt, h, w):
    gt = np.zeros((batch, G, 5), np.float32)
    for b in range(batch):
        for g in range(n_gt[b]):
            x1, y1 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(12, w * 0.5), rng.uniform(12, h * 0.5)
            gt[b, g] = [x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1), rng.randint(1, NC)]
    return gt


@pytest.mark.parametrize("clobber", [False, True])
def test_anchor_target_matches_jax(clobber):
    rng = np.random.RandomState(1)
    fh, fw = 6, 8
    anchors = shifted_anchors(fh, fw, 16, generate_anchors(16, (0.5, 1, 2), (1, 2)))
    anchors = np.ascontiguousarray(anchors, np.float32)
    n_gt = np.array([3, 1, 0], np.int32)
    gt = _gt(rng, 3, n_gt, 96, 128)
    gt[0, 2, :4] = anchors[100]                    # an exact match: IoU 1
    gt[1, 0, :4] = gt[0, 0, :4]
    im_info = np.array([[96, 128, 1.0], [80, 100, 1.0], [96, 128, 1.0]], np.float32)
    # 4 anchors an image: image 0's 3 foreground anchors are subsampled to 2
    cfg = dict(rpn_batch_size=4, clobber_positives=clobber)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jrpn.anchor_target, static_argnums=(0, 6))(
        (fh, fw), jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(n_gt),
        jnp.asarray(im_info), key, jrpn.RPNConfig(**cfg))
    got = trpn.anchor_target(_t(anchors), _t(gt), _t(n_gt), _t(im_info),
                             _uniform_pairs(key, 3, len(anchors), len(anchors)),
                             trpn.RPNConfig(**cfg))
    labels, targets, in_w, out_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), labels)
    assert (labels[0] == 1).sum() == 2 and (labels[0] >= 0).sum() == 4      # subsampled
    np.testing.assert_allclose(got[1].numpy(), targets, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), in_w)
    np.testing.assert_array_equal(got[3].numpy(), out_w)


def test_proposal_target_matches_jax():
    rng = np.random.RandomState(2)
    P, Bt = 40, 3
    n_gt = np.array([3, 0, 2], np.int32)
    gt = _gt(rng, Bt, n_gt, 96, 128)
    atts = (rng.rand(Bt, G, NA) > 0.5).astype(np.float32)
    xy = rng.uniform(0, 100, (Bt, P, 2))
    rois = np.concatenate([np.zeros((Bt, P, 1)), xy, xy + rng.uniform(4, 60, (Bt, P, 2))],
                          -1).astype(np.float32)
    # image 2: every valid roi near a ground-truth box (foreground only)
    jitter = rng.uniform(-1, 1, (P, 4)).astype(np.float32)
    rois[2, :, 1:] = gt[2, np.arange(P) % 2, :4] + jitter
    # image 0: six near its ground truth among the random ones
    rois[0, :6, 1:] = gt[0, np.arange(6) % 3, :4] + jitter[:6]
    valid = rng.rand(Bt, P) > 0.2
    rois[~valid] = 0.0
    cfg = dict(rois_per_image=16, num_classes=NC)
    key = jax.random.PRNGKey(9)
    want = [np.asarray(x) for x in jax.jit(jtargets.proposal_target, static_argnums=6)(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(n_gt),
        jnp.asarray(atts), key, jtargets.ProposalTargetConfig(**cfg))]
    got = [x.numpy() for x in ttargets.proposal_target(
        _t(rois), _t(valid), _t(gt), _t(n_gt), _t(atts), _uniform_pairs(key, Bt, P, 16),
        ttargets.ProposalTargetConfig(**cfg))]
    for i in (0, 1, 3, 4, 5):            # rois, labels, inside weights, attributes, fg
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    fg = want[5]
    assert 0 < fg[0].sum() < 16 and fg[1].sum() == 0 and fg[2].sum() == 16


def test_rpn_losses_and_smooth_l1_match_jax():
    rng = np.random.RandomState(3)
    Bt, h, w, A = 2, 3, 4, 6
    N = h * w * A
    cls = rng.randn(Bt, h, w, A, 2).astype(np.float32) * 2
    deltas = rng.randn(Bt, h, w, A, 4).astype(np.float32)
    labels = rng.choice([-1.0, 0.0, 1.0], (Bt, N)).astype(np.float32)
    targets = rng.randn(Bt, N, 4).astype(np.float32)
    in_w = (labels == 1).astype(np.float32)
    out_w = np.where(labels >= 0, 1.0 / np.maximum((labels >= 0).sum(1, keepdims=True), 1),
                     0.0).astype(np.float32)
    want = jrpn.rpn_losses(*map(jnp.asarray, (cls, deltas, labels, targets, in_w, out_w)))
    got = trpn.rpn_losses(*map(_t, (cls, deltas, labels, targets, in_w, out_w)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.item(), float(wv), rtol=1e-6)
    pred, tgt = rng.randn(50, 4).astype(np.float32), rng.randn(50, 4).astype(np.float32)
    iw = (rng.rand(50, 4) > 0.3).astype(np.float32)
    for sigma in (1.0, 3.0):
        want = jrpn.smooth_l1_loss(*map(jnp.asarray, (pred, tgt, iw, iw)), sigma=sigma)
        got = trpn.smooth_l1_loss(*map(_t, (pred, tgt, iw, iw)), sigma=sigma)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _cb_cases():
    rng = np.random.RandomState(7)
    R, C = 12, 9
    labels = (rng.rand(R, C) > 0.6).astype(np.float32)
    labels[3] = 0.0
    plain = (labels, rng.randn(R, C).astype(np.float32) * 3,
             rng.randint(5, 500, (C,)).astype(np.float32))
    rng = np.random.RandomState(11)
    R, C = 8, 106
    counts = np.zeros((C,), np.float32)
    counts[:8] = rng.randint(20, 400, (8,)).astype(np.float32)
    labels = np.zeros((R, C), np.float32)
    labels[np.arange(R), rng.randint(0, 8, R)] = 1.0
    zero_counts = (labels, rng.randn(R, C).astype(np.float32) * 3, counts)
    extreme = (np.eye(4, dtype=np.float32), np.array([[-200.0, 50, 0, 1]] * 4, np.float32),
               np.full((4,), 10.0, np.float32))
    return {"plain": plain, "zero_counts": zero_counts, "extreme_logits": extreme}


@pytest.mark.parametrize("case", ["plain", "zero_counts", "extreme_logits"])
@pytest.mark.parametrize("kind", ["sigmoid", "softmax", "focal", "focal_gamma0"])
def test_cb_losses_match_jax(case, kind):
    labels, logits, counts = _cb_cases()[case]
    j_args, t_args = (jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(counts)), \
        (_t(labels), _t(logits), _t(counts))
    if kind.startswith("focal"):
        gamma = 0.0 if kind == "focal_gamma0" else 2.0
        want = np.asarray(jfr.cb_focal_loss(*j_args, 0.9, gamma))
        got = tfr.cb_focal_loss(*t_args, 0.9, gamma).numpy()
    else:
        fn = {"sigmoid": "cb_sigmoid_loss", "softmax": "cb_softmax_loss"}[kind]
        want = np.asarray(getattr(jfr, fn)(*j_args, 0.9))
        got = getattr(tfr, fn)(*t_args, 0.9).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


@lru_cache(maxsize=None)
def _jax_params(backbone):
    cfg = jfr.DetectorConfig(num_classes=NC, num_att_classes=NA if backbone == "resnet" else 0,
                             backbone=backbone, depth=50, anchor_scales=SCALES)
    p = jax.tree_util.tree_map(np.asarray, jit_init(jfr.init_detector, cfg,
                                                    jax.random.PRNGKey(0)))
    p["rpn"]["cls"]["w"] = p["rpn"]["cls"]["w"] * 30
    return p


def _train_batch(n_att, image_seed=0):
    rng = np.random.RandomState(0)
    images = (np.random.RandomState(image_seed).randn(B, H, W, 3) * 50).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 16, 1.0]], np.float32)
    num_gt = np.array([3, 2], np.int32)
    gt = _gt(rng, B, num_gt, H, W)
    atts = (rng.rand(B, G, max(n_att, 1)) > 0.6).astype(np.float32)
    counts = rng.randint(1, 50, (max(n_att, 1),)).astype(np.float32)
    return dict(images=images, im_info=im_info, gt_boxes=gt, num_gt=num_gt, gt_atts=atts,
                att_counts=counts)


def _configs(backbone, mode, **kw):
    common = dict(num_classes=NC, num_att_classes=NA if backbone == "resnet" else 0,
                  backbone=backbone, depth=50, pooling_mode=mode, anchor_scales=SCALES, **kw)
    return (jfr.DetectorConfig(rpn=jrpn.RPNConfig(**RPN_KW),
                               pt=jtargets.ProposalTargetConfig(**PT_KW), **common),
            tfr.DetectorConfig(rpn=trpn.RPNConfig(**RPN_KW),
                               pt=ttargets.ProposalTargetConfig(**PT_KW), **common))


def _port_losses_and_grads(tcfg, jp, batch, draws):
    params = from_jax_detector_params(jp, device="cpu")
    leaves = named_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    losses = tfr.detector_forward_train(params, tcfg, {k: _t(v) for k, v in batch.items()},
                                        draws)
    losses["total"].backward()
    return ({k: v.item() for k, v in losses.items()},
            {path: t.grad for path, t in leaves})


def _draws_for(tcfg, jp, key):
    n_anchors = (H // 16) * (W // 16) * len(SCALES) * 3
    return jax_train_draws(key, B, n_anchors, RPN_KW["post_nms_top_n"], PT_KW["rois_per_image"])


def _assert_vgg_decisions_agree(jp, images):
    """The premise of the VGG16 gradient check: JAX's and the port's
    backbones, layer by layer on the same input, take the same discrete
    decisions (every ReLU's sign and every 2×2 max-pool's winner), so that
    their gradients take the same paths. The two sum each convolution in
    another order, which can flip a pre-activation within a few ulps of 0 or
    a near-tied window."""
    conv = jax.jit(lambda x, w, b: jvgg._conv(x, {"w": w, "b": b}))
    tp = from_jax_detector_params(jp, device="cpu")["vgg"]
    xj, xt = jnp.asarray(images), torch.from_numpy(images).permute(0, 3, 1, 2)
    ci = 0
    for bi, (_, n) in enumerate(tvgg._CFG):
        for _ in range(n):
            pj, pt = jp["vgg"]["convs"][ci], tp["convs"][ci]
            pre_j = np.asarray(conv(xj, pj["w"], pj["b"]))
            pre_t = torch.nn.functional.conv2d(xt, pt["w"], pt["b"], padding=1)
            flips = int(((pre_j > 0) != (pre_t.permute(0, 2, 3, 1).numpy() > 0)).sum())
            assert flips == 0, f"conv {ci}: {flips} ReLU signs differ"
            xj, xt = jnp.maximum(jnp.asarray(pre_j), 0), torch.relu(pre_t)
            ci += 1
        if bi == 4:
            break
        b, c, h, w = xt.shape
        win_t = xt.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
        win_j = np.asarray(xj).reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 5, 1, 3, 2, 4)
        win_t, win_j = win_t.reshape(b, c, h // 2, w // 2, 4), win_j.reshape(b, c, h // 2,
                                                                              w // 2, 4)
        moved = (win_j.argmax(-1) != win_t.argmax(-1).numpy()) & (win_j.max(-1) > 0)
        assert not moved.any(), f"pool {bi}: {int(moved.sum())} windows pick another pixel"
        xj = jax.lax.reduce_window(xj, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        xt = torch.nn.functional.max_pool2d(xt, 2, 2)


@pytest.mark.parametrize("backbone,mode", [("resnet", "align"), ("resnet", "pool"),
                                           ("resnet", "crop"), ("vgg16", "align")])
def test_forward_train_matches_jax(backbone, mode):
    jcfg, tcfg = _configs(backbone, mode)
    jp = _jax_params(backbone)
    # VGG16's images: a seed on which both backbones decide alike
    batch = _train_batch(jcfg.num_att_classes, image_seed=2 if backbone == "vgg16" else 0)
    if backbone == "vgg16":
        _assert_vgg_decisions_agree(jp, batch["images"])
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        losses = jfr.detector_forward_train(p, jcfg, {k: jnp.asarray(v) for k, v in
                                                      batch.items()}, key)
        return losses["total"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    losses, grads = _port_losses_and_grads(tcfg, jp, batch, _draws_for(tcfg, jp, key))
    assert set(losses) == set(jl)
    for name, v in jl.items():
        np.testing.assert_allclose(losses[name], float(v), rtol=LOSS_RTOL, err_msg=name)
    assert all(float(v) > 0 for v in jl.values())       # every loss is exercised
    jgrads = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    assert jgrads.keys() == grads.keys()
    for path, want in jgrads.items():
        got = grads[path]
        got = np.zeros_like(want) if got is None else got.numpy()
        if got.ndim == 4:                                   # OIHW → HWIO
            got = np.transpose(got, (2, 3, 1, 0))
        scale = max(float(np.linalg.norm(want)), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, path


def test_remat_equals_no_remat():
    jp = _jax_params("resnet")
    batch = _train_batch(NA)
    draws = _draws_for(None, jp, jax.random.PRNGKey(5))
    plain = _port_losses_and_grads(_configs("resnet", "align")[1], jp, batch, draws)
    remat = _port_losses_and_grads(_configs("resnet", "align", remat=True)[1], jp, batch, draws)
    assert plain[0] == remat[0]
    for path, g in plain[1].items():
        torch.testing.assert_close(remat[1][path], g, rtol=0, atol=0, msg=path)


@pytest.mark.parametrize("backbone", ["resnet", "vgg16"])
@pytest.mark.parametrize("freeze", [True, False])
def test_trainable_labels_match_jax(backbone, freeze):
    jp = _jax_params(backbone)
    want = dict(named_leaves(jfr.detector_trainable_labels(jp, freeze)))
    got = dict(named_leaves(tfr.detector_trainable_labels(
        from_jax_detector_params(jp, device="cpu"), freeze)))
    assert got == want
    assert "always" in got.values()
    # frozen: the first blocks; unfrozen, the BatchNorm statistics (VGG has none)
    assert ("never" in got.values()) == (freeze or backbone == "resnet")
    assert ("input_conv" in got.values()) == (not freeze and backbone == "resnet")


@pytest.mark.parametrize("freeze", [True, False])
def test_optimizer_six_steps_match_jax(freeze):
    # a ResNet tree cut to one bottleneck a layer: every kind of leaf, fewer leaves
    full = _jax_params("resnet")
    jp = {k: v for k, v in full.items() if k != "resnet"}
    jp["resnet"] = {k: (v[:1] if isinstance(v, list) else v) for k, v in full["resnet"].items()}
    kw = dict(lr=0.01, momentum=0.9, weight_decay=1e-3, double_bias=True, bias_decay=False,
              steps_per_epoch=2, lr_decay_step_epochs=1, gamma=0.1, clip_norm=5.0,
              freeze_backbone=freeze)
    tx = make_detector_optimizer(jp, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    state = tx.init(jparams)
    tparams = from_jax_detector_params(jp, device="cpu")
    opt = DetectorSGD(tparams, **kw)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(6)
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32) * (step + 1), jp)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, updates)
        # JAX's gradients on the leaves' ``.grad``, as a backward pass leaves them
        tg = dict(named_leaves(from_jax_detector_params(grads, device="cpu")))
        got = dict(named_leaves(tparams))
        for path, p in got.items():
            if p.requires_grad:
                p.grad = tg[path]
        opt.apply()
        assert all(p.grad is None for p in got.values())
        for path, want in named_leaves(jax.tree_util.tree_map(np.asarray, jparams)):
            g = got[path].detach().numpy()
            if g.ndim == 4:
                g = np.transpose(g, (2, 3, 1, 0))
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-8,
                                       err_msg=f"step {step + 1} {path}")
    assert opt.step == int(state.step) == 6
    assert opt.lr_at(6) == np.float32(0.01) * np.float32(0.1) ** 3


def test_flip_record_matches_jax():
    rng = np.random.RandomState(8)
    img = rng.rand(7, 11, 3).astype(np.float32)
    rec = {"boxes": np.array([[0, 1, 4, 5], [3, 0, 10, 6]], np.float32), "image_id": 3}
    want_rec, want_img = jdet.flip_record(rec, img)
    got_rec, got_img = tdet.flip_record(rec, torch.from_numpy(img))
    np.testing.assert_array_equal(got_rec["boxes"], want_rec["boxes"])
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    assert got_rec["image_id"] == 3 and rec["boxes"][0, 0] == 0
