"""The port's other detector variants against the JAX package, f32 on the
CPU: the VGG16 backbone (``models/detector/vgg.py``, its torchvision
importer and its parameters through ``weights.py``) and the ``pool`` and
``crop`` RoI modes (``ops/roi_align.py::roi_pool``, ``ops/roi_crop.py``),
alone and through ``detector_forward_test``.

JAX's RoI pooling runs under ``jax.jit`` here, as in its detector: XLA turns
the division by the bin count into a product with its reciprocal, which
moves ``roi_pool``'s floor / ceil edges, and the port computes it so.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector import vgg as jvgg
from style_seqcvae_tpu.ops import roi_align as jra
from style_seqcvae_tpu.ops import roi_crop as jrc
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.models.detector import faster_rcnn as tfr
from style_seqcvae_tpu_torch.models.detector import vgg as tvgg
from style_seqcvae_tpu_torch.ops import roi_align as tra
from style_seqcvae_tpu_torch.ops import roi_crop as trc
from style_seqcvae_tpu_torch.utils import torch_import as tti
from style_seqcvae_tpu_torch.weights import (
    from_jax_detector_params,
    load_detector_params,
    named_leaves,
    save_params_npz,
    to_jax_detector_params,
)

torch.set_num_threads(1)

# activations through a dozen convolutions that XLA and oneDNN sum in other
# orders: 1e-5 of each tensor's largest value (test_torch_detector.py's)
REL_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@lru_cache(maxsize=None)
def _vgg_params():
    cfg = jfr.DetectorConfig(num_classes=4, num_att_classes=0, backbone="vgg16",
                             anchor_scales=(1, 2, 4))
    p = jax.tree_util.tree_map(np.asarray, jit_init(jfr.init_detector, cfg,
                                                    jax.random.PRNGKey(1)))
    p["rpn"]["cls"]["w"] = p["rpn"]["cls"]["w"] * 30
    return p


def test_vgg_backbone_and_head_match_jax():
    jp = _vgg_params()
    tp = from_jax_detector_params(jp, device="cpu")
    images = (np.random.RandomState(0).randn(2, 48, 80, 3) * 50).astype(np.float32)
    want = np.asarray(jax.jit(jvgg.backbone)(jax.tree_util.tree_map(jnp.asarray, jp["vgg"]),
                                             jnp.asarray(images)))
    got = tvgg.backbone(tp["vgg"], _t(images))
    assert got.shape == (2, 3, 5, 512) and got.is_contiguous()
    _close(got.numpy(), want)
    pooled = np.random.RandomState(1).rand(6, 7, 7, 512).astype(np.float32)
    want = np.asarray(jax.jit(jvgg.head_to_tail)(jax.tree_util.tree_map(jnp.asarray, jp["vgg"]),
                                                 jnp.asarray(pooled)))
    got = tvgg.head_to_tail(tp["vgg"], _t(pooled))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_init_vgg16_shapes_match_jax():
    cfg = tfr.DetectorConfig(num_classes=4, num_att_classes=0, backbone="vgg16",
                             anchor_scales=(1, 2, 4))
    got = dict(named_leaves(to_jax_detector_params(tfr.init_detector(cfg, device="cpu"))))
    want = dict(named_leaves(_vgg_params()))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    with pytest.raises(ValueError, match="no attribute head"):
        tfr.init_detector(cfg._replace(num_att_classes=3), device="cpu")


def test_import_vgg_state_dict_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    sd, in_ch = {}, 3
    layers = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for i, out in zip(layers, widths):
        sd[f"features.{i}.weight"] = torch.from_numpy(rng.randn(out, in_ch, 3, 3).astype(
            np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy(rng.randn(out).astype(np.float32))
        in_ch = out
    # torchvision's classifier (fc6, fc7, and the ImageNet fc8 the import
    # skips), narrowed: neither importer reads the widths
    for i, (o, n) in {0: (40, 250), 3: (40, 40), 6: (10, 40)}.items():
        sd[f"classifier.{i}.weight"] = torch.from_numpy(rng.randn(o, n).astype(np.float32))
        sd[f"classifier.{i}.bias"] = torch.from_numpy(rng.randn(o).astype(np.float32))
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray,
                                                    jvgg.import_vgg_state_dict(sd))))
    got = tti.import_vgg_state_dict(sd, device="cpu")
    got_np = dict(named_leaves(to_jax_detector_params({"vgg": got})["vgg"]))
    assert got_np.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got_np[k], want[k], err_msg=k)
    assert got["convs"][0]["w"].shape == (64, 3, 3, 3)                 # OIHW
    # a .npz of a vgg detector tree loads through load_detector_params
    tree = {"vgg": to_jax_detector_params({"vgg": got})["vgg"],
            **{k: v for k, v in _vgg_params().items() if k != "vgg"}}
    save_params_npz(tree, str(tmp_path / "vgg.npz"))
    loaded = load_detector_params(str(tmp_path / "vgg.npz"), device="cpu")
    torch.testing.assert_close(loaded["vgg"]["fc6"]["w"], got["fc6"]["w"], rtol=0, atol=0)
    assert loaded["rpn"]["conv"]["w"].shape == (512, 512, 3, 3)


def _features_and_rois(seed, B=2, H=9, W=11, C=5, R=24, tie=False):
    rng = np.random.RandomState(seed)
    f = rng.randn(B, H, W, C).astype(np.float32)
    if tie:
        f[0, 2:5, 3:6, :] = 2.5              # a plateau: tied maxima in a bin
        f[1, :, :, 1] = np.round(f[1, :, :, 1])
    xy = rng.uniform(-30, 150, (R, 2))
    wh = rng.uniform(0, 120, (R, 2))
    rois = np.concatenate([rng.randint(0, B, (R, 1)), xy, xy + wh], 1).astype(np.float32)
    rois[0] = [0, 32, 32, 95, 95]            # over the plateau
    rois[1] = [1, 0, 0, 16 * W - 1, 16 * H - 1]
    rois[2] = [0, 0, 0, 0, 0]                # a padding row
    rois[3] = [1, 200, 200, 260, 260]        # off the map: empty bins
    g = rng.randn(R, 7, 7, C).astype(np.float32)
    return f, rois, g


def _vjp_jax(fn, f, rois, g):
    out, vjp = jax.vjp(jax.jit(lambda x: fn(x, jnp.asarray(rois))), jnp.asarray(f))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _vjp_port(fn, f, rois, g):
    x = _t(f).requires_grad_(True)
    out = fn(x, _t(rois))
    out.backward(_t(g))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("tie", [False, True])
def test_roi_pool_matches_jax(tie):
    f, rois, g = _features_and_rois(4, tie=tie)
    kw = dict(spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7)
    out_j, grad_j = _vjp_jax(lambda x, r: jra.roi_pool(x, r, **kw), f, rois, g)
    out_t, grad_t = _vjp_port(lambda x, r: tra.roi_pool(x, r, **kw), f, rois, g)
    np.testing.assert_array_equal(out_t, out_j)
    assert (out_j[3] == 0).all()
    # tied maxima share their bin's gradient evenly (sums in another order)
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-6)
    if tie:
        # a bin wholly on the plateau spreads its gradient over its pixels
        assert (np.abs(grad_j[0, 2:5, 3:6, 0]) > 0).sum() >= 4
        np.testing.assert_allclose(grad_j[0, 2:5, 3:6].sum(), grad_t[0, 2:5, 3:6].sum(),
                                   rtol=1e-5)


def test_roi_crop_matches_jax():
    f, rois, g = _features_and_rois(5)
    kw = dict(spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7)
    out_j, grad_j = _vjp_jax(lambda x, r: jrc.roi_crop(x, r, **kw), f, rois, g)
    out_t, grad_t = _vjp_port(lambda x, r: trc.roi_crop(x, r, **kw), f, rois, g)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-5)
    theta = np.asarray(jrc.affine_theta(jnp.asarray(rois), 9, 11, 1 / 16.0))
    np.testing.assert_allclose(trc.affine_theta(_t(rois), 9, 11, 1 / 16.0).numpy(), theta,
                               rtol=0, atol=1e-6)
    grid = np.asarray(jrc.affine_grid(jnp.asarray(theta), 14, 14))
    np.testing.assert_allclose(trc.affine_grid(_t(theta), 14, 14).numpy(), grid, rtol=0,
                               atol=1e-5)


@lru_cache(maxsize=None)
def _resnet_params():
    cfg = jfr.DetectorConfig(num_classes=4, num_att_classes=3, depth=50, anchor_scales=(1, 2, 4))
    p = jax.tree_util.tree_map(np.asarray, jit_init(jfr.init_detector, cfg,
                                                    jax.random.PRNGKey(2)))
    p["rpn"]["cls"]["w"] = p["rpn"]["cls"]["w"] * 30
    return p


@pytest.mark.parametrize("backbone,mode", [("vgg16", "align"), ("vgg16", "pool"),
                                           ("resnet", "pool"), ("resnet", "crop")])
def test_forward_test_matches_jax(backbone, mode):
    kw = dict(num_classes=4, num_att_classes=0 if backbone == "vgg16" else 3, depth=50,
              backbone=backbone, pooling_mode=mode, anchor_scales=(1, 2, 4))
    jp = _vgg_params() if backbone == "vgg16" else _resnet_params()
    images = (np.random.RandomState(6).randn(2, 64, 96, 3) * 50).astype(np.float32)
    im_info = np.array([[64, 96, 1.0], [56, 80, 1.0]], np.float32)
    fwd = dict(post_nms_top_n=12, pre_nms_top_n=64, nms_thresh=0.7)
    want = jax.jit(lambda p, x, i: jfr.detector_forward_test(p, jfr.DetectorConfig(**kw), x, i,
                                                             **fwd))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(images), jnp.asarray(im_info))
    with torch.inference_mode():
        got = tfr.detector_forward_test(from_jax_detector_params(jp, device="cpu"),
                                        tfr.DetectorConfig(**kw), _t(images), _t(im_info),
                                        **fwd)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]), rtol=0, atol=1e-3)
    for name in ("cls_prob", "bbox_pred", "pooled_feat") + (
            ("cls_prob_atts",) if backbone == "resnet" else ()):
        _close(got[name].numpy(), want[name])
    assert got["pooled_feat"].shape[-1] == (4096 if backbone == "vgg16" else 2048)
