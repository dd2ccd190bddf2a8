"""Two data-parallel ranks against one process, and against JAX: the port's
``parallel/distributed_worker.py`` payloads in two gloo processes on the
CPU (tiny widths, one thread each, every launch bounded by ``TIMEOUT``).

* The captioner: two ranks of 8 rows equal one process on the 16 rows and
  the JAX package's ``make_train_step`` on them, with the JAX params carried
  over and JAX's z-noise (each rank its rows of the global (T+1, 16, z)
  stack): metrics rtol 1e-5, every parameter within 1e-5 of its leaf's norm
  (JAX's own two-step parity, ``tests/test_torch_trainer.py``).
* The detector: two ranks of 2 images whose anchor, foreground and
  attribute counts differ (the second rank's images hold no attribute)
  equal JAX's one-process step on the 4 images on JAX's draws: every loss
  rtol 1e-5, every leaf's update within 1e-4 of the update's norm. The
  ranks' own means, averaged, miss JAX's losses by far more, which this
  check would catch.
* Checkpoints saved by one process restore in two ranks, which take the
  next step as one process does, and the reverse
  (``tests/test_multihost.py::test_distributed_checkpoint_portability``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector import rpn as jrpn
from style_seqcvae_tpu.models.detector import targets as jtargets
from style_seqcvae_tpu.training import trainer as jtrainer
from style_seqcvae_tpu.training.detector_optimizer import make_detector_optimizer
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.parallel import distributed_worker as W
from style_seqcvae_tpu_torch.weights import named_leaves
from tests.test_torch_detector_train import jax_train_draws
from tests.test_torch_train import jax_leaves

torch.set_num_threads(1)

TIMEOUT = 240.0            # seconds a two-process launch may take
METRIC_RTOL = 1e-5
PARAM_REL = 1e-5
UPDATE_REL = 1e-4


def _save_tree(tree, path):
    np.savez(path, **dict(named_leaves(jax.tree_util.tree_map(np.asarray, tree))))
    return str(path)


def _leaves(path):
    return dict(np.load(path))


# -------------------------------------------------------------- captioner


def _jax_eps(key, steps, batch, T1, z):
    """JAX's z-noise of ``steps`` train steps from the state key: (steps,
    T+1, B, z)."""
    out = []
    for _ in range(steps):
        key, step_rng = jax.random.split(key)
        out.append(np.stack([np.asarray(jax.random.normal(k, (batch, z), jnp.float32))
                             for k in jax.random.split(step_rng, T1)]))
    return np.stack(out)


def test_captioner_two_ranks_equal_one_process_and_jax(tmp_path):
    spec = W.captioner_spec(steps=2)
    model, B = spec["model"], spec["batch"]
    jcfg = jcap.CaptionerConfig(**model)
    jconfig = JConfig(config_override=spec["overrides"])
    jp = jcap.init_captioner(jax.random.PRNGKey(0), jcfg)
    batch = W.caption_batch(model, B, spec["boxes"], seed=5)
    np.savez(tmp_path / "batch.npz", **batch)
    eps = _jax_eps(jax.random.PRNGKey(1), 2, B, model["max_caption_length"] + 1,
                   model["z_space"])
    np.savez(tmp_path / "eps.npz", eps=eps)
    spec.update(params=_save_tree(jp, tmp_path / "params.npz"),
                batch_npz=str(tmp_path / "batch.npz"), eps=str(tmp_path / "eps.npz"),
                save=str(tmp_path / "ranks.npz"))

    ranks = W.launch_two_process_run({"captioner": spec}, device="cpu", timeout=TIMEOUT,
                                     out_dir=str(tmp_path / "w"))
    one = W.run_payloads({"captioner": dict(spec, save=str(tmp_path / "one.npz"))}, "cpu")

    jstate, tx = jtrainer.create_train_state(jp, jconfig, jcfg, jax.random.PRNGKey(1))
    jstep = jtrainer.make_train_step(tx, jcfg, jconfig.MODEL.KLD_WEIGHT)
    jmetrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})

    ranks = [dict(r["captioner"], process_count=r["process_count"]) for r in ranks]
    one = one["captioner"]
    for r in ranks:
        assert r["process_count"] == 2 and r["opt_step"] == 2
        assert r["metrics"] == ranks[0]["metrics"]            # every rank: the global step
        assert r["allreduce_ms"] is not None
    for got in (ranks[0], one):
        for s in range(2):
            for name in ("loss", "reconstr_loss", "kld_loss"):
                np.testing.assert_allclose(got["metrics"][s][name], jmetrics[s][name],
                                           rtol=METRIC_RTOL, err_msg=f"step {s + 1} {name}")
    want = jax_leaves(jstate.params)
    for saved in ("ranks.npz", "one.npz"):
        got = _leaves(tmp_path / saved)
        assert got.keys() == want.keys()
        for path, w in want.items():
            err = np.linalg.norm(got[path] - w) / max(np.linalg.norm(w), 1e-12)
            assert err <= PARAM_REL, f"{saved} {path}: off by {err:.3g}"


# --------------------------------------------------------------- detector


def _jax_detector(spec):
    m = dict(spec["model"])
    rpn, pt = jrpn.RPNConfig(**m.pop("rpn")), jtargets.ProposalTargetConfig(**m.pop("pt"))
    m["anchor_scales"] = tuple(m["anchor_scales"])
    return jfr.DetectorConfig(rpn=rpn, pt=pt, **m)


def test_detector_two_ranks_equal_jax_with_unequal_counts(tmp_path):
    spec = W.detector_spec()
    jcfg = _jax_detector(spec)
    jp = jax.tree_util.tree_map(np.asarray, jit_init(jfr.init_detector, jcfg,
                                                     jax.random.PRNGKey(0)))
    jp["rpn"]["cls"]["w"] = jp["rpn"]["cls"]["w"] * 30         # some foreground RoIs
    B, (H, Wd) = spec["batch"], spec["image_hw"]
    batch = W.detector_batch(B, (H, Wd), jcfg.num_classes, jcfg.num_att_classes, seed=7)
    np.savez(tmp_path / "batch.npz", **batch)
    key = jax.random.PRNGKey(8)
    n_anchors = (H // 16) * (Wd // 16) * len(jcfg.anchor_scales) * 3
    draws = jax_train_draws(key, B, n_anchors, jcfg.rpn.post_nms_top_n,
                            jcfg.pt.rois_per_image)
    np.savez(tmp_path / "draws.npz", **{f: d.numpy()[None] for f, d in draws._asdict().items()})
    spec.update(params=_save_tree(jp, tmp_path / "params.npz"),
                batch_npz=str(tmp_path / "batch.npz"), draws=str(tmp_path / "draws.npz"),
                save=str(tmp_path / "ranks.npz"))

    ranks = W.launch_two_process_run({"detector": spec}, device="cpu", timeout=TIMEOUT,
                                     out_dir=str(tmp_path / "w"))

    tx = make_detector_optimizer(jp, **spec["optimizer"])
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)

    @jax.jit
    def jstep(p, o):
        def loss_fn(pp):
            losses = jfr.detector_forward_train(
                pp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, key)
            return losses["total"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, _ = tx.update(grads, o, p)
        return losses, jax.tree_util.tree_map(lambda a, u: a + u, p, upd)

    jlosses, jnew = jstep(jparams, tx.init(jparams))
    jlosses = {k: float(v) for k, v in jlosses.items()}
    ranks = [r["detector"] for r in ranks]
    for r in ranks:
        assert r["det_losses"] == ranks[0]["det_losses"]
        for name, want in jlosses.items():
            np.testing.assert_allclose(r["det_losses"][0][name], want, rtol=METRIC_RTOL,
                                       err_msg=name)
    assert all(v > 0 for v in jlosses.values())                # every term is exercised

    # each rank's own means, averaged: what a step without the global
    # denominators would report; far off JAX's
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        np.savez(tmp_path / "half.npz", **{k: (v if k == "att_counts" else v[rows])
                                           for k, v in batch.items()})
        np.savez(tmp_path / "half_draws.npz",
                 **{f: d.numpy()[None, rows] for f, d in draws._asdict().items()})
        halves.append(W.run_payloads({"detector": dict(
            spec, batch=2, batch_npz=str(tmp_path / "half.npz"),
            draws=str(tmp_path / "half_draws.npz"), save=None)}, "cpu")["detector"]["det_losses"][0])
    for name in ("rpn_cls", "rcnn_cls_atts", "total"):
        averaged = (halves[0][name] + halves[1][name]) / 2
        assert abs(averaged - jlosses[name]) > 100 * METRIC_RTOL * abs(jlosses[name]), name

    before = dict(named_leaves(jp))
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jnew)))
    got = _leaves(tmp_path / "ranks.npz")
    moved = 0
    for path, w in want.items():
        dw, dg = w - before[path], got[path] - before[path]
        scale = np.linalg.norm(dw)
        moved += scale > 0
        assert np.abs(dg - dw).max() <= UPDATE_REL * max(scale, 1e-12) + 1e-7, path
    assert moved >= 50                  # the heads, the RPN and layer4 (the backbone's rest is frozen)


# ------------------------------------------------------------ checkpoints


def test_checkpoints_restore_across_world_sizes(tmp_path):
    """One process saves after a step; two ranks restore it and take the
    second step as one process does in two steps, then save; one process
    restores the two ranks' save with their params and step."""
    ckpt = str(tmp_path / "ckpts")
    base = W.captioner_spec(ckpt_dir=ckpt)

    def payload(**kw):
        return W.run_payloads({"captioner": dict(base, **kw)}, "cpu")["captioner"]

    one = payload(steps=1, ckpt_save="single_step1")
    two = payload(steps=2, ckpt_dir=None)
    assert one["opt_step"] == 1 and two["opt_step"] == 2

    ranks = W.launch_two_process_run(
        {"captioner": dict(base, steps=1, ckpt_restore="single_step1",
                           ckpt_save="multi_step2")},
        device="cpu", timeout=TIMEOUT, out_dir=str(tmp_path / "w"))
    for r in ranks:
        assert r["process_count"] == 2
        r = r["captioner"]
        assert r["opt_step"] == 2
        np.testing.assert_allclose(r["loss"], two["loss"], rtol=METRIC_RTOL)
        np.testing.assert_allclose(r["param_norm_sq"], two["param_norm_sq"], rtol=1e-6)
    assert sorted(os.listdir(ckpt)) == ["multi_step2", "single_step1"]

    restored = payload(steps=0, ckpt_restore="multi_step2")
    assert restored["opt_step"] == 2
    assert restored["param_norm_sq"] == ranks[0]["captioner"]["param_norm_sq"]


def test_a_failing_rank_fails_the_launch(tmp_path):
    spec = W.captioner_spec()
    spec["params"] = str(tmp_path / "missing.npz")
    with pytest.raises(RuntimeError, match="worker 0 failed"):
        W.launch_two_process_run({"captioner": spec}, device="cpu", timeout=TIMEOUT,
                                 out_dir=str(tmp_path / "w"))


def test_launchers_default_to_the_card(tmp_path, monkeypatch):
    """With no device given, the launchers and the worker CLI take the card;
    with no GPU they raise before any rank starts and never fall back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.launch_two_process_run({"captioner": W.captioner_spec()}, timeout=TIMEOUT,
                                 out_dir=str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.launch_ranks(4, ("captioner",), timeout=TIMEOUT, out_dir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_ranks_sharing_a_card_need_gloo(tmp_path, monkeypatch):
    """Two ranks on one card: an explicit ``cuda:i`` is shared over gloo
    (NCCL refuses two ranks on one GPU), and more ranks than cards without
    one is refused by name; both before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on 1 CUDA device.*device='cuda:0'"):
        W.launch_two_process_run(out_dir=str(tmp_path / "w"))
    with pytest.raises(ValueError, match="share cuda:0, which needs backend='gloo'"):
        W.launch_two_process_run(device="cuda:0", backend="nccl", out_dir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()
