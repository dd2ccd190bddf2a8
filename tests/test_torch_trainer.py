"""The port's train steps (``training/trainer.py``, ``training/optimizer.py``)
against the JAX package's ``make_train_step``.

The port is handed JAX's own z-noise: each JAX step splits its state key
(``rng, step_rng = split(state.rng)``), splits ``step_rng`` into T+1 step
keys and draws a (B, z) f32 normal from each inside the cell; the test makes
the same draws and passes them as the port step's ``eps``.

* Several steps in f32 from the same params: per-step loss, reconstruction
  and KL within rtol 1e-5, and the params after every step within 1e-5 of
  each leaf's norm (f32 sums in other orders, compounded by SGD). The run
  crosses the decoder freeze boundary (inactive, active, inactive, then
  active for good) and holds steps whose gradient norm is clipped and steps
  whose norm is not. The tied embedding never moves; an inactive decoder
  LSTM moves on neither side.
* Chained steps (K stacked batches) equal K single steps, bit for bit; the
  corpus step (rows gathered by ``feat_idx`` from a table) equals the regular
  step on the gathered rows, bit for bit, in modes 1 and 2.
"""

import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.training import trainer as jtrainer
from style_seqcvae_tpu_torch.config import Config as TConfig
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.training import trainer as ttrainer
from style_seqcvae_tpu_torch.training.optimizer import make_labels
from style_seqcvae_tpu_torch.weights import named_leaves
from tests.test_torch_train import (
    B,
    T,
    jax_leaves,
    jax_params,
    make_batch,
    model_kw,
    port_params,
)

torch.set_num_threads(1)

STEPS = 6
PARAM_REL = 1e-5
METRIC_RTOL = 1e-5
# decoder inactive at 1 and 3, active at 2 (every 2nd) and from 4 on; the
# gradient norm of the first step (55-59) stays under the clip, the later
# ones (63-113) go over it
OVERRIDES = ["OPTIM.LR", "0.05", "OPTIM.NUM_ITERATIONS", "100",
             "OPTIM.EPOCH_START_DECODER_TRAINING", "3",
             "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "2",
             "OPTIM.CLIP_GRADIENTS", "60.0"]


def jax_step_draws(key, steps, z):
    """The z-noise of ``steps`` JAX train steps from the state key ``key``:
    (steps, T+1, B, z)."""
    out = []
    for _ in range(steps):
        key, step_rng = jax.random.split(key)
        keys = jax.random.split(step_rng, T + 1)
        out.append(np.stack([np.asarray(jax.random.normal(k, (B, z), jax.numpy.float32))
                             for k in keys]))
    return np.stack(out)


def batches(kw, steps):
    return [make_batch(kw, seed=s) for s in range(steps)]


@pytest.mark.parametrize("case", ["mode1_tied", "mode2_glove_tied"])
def test_train_steps_match_jax(case):
    kw = model_kw(case)
    jcfg, tcfg = jcap.CaptionerConfig(**kw), tcap.CaptionerConfig(**kw)
    jconfig, tconfig = JConfig(config_override=OVERRIDES), TConfig(config_override=OVERRIDES)
    jp = jax_params(kw)
    jstate, tx = jtrainer.create_train_state(jp, jconfig, jcfg, jax.random.PRNGKey(1))
    jstep = jtrainer.make_train_step(tx, jcfg, jconfig.MODEL.KLD_WEIGHT)
    tstate = ttrainer.create_train_state(port_params(jp, requires_grad=False), tconfig, tcfg,
                                         seed=0, device="cpu")
    tstep = ttrainer.make_train_step(tcfg, tconfig.MODEL.KLD_WEIGHT)
    draws = jax_step_draws(jax.random.PRNGKey(1), STEPS, kw["z_space"])
    labels = make_labels(tstate.params, freeze_embedding=True)
    norms, moved = [], []
    update = tstate.tx.update
    tstate.tx.update = lambda: norms.append(float(update())) or norms[-1]
    for i, b in enumerate(batches(kw, STEPS)):
        before = {p: t.detach().clone() for p, t in named_leaves(tstate.params)}
        jstate, jm = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b, eps=draws[i])
        for name in ("loss", "reconstr_loss", "kld_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=METRIC_RTOL,
                                       err_msg=f"step {i + 1} {name}")
        want = jax_leaves(jstate.params)
        for path, t in named_leaves(tstate.params):
            err = np.linalg.norm(t.detach().numpy() - want[path]) / np.linalg.norm(want[path])
            assert err <= PARAM_REL, f"step {i + 1} {path}: off by {err:.3g}"
        moved.append({p: not torch.equal(t.detach(), before[p])
                      for p, t in named_leaves(tstate.params)})
        assert tstate.step == int(jstate.step) == i + 1
    assert labels["embedding"] == "never"
    assert not any(m["embedding"] for m in moved)
    dec = [any(m[p] for p in m if labels[p] == "decoder") for m in moved]
    assert dec == [False, True, False, True, True, True]
    # the gradient norms before the clip: above it on some steps, below on others
    clip = tconfig.OPTIM.CLIP_GRADIENTS
    assert any(n > clip for n in norms) and any(n < clip for n in norms), norms


def _fresh(kw, seed=0):
    tcfg = tcap.CaptionerConfig(**kw)
    state = ttrainer.create_train_state(port_params(jax_params(kw), requires_grad=False),
                                        TConfig(config_override=OVERRIDES), tcfg, seed=seed,
                                        device="cpu")
    return tcfg, state


def _assert_same_state(a, b):
    for (pa, ta), (pb, tb) in zip(named_leaves(a.params), named_leaves(b.params)):
        assert pa == pb and torch.equal(ta, tb), pa
    assert a.step == b.step


def test_chained_steps_equal_sequential():
    kw = model_kw("mode1_tied")
    K = 4
    bs = batches(kw, K)
    stacked = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    tcfg, s1 = _fresh(kw)
    _, s2 = _fresh(kw)
    single = ttrainer.make_train_step(tcfg, 750.0)
    chained = ttrainer.make_chained_train_step(tcfg, 750.0)
    ms = []
    for b in bs:                     # noise from the generator, the same seed
        s1, m = single(s1, b)
        ms.append(m)
    s2, mk = chained(s2, stacked)
    _assert_same_state(s1, s2)
    assert mk["loss"].shape == (K,)
    for name in mk:
        assert torch.equal(mk[name], torch.stack([m[name] for m in ms]))


@pytest.mark.parametrize("case", ["mode1_tied", "mode2_glove_tied"])
def test_corpus_steps_equal_regular_steps(case):
    kw = model_kw(case)
    K = 3
    r = np.random.RandomState(7)
    table = r.randn(10, 5, kw["image_feature_size"]).astype(np.float32)
    table[2, 3:] = 0.0
    oae = r.randn(10, 5, kw["z_space"]).astype(np.float32)
    idx = r.randint(0, 10, (K, B))
    tables = ({"image_features": torch.from_numpy(table), "obj_att_embeds": torch.from_numpy(oae)}
              if kw["sentiment_vae"] == 2 else torch.from_numpy(table))
    corpus_batches, regular = [], []
    for k, b in enumerate(batches(kw, K)):
        cb = {"caption_tokens": b["caption_tokens"], "sentiment": b["sentiment"],
              "feat_idx": idx[k]}
        rb = dict(cb, image_features=table[idx[k]])
        del rb["feat_idx"]
        if kw["sentiment_vae"] == 2:
            rb["obj_att_embeds"] = oae[idx[k]]
        corpus_batches.append(cb)
        regular.append(rb)
    tcfg, s1 = _fresh(kw)
    _, s2 = _fresh(kw)
    _, s3 = _fresh(kw)
    single = ttrainer.make_train_step(tcfg, 750.0)
    corpus = ttrainer.make_corpus_train_step(tcfg, 750.0)
    corpus_k = ttrainer.make_corpus_chained_train_step(tcfg, 750.0)
    for rb, cb in zip(regular, corpus_batches):
        s1, m1 = single(s1, rb)
        s2, m2 = corpus(s2, tables, cb)
        assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(s1, s2)
    s3, mk = corpus_k(s3, tables, {k: np.stack([c[k] for c in corpus_batches])
                                   for k in corpus_batches[0]})
    _assert_same_state(s1, s3)


def test_frozen_leaves_have_no_grad():
    kw = model_kw("mode1_tied")
    tcfg, s = _fresh(kw)
    step = ttrainer.make_train_step(tcfg, 750.0)
    s, _ = step(s, make_batch(kw))                  # iteration 1: decoder inactive
    labels = make_labels(s.params, freeze_embedding=True)
    for path, p in named_leaves(s.params):
        assert (p.grad is None) == (labels[path] in ("never", "decoder")), path
    s, _ = step(s, make_batch(kw, seed=1))          # iteration 2: active
    for path, p in named_leaves(s.params):
        assert (p.grad is None) == (labels[path] == "never"), path
    assert s.optimizer.param_groups[0]["lr"] == pytest.approx(0.05 * (1 - 2 / 100))
