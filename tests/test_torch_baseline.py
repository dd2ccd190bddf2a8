"""The port's UpDown baseline family (``models/baseline.py``, its train step,
``DecodeHarness(family="baseline")``, its weights and its state-dict
importer) against the JAX package's, on the same parameters (JAX's
``init_baseline``, carried over by ``from_jax_params``), batches and noise.

* f32: ``baseline_train_forward``'s loss within rtol 1e-5 and its gradient
  on every leaf within 1e-4 of the leaf's norm (tied and untied heads); six
  ``make_baseline_train_step`` steps: metrics within rtol 1e-5, every leaf
  after every step within 1e-5 of its norm; the freeze schedule moves every
  leaf but the tied embedding on every step.
* bf16: the LSTM inputs, the state fields and the log-probs of three steps
  in JAX's dtypes, values within 2e-2 of each tensor's largest magnitude;
  the bf16-compute loss in JAX's dtype within rtol 2e-2.
* Decodes: ``make_baseline_step_fn`` over three steps (log-probs and state
  within 1e-5), and the harness's ``decode_cbs`` (logprob; batched and per-z
  FSM lists), ``decode_beam`` and ``decode_sample`` (each sampler, on JAX's
  own Gumbel noise) token-identical to JAX's harness, scores within 1e-4;
  the other selections refused.
* Weights: ``from_jax_params`` → ``to_jax_params`` bit-equal, through a
  ``.npz`` too; a tree of the other family refused; the state-dict importer
  equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu.decoding import cbs_fast as jcbs
from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.models import baseline as jbase
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.training import optimizer as joptim
from style_seqcvae_tpu.training import trainer as jtrainer
from style_seqcvae_tpu.training.trainer import _compute_cast
from style_seqcvae_tpu.utils import torch_import as jimport
from style_seqcvae_tpu_torch.config import Config as TConfig
from style_seqcvae_tpu_torch.decoding.harness import SAMPLERS, DecodeHarness
from style_seqcvae_tpu_torch.models import baseline as tbase
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.training import trainer as ttrainer
from style_seqcvae_tpu_torch.training.optimizer import make_labels
from style_seqcvae_tpu_torch.utils import torch_import as timport
from style_seqcvae_tpu_torch.weights import (
    cast_floats,
    from_jax_params,
    load_params_npz,
    named_leaves,
    save_params_npz,
    to_jax_params,
)
from tests.test_torch_cbs import _fsm, _port_tables
from tests.test_torch_decode import BF16_REL, _lstm_input_dtypes
from tests.test_torch_samplers import _sample_draws
from tests.test_torch_train import assert_grads_close, jax_leaves

torch.set_num_threads(1)

# the helpers of tests/test_torch_samplers.py draw for T = 6, and those of
# tests/test_torch_cbs.py build FSMs of S = 8 states over V = 48 tokens
V, B, NZ, S, BEAM, T, NBOX, F, H, P = 48, 2, 2, 8, 3, 6, 6, 24, 16, 12
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_REL = 1e-5
METRIC_RTOL = 1e-5
STEP_ATOL = 1e-5
SCORE_ATOL = 1e-4
END_LOGIT = 6.5
HEADS = {"tied": 300, "untied": 8}
OVERRIDES = ["OPTIM.LR", "0.05", "OPTIM.NUM_ITERATIONS", "100",
             "OPTIM.EPOCH_START_DECODER_TRAINING", "3",
             "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "2", "OPTIM.CLIP_GRADIENTS", "60.0"]


def _cfg(emb=300, **kw):
    base = dict(vocab_size=V, image_feature_size=F, embedding_size=emb, hidden_size=H,
                attention_projection_size=P, z_space=4, max_caption_length=T,
                beam_size=BEAM, pad_index=0, boundary_index=1)
    base.update(kw)
    return jcap.CaptionerConfig(**base), tcap.CaptionerConfig(**base)


def _params(jcfg, seed, end_logit=None):
    """JAX's ``init_baseline`` (with the end token's logit pushed to about
    ``end_logit`` when given, so that some captions end before T) and the
    port's copy on the CPU."""
    params = jbase.init_baseline(jax.random.PRNGKey(seed), jcfg)
    if end_logit is not None:
        direction = jnp.tanh(params["output_projection"]["b"])
        params["embedding"] = params["embedding"].at[1].set(
            end_logit * direction / jnp.sum(direction ** 2))
    return params, from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _batch(jcfg, seed, batch=4):
    """Features with padding boxes; captions with padding and an UNK."""
    r = np.random.RandomState(seed)
    feats = r.randn(batch, NBOX, F).astype(np.float32)
    feats[0, 4:] = 0.0
    toks = r.randint(2, V, (batch, T)).astype(np.int32)
    toks[1, 3:] = 0
    toks[-1, 2] = 0
    return {"image_features": feats, "caption_tokens": toks,
            "sentiment": r.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- training


@pytest.mark.parametrize("head", sorted(HEADS))
def test_baseline_train_forward_and_grads_match_jax(head):
    jcfg, tcfg = _cfg(HEADS[head])
    jp, tp = _params(jcfg, 0)
    batch = _batch(jcfg, 1)

    def jloss(p):
        out = jbase.baseline_train_forward(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.mean(out["loss"]), out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    for _, p in named_leaves(tp):
        p.requires_grad_(True)
    tout = tbase.baseline_train_forward(tp, tcfg, {k: _t(v) for k, v in batch.items()})
    assert set(tout) == {"loss"} and tout["loss"].dtype == torch.float32
    np.testing.assert_allclose(tout["loss"].detach().numpy(), np.asarray(jout["loss"]),
                               rtol=LOSS_RTOL)
    tout["loss"].mean().backward()
    assert_grads_close(tp, jgrads, GRAD_REL)


def _close_scaled(got, want, err_msg):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_REL,
                               atol=BF16_REL * np.abs(want).max(), err_msg=err_msg)


def test_baseline_bf16_dtypes_follow_jax(monkeypatch):
    """bf16 params and features: the step's dtypes equal JAX's along three
    steps (values within 2e-2 of each tensor's largest magnitude: bf16 keeps
    8 bits, and XLA rounds fused chains once where PyTorch rounds each
    operation), and so does the bf16-compute loss."""
    jcfg, tcfg = _cfg()
    jp, tp = _params(jcfg, 2)
    batch = _batch(jcfg, 3)
    jloss = jbase.baseline_train_forward(
        _compute_cast(jp, jnp.bfloat16), jcfg,
        _compute_cast({k: jnp.asarray(v) for k, v in batch.items()}, jnp.bfloat16))["loss"]
    tloss = tbase.baseline_train_forward(
        cast_floats(tp, torch.bfloat16), tcfg,
        cast_floats({k: _t(v) for k, v in batch.items()}, torch.bfloat16))["loss"]
    assert str(tloss.dtype).split(".")[-1] == str(jloss.dtype) == "float32"
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=BF16_REL)

    jseen = _lstm_input_dtypes(monkeypatch, jbase)
    tseen = _lstm_input_dtypes(monkeypatch, tbase)
    feats = batch["image_features"]
    jstep = jbase.make_baseline_step_fn(_compute_cast(jp, jnp.bfloat16), jcfg,
                                        jnp.asarray(feats, jnp.bfloat16))
    tstep = tbase.make_baseline_step_fn(cast_floats(tp, torch.bfloat16), tcfg,
                                        _t(feats).bfloat16())
    n = feats.shape[0]
    jstate = jbase.init_baseline_state((n,), H, jnp.bfloat16)
    tstate = tbase.init_baseline_state((n,), H, device=torch.device("cpu"),
                                       dtype=torch.bfloat16)
    tokens = np.full((n,), 1)
    for t in range(3):
        jlp, jstate = jstep(jnp.asarray(tokens), jstate, jax.random.PRNGKey(t))
        tlp, tstate = tstep(_t(tokens), tstate, None)
        assert tseen == jseen, f"step {t}: LSTM inputs {tseen}, JAX {jseen}"
        for name, got, want in [("log_probs", tlp, jlp)] + [
                (f, getattr(tstate, f), getattr(jstate, f)) for f in tbase.BaselineState._fields]:
            assert str(got.dtype).split(".")[-1] == str(want.dtype), f"step {t} {name}"
            _close_scaled(got, want, f"step {t} {name}")
        tokens = np.asarray(jnp.argmax(jlp, axis=-1))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_baseline_train_steps_match_jax(head):
    """Six steps of the port's baseline train step against JAX's on the same
    batches. The config's freeze schedule (decoder inactive at iterations 1
    and 3) has nothing to freeze: every trainable leaf moves on every step."""
    jcfg, tcfg = _cfg(HEADS[head])
    jp, tp = _params(jcfg, 4)
    jconfig, tconfig = JConfig(config_override=OVERRIDES), TConfig(config_override=OVERRIDES)
    jstate, tx = jtrainer.create_train_state(jp, jconfig, jcfg, jax.random.PRNGKey(1))
    jstep = jtrainer.make_baseline_train_step(tx, jcfg)
    for _, p in named_leaves(tp):
        p.requires_grad_(False)
    tstate = ttrainer.create_train_state(tp, tconfig, tcfg, seed=0, device="cpu")
    tstep = ttrainer.make_baseline_train_step(tcfg)
    labels = make_labels(tstate.params, freeze_embedding=tcfg.tie_embeddings)
    jlabels = jax_leaves(jax.tree_util.tree_map(
        lambda s: np.float32({"always": 0, "never": 1, "decoder": 2}[s]),
        joptim.make_labels(jp, jcfg.tie_embeddings)))
    want_labels = {p: ("always", "never", "decoder")[int(v)] for p, v in jlabels.items()}
    assert labels == want_labels
    assert "decoder" not in labels.values()
    assert (labels["embedding"] == "never") == (head == "tied")
    for i in range(6):
        b = _batch(jcfg, 10 + i)
        before = {p: t.detach().clone() for p, t in named_leaves(tstate.params)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        assert set(tm) == {"loss", "reconstr_loss", "kld_loss"}
        for name in tm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=METRIC_RTOL,
                                       err_msg=f"step {i + 1} {name}")
        assert float(tm["kld_loss"]) == 0.0 and torch.equal(tm["loss"], tm["reconstr_loss"])
        want = jax_leaves(jstate.params)
        for path, t in named_leaves(tstate.params):
            err = np.linalg.norm(t.detach().numpy() - want[path]) / np.linalg.norm(want[path])
            assert err <= PARAM_REL, f"step {i + 1} {path}: off by {err:.3g}"
            assert torch.equal(t.detach(), before[path]) == (labels[path] == "never"), path
        assert tstate.step == int(jstate.step) == i + 1


def test_baseline_bf16_train_step_keeps_f32_masters():
    jcfg, tcfg = _cfg()
    _, tp = _params(jcfg, 5)
    state = ttrainer.create_train_state(tp, TConfig(config_override=OVERRIDES), tcfg, seed=0,
                                        device="cpu")
    step = ttrainer.make_baseline_train_step(tcfg, compute_dtype=torch.bfloat16)
    state, m = step(state, _batch(jcfg, 6))
    assert np.isfinite(float(m["loss"])) and m["loss"].dtype == torch.float32
    for path, p in named_leaves(state.params):
        assert p.dtype == torch.float32, path
        assert (p.grad is None) == (path == "embedding"), path


# --------------------------------------------------------------- decoding


def test_make_baseline_step_fn_matches_jax():
    """Three steps on a (B, 2, 3) grid, the port's noise slot ignored as JAX
    ignores its key."""
    jcfg, tcfg = _cfg()
    jp, tp = _params(jcfg, 7)
    feats = _batch(jcfg, 8, batch=B)["image_features"]
    rng = np.random.RandomState(9)
    grid = (B, 2, 3)
    jstep = jbase.make_baseline_step_fn(jp, jcfg, jnp.asarray(feats))
    tstep = tbase.make_baseline_step_fn(tp, tcfg, _t(feats))
    state = [rng.randn(*grid, H).astype(np.float32) for _ in range(4)]
    jstate, tstate = jbase.BaselineState(*map(jnp.asarray, state)), \
        tbase.BaselineState(*map(_t, state))
    tokens = rng.randint(0, V, grid)
    for t in range(3):
        jlp, jstate = jstep(jnp.asarray(tokens), jstate, jax.random.PRNGKey(t))
        tlp, tstate = tstep(_t(tokens), tstate, torch.from_numpy(rng.randn(*grid, 4)))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=STEP_ATOL, rtol=STEP_ATOL)
        for f in tbase.BaselineState._fields:
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)), atol=STEP_ATOL,
                                       rtol=STEP_ATOL)
        tokens = np.asarray(jnp.argmax(jlp, axis=-1))


def _decode_setup(seed):
    jcfg, tcfg = _cfg()
    jp, tp = _params(jcfg, seed, end_logit=END_LOGIT)
    rng = np.random.RandomState(seed + 1)
    feats = rng.randn(B, NBOX, F).astype(np.float32)
    feats[-1, -1] = 0.0
    sent = rng.choice([-1.0, 1.0], (B, 1)).astype(np.float32)
    tables = [[jcbs.fsm_to_tables(_fsm(rng)) for _ in range(NZ)] for _ in range(B)]
    return (jharness.DecodeHarness(jp, jcfg, family="baseline"),
            DecodeHarness(tp, tcfg, device="cpu", family="baseline"), feats, sent, tables)


@pytest.mark.parametrize("case", ["batched", "per_z_one_image"])
def test_baseline_decode_cbs_matches_jax(case):
    jh, th, feats, sent, tables = _decode_setup(11)
    if case == "per_z_one_image":
        feats, sent, tables, nc, b = feats[:1], sent[:1], tables[0], 3, 1
    else:
        nc, b = [3, 2], B
    ref_best, ref_lp = jh.decode_cbs(feats, sent, None, tables, nc, jax.random.PRNGKey(0), NZ)
    # the noise argument keeps its layout; the baseline's step ignores it
    noise = np.random.RandomState(12).randn(NZ, T, b, S, BEAM, 4).astype(np.float32)
    t_tables = _port_tables(tables) if case == "batched" else _port_tables([tables])[0]
    best, lp = th.decode_cbs(feats, sent, None, t_tables, nc, noise, NZ)
    assert best.shape == ref_best.shape == (NZ, b, T)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    assert np.isfinite(ref_lp).all() and (ref_best == 1).any()
    again, _ = th.decode_cbs(feats, sent, None, t_tables, nc, np.zeros_like(noise), NZ,
                             selection="logprob")
    assert torch.equal(again, best)


def test_baseline_decode_beam_matches_jax():
    jh, th, feats, sent, _ = _decode_setup(13)
    ref_seqs, ref_lp = jh.decode_beam(feats, sent, None, jax.random.PRNGKey(0), NZ)
    noise = np.random.RandomState(14).randn(NZ, T, B, BEAM, 4).astype(np.float32)
    seqs, lp = th.decode_beam(feats, sent, None, noise, NZ)
    assert seqs.shape == (NZ, B, T)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("method", SAMPLERS)
def test_baseline_decode_sample_matches_jax(method):
    """The samplers' Gumbel noise, drawn with JAX from the harness's key
    splits, drives both sides' draws; the z-noise is ignored."""
    jh, th, feats, sent, _ = _decode_setup(15)
    kw = dict(top_k=5, top_p=0.9, temperature=0.8 if method == "topp" else 1.0)
    key = jax.random.PRNGKey(16)
    ref = jh.decode_sample(feats, sent, None, key, NZ, method, **kw)
    draws = [_sample_draws(k, B, V, 4, beam=BEAM if method == "gumbel" else 0)
             for k in jax.random.split(key, NZ)]
    noise = tuple(np.stack([d[i] for d in draws]) for i in range(2))
    got = th.decode_sample(feats, sent, None, noise, NZ, method, **kw)
    assert got.shape == (NZ, B, T)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("selection", ["prehead", "fused", "raw"])
def test_baseline_harness_refuses_other_selections(selection):
    _, th, feats, sent, tables = _decode_setup(17)
    with pytest.raises(ValueError, match="baseline family"):
        th.decode_cbs(feats, sent, None, _port_tables(tables), 3,
                      torch.Generator().manual_seed(0), NZ, selection=selection)


def test_harness_family_checks():
    jcfg, tcfg = _cfg()
    _, tp = _params(jcfg, 18)
    cvae = tcap.init_captioner(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="family must be one of"):
        DecodeHarness(tp, tcfg, device="cpu", family="updown")
    with pytest.raises(ValueError, match="given the baseline family's parameters"):
        DecodeHarness(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="given the cvae family's parameters"):
        DecodeHarness(cvae, tcfg, device="cpu", family="baseline")


# --------------------------------------------------------------- weights


@pytest.mark.parametrize("head", sorted(HEADS))
def test_baseline_weights_round_trip(tmp_path, head):
    jcfg, tcfg = _cfg(HEADS[head])
    jp, tp = _params(jcfg, 19)
    want = jax_leaves(jp)
    back = dict(named_leaves(to_jax_params(tp)))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    save_params_npz(jax.tree_util.tree_map(np.asarray, jp), str(tmp_path / "p.npz"))
    tree = load_params_npz(str(tmp_path / "p.npz"))
    assert set(tree["cell"]) == {"attention_lstm", "attention", "language_lstm"}
    again = from_jax_params(tree, device="cpu", family="baseline")
    assert isinstance(again["cell"], tbase.BaselineCellParams)
    for (pa, a), (pb, b) in zip(named_leaves(again), named_leaves(tp)):
        assert pa == pb and torch.equal(a, b), pa
    with pytest.raises(ValueError, match="the parameters are the baseline family's"):
        from_jax_params(tree, device="cpu", family="cvae")
    cvae = jax.tree_util.tree_map(np.asarray, jcap.init_captioner(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="the parameters are the cvae family's"):
        from_jax_params(cvae, device="cpu", family="baseline")
    with pytest.raises(ValueError, match="not a captioner parameter tree"):
        from_jax_params({"embedding": tree["embedding"], "cell": {}}, device="cpu")


def test_init_baseline_shapes_and_ranges():
    jcfg, tcfg = _cfg()
    jp = jax_leaves(jbase.init_baseline(jax.random.PRNGKey(0), jcfg))
    tp = dict(named_leaves(tbase.init_baseline(tcfg, seed=0, device="cpu")))
    assert tp.keys() == jp.keys()
    for k, t in tp.items():
        assert tuple(t.shape) == jp[k].shape and t.dtype == torch.float32, k
        if k != "embedding":                 # uniform draws: the same bounds
            bound = max(np.abs(jp[k]).max(), 1e-6) * 1.5
            assert float(t.abs().max()) <= bound, k
    assert float(tp["embedding"][tcfg.pad_index].abs().max()) == 0.0
    table = np.random.RandomState(1).randn(V, 300).astype(np.float32)
    tp2 = tbase.init_baseline(tcfg, seed=0, device="cpu", embedding_table=table)
    np.testing.assert_array_equal(tp2["embedding"].numpy(), table)


def test_import_baseline_state_dict_matches_jax():
    """An updown-baseline state dict made with numpy, through both importers."""
    jcfg, tcfg = _cfg()
    r = np.random.RandomState(20)
    E = 300

    def lstm(prefix, n_in):
        return {f"{prefix}.weight_ih": r.randn(4 * H, n_in), f"{prefix}.weight_hh": r.randn(4 * H, H),
                f"{prefix}.bias_ih": r.randn(4 * H), f"{prefix}.bias_hh": r.randn(4 * H)}

    butd = "_updown_cell._butd_attention."
    sd = {**lstm("_updown_cell._attention_lstm_cell", E + F + 2 * H),
          **lstm("_updown_cell._language_lstm_cell", F + 2 * H),
          butd + "_query_vector_projection_layer.weight": r.randn(P, H),
          butd + "_image_features_projection_layer.weight": r.randn(P, F),
          butd + "_attention_layer.weight": r.randn(1, P),
          "_embedding_layer.weight": r.randn(V, E),
          "_output_projection.0.weight": r.randn(E, H),
          "_output_projection.0.bias": r.randn(E)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jax_leaves(jimport.import_baseline_state_dict(
        sd, jbase.init_baseline(jax.random.PRNGKey(0), jcfg)))
    got = timport.import_baseline_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        tbase.init_baseline(tcfg, seed=0, device="cpu"))
    got = dict(named_leaves(got))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
