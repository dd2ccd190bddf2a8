"""The port's deterministic decodes against the JAX package, f32 on the CPU:
the unfolded step (``cell_step``, ``make_step_fn``), beam search and greedy
decoding, the dense CBS over a packed FSM, the host-side beam selections
and ``DecodeHarness.decode_beam``. Weights are carried over by
``from_jax_params``; features and z-noise come from numpy seeds.

Where the JAX function draws its z-noise from PRNG keys inside the step,
the test draws the same normals with JAX (``_key_draws``) and hands them to
the port as its noise stack.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import fsm as jfsm
from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.decoding import select as jselect
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models import updown_cell as jcell
from style_seqcvae_tpu_torch.decoding import beam_search as tbs
from style_seqcvae_tpu_torch.decoding import cbs as tdense
from style_seqcvae_tpu_torch.decoding import cbs_fast as tcbs
from style_seqcvae_tpu_torch.decoding import fsm as tfsm
from style_seqcvae_tpu_torch.decoding import select as tselect
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.models import updown_cell as tcell
from style_seqcvae_tpu_torch.weights import from_jax_params

# the JAX package's decoding/__init__.py binds the names beam_search and
# constrained_beam_search to functions, so the modules come from sys.modules
jbs = importlib.import_module("style_seqcvae_tpu.decoding.beam_search")
jdense = importlib.import_module("style_seqcvae_tpu.decoding.cbs")

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "golden_decode.npz"
V, B, NZ, S, BEAM, T, NBOX, F, H, Z = 40, 2, 2, 8, 4, 6, 5, 12, 10, 4
# Step values agree to ~1e-6 (the same f32 products summed in another
# order); scores are sums of T of them. 1e-4 leaves room without hiding a
# wrong token, which moves a score by far more.
ATOL = 1e-5
SCORE_ATOL = 1e-4
END_LOGIT = 6.5

MODES = {
    "mode0": dict(sentiment_vae=0, simple_vae=False),
    "mode1": dict(sentiment_vae=1, simple_vae=False),
    "mode2_glove": dict(sentiment_vae=2, simple_vae=False),
    "mode2_senti_word_net": dict(sentiment_vae=2, simple_vae=False,
                                 latent_embedding="senti_word_net"),
}


def _cfg(**kw):
    base = dict(vocab_size=V, image_feature_size=F, embedding_size=300, hidden_size=H,
                attention_projection_size=6, z_space=Z, sentiment_vae=1, simple_vae=False,
                max_caption_length=T, beam_size=BEAM)
    base.update(kw)
    return jcap.CaptionerConfig(**base), tcap.CaptionerConfig(**base)


def _params(jcfg, seed, logits=((1, END_LOGIT),)):
    """JAX params with the logits of the given (token, logit) pairs pushed to
    about that logit (tied head: the token's embedding along the head's bias
    direction; untied: its output bias). By default the end token's, so that
    some captions end before T and frozen beams are compared too. Returns
    (JAX params, the port's params on the CPU)."""
    params = jcap.init_captioner(jax.random.PRNGKey(seed), jcfg)
    for token, logit in logits:
        if jcfg.tie_embeddings:
            direction = jnp.tanh(params["output_projection"]["b"])
            direction = direction / jnp.sum(direction ** 2)
            params["embedding"] = params["embedding"].at[token].set(logit * direction)
        else:
            params["output_layer"]["b"] = params["output_layer"]["b"].at[token].set(logit)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(np_params, device="cpu")


def _inputs(jcfg, seed, batch=B):
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, NBOX, F).astype(np.float32)
    feats[-1, -1] = 0.0                      # one padded box
    sent = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    oae = (rng.randn(batch, NBOX, jcfg.z_space).astype(np.float32)
           if jcfg.sentiment_vae == 2 else None)
    return feats, sent, oae


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _contexts(params, tparams, jcfg, tcfg, feats, sent, oae):
    jctx = jcap.make_decode_context(params, jcfg, _j(feats), sentiment=_j(sent),
                                    obj_att_embeds=_j(oae))
    tctx = tcap.make_decode_context(tparams, tcfg, _t(feats), sentiment=_t(sent),
                                    obj_att_embeds=_t(oae))
    return jctx, tctx


STEPS = {"unfolded": (jcap.make_step_fn, tcap.make_step_fn),
         "optimized": (jcap.make_optimized_step_fn, tcap.make_optimized_step_fn)}


def _key_draws(key, first_shape, later_shape, max_steps=T):
    """The z-noise that JAX's searches draw inside the step from ``key``:
    ``rng, k0 = split(key)``, then ``split(rng, max_steps - 1)``, each draw
    ``normal(k, shape)`` in f32 (``updown_cell.py:222-233``). Returned as the
    port's (max_steps, *later_shape) stack, the first draw in row 0's first
    slots."""
    rng, k0 = jax.random.split(key)
    keys = jax.random.split(rng, max_steps - 1)
    stack = np.zeros((max_steps,) + tuple(later_shape), np.float32)
    stack[0][tuple(slice(0, n) for n in first_shape)] = np.asarray(
        jax.random.normal(k0, first_shape, jnp.float32))
    for t in range(1, max_steps):
        stack[t] = np.asarray(jax.random.normal(keys[t - 1], later_shape, jnp.float32))
    return stack


# --------------------------------------------------------------- the step


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cell_step_matches_jax(mode):
    jcfg, tcfg = _cfg(**MODES[mode])
    params, tparams = _params(jcfg, 0)
    feats, sent, oae = _inputs(jcfg, 1)
    jctx, tctx = _contexts(params, tparams, jcfg, tcfg, feats, sent, oae)
    rng = np.random.RandomState(2)
    grid = (B, 2, 3)
    emb = rng.randn(*grid, 300).astype(np.float32)
    state = [rng.randn(*grid, H).astype(np.float32) for _ in range(6)]
    eps = rng.randn(*grid, Z).astype(np.float32)
    fields = ("image_features", "projected_image_features", "averaged_image_features",
              "image_features_mask", "sentiment", "obj_att_embeds", "prior_mean", "prior_var")
    common = dict(training=False, sentiment_vae=jcfg.sentiment_vae,
                  simple_vae=jcfg.simple_vae, latent_embedding=jcfg.latent_embedding)
    jout = jcell.cell_step(params["cell"], jnp.asarray(emb), jcell.CellState(*map(_j, state)),
                           rng=jnp.asarray(eps), **{f: getattr(jctx, f) for f in fields},
                           **common)
    targs = dict(**{f: getattr(tctx, f) for f in fields}, **common)
    tstate = tcell.CellState(*map(_t, state))
    # eps= and a floating rng are the same noise
    for noise in (dict(rng=_t(eps)), dict(rng=None, eps=_t(eps))):
        tout = tcell.cell_step(tparams["cell"], _t(emb), tstate, **targs, **noise)
        for got, want in zip(tout, jout):
            if isinstance(want, tuple):
                for g, w in zip(got, want):
                    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    a = tcell.cell_step(tparams["cell"], _t(emb), tstate, **targs,
                        rng=torch.Generator().manual_seed(3))[0]
    b = tcell.cell_step(tparams["cell"], _t(emb), tstate, **targs,
                        rng=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b)
    # the training branch takes its noise as eps or from a generator only
    with pytest.raises(TypeError, match="not a noise tensor"):
        tcell.cell_step(tparams["cell"], _t(emb), tstate, **{**targs, "training": True},
                        rng=_t(eps))


@pytest.mark.parametrize("contract", ["log_probs", "raw"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_make_step_fn_matches_jax_and_optimized(mode, contract):
    jcfg, tcfg = _cfg(**MODES[mode])
    params, tparams = _params(jcfg, 1)
    feats, sent, oae = _inputs(jcfg, 2)
    jctx, tctx = _contexts(params, tparams, jcfg, tcfg, feats, sent, oae)
    rng = np.random.RandomState(3)
    grid = (B, 2, 3)
    tokens = rng.randint(0, V, grid)
    state = [rng.randn(*grid, H).astype(np.float32) for _ in range(6)]
    eps = rng.randn(*grid, Z).astype(np.float32)
    raw = contract == "raw"
    jout, jstate = jcap.make_step_fn(params, jcfg, jctx, return_raw=raw)(
        jnp.asarray(tokens), jcell.CellState(*map(_j, state)), jnp.asarray(eps))
    tstate_in = tcell.CellState(*map(_t, state))
    tout, tstate = tcap.make_step_fn(tparams, tcfg, tctx, return_raw=raw)(
        torch.from_numpy(tokens), tstate_in, _t(eps))
    oout, ostate = tcap.make_optimized_step_fn(tparams, tcfg, tctx, return_raw=raw)(
        torch.from_numpy(tokens), tstate_in, _t(eps))
    flat = (lambda o: list(o)) if raw else (lambda o: [o])
    for got, opt, want in zip(flat(tout), flat(oout), flat(jout)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got.numpy(), opt.numpy(), atol=ATOL, rtol=ATOL)
    for f in tcell.CellState._fields:
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(getattr(tstate, f).numpy(), getattr(ostate, f).numpy(),
                                   atol=ATOL, rtol=ATOL)


# bf16 keeps 8 bits, and XLA rounds fused elementwise chains once where
# PyTorch rounds each operation: values within 2e-2 of the largest
# magnitude of the compared tensor (the tied head's logits reach ~30, whose
# bf16 step is 0.125)
BF16_REL = 2e-2


def _lstm_input_dtypes(monkeypatch, module):
    """Record the dtype of every LSTM input ``module``'s cell step builds."""
    seen = []
    real = module.lstm_cell

    def spy(params, x, h, c):
        seen.append(str(x.dtype).split(".")[-1])
        return real(params, x, h, c)

    monkeypatch.setattr(module, "lstm_cell", spy)
    return seen


@pytest.mark.parametrize("mode", ["mode1", "mode2_glove"])
def test_make_step_fn_bf16_dtypes_follow_jax(monkeypatch, mode):
    """The unfolded inference step in bf16 over three steps: the inputs of
    the attention and decoder LSTMs, every state field and the log-probs
    have JAX's dtypes (the f32 prior makes z, and so the decoder LSTM's
    input, f32: ``jnp.concatenate`` promotes), and the values agree."""
    from style_seqcvae_tpu.training.trainer import _compute_cast
    from style_seqcvae_tpu_torch.weights import cast_floats

    jcfg, tcfg = _cfg(**MODES[mode])
    params, tparams = _params(jcfg, 1)
    jp, tp = _compute_cast(params, jnp.bfloat16), cast_floats(tparams, torch.bfloat16)
    feats, sent, oae = _inputs(jcfg, 2)
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jctx = jcap.make_decode_context(jp, jcfg, bf(feats), sentiment=_j(sent),
                                    obj_att_embeds=bf(oae))
    tctx = tcap.make_decode_context(tp, tcfg, _t(feats).bfloat16(), sentiment=_t(sent),
                                    obj_att_embeds=None if oae is None else _t(oae).bfloat16())
    jseen = _lstm_input_dtypes(monkeypatch, jcell)
    tseen = _lstm_input_dtypes(monkeypatch, tcell)
    jstep, tstep = jcap.make_step_fn(jp, jcfg, jctx), tcap.make_step_fn(tp, tcfg, tctx)
    jstate = jcell.init_cell_state((B,), H, jnp.bfloat16)
    tstate = tcell.init_cell_state((B,), H, device=torch.device("cpu"), dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    tokens = np.full((B,), 1)
    for t in range(3):
        eps = rng.randn(B, Z).astype(np.float32)
        jlp, jstate = jstep(jnp.asarray(tokens), jstate, jnp.asarray(eps))
        tlp, tstate = tstep(torch.from_numpy(tokens), tstate, _t(eps))
        assert tseen == jseen, f"step {t}: LSTM inputs {tseen}, JAX {jseen}"
        pairs = [("log_probs", tlp, jlp)] + [(f, getattr(tstate, f), getattr(jstate, f))
                                            for f in tcell.CellState._fields]
        for name, got, want in pairs:
            assert str(got.dtype).split(".")[-1] == str(want.dtype), f"step {t} {name}"
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_REL,
                                       atol=BF16_REL * np.abs(want).max(),
                                       err_msg=f"step {t} {name}")
        tokens = np.asarray(jnp.argmax(jlp, axis=-1))      # JAX's choice feeds both
    assert jseen[1::2] == ["float32"] * 3                   # the decoder LSTM's input


# ------------------------------------------------ golden fixture, beam, greedy


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_golden_decode_reproduced(kind):
    """``tests/fixtures/golden_decode.npz`` (``test_golden_decode.py``):
    greedy and beam search through the step from PRNGKey(3)."""
    data = np.load(FIXTURE)
    kw = dict(vocab_size=120, image_feature_size=32, embedding_size=300, hidden_size=24,
              attention_projection_size=16, z_space=8, sentiment_vae=1, simple_vae=False,
              max_caption_length=12, beam_size=4)
    jcfg, tcfg = jcap.CaptionerConfig(**kw), tcap.CaptionerConfig(**kw)
    _, treedef = jax.tree_util.tree_flatten(jcap.init_captioner(jax.random.PRNGKey(42), jcfg))
    params = jax.tree_util.tree_unflatten(
        treedef, [data[f"p{i}"] for i in range(treedef.num_leaves)])
    tparams = from_jax_params(params, device="cpu")
    feats = torch.from_numpy(data["feats"])
    n = feats.shape[0]
    ctx = tcap.make_decode_context(tparams, tcfg, feats, sentiment=torch.from_numpy(data["sent"]))
    step = STEPS[kind][1](tparams, tcfg, ctx)
    st = tcell.init_cell_state((n,), 24, device=torch.device("cpu"))
    start = torch.full((n,), 1, dtype=torch.long)
    key = jax.random.PRNGKey(3)

    noise = torch.from_numpy(_key_draws(key, (n, 1, 8), (n, 1, 8), 12))
    greedy = tbs.greedy_decode(step, start, st, noise, max_steps=12, end_index=1)
    np.testing.assert_array_equal(greedy.numpy(), data["greedy"])

    noise = torch.from_numpy(_key_draws(key, (n, 1, 8), (n, 4, 8), 12))
    beams, lp = tbs.beam_search(step, start, st, noise, max_steps=12, beam_size=4,
                                per_node_beam_size=2, end_index=1)
    np.testing.assert_array_equal(beams.numpy(), data["beams"])
    np.testing.assert_allclose(lp.numpy(), data["lp"], atol=1e-5)


@pytest.mark.parametrize("mode", ["mode1", "mode2_glove"])
@pytest.mark.parametrize("kind", sorted(STEPS))
def test_beam_and_greedy_match_jax_given_noise(kind, mode):
    """JAX's ``beam_search`` and ``greedy_decode`` with ``noise=``: rows that
    broadcast to the first step's (B, 1, z), handed to both sides as they
    are."""
    jcfg, tcfg = _cfg(**MODES[mode])
    params, tparams = _params(jcfg, 4)
    feats, sent, oae = _inputs(jcfg, 5)
    noise = np.random.RandomState(6).randn(T, B, 1, Z).astype(np.float32)
    jmake, tmake = STEPS[kind]

    @jax.jit
    def run(params, feats, sent, oae, noise):
        ctx = jcap.make_decode_context(params, jcfg, feats, sentiment=sent, obj_att_embeds=oae)
        step = jmake(params, jcfg, ctx)
        st = jcell.init_cell_state((B,), H, jnp.float32)
        start = jnp.full((B,), 1)
        beams, lp = jbs.beam_search(step, start, st, jax.random.PRNGKey(0), max_steps=T,
                                    beam_size=BEAM, per_node_beam_size=BEAM // 2,
                                    end_index=1, noise=noise)
        greedy = jbs.greedy_decode(step, start, st, jax.random.PRNGKey(0), max_steps=T,
                                   end_index=1, noise=noise)
        return beams, lp, greedy

    ref_beams, ref_lp, ref_greedy = map(np.asarray, run(params, _j(feats), _j(sent), _j(oae),
                                                        jnp.asarray(noise)))
    _, tctx = _contexts(params, tparams, jcfg, tcfg, feats, sent, oae)
    step = tmake(tparams, tcfg, tctx)
    st = tcell.init_cell_state((B,), H, device=torch.device("cpu"))
    start = torch.full((B,), 1, dtype=torch.long)
    beams, lp = tbs.beam_search(step, start, st, torch.from_numpy(noise), max_steps=T,
                                beam_size=BEAM, per_node_beam_size=BEAM // 2, end_index=1)
    greedy = tbs.greedy_decode(step, start, st, torch.from_numpy(noise), max_steps=T,
                               end_index=1)
    np.testing.assert_array_equal(beams.numpy(), ref_beams)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(greedy.numpy(), ref_greedy)
    assert (ref_beams == 1).any()                 # some beams ended early


# ------------------------------------------------------------- dense CBS


def _dense_fsm(rng, kind):
    """Simple-CBS FSM over S states, three single-word constraints of two
    wordforms; states 6 and 7 only loop to themselves, so no beam reaches
    them. ``token_zero``: one wordform is token 0, the token that padded
    exception slots carry. ``shared_wordform``: constraints 0 and 1 share a
    wordform, so that token moves a state to two destinations."""
    f = np.zeros((S, S, V), np.uint8)
    for s in range(S):
        f[s, s, :] = 1
    toks = rng.randint(2, V, (3, 2))
    if kind == "token_zero":
        toks[0, 0] = 0
    else:
        toks[1, 0] = toks[0, 0]
    for c in range(3):
        stride = 2 ** c
        for s in range(S):
            if not (s & stride) and (s | stride) < 6:
                for t in toks[c]:
                    f[s, s | stride, t] = 1
                    f[s, s, t] = 0
    return f


@pytest.mark.parametrize("kind", ["token_zero", "shared_wordform"])
def test_dense_cbs_matches_jax(kind):
    jcfg, tcfg = _cfg()
    # token 0 (a wordform in the token_zero FSMs) scores just below the end
    # token, so beams take it as a constraint
    params, tparams = _params(jcfg, 7, ((1, END_LOGIT), (0, 0.9 * END_LOGIT)))
    feats, sent, oae = _inputs(jcfg, 8)
    rng = np.random.RandomState(9)
    dense = [_dense_fsm(rng, kind) for _ in range(B)]
    packed = np.stack([jfsm.pack_fsm(d) for d in dense])
    np.testing.assert_array_equal(np.stack([tfsm.pack_fsm(d) for d in dense]), packed)
    for d, p in zip(dense, packed):
        np.testing.assert_array_equal(tfsm.unpack_fsm(p), jfsm.unpack_fsm(p))
        np.testing.assert_array_equal(tfsm.unpack_fsm(p), d)
    if kind == "shared_wordform":
        assert (np.unpackbits(packed.view(np.uint8)).reshape(packed.shape + (32,)).sum(-1)
                > 1).any()
    key = jax.random.PRNGKey(10)

    @jax.jit
    def run(params, feats, sent, packed, key):
        ctx = jcap.make_decode_context(params, jcfg, feats, sentiment=sent)
        step = jcap.make_optimized_step_fn(params, jcfg, ctx)
        return jdense.constrained_beam_search(
            step, jnp.full((B,), 1), jcell.init_cell_state((B,), H, jnp.float32), packed, key,
            max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2, end_index=1)

    ref_seqs, ref_lp = map(np.asarray, run(params, _j(feats), _j(sent), jnp.asarray(packed), key))
    _, tctx = _contexts(params, tparams, jcfg, tcfg, feats, sent, oae)
    noise = torch.from_numpy(_key_draws(key, (B, 1, 1, Z), (B, S, BEAM, Z)))
    seqs, lp = tdense.constrained_beam_search(
        tcap.make_optimized_step_fn(tparams, tcfg, tctx), torch.full((B,), 1, dtype=torch.long),
        tcell.init_cell_state((B,), H, device=torch.device("cpu")), packed, noise,
        max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2, end_index=1)
    assert seqs.shape == (B, S, BEAM, T)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)          # every state and beam
    reach = ref_lp > -1e18
    assert reach.any() and (~reach).any()
    np.testing.assert_allclose(lp.numpy()[reach], ref_lp[reach], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(lp.numpy()[~reach], ref_lp[~reach])
    if kind == "token_zero":
        assert (seqs.numpy()[reach] == 0).any()   # the token-0 constraint was decoded


def test_dense_cbs_matches_fast_on_reachable_states():
    """The port's dense CBS and its ``constrained_beam_search_fast`` (the
    log-prob selection) keep the same beams wherever a state is reachable."""
    jcfg, tcfg = _cfg()
    _, tparams = _params(jcfg, 11)
    feats, sent, _ = _inputs(jcfg, 12)
    rng = np.random.RandomState(13)
    dense = [_dense_fsm(rng, "token_zero") for _ in range(B)]
    noise = torch.from_numpy(np.random.RandomState(14).randn(T, B, S, BEAM, Z).astype(np.float32))
    ctx = tcap.make_decode_context(tparams, tcfg, _t(feats), sentiment=_t(sent))
    step = tcap.make_optimized_step_fn(tparams, tcfg, ctx)
    start = torch.full((B,), 1, dtype=torch.long)
    st = tcell.init_cell_state((B,), H, device=torch.device("cpu"))
    kw = dict(max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2, end_index=1)
    seqs, lp = tdense.constrained_beam_search(
        step, start, st, np.stack([tfsm.pack_fsm(d) for d in dense]), noise, **kw)
    fsm = tcbs.fsm_to_device(tcbs.stack_fsm_tables([tcbs.fsm_to_tables(d) for d in dense]),
                             torch.device("cpu"))
    fseqs, flp = tcbs.constrained_beam_search_fast(step, start, st, fsm, noise,
                                                   selection="logprob", **kw)
    reach = lp.numpy() > -1e18
    np.testing.assert_array_equal(reach, flp.numpy() > -1e18)
    assert reach.sum() > B * BEAM
    np.testing.assert_array_equal(seqs.numpy()[reach], fseqs.numpy()[reach])
    np.testing.assert_allclose(lp.numpy()[reach], flp.numpy()[reach], atol=SCORE_ATOL, rtol=0)


# --------------------------------------------------------- beam selection


def test_select_best_beam_matches_jax():
    beams = np.random.RandomState(0).randint(0, V, (3, BEAM, T))
    np.testing.assert_array_equal(tselect.select_best_beam(beams, None),
                                  jselect.select_best_beam(beams, None))


@pytest.mark.parametrize("mode", ["cbs_simple", "grounded"])
def test_select_best_beam_with_constraints_matches_jax(mode):
    rng = np.random.RandomState(1)
    n_img, states = 3, 8
    beams = rng.randint(0, V, (n_img, states, BEAM, T))
    lp = rng.randn(n_img, states, BEAM).astype(np.float32)
    given = [3, 2, 1]
    kw = dict(min_constraints_to_satisfy=2, cbs_simple=mode == "cbs_simple")
    if mode == "grounded":
        # an object with attributes needs one of them too; state sets as
        # the FSM builder's constraint2states gives them
        kw["constraints"] = [[("dog", ["brown", "big"]), ("cat", []), ("car", ["red"])],
                             [("dog", []), ("cat", ["black"])],
                             [("tree", [])]]
        kw["constraint2states"] = [
            {"dog": [1, 3, 5, 7], "brown": [3, 7], "big": [5], "cat": [2, 3, 6, 7],
             "car": [4, 5, 6, 7], "red": [6, 7]},
            {"dog": [1, 3], "cat": [2, 3], "black": [3]},
            {"tree": [1]}]
    want_best, want_valid = jselect.select_best_beam_with_constraints(beams, lp, given, **kw)
    got_best, got_valid = tselect.select_best_beam_with_constraints(beams, lp, given, **kw)
    assert got_best.dtype == np.int64
    np.testing.assert_array_equal(got_best, want_best)
    assert len(got_valid) == len(want_valid) == n_img
    for g, w in zip(got_valid, want_valid):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ decode_beam


def _jax_decode_beam_with_noise(params, jcfg, feats, sent, oae, noise):
    """A JAX harness-equivalent of ``decode_beam`` with shared noise:
    ``beam_search`` on the optimized log-prob step, vmapped over z, each z
    given its (T, B, 1, z) noise."""

    @jax.jit
    def run(params, feats, sent, oae, noise):
        n = feats.shape[0]
        ctx = jcap.make_decode_context(params, jcfg, feats, sentiment=sent, obj_att_embeds=oae)
        step = jcap.make_optimized_step_fn(params, jcfg, ctx)
        st = jcell.init_cell_state((n,), jcfg.hidden_size, jnp.float32)

        def one_z(noise_z):
            seqs, lp = jbs.beam_search(step, jnp.full((n,), 1), st, jax.random.PRNGKey(0),
                                       max_steps=T, beam_size=jcfg.beam_size,
                                       per_node_beam_size=jcfg.beam_size // 2,
                                       end_index=1, noise=noise_z)
            return seqs[:, 0, :], lp[:, 0]

        return jax.vmap(one_z)(noise)

    return map(np.asarray, run(params, _j(feats), _j(sent), _j(oae), jnp.asarray(noise)))


DECODE_BEAM_CASES = {
    "tied": dict(),
    "untied": dict(embedding_size=16),
    "mode2_glove": MODES["mode2_glove"],
    "mode2_senti_word_net": MODES["mode2_senti_word_net"],
}


@pytest.mark.parametrize("case", sorted(DECODE_BEAM_CASES))
def test_decode_beam_matches_jax(case):
    jcfg, tcfg = _cfg(**DECODE_BEAM_CASES[case])
    params, tparams = _params(jcfg, 15)
    feats, sent, oae = _inputs(jcfg, 16)
    harness = DecodeHarness(tparams, tcfg, device="cpu")

    # shared noise, one row per step broadcast over the beams
    noise = np.random.RandomState(17).randn(NZ, T, B, 1, Z).astype(np.float32)
    ref_seqs, ref_lp = _jax_decode_beam_with_noise(params, jcfg, feats, sent, oae, noise)
    seqs, lp = harness.decode_beam(feats, sent, oae, noise, NZ)
    assert seqs.shape == (NZ, B, T) and lp.shape == (NZ, B)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)

    # the JAX harness itself, its noise drawn per beam from the z keys
    key = jax.random.PRNGKey(18)
    ref_seqs, ref_lp = jharness.DecodeHarness(params, jcfg).decode_beam(
        feats, sent, oae, key, NZ)
    noise = np.stack([_key_draws(k, (B, 1, Z), (B, BEAM, Z))
                      for k in jax.random.split(key, NZ)])
    seqs, lp = harness.decode_beam(feats, sent, oae, noise, NZ)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    assert (ref_seqs == 1).any()


# ------------------------------------------------------------ bad inputs


def _bad_calls():
    jcfg, tcfg = _cfg()
    _, tparams = _params(jcfg, 19)
    feats, sent, _ = _inputs(jcfg, 20)
    harness = DecodeHarness(tparams, tcfg, device="cpu")
    ctx = tcap.make_decode_context(tparams, tcfg, _t(feats), sentiment=_t(sent))
    step = tcap.make_optimized_step_fn(tparams, tcfg, ctx)
    start = torch.full((B,), 1, dtype=torch.long)
    st = tcell.init_cell_state((B,), H, device=torch.device("cpu"))
    ok = torch.zeros(T, B, BEAM, Z)
    kw = dict(max_steps=T, end_index=1)
    packed = np.zeros((B, S, V), np.uint32)
    good = np.zeros((NZ, T, B, BEAM, Z), np.float32)
    return {
        "beam_short_noise": lambda: tbs.beam_search(step, start, st, ok[:-1], beam_size=BEAM, **kw),
        "beam_int_noise": lambda: tbs.beam_search(step, start, st, ok.long(), beam_size=BEAM,
                                                  **kw),
        "greedy_short_noise": lambda: tbs.greedy_decode(step, start, st, ok[1:], **kw),
        "dense_float_fsm": lambda: tdense.constrained_beam_search(
            step, start, st, packed.astype(np.float32), ok, beam_size=BEAM, **kw),
        "dense_fsm_batch": lambda: tdense.constrained_beam_search(
            step, start, st, packed[:1], ok, beam_size=BEAM, **kw),
        "decode_beam_noise_shape": lambda: harness.decode_beam(feats, sent, None, good[:, :, :1],
                                                               NZ),
        "decode_beam_noise_beams": lambda: harness.decode_beam(feats, sent, None,
                                                               good[:, :, :, :3], NZ),
        "decode_beam_int_noise": lambda: harness.decode_beam(feats, sent, None,
                                                             good.astype(np.int64), NZ),
    }


@pytest.mark.parametrize("case", ["beam_short_noise", "beam_int_noise", "greedy_short_noise",
                                  "dense_float_fsm", "dense_fsm_batch",
                                  "decode_beam_noise_shape", "decode_beam_noise_beams",
                                  "decode_beam_int_noise"])
def test_decodes_reject_bad_inputs(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()
