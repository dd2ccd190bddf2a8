"""The port's stochastic samplers and CIDEr against the JAX package, on the
CPU: the top-k and top-p filters, ``sample_decode``, ``gumbel_beam_search``,
``DecodeHarness.decode_sample`` (against the JAX harness itself) and
``Cider``/``CiderCorpus``. f32 at small widths, weights carried over by
``from_jax_params``; a bf16 search on a fixed step holds the dtypes.

Every draw of the JAX samplers is Gumbel noise (``jax.random.categorical``
is an argmax of the logits plus ``jax.random.gumbel`` of the same key), so
the tests draw the z-noise and the Gumbel noise with JAX from the samplers'
own key splits (``_sample_draws``) and hand both to the port: the tokens
must be identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.evaluation import metrics as jmetrics
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models import updown_cell as jcell
from style_seqcvae_tpu_torch.decoding import samplers as tsam
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.evaluation import metrics as tmetrics
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.models import updown_cell as tcell
from style_seqcvae_tpu_torch.weights import from_jax_params

# the JAX package's decoding/__init__.py may rebind submodule names
jsam = importlib.import_module("style_seqcvae_tpu.decoding.samplers")

torch.set_num_threads(1)

V, B, NZ, K, T, NBOX, F, H, Z = 40, 2, 2, 3, 6, 5, 12, 10, 4
# Step values agree to ~1e-6 (the same f32 products summed in another
# order); phi is a sum of T of them.
ATOL = 1e-5
END_LOGIT = 6.0
# (method, top_k, top_p, temperature) as DecodeHarness.decode_sample takes them
METHODS = {"multinomial": ("multinomial", 0, 0.0, 1.0), "topk": ("topk", 5, 0.0, 1.0),
           "topp": ("topp", 0, 0.9, 0.8), "gumbel": ("gumbel", 0, 0.0, 1.0)}
MODES = {"mode1": dict(sentiment_vae=1), "mode2": dict(sentiment_vae=2)}


def _cfg(**kw):
    base = dict(vocab_size=V, image_feature_size=F, embedding_size=300, hidden_size=H,
                attention_projection_size=6, z_space=Z, sentiment_vae=1, simple_vae=False,
                max_caption_length=T, beam_size=K)
    base.update(kw)
    return jcap.CaptionerConfig(**base), tcap.CaptionerConfig(**base)


def _params(jcfg, seed):
    """JAX params with the end token's logit pushed to about END_LOGIT, so
    that some samples end before T; and the port's copy on the CPU."""
    params = jcap.init_captioner(jax.random.PRNGKey(seed), jcfg)
    direction = jnp.tanh(params["output_projection"]["b"])
    params["embedding"] = params["embedding"].at[1].set(
        END_LOGIT * direction / jnp.sum(direction ** 2))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(np_params, device="cpu")


def _inputs(jcfg, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, NBOX, F).astype(np.float32)
    feats[-1, -1] = 0.0                      # one padded box
    sent = rng.choice([-1.0, 1.0], (B, 1)).astype(np.float32)
    oae = rng.randn(B, NBOX, Z).astype(np.float32) if jcfg.sentiment_vae == 2 else None
    return feats, sent, oae


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _sample_draws(key, batch, vocab, z, beam=0, gumbel_dtype=jnp.float32):
    """The noise JAX's samplers draw from ``key``: ``rng, k0, s0 =
    split(key, 3)``, then ``split(rng, T - 1)``, each key split into the
    step's z key and the Gumbel key (``samplers.py:60-71, 90-112``). z-noise
    ``normal(k, (batch, 1 or beam, z))`` in f32 as the step draws it
    (``captioner.py:473``); Gumbel noise ``gumbel(k, shape, dtype)`` as
    ``categorical`` draws it (the log-probs' dtype) or, with ``beam``, as
    ``gumbel_beam_search`` does (f32, shape (batch, beam, vocab) after the
    first step's (batch, vocab)). Returned as the port's pair of (T, ...)
    stacks, the first draws in row 0's first beam."""
    inner = beam or 1
    rng, k0, s0 = jax.random.split(key, 3)
    keys = jax.random.split(rng, T - 1)
    zs = np.zeros((T, batch, inner, z), np.float32)
    gs = np.zeros((T, batch, beam, vocab) if beam else (T, batch, vocab), np.float32)
    zs[0, :, :1] = np.asarray(jax.random.normal(k0, (batch, 1, z), jnp.float32))
    g0 = np.asarray(jax.random.gumbel(s0, (batch, vocab), gumbel_dtype), np.float32)
    if beam:
        gs[0, :, 0] = g0
    else:
        gs[0] = g0
    for t in range(1, T):
        kstep, kg = jax.random.split(keys[t - 1])
        zs[t] = np.asarray(jax.random.normal(kstep, (batch, inner, z), jnp.float32))
        gs[t] = np.asarray(jax.random.gumbel(kg, gs.shape[1:], gumbel_dtype), np.float32)
    return zs, gs


# --------------------------------------------------------------- filters


def _log_probs(seed, rows=6, vocab=V):
    lp = np.random.RandomState(seed).randn(rows, vocab).astype(np.float32) * 2.0
    return np.array(jax.nn.log_softmax(jnp.asarray(lp), axis=-1))


def _same_filter(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[~np.isneginf(got)], want[~np.isneginf(want)])


@pytest.mark.parametrize("k", [1, 5, 12])
def test_filter_top_k_matches_jax_and_keeps_ties(k):
    lp = _log_probs(0)
    # rows 0-2: the four entries after the k-th largest tied with it
    for r in range(3):
        order = np.argsort(-lp[r])
        lp[r, order[k:k + 4]] = lp[r, order[k - 1]]
    got = tsam._filter_top_k(torch.from_numpy(lp), k)
    _same_filter(got, jsam._filter_top_k(jnp.asarray(lp), k))
    kept = np.isfinite(got.numpy()).sum(axis=-1)
    assert (kept[:3] == k + 4).all() and (kept[3:] == k).all()


def test_filter_top_p_dyadic_boundary():
    """Probabilities 0.5, 0.25, 0.125, 0.125 with p = 0.75: the mass before
    the third token is exactly 0.75 in any order of summation, which is not
    < p, so the third token and its tie are dropped."""
    probs = np.array([0.125, 0.5, 0.125, 0.25], np.float32)
    lp = np.log(probs)[None]
    got = tsam._filter_top_p(torch.from_numpy(lp), 0.75)
    np.testing.assert_array_equal(np.isfinite(got.numpy()[0]), [False, True, False, True])
    _same_filter(got, jsam._filter_top_p(jnp.asarray(lp), 0.75))


@pytest.mark.parametrize("p", [0.3, 0.9])
@pytest.mark.parametrize("temperature", [1.0, 0.8])
def test_filter_top_p_matches_jax(p, temperature):
    lp = _log_probs(1)
    lp[0, :4] = lp[0].max()                   # ties at the top
    if temperature != 1.0:
        jlp = np.asarray(jax.nn.log_softmax(jnp.asarray(lp) / temperature, axis=-1))
        tlp = torch.log_softmax(torch.from_numpy(lp) / temperature, dim=-1)
        np.testing.assert_allclose(tlp.numpy(), jlp, atol=1e-6, rtol=0)
    else:
        jlp, tlp = lp, torch.from_numpy(lp)
    got = tsam._filter_top_p(tlp, p)
    want = np.asarray(jsam._filter_top_p(jnp.asarray(jlp), p))
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = ~np.isneginf(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=1e-6, rtol=0)
    assert (np.isfinite(want).sum(-1) > 1).any() and (np.isneginf(want).any(-1)).all()


# ------------------------------------------------- the samplers on a model


STEPS = {"unfolded": (jcap.make_step_fn, tcap.make_step_fn),
         "optimized": (jcap.make_optimized_step_fn, tcap.make_optimized_step_fn)}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("kind", sorted(STEPS))
def test_samplers_match_jax(kind, method):
    jcfg, tcfg = _cfg()
    params, tparams = _params(jcfg, 0)
    feats, sent, _ = _inputs(jcfg, 1)
    _, top_k, top_p, temperature = METHODS[method]
    jmake, tmake = STEPS[kind]
    key = jax.random.PRNGKey(2)
    gumbel = method == "gumbel"

    @jax.jit
    def run(params, feats, sent, key):
        ctx = jcap.make_decode_context(params, jcfg, feats, sentiment=sent)
        step = jmake(params, jcfg, ctx)
        st = jcell.init_cell_state((B,), H, jnp.float32)
        start = jnp.full((B,), 1)
        if gumbel:
            return jsam.gumbel_beam_search(step, start, st, key, max_steps=T, beam_size=K,
                                           end_index=1)
        return jsam.sample_decode(step, start, st, key, max_steps=T, end_index=1,
                                  temperature=temperature, top_k=top_k, top_p=top_p)

    ref = run(params, _j(feats), _j(sent), key)
    ctx = tcap.make_decode_context(tparams, tcfg, _t(feats), sentiment=_t(sent))
    step = tmake(tparams, tcfg, ctx)
    st = tcell.init_cell_state((B,), H, device=torch.device("cpu"))
    start = torch.full((B,), 1, dtype=torch.long)
    noise = tuple(map(torch.from_numpy, _sample_draws(key, B, V, Z, beam=K if gumbel else 0)))
    if gumbel:
        seqs, phi, g = tsam.gumbel_beam_search(step, start, st, noise, max_steps=T,
                                               beam_size=K, end_index=1)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(phi.numpy(), np.asarray(ref[1]), atol=ATOL, rtol=0)
        assert (np.diff(g.numpy(), axis=-1) <= 0).all()        # by perturbed score
        toks = seqs.numpy()
        assert len({tuple(s) for s in toks[0]}) == K           # without replacement
    else:
        toks = tsam.sample_decode(step, start, st, noise, max_steps=T, end_index=1,
                                  temperature=temperature, top_k=top_k, top_p=top_p).numpy()
        np.testing.assert_array_equal(toks, np.asarray(ref))
    assert (toks == 1).any()                                    # some samples ended


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_decode_sample_matches_jax_harness(method, mode):
    jcfg, tcfg = _cfg(**MODES[mode])
    params, tparams = _params(jcfg, 3)
    feats, sent, oae = _inputs(jcfg, 4)
    name, top_k, top_p, temperature = METHODS[method]
    kw = dict(top_k=top_k or 5, top_p=top_p or 0.9, temperature=temperature)
    key = jax.random.PRNGKey(5)
    ref = jharness.DecodeHarness(params, jcfg).decode_sample(feats, sent, oae, key, NZ, name,
                                                             **kw)
    draws = [_sample_draws(k, B, V, Z, beam=K if name == "gumbel" else 0)
             for k in jax.random.split(key, NZ)]
    noise = tuple(np.stack([d[i] for d in draws]) for i in range(2))
    got = DecodeHarness(tparams, tcfg, device="cpu").decode_sample(feats, sent, oae, noise, NZ,
                                                                   name, **kw)
    assert got.shape == (NZ, B, T) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), ref)
    # some samples ended (the highest-scoring Gumbel sample seldom does; the
    # beam search's ended beams are compared in test_samplers_match_jax)
    assert name == "gumbel" or (ref == 1).any()


def test_decode_sample_generator_is_deterministic():
    _, tcfg = _cfg()
    _, tparams = _params(_cfg()[0], 6)
    feats, sent, _ = _inputs(_cfg()[0], 7)
    harness = DecodeHarness(tparams, tcfg, device="cpu")
    for method in METHODS:
        a, b, c = (harness.decode_sample(feats, sent, None, torch.Generator().manual_seed(s),
                                         NZ, method) for s in (8, 8, 9))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert ((a >= 0) & (a < V)).all()


# --------------------------------------------------- bf16 on a fixed step


class _Carry(tuple):
    """A one-field state (the searches rebuild states by ``type(state)(*fields)``)."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


@pytest.mark.parametrize("method", ["multinomial", "topk", "gumbel"])
def test_search_bf16_on_a_fixed_step_as_jax(method):
    """A step with no matmul: bf16 log-probs looked up by the last token.
    JAX and the port must then pick identical tokens, with JAX's dtypes:
    ``sample_decode`` adds its Gumbel noise in bf16 (the log-probs' dtype),
    ``gumbel_beam_search`` in f32 (JAX's default dtype), so that phi stays
    bf16 and the perturbed scores are f32. Top-p is left out: JAX and torch
    sum a bf16 cumsum in other orders."""
    v, b = 24, 3
    rng = np.random.RandomState(10)
    table32 = rng.randn(v, v).astype(np.float32) * 1.5
    table32[:, 1] += 1.0                                     # the end token
    jtable = jax.nn.log_softmax(jnp.asarray(table32), axis=-1).astype(jnp.bfloat16)
    ttable = torch.from_numpy(np.array(jtable.astype(jnp.float32))).to(torch.bfloat16)
    gumbel = method == "gumbel"
    top_k = 5 if method == "topk" else 0
    key = jax.random.PRNGKey(11)

    def jstep(tokens, carry, _):
        return jtable[tokens], carry

    def tstep(tokens, carry, _):
        return ttable[tokens], carry

    jstart, tstart = jnp.full((b,), 1), torch.full((b,), 1, dtype=torch.long)
    zs, gs = _sample_draws(key, b, v, 1, beam=K if gumbel else 0,
                           gumbel_dtype=jnp.float32 if gumbel else jnp.bfloat16)
    noise = (torch.from_numpy(zs), torch.from_numpy(gs))
    if gumbel:
        ref_seqs, ref_phi = jsam.gumbel_beam_search(jstep, jstart, (jnp.zeros((b, 1)),), key,
                                                    max_steps=T, beam_size=K, end_index=1)
        seqs, phi, g = tsam.gumbel_beam_search(tstep, tstart, _Carry(torch.zeros(b, 1)), noise,
                                               max_steps=T, beam_size=K, end_index=1)
        assert ref_phi.dtype == jnp.bfloat16 and phi.dtype == torch.bfloat16
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
        np.testing.assert_array_equal(phi.float().numpy(), np.asarray(ref_phi, np.float32))
    else:
        ref = jsam.sample_decode(jstep, jstart, (jnp.zeros((b, 1)),), key, max_steps=T,
                                 end_index=1, top_k=top_k)
        got = tsam.sample_decode(tstep, tstart, _Carry(torch.zeros(b, 1)), noise, max_steps=T,
                                 end_index=1, top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ CIDEr


def _captions(rng, n, lo=3, hi=12, vocab=30):
    return [" ".join(f"w{t}" for t in rng.randint(2, vocab, rng.randint(lo, hi)))
            for _ in range(n)]


def test_cider_matches_jax():
    rng = np.random.RandomState(12)
    gts = {i: _captions(rng, 1 + i % 3) for i in range(8)}
    jc, tc = jmetrics.Cider(), tmetrics.Cider()
    jcorpus, tcorpus = jc.make_corpus(gts), tc.make_corpus(gts)
    assert tcorpus.ref_len == jcorpus.ref_len and dict(tcorpus.doc_freq) == dict(jcorpus.doc_freq)
    n_df = len(tcorpus.doc_freq)
    for r in range(3):
        res = {i: _captions(rng, 1) for i in gts}
        if r == 0:
            res[0] = [gts[0][0]]                                 # a perfect match
        want = jc.compute_score(gts, res)
        assert tc.compute_score(gts, res) == want
        assert tc.compute_score(gts, res, corpus=tcorpus) == want
        assert jc.compute_score(gts, res, corpus=jcorpus) == want
    assert len(tcorpus.doc_freq) == n_df                          # the reused corpus did not grow
    assert want[0] > 0
    with pytest.raises(ValueError):
        tc.compute_score({i: gts[i] for i in range(4)}, res, corpus=tcorpus)


# ------------------------------------------------------------- misuse


def test_samplers_reject_misuse():
    jcfg, tcfg = _cfg()
    _, tparams = _params(jcfg, 13)
    feats, sent, _ = _inputs(jcfg, 14)
    harness = DecodeHarness(tparams, tcfg, device="cpu")
    z = np.zeros((NZ, T, B, 1, Z), np.float32)
    g = np.zeros((NZ, T, B, V), np.float32)
    gk = np.zeros((NZ, T, B, K, V), np.float32)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="method"):
        harness.decode_sample(feats, sent, None, gen, NZ, "beam")
    bad = {
        "gumbel_stack_vocab": ("topk", (z, g[..., :-1])),
        "gumbel_stack_no_beams": ("gumbel", (z, g)),
        "gumbel_stack_beams_for_sampling": ("multinomial", (z, gk)),
        "gumbel_stack_short": ("topp", (z, g[:, 1:])),
        "gumbel_stack_integer": ("multinomial", (z, g.astype(np.int64))),
        "z_stack_beams": ("gumbel", (np.zeros((NZ, T, B, 2, Z), np.float32), gk)),
        "one_stack": ("multinomial", z),
    }
    for case, (method, noise) in bad.items():
        with pytest.raises(ValueError):
            harness.decode_sample(feats, sent, None, noise, NZ, method)
            pytest.fail(case)
    ctx = tcap.make_decode_context(tparams, tcfg, _t(feats), sentiment=_t(sent))
    step = tcap.make_optimized_step_fn(tparams, tcfg, ctx)
    start = torch.full((B,), 1, dtype=torch.long)
    st = tcell.init_cell_state((B,), H, device=torch.device("cpu"))
    zt = torch.zeros(T, B, K, Z)
    with pytest.raises(ValueError):          # (T, B, V) rows where the beam search needs K
        tsam.gumbel_beam_search(step, start, st, (zt, torch.zeros(T, B, V)), max_steps=T,
                                beam_size=K, end_index=1)
    with pytest.raises(ValueError):
        tsam.sample_decode(step, start, st, (zt[:, :, :1], torch.zeros(T - 1, B, V)),
                           max_steps=T, end_index=1)
