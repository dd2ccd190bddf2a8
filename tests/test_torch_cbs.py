"""The port's CBS decode (style_seqcvae_tpu_torch) against the JAX reference:
same weights (carried over by ``from_jax_params``), same z-noise, same FSM
tables, f32 on the CPU.

The JAX side is built as ``bench.py`` builds its CBS program: the optimized
step with the prehead, raw or log-prob contract,
``constrained_beam_search_fast`` vmapped over z with precomputed noise,
then ``select_best_beam_simple_jax``. Its Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import cbs_fast as jcbs
from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.decoding.select import select_best_beam_simple_jax
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models.updown_cell import init_cell_state as j_init_state
from style_seqcvae_tpu_torch.decoding import cbs_fast as tcbs
from style_seqcvae_tpu_torch.decoding import harness as tharness
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig
from style_seqcvae_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

V, B, NZ, S, BEAM, T, NBOX = 48, 2, 2, 8, 4, 6, 5
# Scores are sums of T f32 log-probs whose logits both sides compute with
# the same f32 products but in a different summation order (and the kernels
# merge their logsumexp tile by tile), so they agree to ~1e-6; 1e-4 leaves
# room without hiding a wrong token, which moves a score by far more.
SCORE_ATOL = 1e-4
END_LOGIT = 6.5


def _cfg(**kw):
    base = dict(vocab_size=V, image_feature_size=12, embedding_size=300,
                hidden_size=10, attention_projection_size=6, z_space=4,
                sentiment_vae=1, simple_vae=False, max_caption_length=T,
                beam_size=BEAM)
    base.update(kw)
    return jcap.CaptionerConfig(**base), CaptionerConfig(**base)


def _fsm(rng, n_constraints=3, token_zero=False):
    """Simple-CBS FSM: single-word constraints with two wordforms each, as
    bench.py's synthetic tables. ``token_zero`` makes one wordform token 0,
    the index that padded exception entries also carry."""
    f = np.zeros((S, S, V), np.uint8)
    for s in range(S):
        f[s, s, :] = 1
    toks = rng.randint(2, V, (n_constraints, 2))
    if token_zero:
        toks[0, 0] = 0
    for c in range(n_constraints):
        stride = 2 ** c
        for s in range(S):
            if not (s & stride) and (s | stride) < S:
                for t in toks[c]:
                    f[s, s | stride, t] = 1
                    f[s, s, t] = 0
    return f


def _inputs(seed=0, batch=B):
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, NBOX, 12).astype(np.float32)
    feats[1, -1] = 0.0                       # one padded box
    sentiment = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    tables = [[jcbs.fsm_to_tables(_fsm(rng, token_zero=(b == 0 and z == 0)))
               for z in range(NZ)] for b in range(batch)]
    noise = rng.randn(NZ, T, batch, S, BEAM, 4).astype(np.float32)
    return feats, sentiment, tables, noise


def _jax_decode(params, jcfg, feats, sentiment, stacked, noise, selection, nc=None, oae=None,
                return_all=False):
    """``nc``: the (B,) constraint counts handed to the selection (3 each
    by default); ``oae``: mode 2's (B, N, z) attribute embeddings;
    ``return_all``: every (state, beam), without the selection."""
    prehead = selection == "prehead"
    raw = selection in ("fused", "raw")
    B = feats.shape[0]
    nc = jnp.full((B,), 3) if nc is None else jnp.asarray(nc)

    @jax.jit
    def run(params, feats, sentiment, oae, tables, noise, nc):
        ctx = jcap.make_decode_context(params, jcfg, feats, sentiment=sentiment,
                                       obj_att_embeds=oae)
        step = jcap.make_optimized_step_fn(params, jcfg, ctx, return_raw=raw,
                                           return_prehead=prehead)
        init_state = j_init_state((B,), jcfg.hidden_size, jnp.float32)
        start = jnp.full((B,), jcfg.boundary_index)

        def one_z(noise_z, fsm_z):
            seqs, lp = jcbs.constrained_beam_search_fast(
                step, start, init_state, fsm_z, jax.random.PRNGKey(0),
                max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2,
                end_index=jcfg.boundary_index, raw_step=raw,
                prehead_step=prehead, noise=noise_z,
                embedding=params["embedding"] if prehead else None,
                fused_vocab_topk=(selection == "fused") or None)
            if return_all:
                return seqs, lp
            return select_best_beam_simple_jax(seqs, lp, nc, jcfg.min_constraints_to_satisfy)

        return jax.vmap(one_z)(noise, tables)

    best, lp = run(params, jnp.asarray(feats), jnp.asarray(sentiment),
                   None if oae is None else jnp.asarray(oae), stacked, jnp.asarray(noise), nc)
    return np.asarray(best), np.asarray(lp)


def test_fsm_packers_match_reference():
    feats, sentiment, tables, noise = _inputs(1)
    rng = np.random.RandomState(3)
    dense = _fsm(rng)
    for a, b in zip(jcbs.fsm_to_tables(dense), tcbs.fsm_to_tables(dense)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jcbs.stack_fsm_tables(tables[0], pad_exceptions=12),
                    tcbs.stack_fsm_tables(tables[0], pad_exceptions=12)):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = jharness.pad_tables_batch(tables, NZ)
    port = tharness.pad_tables_batch(
        [[tcbs.FSMTables(*[np.asarray(x) for x in t]) for t in ts] for ts in tables], NZ)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("selection", ["prehead", "fused", "raw", "logprob"])
def test_decode_cbs_matches_jax(selection):
    jcfg, tcfg = _cfg()
    params = jcap.init_captioner(jax.random.PRNGKey(0), jcfg)
    # point the end token's embedding along the head's bias direction, so its
    # logit is ~END_LOGIT and some captions end before T: ended beams (frozen
    # at the end token with log-prob 0) are compared too
    direction = jnp.tanh(params["output_projection"]["b"])
    direction = direction / jnp.sum(direction ** 2)
    emb = params["embedding"].at[jcfg.boundary_index].set(END_LOGIT * direction)
    # token 0 is a constraint wordform of one FSM and also the token of every
    # padded exception slot (see _inputs); a logit just above the end token's
    # makes it win that FSM's first step as a default (self-loop) token if
    # the first-step exception mask lets a padded slot unmask it
    params["embedding"] = emb.at[0].set(1.1 * END_LOGIT * direction)
    feats, sentiment, tables, noise = _inputs()
    stacked = jharness.pad_tables_batch(tables, NZ)
    ref_best, ref_lp = _jax_decode(params, jcfg, feats, sentiment, stacked, noise, selection)

    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    harness = DecodeHarness(tparams, tcfg, device="cpu")
    best, lp = harness.decode_cbs(feats, sentiment, None, tables, 3, noise, NZ,
                                  selection=selection)
    assert best.shape == (NZ, B, T) and lp.shape == (NZ, B)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    assert np.isfinite(ref_lp).all()
    ended = (ref_best == jcfg.boundary_index).any(axis=-1)
    assert ended.any()


@pytest.mark.parametrize("selection", ["raw", "logprob"])
def test_decode_cbs_all_beams_match_jax(selection):
    """Every (z, image, state, beam), the unreachable ones too: where a state
    has fewer live candidates than beams, the beams it keeps depend on how
    ended beams' candidates were masked (before or after the selection)."""
    jcfg, tcfg = _cfg()
    params = jcap.init_captioner(jax.random.PRNGKey(9), jcfg)
    direction = jnp.tanh(params["output_projection"]["b"])
    direction = direction / jnp.sum(direction ** 2)
    params["embedding"] = params["embedding"].at[jcfg.boundary_index].set(
        END_LOGIT * direction)
    feats, sentiment, tables, noise = _inputs(10)
    stacked = jharness.pad_tables_batch(tables, NZ)
    ref_seqs, ref_lp = _jax_decode(params, jcfg, feats, sentiment, stacked, noise, selection,
                                   return_all=True)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    seqs, lp = DecodeHarness(tparams, tcfg, device="cpu").decode_cbs(
        feats, sentiment, None, tables, 3, noise, NZ, selection=selection, return_all=True)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)


class _Carry(NamedTuple):
    h: object


@pytest.mark.parametrize("selection", ["raw", "logprob"])
def test_search_freezes_ended_beams_as_jax(selection):
    """A fixed step under which the end token and one wordform per
    constraint are the only likely tokens. Log-probs: every other token is
    impossible (-inf), so the beams that end leave their states with fewer
    live candidates than beams, and the fillers the search keeps there show
    whether it froze the ended beams before the selection and only there.
    Raw logits: every other token has logit -50, finite, because JAX takes
    the exception logits by a one-hot einsum, which turns an infinite logit
    anywhere in the row into NaN (0 · -inf) where the port's gather keeps
    the value; ended beams must emit only the end token, which they do only
    if the search freezes them after the selection."""
    v, s, k, t, b = 12, 4, 4, 5, 2
    raw = selection == "raw"
    table = np.full(v, -50.0 if raw else -np.inf, np.float32)
    table[[1, 5, 7]] = [2.0, 1.0, 0.5]                # end and one wordform per constraint
    dense = np.zeros((s, s, v), np.uint8)
    for st in range(s):
        dense[st, st, :] = 1
    for c, words in enumerate(([5, 6], [7, 8])):
        for st in range(s):
            if not st & (1 << c):
                for w in words:
                    dense[st, st | (1 << c), w], dense[st, st, w] = 1, 0
    tables = jcbs.stack_fsm_tables([jcbs.fsm_to_tables(dense)] * b, pad_exceptions=8)
    noise = np.zeros((t, b, s, k, 1), np.float32)
    logz = np.log(np.exp(table.astype(np.float64)).sum()).astype(np.float32)

    def jstep(tokens, carry, _):
        logits = jnp.broadcast_to(jnp.asarray(table), tokens.shape + (v,))
        out = (logits, jnp.full(tokens.shape, logz)) if raw else logits - logz
        return out, carry

    ref_seqs, ref_lp = jcbs.constrained_beam_search_fast(
        jstep, jnp.full((b,), 1), _Carry(jnp.zeros((b, 1))), jcbs.FSMTables(
            *map(jnp.asarray, tables)), jax.random.PRNGKey(0), max_steps=t, beam_size=k,
        per_node_beam_size=k // 2, end_index=1, raw_step=raw, noise=jnp.asarray(noise))

    def tstep(tokens, carry, _):
        logits = torch.from_numpy(table).expand(tuple(tokens.shape) + (v,))
        out = (logits, torch.full(tuple(tokens.shape), float(logz))) if raw else logits - logz
        return out, carry

    seqs, lp = tcbs.constrained_beam_search_fast(
        tstep, torch.full((b,), 1), _Carry(torch.zeros(b, 1)),
        tcbs.fsm_to_device(tcbs.FSMTables(*map(np.array, tables)), torch.device("cpu")),
        torch.from_numpy(noise),
        max_steps=t, beam_size=k, per_node_beam_size=k // 2, end_index=1, selection=selection)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=SCORE_ATOL, rtol=0)
    # live beams that ended emit only the end token (fillers may not)
    ended = (np.cumsum(seqs.numpy() == 1, axis=-1) > 0) & (lp.numpy() > -1e18)[..., None]
    assert (seqs.numpy()[ended] == 1).all() and ended[..., 1].any()
    if not raw:
        filler = (lp.numpy() < -1e18) & (lp.numpy() > -np.inf)
        assert filler.any()


def test_prehead_and_fused_agree_on_all_beams():
    """Both selections of the port return the same beams for every reachable
    (state, beam)."""
    jcfg, tcfg = _cfg()
    params = jcap.init_captioner(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    feats, sentiment, tables, noise = _inputs(2)
    harness = DecodeHarness(tparams, tcfg, device="cpu")
    sa, la = harness.decode_cbs(feats, sentiment, None, tables, 3, noise, NZ,
                                selection="prehead", return_all=True)
    sb, lb = harness.decode_cbs(feats, sentiment, None, tables, 3, noise, NZ,
                                selection="fused", return_all=True)
    reach = la.numpy() > -1e18
    assert reach.any()
    np.testing.assert_array_equal(sa.numpy()[reach], sb.numpy()[reach])
    np.testing.assert_allclose(lb.numpy()[reach], la.numpy()[reach], atol=SCORE_ATOL)


def _jax_harness_inputs(params, jcfg, feats, sentiment, tables, num_constraints):
    """The padded tables and (B,) constraint counts that the JAX harness's
    ``decode_cbs`` derives from its arguments before it decodes."""
    seen = {}

    def capture(params, feats, sentiment, oae, stacked, nc, key, **kw):
        seen.update(stacked=stacked, nc=np.asarray(nc))
        return jnp.zeros(()), jnp.zeros(())

    h = jharness.DecodeHarness(params, jcfg)
    h._jit_cbs = capture
    h.decode_cbs(feats, sentiment, None, tables, num_constraints, jax.random.PRNGKey(0), NZ)
    return seen["stacked"], seen["nc"]


def _port_tables(tables):
    return [[tcbs.FSMTables(*[np.asarray(x) for x in t]) for t in ts] for ts in tables]


@pytest.mark.parametrize("case", ["short_num_constraints", "per_z_tables"])
def test_decode_cbs_interface_matches_jax(case):
    """The two argument forms the JAX harness takes besides a full per-image
    batch: ``num_constraints`` shorter than the batch (its first entry then
    holds for every image), and one image's per-z ``List[FSMTables]``."""
    jcfg, tcfg = _cfg()
    params = jcap.init_captioner(jax.random.PRNGKey(3), jcfg)
    if case == "short_num_constraints":
        feats, sentiment, tables, noise = _inputs(4, batch=3)
        j_tables, t_tables, nc = tables, _port_tables(tables), [2, 1]
    else:
        feats, sentiment, tables, noise = _inputs(5)
        feats, sentiment, noise = feats[:1], sentiment[:1], noise[:, :, :1]
        j_tables, t_tables, nc = tables[0], _port_tables(tables)[0], 3
    stacked, j_nc = _jax_harness_inputs(params, jcfg, feats, sentiment, j_tables, nc)
    ref_best, ref_lp = _jax_decode(params, jcfg, feats, sentiment, stacked, noise,
                                   "prehead", nc=j_nc)

    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    best, lp = DecodeHarness(tparams, tcfg, device="cpu").decode_cbs(
        feats, sentiment, None, t_tables, nc, noise, NZ, selection="prehead")
    assert best.shape == ref_best.shape == (NZ, feats.shape[0], T)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    assert np.isfinite(ref_lp).all()


@pytest.mark.parametrize("latent_embedding", ["glove", "senti_word_net"])
@pytest.mark.parametrize("selection", ["raw", "prehead"])
def test_decode_cbs_mode2_matches_jax(selection, latent_embedding):
    """The mode-2 prior: each step's prior mean attends over per-box
    attribute embeddings (``obj_att_embeds``), and conditions the decoder on
    it (glove) or on its first component (senti_word_net)."""
    jcfg, tcfg = _cfg(sentiment_vae=2, latent_embedding=latent_embedding)
    params = jcap.init_captioner(jax.random.PRNGKey(6), jcfg)
    feats, sentiment, tables, noise = _inputs(7)
    oae = np.random.RandomState(8).randn(B, NBOX, 4).astype(np.float32)
    stacked = jharness.pad_tables_batch(tables, NZ)
    ref_best, ref_lp = _jax_decode(params, jcfg, feats, sentiment, stacked, noise, selection,
                                   oae=oae)

    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    best, lp = DecodeHarness(tparams, tcfg, device="cpu").decode_cbs(
        feats, sentiment, oae, tables, 3, noise, NZ, selection=selection)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=SCORE_ATOL, rtol=0)
    assert np.isfinite(ref_lp).all()
