"""A whole bf16 CBS decode, the port's ``DecodeHarness.decode_cbs`` with
``selection="raw"`` (the JAX harness's own route), against the JAX
harness's bf16 decode: the same carried-over parameters (cast to bf16 as
both inference CLIs cast them), the same bf16 features and attribute
embeddings, FSM tables and z-noise, small widths on the CPU.

bf16 rounds each side's own way (XLA fuses elementwise chains and rounds
once; PyTorch rounds each operation), so the captions' log-probs are held
within a band measured on JAX alone: the distance between JAX's bf16 decode
and JAX's f32 decode of the same noise values, as
``test_torch_detector_bf16.py`` sets its bands. JAX's own note
(``decoding/cbs_fast.py:165-167``) says bf16 rounding flips near-tied
beams, so token agreement is printed (``pytest -s``), not asserted.

The noise: JAX draws each step's eps inside the step, in the prior mean's
dtype (``models/updown_cell.py:234``): f32 in mode 1, whose sentiment prior
is f32, and bf16 in mode 2, whose prior attends over the bf16 attribute
embeddings. The test draws it the same way from the same keys and hands it
to the port, and JAX's f32 reference decodes those values through the
explicit-noise program of ``test_torch_cbs.py`` (the harness's search with
the noise given; equal to the harness's own f32 decode where the draws
agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.training.trainer import _compute_cast
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.weights import cast_floats, from_jax_params
from tests import test_torch_cbs as tcbs

torch.set_num_threads(1)

NZ, BATCH = 4, 4
# the port's bf16 log-probs within this many bands of JAX's bf16 ones;
# readings over 12 seeded cases (6 mode 1, 3 each mode-2 embedding) put the
# largest ratio at 1.07, most at 0.5-1.0
BAND_FACTOR = 1.25

# mode1-4 and mode2_glove-2 hold flipped captions; mode2_senti_word_net-1 a
# caption that JAX's bf16 decode scored in other beam slots (band 1.24)
CASES = {
    "mode1-0": (0, {}),
    "mode1-4": (4, {}),
    "mode2_glove-2": (2, {"sentiment_vae": 2, "latent_embedding": "glove"}),
    "mode2_senti_word_net-1": (1, {"sentiment_vae": 2, "latent_embedding": "senti_word_net"}),
}


def _draws(key, z, dtype):
    """The (T, B, S, K, z) stack that JAX's CBS draws from ``key`` in
    ``dtype`` (``rng, k0 = split(key)``, then ``split(rng, T - 1)``), the
    first draw in row 0's first state and beam, as f32 values."""
    T, S, K = tcbs.T, tcbs.S, tcbs.BEAM
    rng, k0 = jax.random.split(key)
    keys = jax.random.split(rng, T - 1)
    stack = np.zeros((T, BATCH, S, K, z), np.float32)
    stack[0][:, :1, :1] = np.asarray(jax.random.normal(k0, (BATCH, 1, 1, z), dtype), np.float32)
    for t in range(1, T):
        stack[t] = np.asarray(jax.random.normal(keys[t - 1], (BATCH, S, K, z), dtype), np.float32)
    return stack


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_cbs_bf16_within_jax_band(case):
    seed, kw = CASES[case]
    mode2 = kw.get("sentiment_vae") == 2
    jcfg, tcfg = tcbs._cfg(**kw)
    params = jcap.init_captioner(jax.random.PRNGKey(seed), jcfg)
    # the end token's logit near 1.6 END_LOGIT, so that some captions end early
    direction = jnp.tanh(params["output_projection"]["b"])
    params["embedding"] = params["embedding"].at[jcfg.boundary_index].set(
        1.6 * tcbs.END_LOGIT * direction / jnp.sum(direction ** 2))
    rng = np.random.RandomState(seed)
    feats = rng.randn(BATCH, tcbs.NBOX, jcfg.image_feature_size).astype(np.float32)
    sentiment = rng.choice([-1.0, 1.0], (BATCH, 1)).astype(np.float32)
    tables = [[tcbs.jcbs.fsm_to_tables(tcbs._fsm(rng)) for _ in range(NZ)]
              for _ in range(BATCH)]
    oae = rng.randn(BATCH, tcbs.NBOX, jcfg.z_space).astype(np.float32) if mode2 else None
    # bf16-valued inputs: both sides decode the same values
    feats = np.asarray(jnp.asarray(feats, jnp.bfloat16), np.float32)
    oae = None if oae is None else np.asarray(jnp.asarray(oae, jnp.bfloat16), np.float32)
    key = jax.random.PRNGKey(seed + 100)

    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    j16 = jharness.DecodeHarness(_compute_cast(params, jnp.bfloat16), jcfg).decode_cbs(
        bf(feats), sentiment, bf(oae), tables, [3], key, NZ)
    noise = np.stack([_draws(k, jcfg.z_space, jnp.bfloat16 if mode2 else jnp.float32)
                      for k in jax.random.split(key, NZ)])
    j32 = tcbs._jax_decode(params, jcfg, feats, sentiment, jharness.pad_tables_batch(tables, NZ),
                           noise, "raw", oae=oae)

    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    port_tables = tcbs._port_tables(tables)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    t16 = DecodeHarness(cast_floats(tparams, torch.bfloat16), tcfg, device="cpu").decode_cbs(
        t(feats).bfloat16(), sentiment, None if oae is None else t(oae).bfloat16(),
        port_tables, [3], noise, NZ, selection="raw")
    t32 = DecodeHarness(tparams, tcfg, device="cpu").decode_cbs(
        feats, sentiment, oae, port_tables, [3], noise, NZ, selection="raw")

    # f32: the port's decode of the same noise is JAX's, token for token
    np.testing.assert_array_equal(t32[0].numpy(), j32[0])
    np.testing.assert_allclose(t32[1].numpy(), j32[1], atol=tcbs.SCORE_ATOL, rtol=0)
    # bf16: JAX's dtypes and shapes, finite, within the band
    assert t16[0].shape == np.asarray(j16[0]).shape == (NZ, BATCH, tcbs.T)
    assert str(t16[1].dtype).split(".")[-1] == str(np.asarray(j16[1]).dtype) == "float32"
    tok_j16, tok_j32, tok_t16 = np.asarray(j16[0]), j32[0], t16[0].numpy()
    lp_j16, lp_t16 = np.asarray(j16[1], np.float64), t16[1].double().numpy()
    assert np.isfinite(lp_j16).all() and np.isfinite(lp_t16).all()
    # a flipped near-tie continues on another path, whose log-prob may lie far
    # off: the band and the comparison take the captions whose tokens agree.
    # Those still differ by more than rounding where a near tie reordered the
    # beams: the noise is drawn per (state, beam) slot, so the same caption
    # in another slot drew other z (1.24 nats in one reading)
    same_jax = (tok_j16 == tok_j32).all(-1)
    same = (tok_t16 == tok_j16).all(-1)
    band = np.abs(lp_j16 - j32[1])[same_jax].max()
    dist = np.abs(lp_t16 - lp_j16)[same].max()
    print(f"{case}: band {band:.4f} (JAX bf16 vs f32 on {same_jax.mean():.1%} identical best "
          f"captions), port bf16 vs JAX bf16 {dist:.4f} ({dist / band:.2f} bands) on "
          f"{same.mean():.1%} identical; flipped: "
          f"{np.abs(lp_t16 - lp_j16)[~same].round(4).tolist()}")
    assert band > 0
    assert dist <= BAND_FACTOR * band, (dist, band)
    # enough identical captions that the band holds something (measured at
    # least 87.5%; agreement itself is JAX's near ties, not a parity check)
    assert same.mean() >= 0.5
    # the port really decoded in bf16: its log-probs moved from its f32 ones
    # by more than f32's own tolerance
    assert np.abs(lp_t16 - t32[1].double().numpy()).max() > 10 * tcbs.SCORE_ATOL
