"""The port's teacher-forced training forward (``models/captioner.py::
train_forward`` and the posterior branch of ``models/updown_cell.py::
cell_step``) against the JAX package's, on the same parameters (JAX's init,
carried over by ``from_jax_params``), batch and z-noise (a (T+1, B, z)
``eps`` stack handed to both).

* f32: per-sequence loss and KL within rtol 1e-5, and the gradient of the
  train step's objective (``mean(loss) + mean(kld) / KLD_WEIGHT``) on every
  leaf, ``torch.autograd`` against ``jax.grad``, within 1e-4 of the leaf's
  gradient norm, in prior modes 0, 1 and 2 (glove and ``senti_word_net``),
  with ``simple_vae`` on and off, with the tied and the untied head.
* bf16 compute (every f32 leaf and batch entry cast to bf16, as JAX's
  ``_compute_cast`` casts them): the same dtypes along the step as JAX's,
  loss and KL within 1e-2 relative, each leaf's gradient within 5e-2 of its
  norm (bf16 keeps 8 bits; JAX's XLA and PyTorch round the bf16 log-softmax,
  gate math and products in other places).
* ``add_boundary_tokens`` with an UNK inside a caption: the UNK is the pad
  index, so it counts as padding and the boundary lands over a real token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models import updown_cell as jcell
from style_seqcvae_tpu.training.trainer import _compute_cast
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.weights import cast_floats, from_jax_params, named_leaves

torch.set_num_threads(1)

B, N, T = 4, 5, 6
KLD_WEIGHT = 750.0
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL = 5e-2

# (sentiment_vae, simple_vae, latent_embedding, embedding_size): 300 ties
# the head to the embedding, 16 does not
CASES = {
    "mode0_simple_tied": (0, True, "glove", 300),
    "mode0_untied": (0, False, "glove", 16),
    "mode1_tied": (1, False, "glove", 300),
    "mode1_simple_untied": (1, True, "glove", 16),
    "mode2_glove_tied": (2, False, "glove", 300),
    "mode2_swn_untied": (2, False, "senti_word_net", 16),
    "mode2_glove_simple_tied": (2, True, "glove", 300),
}


def model_kw(case, vocab=40, feat=8, hidden=8, proj=6, z=4):
    mode, simple, latent, emb = CASES[case]
    return dict(vocab_size=vocab, image_feature_size=feat, embedding_size=emb,
                hidden_size=hidden, attention_projection_size=proj, z_space=z,
                sentiment_vae=mode, simple_vae=simple, latent_embedding=latent,
                max_caption_length=T, pad_index=0, boundary_index=1)


def make_batch(kw, seed=0, batch=B, boxes=N):
    """A seeded batch with padded boxes, padded captions and an UNK inside
    one caption; mode 2 adds attribute embeddings."""
    r = np.random.RandomState(seed)
    feats = r.randn(batch, boxes, kw["image_feature_size"]).astype(np.float32)
    feats[0, 3:] = 0.0                                      # padding boxes
    toks = r.randint(2, kw["vocab_size"], (batch, T)).astype(np.int32)
    toks[1, 4:] = kw["pad_index"]                           # a short caption
    toks[2, 2] = kw["pad_index"]                            # an UNK inside one
    out = {"image_features": feats, "caption_tokens": toks,
           "sentiment": r.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)}
    if kw["sentiment_vae"] == 2:
        out["obj_att_embeds"] = r.randn(batch, boxes, kw["z_space"]).astype(np.float32)
    return out


def jax_params(kw, seed=0):
    return jcap.init_captioner(jax.random.PRNGKey(seed), jcap.CaptionerConfig(**kw))


def port_params(jparams, requires_grad=True):
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for _, p in named_leaves(params):
        p.requires_grad_(requires_grad)
    return params


def jax_leaves(tree):
    """Path (as the port's ``named_leaves`` writes it) → numpy leaf."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        out["/".join(str(k) for k in keys)] = np.asarray(v, np.float32)
    return out


def objective_jax(params, cfg, batch, eps):
    out = jcap.train_forward(params, cfg, batch, jax.random.PRNGKey(0), eps=eps)
    return jnp.mean(out["loss"]) + jnp.mean(out["kld"]) / KLD_WEIGHT, out


def assert_grads_close(port_params_, jgrads, rel):
    jg = jax_leaves(jgrads)
    tg = {path: p.grad for path, p in named_leaves(port_params_)}
    assert tg.keys() == jg.keys()
    for path, want in jg.items():
        got = tg[path].float().numpy()
        scale = max(np.linalg.norm(want), 1e-12)
        err = np.linalg.norm(got - want) / scale
        assert err <= rel, f"{path}: gradient off by {err:.3g} of its norm"


def run_both(case, compute_dtype=None, seed=0):
    kw = model_kw(case)
    jcfg, tcfg = jcap.CaptionerConfig(**kw), tcap.CaptionerConfig(**kw)
    jp = jax_params(kw, seed)
    batch = make_batch(kw, seed)
    eps = np.random.RandomState(seed + 100).randn(T + 1, B, kw["z_space"]).astype(np.float32)

    jdt = None if compute_dtype is None else jnp.bfloat16

    def jobj(p):
        return objective_jax(_compute_cast(p, jdt), jcfg,
                             _compute_cast({k: jnp.asarray(v) for k, v in batch.items()}, jdt),
                             jnp.asarray(eps))

    (jl, jout), jgrads = jax.value_and_grad(jobj, has_aux=True)(jp)
    tp = port_params(jp)
    tb = cast_floats({k: torch.from_numpy(v) for k, v in batch.items()}, compute_dtype)
    tout = tcap.train_forward(cast_floats(tp, compute_dtype), tcfg, tb, eps=torch.from_numpy(eps))
    tl = tout["loss"].mean() + tout["kld"].mean() / KLD_WEIGHT
    tl.backward()
    return jout, jgrads, tout, tp, float(jl), float(tl.detach())


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_forward_and_grads_match_jax(case):
    jout, jgrads, tout, tp, jl, tl = run_both(case)
    assert tout["loss"].dtype == tout["kld"].dtype == torch.float32
    np.testing.assert_allclose(tout["loss"].detach().numpy(), np.asarray(jout["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tout["kld"].detach().numpy(), np.asarray(jout["kld"]),
                               rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_grads_close(tp, jgrads, GRAD_REL)


@pytest.mark.parametrize("case", ["mode1_tied", "mode2_glove_tied", "mode0_untied"])
def test_bf16_compute_matches_jax(case):
    jout, jgrads, tout, tp, jl, tl = run_both(case, compute_dtype=torch.bfloat16)
    assert tout["loss"].dtype == torch.float32
    np.testing.assert_allclose(tout["loss"].detach().numpy(), np.asarray(jout["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(tout["kld"].detach().numpy(), np.asarray(jout["kld"]),
                               rtol=BF16_LOSS_RTOL, atol=1e-3)
    assert_grads_close(tp, jgrads, BF16_GRAD_REL)
    for _, p in named_leaves(tp):                          # grads reach the f32 masters
        assert p.grad.dtype == torch.float32


def test_bf16_step_dtypes_follow_jax():
    """Under bf16 compute JAX's posterior is f32 and promotes the decoder
    LSTM's input to f32; the port's cell step gives the same dtypes."""
    kw = model_kw("mode1_tied")
    jp = _compute_cast(jax_params(kw), jnp.bfloat16)
    batch = _compute_cast({k: jnp.asarray(v) for k, v in make_batch(kw).items()}, jnp.bfloat16)
    feats = batch["image_features"]
    avg, mask = jcell.image_feature_stats(feats)
    proj = jcap.project_image_features(jp["cell"].attention, feats)
    pm, pv = jcap.base_prior(jcap.CaptionerConfig(**kw), B, batch["sentiment"])
    state = jcell.init_cell_state((B,), kw["hidden_size"], feats.dtype)
    jres = jcell.cell_step(jp["cell"], jp["embedding"][batch["caption_tokens"][:, 0]], state,
                           image_features=feats, projected_image_features=proj,
                           averaged_image_features=avg, image_features_mask=mask,
                           training=True, rng=jax.random.PRNGKey(0),
                           eps=jnp.zeros((B, kw["z_space"])), sentiment_vae=1,
                           simple_vae=False, latent_embedding="glove",
                           sentiment=batch["sentiment"], prior_mean=pm, prior_var=pv)

    from style_seqcvae_tpu_torch.models import updown_cell as tcell
    tp = cast_floats(port_params(jax_params(kw), requires_grad=False), torch.bfloat16)
    tb = cast_floats({k: torch.from_numpy(v) for k, v in make_batch(kw).items()},
                     torch.bfloat16)
    tfeats = tb["image_features"]
    tavg, tmask = tcell.image_feature_stats(tfeats)
    tproj = tcap.project_image_features(tp["cell"].attention, tfeats)
    tpm, tpv = tcap.base_prior(tcap.CaptionerConfig(**kw), B, tb["sentiment"], "cpu")
    tstate = tcell.init_cell_state((B,), kw["hidden_size"], device="cpu", dtype=torch.bfloat16)
    tres = tcell.cell_step(tp["cell"], tp["embedding"][tb["caption_tokens"][:, 0].long()],
                           tstate, image_features=tfeats, projected_image_features=tproj,
                           averaged_image_features=tavg, image_features_mask=tmask,
                           training=True, rng=None, eps=torch.zeros(B, kw["z_space"]),
                           sentiment_vae=1, simple_vae=False, latent_embedding="glove",
                           sentiment=tb["sentiment"], prior_mean=tpm, prior_var=tpv)
    names = ["h_dec", "q_mean", "q_log_var", "prior_mean", "attn_w"]
    for name, j, t in zip(names, [jres[0]] + list(jres[2:]), [tres[0]] + list(tres[2:])):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
    for j, t in zip(jres[1], tres[1]):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    assert tres[2].dtype == torch.float32                   # q_mean f32 under bf16


def test_cell_step_training_refuses_noise_tensor_in_rng():
    kw = model_kw("mode1_tied")
    tp = port_params(jax_params(kw), requires_grad=False)
    b = {k: torch.from_numpy(v) for k, v in make_batch(kw).items()}
    with pytest.raises(TypeError, match="eps or a torch.Generator"):
        tcap.train_forward(tp, tcap.CaptionerConfig(**kw), b)
    from style_seqcvae_tpu_torch.models import updown_cell as tcell
    avg, mask = tcell.image_feature_stats(b["image_features"])
    with pytest.raises(TypeError, match="not a noise tensor"):
        tcell.cell_step(tp["cell"], tp["embedding"][:B], tcell.init_cell_state(
            (B,), kw["hidden_size"], device="cpu"), image_features=b["image_features"],
            projected_image_features=tcap.project_image_features(tp["cell"].attention,
                                                                 b["image_features"]),
            averaged_image_features=avg, image_features_mask=mask, training=True,
            rng=torch.zeros(B, kw["z_space"]), sentiment_vae=1, simple_vae=False,
            latent_embedding="glove", sentiment=b["sentiment"],
            prior_mean=torch.zeros(B, kw["z_space"]), prior_var=torch.ones(B, kw["z_space"]))


def test_train_forward_generator_noise_is_seeded():
    """Without eps the noise comes from the generator: the same seed gives
    the same loss, another seed another."""
    kw = model_kw("mode1_tied")
    tp = port_params(jax_params(kw), requires_grad=False)
    b = {k: torch.from_numpy(v) for k, v in make_batch(kw).items()}
    cfg = tcap.CaptionerConfig(**kw)
    runs = [tcap.train_forward(tp, cfg, b, rng=torch.Generator().manual_seed(s))["kld"]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_add_boundary_tokens_unk_inside_caption_counts_as_padding():
    pad, bnd = 0, 1
    caps = np.array([[5, 6, 7, 0, 0],       # plain padding
                     [5, 0, 7, 8, 0],       # UNK (= pad) inside the caption
                     [5, 6, 7, 8, 9]], np.int32)
    want = np.asarray(jcap.add_boundary_tokens(jnp.asarray(caps), pad, bnd))
    got = tcap.add_boundary_tokens(torch.from_numpy(caps), pad, bnd).numpy()
    np.testing.assert_array_equal(got, want)
    # three real tokens in row 1: its closing boundary lands at position 4,
    # over the 8, and the UNK stays as padding inside the caption
    np.testing.assert_array_equal(got[1], [bnd, 5, 0, 7, bnd, 0, 0])
    np.testing.assert_array_equal(got[0], [bnd, 5, 6, 7, bnd, 0, 0])
    np.testing.assert_array_equal(got[2], [bnd, 5, 6, 7, 8, 9, bnd])


@pytest.mark.parametrize("mode", [0, 1])
def test_per_step_kld_both_closed_forms(mode):
    r = np.random.RandomState(mode)
    qm, qlv, pm, plv = (r.randn(3, 4).astype(np.float32) for _ in range(4))
    kw = model_kw("mode1_tied")
    kw["sentiment_vae"] = mode
    want = np.asarray(jcap._per_step_kld(jcap.CaptionerConfig(**kw), *map(jnp.asarray,
                                                                          (qm, qlv, pm, plv))))
    got = tcap._per_step_kld(tcap.CaptionerConfig(**kw), *map(torch.from_numpy,
                                                              (qm, qlv, pm, plv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_load_glove_embeddings_matches_jax(tmp_path):
    from style_seqcvae_tpu.data.vocabulary import Vocabulary as JVocabulary
    from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary as TVocabulary
    words = ["@@UNKNOWN@@", "@@BOUNDARY@@", "dog", "cat", "car"]
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("dog 1 2 3\ncar 4 5 6\nbad 1 2\n")
    b.write_text("cat 7 8 9\n")
    paths = [(str(a), 3), (str(b), 3)]
    want = jcap.load_glove_embeddings(JVocabulary(words), 6, paths, 0)
    got = tcap.load_glove_embeddings(TVocabulary(words), 6, paths, 0)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not 7"):
        tcap.load_glove_embeddings(TVocabulary(words), 7, paths, 0)
