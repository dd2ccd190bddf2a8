"""The port's inference CLI (``style_seqcvae_tpu_torch/scripts/inference.py``)
against the JAX CLI (``scripts/inference.py``, loaded as a module and
unchanged).

* ``_dispatch_group`` + ``_collect_group``: the port's, given the z-noise
  (and Gumbel noise) that the JAX harness draws from its keys, against the
  JAX CLI's own functions on the same prepared group: identical tokens in
  f32 for ``cbs_simple``, ``cbs_grounded``, beam search and a sampler, in
  prior modes 1 and 2.
* The whole CLI against the JAX CLI run in this process, with the same
  weights (JAX's init, handed to the port through ``save_params_npz``) and
  ``MODEL.PRIOR_STD 0`` (z is then the prior mean in both): the same
  predictions JSON, byte for byte, and the same printed lines.
* The port CLI alone: schema, count and order, the tail group,
  determinism, the counted fallback, and what it refuses.
* ``--model baseline``: the predictions JSON byte-equal to the JAX CLI's
  and the same printed lines (JAX's ``init_baseline`` shared through a
  ``.npz``), one z-sample an image; under ``--sampler topk`` the config's
  z-samples.
"""

import importlib.util
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.models import baseline as jbase
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.datasets import (
    EvaluationDataset,
    EvaluationDatasetWithConstraints,
)
from style_seqcvae_tpu_torch.data.vocabulary import (
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.decoding import harness as tharness
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.ops.kernels._build import KernelError
from style_seqcvae_tpu_torch.scripts import inference as P
from style_seqcvae_tpu_torch.weights import from_jax_params, save_params_npz
from tests.test_torch_datasets import write_world

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_inference_cli", ROOT / "scripts" / "inference.py")
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)

B, NZ = 2, 3
# the group function cases: (world kind, sampler)
GROUP_KINDS = {"cbs_simple": ("simple_attributes", None),
               "cbs_grounded": ("grounded", None),
               "beam": ("plain", None),
               "sampler_topk": ("sentiment", dict(method="topk", top_k=5, top_p=0.9,
                                                  temperature=1.0))}
MODES = {"mode1": "", "mode2": "  SENTIMENT_VAE: 2\n"}


def _key_draws(key, first_shape, later_shape, steps):
    """The z-noise a JAX search draws inside its step from ``key`` (as
    ``tests/test_torch_decode.py`` draws it): the port's (steps, ...)
    stack, the first draw in row 0's first slots."""
    rng, k0 = jax.random.split(key)
    keys = jax.random.split(rng, steps - 1)
    stack = np.zeros((steps,) + tuple(later_shape), np.float32)
    stack[0][tuple(slice(0, n) for n in first_shape)] = np.asarray(
        jax.random.normal(k0, first_shape, jnp.float32))
    for t in range(1, steps):
        stack[t] = np.asarray(jax.random.normal(keys[t - 1], later_shape, jnp.float32))
    return stack


def _sample_draws(key, vocab, z, steps):
    """The z-noise and Gumbel noise JAX's ``sample_decode`` draws from
    ``key`` (as ``tests/test_torch_samplers.py`` draws them)."""
    rng, k0, s0 = jax.random.split(key, 3)
    keys = jax.random.split(rng, steps - 1)
    zs = np.zeros((steps, B, 1, z), np.float32)
    gs = np.zeros((steps, B, vocab), np.float32)
    zs[0] = np.asarray(jax.random.normal(k0, (B, 1, z), jnp.float32))
    gs[0] = np.asarray(jax.random.gumbel(s0, (B, vocab), jnp.float32))
    for t in range(1, steps):
        kstep, kg = jax.random.split(keys[t - 1])
        zs[t] = np.asarray(jax.random.normal(kstep, (B, 1, z), jnp.float32))
        gs[t] = np.asarray(jax.random.gumbel(kg, (B, vocab), jnp.float32))
    return zs, gs


def _prepared(cfg_path, n_images=B):
    """The CLI's prepared group: (collated batch, obj_att_embeds) per image,
    candidates drawn as the CLI draws them."""
    C = Config(str(cfg_path))
    voc = Vocabulary.from_files(C.DATA.VOCABULARY)
    add_constraint_words_to_vocabulary(voc, C.DATA.CBS.WORDFORMS)
    add_constraint_words_to_vocabulary(voc, C.DATA.CBS.WORDFORMS_ATTRIBS)
    random.seed(C.RANDOM_SEED)
    ds = (EvaluationDatasetWithConstraints.from_config(C, vocabulary=voc)
          if C.MODEL.USE_CBS else EvaluationDataset.from_config(C))
    oae_rng = np.random.RandomState(4)
    prepared = []
    for i in range(n_images):
        batch = ds.collate_fn([ds[i]])
        oae = (oae_rng.randn(1, C.DATA.MAX_BOXES, C.MODEL.Z_SPACE).astype(np.float32)
               if C.MODEL.SENTIMENT_VAE == 2 else None)
        prepared.append((batch, oae))
    return C, voc, prepared


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", sorted(GROUP_KINDS))
def test_group_functions_match_jax_cli(tmp_path, kind, mode):
    world, sampler = GROUP_KINDS[kind]
    C, voc, prepared = _prepared(write_world(tmp_path, world, model=MODES[mode]))
    jcfg = jcap.CaptionerConfig.from_config(C, voc)
    tcfg = tcap.CaptionerConfig.from_config(C, voc)
    assert tuple(tcfg) == tuple(jcfg)
    params = jcap.init_captioner(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    key = jax.random.PRNGKey(9)

    jout = J._dispatch_group(C, jcfg, jharness.DecodeHarness(params, jcfg), prepared, key, NZ,
                             sampler=sampler)
    T, K, Z = jcfg.max_caption_length, jcfg.beam_size, jcfg.z_space
    zkeys = jax.random.split(key, NZ)
    if sampler is not None:
        draws = [_sample_draws(k, jcfg.vocab_size, Z, T) for k in zkeys]
        noise = tuple(np.stack([d[i] for d in draws]) for i in range(2))
    elif C.MODEL.USE_CBS:
        S = tharness._bucket(max(t.default_dest.shape[0] for b, _ in prepared
                                 for t in b["fsm_tables"]))
        noise = np.stack([_key_draws(k, (B, 1, 1, Z), (B, S, K, Z), T) for k in zkeys])
    else:
        noise = np.stack([_key_draws(k, (B, 1, Z), (B, K, Z), T) for k in zkeys])
    th = tharness.DecodeHarness(tparams, tcfg, device="cpu")
    tout = P._dispatch_group(C, tcfg, th, prepared, noise, NZ, sampler=sampler)
    assert tout[0] == jout[0]
    if kind == "cbs_grounded":
        # every state and beam of every z, as the grounded selection reads them
        seqs, lp = (t.numpy() for t in tout[1])
        np.testing.assert_array_equal(seqs, np.asarray(jout[1][0]))
        live = np.asarray(jout[1][1]) > -1e18
        assert live.any() and np.array_equal(lp > -1e18, live)
        np.testing.assert_allclose(lp[live], np.asarray(jout[1][1])[live], atol=1e-4, rtol=0)
        # The JAX datasets give grounded mode's FSM its attribute words only,
        # while the selection looks each candidate's object up among the
        # FSM's constraints: a KeyError in both, on which the CLIs fall back
        # to beam search image by image. Candidates made of the FSM's own
        # words take the selection through.
        for fn, cfg, out in ((J._collect_group, jcfg, jout), (P._collect_group, tcfg, tout)):
            with pytest.raises(KeyError):
                fn(C, cfg, out, prepared, NZ)
        prepared = _selectable(prepared)
    want = J._collect_group(C, jcfg, jout, prepared, NZ)
    got = P._collect_group(C, tcfg, tout, prepared, NZ)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        assert g.shape == w.shape == (NZ, T)
        np.testing.assert_array_equal(g, w)
    assert any((w != jcfg.boundary_index).any() for w in want)


def _selectable(prepared):
    """``prepared`` with each z's grounded candidates rebuilt from its FSM's
    constraint words: the first word an object whose attribute is the
    second, the rest objects without attributes."""
    out = []
    for batch, oae in prepared:
        cands = []
        for c2s in batch["constraint2states"]:
            words = list(c2s)
            cands.append(([[words[0], words[1:2]]] if words else [])
                         + [[w, []] for w in words[2:]])
        out.append(({**batch, "candidates": cands}, oae))
    return out


def _same_weights(cfg_path, npz, init=jcap.init_captioner):
    """JAX's init (``init``) as the JAX CLI draws it, saved for the port."""
    from style_seqcvae_tpu.config import Config as JConfig
    from style_seqcvae_tpu.data import vocabulary as jvoc

    C = JConfig(str(cfg_path))
    voc = jvoc.Vocabulary.from_files(C.DATA.VOCABULARY)
    for tsv in (C.DATA.CBS.WORDFORMS, C.DATA.CBS.WORDFORMS_ATTRIBS):
        jvoc.add_constraint_words_to_vocabulary(voc, tsv)
    cfg = jcap.CaptionerConfig.from_config(C, voc)
    tokens = [voc.get_token_from_index(i) for i in range(voc.get_vocab_size())]
    emb = jcap.hashed_random_embeddings(tokens, cfg.embedding_size, cfg.pad_index)
    np.testing.assert_array_equal(
        tcap.hashed_random_embeddings(tokens, cfg.embedding_size, cfg.pad_index), emb)
    params = jit_init(init, cfg, jax.random.PRNGKey(C.RANDOM_SEED), emb)
    save_params_npz(jax.tree_util.tree_map(np.asarray, params), str(npz))


@pytest.mark.parametrize("world", ["sentiment", "plain"])
def test_whole_cli_matches_jax_cli(tmp_path, capsys, monkeypatch, world):
    cfg = write_world(tmp_path, world, model="  PRIOR_STD: 0.0\n")
    _same_weights(cfg, tmp_path / "params.npz")
    out = tmp_path / "preds.json"
    common = ["--config", str(cfg), "--output-path", str(out), "--cpu", "--batch-images", "2",
              "--max-images", "4"]
    monkeypatch.setattr("sys.argv", ["inference.py", *common])
    J.main()
    want, want_out = out.read_bytes(), capsys.readouterr().out
    out.unlink()
    assert P.main(common + ["--checkpoint-path", str(tmp_path / "params.npz")]) == 0
    got, got_out = out.read_bytes(), capsys.readouterr().out
    assert got == want
    assert got_out == want_out
    preds = json.loads(got)
    assert len(preds) == 4 * NZ and len({p["caption"] for p in preds}) > 1


@pytest.mark.parametrize("world", ["sentiment", "plain"])
def test_whole_cli_baseline_matches_jax_cli(tmp_path, capsys, monkeypatch, world):
    cfg = write_world(tmp_path, world)
    _same_weights(cfg, tmp_path / "params.npz", init=jbase.init_baseline)
    out = tmp_path / "preds.json"
    common = ["--config", str(cfg), "--output-path", str(out), "--cpu", "--batch-images", "2",
              "--max-images", "4", "--model", "baseline"]
    monkeypatch.setattr("sys.argv", ["inference.py", *common])
    J.main()
    want, want_out = out.read_bytes(), capsys.readouterr().out
    out.unlink()
    stats = {}
    assert P.main(common + ["--checkpoint-path", str(tmp_path / "params.npz")],
                  stats=stats) == 0
    got, got_out = out.read_bytes(), capsys.readouterr().out
    assert got == want
    assert got_out == want_out
    preds = json.loads(got)
    assert len(preds) == 4 and stats["fallbacks"] == 0       # one z-sample an image
    assert len({p["caption"] for p in preds}) > 1


def test_port_cli_baseline_sampler(tmp_path):
    cfg = write_world(tmp_path, "sentiment")
    preds, stats = _run(cfg, tmp_path / "s.json", "--model", "baseline", "--sampler", "topk",
                        "--batch-images", "2", "--max-images", "3")
    assert len(preds) == 3 * NZ and stats["fallbacks"] == 0   # the config's z-samples
    assert [p["image_id"] for p in preds[:NZ]] == [preds[0]["image_id"]] * NZ
    again, _ = _run(cfg, tmp_path / "t.json", "--model", "baseline", "--sampler", "topk",
                    "--batch-images", "2", "--max-images", "3")
    assert again == preds


def _run(cfg, out, *extra):
    stats = {}
    rc = P.main(["--config", str(cfg), "--output-path", str(out), "--cpu", *extra], stats=stats)
    assert rc == 0
    return json.loads(Path(out).read_text()), stats


def test_port_cli_output_order_tail_and_determinism(tmp_path, capsys):
    cfg = write_world(tmp_path, "simple_attributes")
    C, _, _ = _prepared(cfg, n_images=0)
    ids = sorted(EvaluationDataset.from_config(C)._image_ids)[:5]
    preds, stats = _run(cfg, tmp_path / "a.json", "--batch-images", "2", "--max-images", "5")
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["5/5 images decoded", f"wrote 15 predictions to {tmp_path / 'a.json'}"]
    assert [p["image_id"] for p in preds] == [i for i in ids for _ in range(NZ)]
    assert all(set(p) == {"image_id", "caption"} and isinstance(p["image_id"], int)
               and isinstance(p["caption"], str) and "@@" not in p["caption"] for p in preds)
    assert stats["images"] == 5 and stats["predictions"] == 15 and stats["fallbacks"] == 0
    again, _ = _run(cfg, tmp_path / "b.json", "--batch-images", "2", "--max-images", "5")
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    # one image a dispatch: the same images in the same order (other
    # captions: the generator's draws follow the group shapes)
    single, _ = _run(cfg, tmp_path / "c.json", "--max-images", "5")
    assert [p["image_id"] for p in single] == [p["image_id"] for p in preds]
    for extra in (["--sampler", "topp", "--batch-images", "2"], ["--bf16", "--batch-images", "3"]):
        out, stats = _run(cfg, tmp_path / "d.json", "--max-images", "4", *extra)
        assert [p["image_id"] for p in out] == [i for i in ids[:4] for _ in range(NZ)]
        assert stats["fallbacks"] == 0


def test_port_cli_fallback_and_what_it_raises(tmp_path, capsys, monkeypatch):
    cfg = write_world(tmp_path, "sentiment")
    args = ["--max-images", "3", "--batch-images", "2"]

    def fail(*a, **k):
        raise ValueError("no CBS today")

    monkeypatch.setattr(tharness.DecodeHarness, "decode_cbs", fail)
    preds, stats = _run(cfg, tmp_path / "f.json", *args)
    out = capsys.readouterr().out
    assert stats["fallbacks"] == 3 and len(preds) == 3 * NZ
    assert "group decode failed (no CBS today); retrying per image" in out
    assert "3 images fell back to unconstrained decoding" in out

    def kernel_fails(*a, **k):
        raise KernelError("vocab_topk_lse launch failed: CUDA error 700")

    monkeypatch.setattr(tharness.DecodeHarness, "decode_cbs", kernel_fails)
    with pytest.raises(KernelError):
        _run(cfg, tmp_path / "g.json", *args)
    monkeypatch.undo()

    base = ["--config", str(cfg), "--output-path", str(tmp_path / "h.json"), "--cpu"]
    # the baseline family runs (it was refused until it was ported)
    assert P.main(base + ["--model", "baseline", "--max-images", "2"]) == 0
    assert len(json.loads((tmp_path / "h.json").read_text())) == 2
    # data parallelism runs since it was ported (tests/test_torch_ddp.py
    # holds its captions to --num-data 1)
    assert P.main(base + ["--num-data", "2", "--max-images", "2"]) == 0
    # a directory without the named checkpoint of the port's layout
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        P.main(base + ["--checkpoint-path", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main(base[:-1])
