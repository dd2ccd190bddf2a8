"""Tensor parallelism and FSDP in the port (``parallel/mesh.py``,
``parallel/tensor_parallel.py``) against one process and against the JAX
package's sharded step, on the CPU.

* The spec table: the port's ``param_sharding`` equals JAX's leaf for leaf
  for both families, tied (E = 300) and untied, FSDP on and off, at a 64-
  and a 63-word vocabulary (the indivisible vocabulary replicated), on a
  (4, 2) mesh; an unknown leaf raises the same error.
* One launch of four gloo ranks as a 2 x 2 mesh (``distributed_worker``,
  bounded by ``TIMEOUT``) trains three steps of the captioner (untied,
  V = 64), of the baseline (tied, E = 300) and of an FSDP captioner (tied,
  H = 5, V = 63: FSDP leaves cut on dim 0 and on dim 1, the vocabulary
  replicated), with the clip engaged (the pre-clip norm exceeds
  ``OPTIM.CLIP_GRADIENTS``). Each is held to one port process on the 16
  rows and to JAX's ``make_train_step`` under ``shard_params`` on a (2, 2)
  mesh, with JAX's params and z-noise: metrics and the pre-clip norm within
  rtol 1e-5, every gathered leaf within 1e-5 of its norm, every leaf held
  whole over the model axis bit-equal across each model group, and every
  sharded leaf's blocks concatenating, in rank order, to the gathered leaf.
* Checkpoints: a 1 x 1 save restores at 2 x 2 (FSDP on) and the next step
  is one process's; the 2 x 2 save restores at 1 x 1.
* The train CLI: ``--num-model 2`` (two ranks it starts itself) equals
  ``--num-model 1`` for both families: losses rtol 1e-5, the final
  checkpoint within 1e-5 of each leaf's norm; so does ``--device-corpus
  --steps-per-dispatch 2`` at ``--num-model 2``
  (``tests/test_torch_train_cli.py::test_train_cli_refusals`` runs
  ``--bf16-compute`` there).
* A one-process 3 x 2 mesh's ``decode_grid_split`` splits over the three
  data rows, and warns as JAX's ``decode_grid_specs`` does.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu.models import baseline as jbase
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.parallel import mesh as jmesh
from style_seqcvae_tpu.training import trainer as jtrainer
from style_seqcvae_tpu_torch.models.baseline import init_baseline
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, init_captioner
from style_seqcvae_tpu_torch.parallel import distributed_worker as W
from style_seqcvae_tpu_torch.parallel import mesh as tmesh
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.weights import load_params_npz
from tests.test_torch_ddp import _jax_eps, _save_tree
from tests.test_torch_ddp_cli import _assert_close_params, _cli, _losses
from tests.test_torch_train import jax_leaves
from tests.test_torch_train_data import write_train_world

torch.set_num_threads(1)

TIMEOUT = 240.0            # seconds the four-rank launch may take
METRIC_RTOL = 1e-5
PARAM_REL = 1e-5
CLIP = 0.5
STEPS = 3
OVERRIDES = ["OPTIM.NUM_ITERATIONS", "100", "OPTIM.CLIP_GRADIENTS", str(CLIP),
             "OPTIM.EPOCH_START_DECODER_TRAINING", "2", "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "2"]
TINY = W._TINY_CAPTIONER
# name → (family, model, fsdp)
CASES = {
    "captioner": ("cvae", TINY, False),
    "baseline": ("baseline", dict(TINY, embedding_size=300), False),
    "fsdp": ("cvae", dict(TINY, embedding_size=300, hidden_size=5, vocab_size=63), True),
}


def _port_mesh(num_data, num_model):
    return tmesh.Mesh(tuple(torch.device("cpu") for _ in range(num_data * num_model)),
                      num_model=num_model)


def _jax_specs(params, mesh, **kw):
    flat = jax.tree_util.tree_flatten_with_path(jmesh.param_sharding(mesh, params, **kw))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): tuple(s.spec)
            for path, s in flat}


# ------------------------------------------------------------- the table


@pytest.mark.parametrize("vocab", [64, 63])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("emb", [8, 300])
@pytest.mark.parametrize("family", ["cvae", "baseline"])
def test_param_sharding_equals_jax(family, emb, fsdp, vocab):
    kw = dict(TINY, embedding_size=emb, vocab_size=vocab)
    init_j = jbase.init_baseline if family == "baseline" else jcap.init_captioner
    init_t = init_baseline if family == "baseline" else init_captioner
    jp = init_j(jax.random.PRNGKey(0), jcap.CaptionerConfig(**kw))
    tp = init_t(CaptionerConfig(**kw), device="cpu")
    want = _jax_specs(jp, jmesh.make_mesh(num_data=4, num_model=2),
                      shard_params_over_data=fsdp)
    got = tmesh.param_sharding(_port_mesh(4, 2), tp, shard_params_over_data=fsdp)
    assert got == want
    sharded = {p for p, s in got.items() if "model" in s}
    assert ("embedding" in sharded) == (vocab % 2 == 0)
    assert any(s and s[0] == "data" for s in got.values()) == fsdp


def test_unknown_leaf_raises_like_jax():
    params = {"cell": {"renamed_lstm": {"w": np.zeros((4, 8), np.float32)}}}
    with pytest.raises(ValueError, match="renamed_lstm.*_PARAM_SPEC_TABLE") as jerr:
        jmesh.param_sharding(jmesh.make_mesh(num_data=4, num_model=2), params)
    with pytest.raises(ValueError, match="renamed_lstm.*_PARAM_SPEC_TABLE") as terr:
        tmesh.param_sharding(_port_mesh(4, 2),
                             {"cell": {"renamed_lstm": {"w": torch.zeros(4, 8)}}})
    assert str(terr.value) == str(jerr.value)


def test_decode_grid_split_on_a_3x2_mesh_warns_like_jax():
    """tests/test_decode_parallel.py:110-140 on the port's one-process 3 x 2
    mesh: no split of 20 z or 7 images over 3 data rows (JAX's warning);
    21 z split three ways, each chunk on its data row's first device."""
    jm = jmesh.make_mesh(num_data=3, num_model=2, devices=jax.devices()[:6])
    mesh = tmesh.make_mesh(3, 2, ["cpu"] * 6)
    for n_z, batch, replicated in ((20, 7, True), (21, 7, False)):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jmesh.decode_grid_specs(jm, n_z, batch)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            split = tmesh.decode_grid_split(mesh, n_z, batch)
        assert bool(jw) == bool(tw) == replicated
        if replicated:
            assert "fully replicated" in str(tw[0].message)
            assert split.axis is None and len(split.chunks) == 1
        else:
            assert split.axis == "z"
            assert [c[0] for c in split.chunks] == [slice(0, 7), slice(7, 14), slice(14, 21)]
            assert [c[1] for c in split.chunks] == [mesh.devices[0], mesh.devices[2],
                                                    mesh.devices[4]]


# ------------------------------------------------------- four gloo ranks


def _jax_run(family, model, fsdp, batch, seed):
    """JAX's step on a (2, 2) mesh, its state key ``PRNGKey(seed)``: the
    initial params, STEPS metrics and the final params."""
    jcfg = jcap.CaptionerConfig(**model)
    jconfig = JConfig(config_override=OVERRIDES)
    init = jbase.init_baseline if family == "baseline" else jcap.init_captioner
    # numpy copies: the step donates the state's buffers
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    mesh = jmesh.make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
    state, tx = jtrainer.create_train_state(
        jmesh.shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, jp),
                           shard_params_over_data=fsdp), jconfig, jcfg,
        jax.random.PRNGKey(seed))
    step = (jtrainer.make_baseline_train_step(tx, jcfg) if family == "baseline"
            else jtrainer.make_train_step(tx, jcfg, jconfig.MODEL.KLD_WEIGHT))
    sharded_batch = jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics = []
    with jax.sharding.set_mesh(mesh):
        for _ in range(STEPS):
            state, m = step(state, sharded_batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return jp, metrics, jax_leaves(state.params)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four-rank launch (every payload), one port process on each
    payload, JAX's sharded runs, and the checkpoint round trips."""
    tmp = tmp_path_factory.mktemp("tp")
    specs, jax_out = {}, {}
    for name, (family, model, fsdp) in CASES.items():
        batch = W.caption_batch(model, 16, 4, seed=5)
        np.savez(tmp / f"{name}_batch.npz", **batch)
        jp, jmetrics, jleaves = _jax_run(family, model, fsdp, batch, seed=1)
        eps = None
        if family == "cvae":
            np.savez(tmp / f"{name}_eps.npz", eps=_jax_eps(
                jax.random.PRNGKey(1), STEPS, 16, model["max_caption_length"] + 1, model["z_space"]))
            eps = str(tmp / f"{name}_eps.npz")
        specs[name] = W.captioner_spec(
            family=family, model=model, fsdp=fsdp, num_model=2, steps=STEPS,
            overrides=OVERRIDES, params=_save_tree(jp, tmp / f"{name}_params.npz"),
            batch_npz=str(tmp / f"{name}_batch.npz"), eps=eps,
            save=str(tmp / f"{name}_ranks.npz"), save_local=str(tmp / f"{name}_blocks"))
        jax_out[name] = (jmetrics, jleaves)
    ones = W.run_payloads({name: dict(spec, num_model=1, fsdp=False, save_local=None,
                                      save=str(tmp / f"{name}_one.npz"))
                           for name, spec in specs.items()}, "cpu")

    # checkpoints: one process saves after a step, the ranks restore it
    ckpt = str(tmp / "ckpts")
    base = W.captioner_spec(overrides=OVERRIDES, ckpt_dir=ckpt)
    one_step = W.run_payloads({"c": dict(base, steps=1, ckpt_save="one_step1")}, "cpu")["c"]
    two_steps = W.run_payloads({"c": dict(base, steps=2)}, "cpu")["c"]
    specs["ckpt"] = dict(base, steps=1, num_model=2, fsdp=True, ckpt_restore="one_step1",
                         ckpt_save="mesh_step2")

    ranks = W.launch_ranks(4, specs, timeout=TIMEOUT, out_dir=str(tmp / "w"))
    restored = W.run_payloads({"c": dict(base, steps=0, ckpt_restore="mesh_step2")},
                              "cpu")["c"]
    return dict(tmp=tmp, specs=specs, jax=jax_out, ones=ones, ranks=ranks,
                one_step=one_step, two_steps=two_steps, restored=restored)


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_2x2_ranks_equal_one_process_and_jax(tp_run, name):
    family, model, fsdp = CASES[name]
    tmp, ranks, one = tp_run["tmp"], [r[name] for r in tp_run["ranks"]], tp_run["ones"][name]
    jmetrics, jleaves = tp_run["jax"][name]
    assert [r["process_count"] for r in tp_run["ranks"]] == [4] * 4
    for r in ranks:
        assert r["opt_step"] == STEPS and r["replicated_mismatches"] == []
        assert r["metrics"] == ranks[0]["metrics"]                # the global step, bit for bit
    for s in range(STEPS):
        got, ref = ranks[0]["metrics"][s], one["metrics"][s]
        assert got["grad_norm"] > CLIP and ref["grad_norm"] > CLIP          # the clip engages
        for k in ("loss", "reconstr_loss", "kld_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=f"{s} {k}")
        for k in ("loss", "reconstr_loss", "kld_loss"):
            np.testing.assert_allclose(got[k], jmetrics[s][k], rtol=METRIC_RTOL,
                                       err_msg=f"JAX {s} {k}")

    gathered = dict(np.load(tmp / f"{name}_ranks.npz"))
    single = dict(np.load(tmp / f"{name}_one.npz"))
    assert gathered.keys() == single.keys() == jleaves.keys()
    for path, want in jleaves.items():
        assert _rel(gathered[path], want) <= PARAM_REL, f"JAX {path}"
        assert _rel(gathered[path], single[path]) <= PARAM_REL, f"one process {path}"

    specs = tmesh.param_sharding(_port_mesh(2, 2),
                                 load_params_npz(str(tmp / f"{name}_ranks.npz")), fsdp)
    blocks = [dict(np.load(tmp / f"{name}_blocks" / f"rank{r}.npz")) for r in range(4)]
    n_sharded = {"model": 0, "data": 0}
    for path, spec in specs.items():
        for axis in ("model", "data"):
            if axis in spec:
                n_sharded[axis] += 1
                dim = spec.index(axis)
                # the blocks of one index of the other axis, in rank order
                members = [0, 1] if axis == "model" else [0, 2]
                np.testing.assert_array_equal(
                    np.concatenate([blocks[r][path] for r in members], axis=dim),
                    gathered[path], err_msg=path)
        if not spec or set(spec) == {None}:
            for r in range(4):
                np.testing.assert_array_equal(blocks[r][path], gathered[path], err_msg=path)
    assert n_sharded["model"] >= (3 if family == "cvae" else 2)
    assert (n_sharded["data"] > 0) == fsdp
    if fsdp:
        assert specs["output_projection/w"] == (None, "data")    # 5 rows: cut on dim 1
        assert specs["cell/attention/w_image"] == ("data", None)
        assert specs["embedding"] == ()                          # 63 words: replicated


def test_collectives_a_step(tp_run):
    """Per step and rank: a gate all-gather and an input-gradient all-reduce
    for each LSTM of each of the T+1 steps (none for the attention LSTM's
    first input under a frozen, tied embedding: nothing before it takes a
    gradient), plus the head's input gradient a step, the embedding lookup
    and the loss's three all-reduces when the vocabulary is sharded; FSDP
    gathers and sums its five leaves."""
    T1 = TINY["max_caption_length"] + 1
    want = {"captioner": {"model_all_gather": 3 * T1, "model_all_reduce": 3 * T1 + T1 + 4},
            "baseline": {"model_all_gather": 2 * T1, "model_all_reduce": 2 * T1 - 1 + T1 + 4},
            "fsdp": {"model_all_gather": 3 * T1, "model_all_reduce": 3 * T1 - 1,
                     "data_all_gather": 5, "data_all_reduce": 5}}
    for name, counts in want.items():
        for r in tp_run["ranks"]:
            assert r[name]["collectives"] == [counts] * STEPS, name
            assert len(r[name]["collective_ms"]) == STEPS


def test_checkpoints_restore_across_meshes(tp_run):
    """One process's step-1 save restored at 2 x 2 (FSDP on) takes the step
    one process takes second; its save restores at 1 x 1 with the ranks'
    params and step."""
    ranks = [r["ckpt"] for r in tp_run["ranks"]]
    two, restored = tp_run["two_steps"], tp_run["restored"]
    assert tp_run["one_step"]["opt_step"] == 1
    for r in ranks:
        assert r["opt_step"] == 2 and r["replicated_mismatches"] == []
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][0][k], two["metrics"][1][k],
                                       rtol=METRIC_RTOL, err_msg=k)
        np.testing.assert_allclose(r["param_norm_sq"], two["param_norm_sq"], rtol=1e-6)
    assert restored["opt_step"] == 2
    assert restored["param_norm_sq"] == ranks[0]["param_norm_sq"]


# ------------------------------------------------------------ the CLI


@pytest.mark.parametrize("model", ["cvae", "baseline"])
def test_train_cli_num_model_2_equals_1(tmp_path, model):
    """``--num-model 2`` against ``--num-model 1``; for cvae also
    ``--device-corpus --steps-per-dispatch 2`` at ``--num-model 2`` (the
    same math as the plain run, so held to it too)."""
    cfg = write_train_world(tmp_path / "w", iterations=4, batch=4)
    variants = [("m1", ["--num-model", "1"]), ("m2", ["--num-model", "2"])]
    if model == "cvae":
        variants.append(("m2_flags", ["--num-model", "2", "--device-corpus",
                                      "--steps-per-dispatch", "2"]))
    runs = {}
    for name, args in variants:
        ser = tmp_path / name
        _cli("style_seqcvae_tpu_torch.scripts.train", "--config", cfg,
             "--serialization-dir", ser, "--cpu", "--model", model, *args,
             "--config-override", "PRINT_EVERY_N_BATCHES", "1")
        runs[name] = (_losses(ser / "metrics.jsonl", ("loss", "reconstr_loss", "kld_loss")),
                      read_checkpoint(str(ser / "checkpoint_4")))
    l1, c1 = runs.pop("m1")
    for name, (l2, c2) in runs.items():
        assert len(l1) == len(l2) == 4
        np.testing.assert_allclose(l2, l1, rtol=METRIC_RTOL, err_msg=name)
        _assert_close_params(c2["params"], c1["params"])
        _assert_close_params(c2["opt_state"]["trace"], c1["opt_state"]["trace"])
        assert int(c2["opt_state"]["step"]) == 4
