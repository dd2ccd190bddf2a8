"""The port's data-parallel layer without a second process
(``style_seqcvae_tpu_torch/parallel``): the process runtime without its
environment, the batch helpers, ``decode_grid_split`` and the decode grid
split over CPU entries of a ``Mesh``.

A split decode is held token for token to the unsplit port decode and to
the JAX harness sharded over the CPU mesh of ``tests/conftest.py`` (8
virtual devices), on the same noise: JAX's draws from its keys
(``_key_draws``, ``_sample_draws``), handed to the port as its stacks.
Log-probs within 1e-5 relative of the unsplit decode's (the chunks' batched
products sum in another order; a score is a sum of T log-probs) and
within JAX's ``SCORE_ATOL`` (1e-4) of the JAX harness's, as the unsplit
parity tests hold them.
A ``torch.Generator``-seeded split decode gives the unsplit tokens: the
split path draws what the unsplit decode draws, in its order.
"""

import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.decoding import harness as jharness
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from style_seqcvae_tpu_torch.decoding.cbs_fast import fsm_to_tables
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models.baseline import init_baseline
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig
from style_seqcvae_tpu_torch.parallel import mesh as tmesh
from style_seqcvae_tpu_torch.parallel import multihost
from style_seqcvae_tpu_torch.weights import cast_floats, from_jax_params
from tests import test_torch_cbs as tcbs
from tests import test_torch_samplers as tsam
from tests.test_torch_decode import _key_draws

torch.set_num_threads(1)

LP_RTOL = 1e-5
ENV = ("SSC_COORDINATOR", "SSC_NUM_PROCESSES", "SSC_PROCESS_ID", "SSC_MULTIHOST", "RANK",
       "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")


def _cpu_mesh(n):
    return tmesh.Mesh(tuple(torch.device("cpu") for _ in range(n)))


def _jax_mesh(n):
    return jax_make_mesh(num_data=n, num_model=1, devices=jax.devices()[:n])


# ------------------------------------------------------------ the runtime


def test_initialize_is_a_noop_without_the_environment(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize_distributed("cpu") is False
    assert multihost.maybe_initialize_distributed() is False      # no card needed either
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert tmesh.local_rows(6) == slice(0, 6)


def test_local_batch_size_and_rows(monkeypatch):
    assert multihost.local_batch_size(150) == 150
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    monkeypatch.setattr(tmesh, "process_count", lambda: 3)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    assert multihost.local_batch_size(150) == 50
    with pytest.raises(ValueError, match="not divisible by the 3"):
        multihost.local_batch_size(151)
    assert tmesh.local_rows(12) == slice(4, 8)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.local_rows(10)


def test_mesh_refuses_a_model_axis_and_missing_devices():
    # a model axis is ported: one process's 2 x 2 mesh, its data rows first
    square = tmesh.make_mesh(2, 2, ["cpu", "cpu", "cpu", "cpu"])
    assert (square.num_data, square.num_model, square.world_size) == (2, 2, 1)
    assert len(square.data_devices) == 2 and square.data_group is None
    assert tmesh.make_mesh(-1, 2, ["cpu"] * 6).num_data == 3
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(-1, 4, ["cpu"] * 6)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(3, 1, ["cpu", "cpu"])
    mesh = tmesh.make_mesh(-1, 1, ["cpu", "cpu"])
    assert len(mesh.devices) == 2 and mesh.world_size == 1 and mesh.data_group is None and mesh.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(1, 1, ["cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeHarness(init_baseline(CaptionerConfig(vocab_size=10), device="cpu"),
                          CaptionerConfig(vocab_size=10), family="baseline",
                          mesh=tmesh.Mesh((torch.device("cuda:1"),)))


def test_decode_grid_split_cases():
    """z first, then the batch, then the whole grid on the first device
    with JAX's warning (tests/test_decode_parallel.py:110-125)."""
    three = _cpu_mesh(3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        split = tmesh.decode_grid_split(three, 20, 7)
    assert split.axis is None and split.chunks == ((slice(None), torch.device("cpu")),)
    assert any("fully replicated" in str(x.message) for x in w)
    for n_z, batch, axis, per in ((21, 7, "z", 7), (20, 6, "batch", 2)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            split = tmesh.decode_grid_split(three, n_z, batch)
        assert not w and split.axis == axis
        assert [c[0] for c in split.chunks] == [slice(i * per, (i + 1) * per) for i in range(3)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tmesh.decode_grid_split(_cpu_mesh(1), 20, 7).axis == "z"
    assert not w


def test_shard_detector_batch_keeps_att_counts_global():
    mesh = _cpu_mesh(1)
    local = {"images": np.zeros((2, 8, 8, 3), np.float32), "num_gt": np.array([1, 2]),
             "att_counts": np.arange(7, dtype=np.float32), "scale": np.float32(1.0)}
    out = tmesh.shard_detector_batch(mesh, local)
    assert out["att_counts"].shape == (7,) and out["images"].shape == (2, 8, 8, 3)
    assert out["scale"].dim() == 0 and tmesh.batch_sharding(mesh) == torch.device("cpu")
    stacked = {"images": np.zeros((3, 2, 8, 8, 3), np.float32),
               "num_gt": np.ones((3, 2), np.int32), "att_counts": np.ones(7, np.float32)}
    assert tmesh.shard_detector_batch(mesh, stacked, leading_scan_axis=True)["num_gt"].shape \
        == (3, 2)
    with pytest.raises(ValueError, match="disagree"):
        tmesh.shard_detector_batch(mesh, dict(local, num_gt=np.array([1, 2, 3])))
    with pytest.raises(ValueError, match="disagree"):
        tmesh.shard_batch(mesh, {"a": np.zeros((2, 3)), "att_counts": np.zeros(7)})


def test_replicate_shares_a_device_listed_twice():
    params = init_baseline(CaptionerConfig(vocab_size=10), device="cpu")
    a, b = tmesh.replicate(_cpu_mesh(2), params)
    assert a is b and torch.equal(a["embedding"], params["embedding"])


# ------------------------------------------------------ the split decodes


def _cbs_case(n_z, batch, seed):
    jcfg, tcfg = tcbs._cfg()
    params = jcap.init_captioner(jax.random.PRNGKey(seed), jcfg)
    # the end token's logit near 1.6 END_LOGIT, so that some captions end early
    direction = jax.numpy.tanh(params["output_projection"]["b"])
    params["embedding"] = params["embedding"].at[jcfg.boundary_index].set(
        1.6 * tcbs.END_LOGIT * direction / jax.numpy.sum(direction ** 2))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, tcbs.NBOX, 12).astype(np.float32)
    feats[-1, -1] = 0.0
    sentiment = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    tables = [[tcbs.jcbs.fsm_to_tables(tcbs._fsm(rng)) for _ in range(n_z)]
              for _ in range(batch)]
    return jcfg, tcfg, params, tparams, feats, sentiment, tables


@pytest.mark.parametrize("n_z,batch,devices,return_all", [(8, 2, 2, False), (3, 8, 4, False),
                                                          (8, 2, 2, True)])
def test_split_decode_cbs_matches_unsplit_and_jax_sharded(n_z, batch, devices, return_all):
    jcfg, tcfg, params, tparams, feats, sentiment, tables = _cbs_case(n_z, batch, 11)
    key = jax.random.PRNGKey(12)
    ref = jharness.DecodeHarness(params, jcfg, mesh=_jax_mesh(devices)).decode_cbs(
        feats, sentiment, None, tables, [3], key, n_z, return_all=return_all)
    noise = np.stack([_key_draws(k, (batch, 1, 1, 4), (batch, tcbs.S, tcbs.BEAM, 4),
                                 max_steps=tcbs.T) for k in jax.random.split(key, n_z)])
    port_tables = tcbs._port_tables(tables)
    split = DecodeHarness(tparams, tcfg, device="cpu", mesh=_cpu_mesh(devices))
    plain = DecodeHarness(tparams, tcfg, device="cpu")
    axis = tmesh.decode_grid_split(split.mesh, n_z, batch).axis
    assert axis == ("z" if n_z % devices == 0 else "batch")
    for selection in ("raw", "prehead"):
        got = split.decode_cbs(feats, sentiment, None, port_tables, [3], noise, n_z,
                               selection=selection, return_all=return_all)
        want = plain.decode_cbs(feats, sentiment, None, port_tables, [3], noise, n_z,
                                selection=selection, return_all=return_all)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=LP_RTOL, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), ref[1], atol=tcbs.SCORE_ATOL, rtol=0)
    assert (ref[0] == jcfg.boundary_index).any()


def test_split_decode_beam_matches_unsplit_and_jax_sharded():
    jcfg, tcfg = tsam._cfg()
    params, tparams = tsam._params(jcfg, 21)
    n_z, batch = 4, 2
    rng = np.random.RandomState(22)
    feats = rng.randn(batch, tsam.NBOX, tsam.F).astype(np.float32)
    sent = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    ref_seqs, ref_lp = jharness.DecodeHarness(params, jcfg, mesh=_jax_mesh(2)).decode_beam(
        feats, sent, None, key, n_z)
    noise = np.stack([_key_draws(k, (batch, 1, tsam.Z), (batch, tsam.K, tsam.Z),
                                 max_steps=tsam.T) for k in jax.random.split(key, n_z)])
    seqs, lp = DecodeHarness(tparams, tcfg, device="cpu", mesh=_cpu_mesh(2)).decode_beam(
        feats, sent, None, noise, n_z)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=tcbs.SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("method", ["topk", "gumbel"])
def test_split_decode_sample_matches_jax_sharded(method):
    jcfg, tcfg = tsam._cfg()
    params, tparams = tsam._params(jcfg, 31)
    n_z, batch = 4, 2
    rng = np.random.RandomState(32)
    feats = rng.randn(batch, tsam.NBOX, tsam.F).astype(np.float32)
    sent = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    name, top_k, top_p, temperature = tsam.METHODS[method]
    kw = dict(top_k=top_k or 5, top_p=top_p or 0.9, temperature=temperature)
    key = jax.random.PRNGKey(33)
    ref = jharness.DecodeHarness(params, jcfg, mesh=_jax_mesh(2)).decode_sample(
        feats, sent, None, key, n_z, name, **kw)
    draws = [tsam._sample_draws(k, batch, tsam.V, tsam.Z,
                                beam=tsam.K if name == "gumbel" else 0)
             for k in jax.random.split(key, n_z)]
    noise = tuple(np.stack([d[i] for d in draws]) for i in range(2))
    got = DecodeHarness(tparams, tcfg, device="cpu", mesh=_cpu_mesh(2)).decode_sample(
        feats, sent, None, noise, n_z, name, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


def _fsm(rng, vocab, states=4):
    """Two single-word constraints of two wordforms each over ``states``
    states, as ``tests/test_torch_cbs.py::_fsm`` builds them."""
    f = np.zeros((states, states, vocab), np.uint8)
    for s in range(states):
        f[s, s, :] = 1
    for c, toks in enumerate(rng.randint(2, vocab, (2, 2))):
        for s in range(states):
            if not s & (1 << c):
                for t in toks:
                    f[s, s | (1 << c), t], f[s, s, t] = 1, 0
    return f


def _generator_case(mode, dtype):
    jcfg, tcfg = tsam._cfg(**tsam.MODES[mode])
    _, tparams = tsam._params(jcfg, 41)
    tparams = cast_floats(tparams, dtype)
    rng = np.random.RandomState(42)
    n_z, batch = 4, 4
    feats = rng.randn(batch, tsam.NBOX, tsam.F).astype(np.float32)
    sent = rng.choice([-1.0, 1.0], (batch, 1)).astype(np.float32)
    oae = rng.randn(batch, tsam.NBOX, tsam.Z).astype(np.float32) if mode == "mode2" else None
    return tcfg, tparams, n_z, (feats, sent, oae)


@pytest.mark.parametrize("mode,dtype", [("mode1", torch.float32), ("mode2", torch.bfloat16)])
def test_generator_seeded_split_equals_unsplit(mode, dtype):
    """Every decode, split by z (2 entries) and by batch (4 entries, n_z 3):
    the split path draws the unsplit decode's noise from the generator, so
    the tokens are the unsplit ones."""
    tcfg, tparams, n_z, inputs = _generator_case(mode, dtype)
    plain = DecodeHarness(tparams, tcfg, device="cpu")
    tables = [[fsm_to_tables(_fsm(np.random.RandomState(b), tsam.V)) for _ in range(n_z)]
              for b in range(inputs[0].shape[0])]

    def decodes(h, nz, tab):
        out = {"cbs": h.decode_cbs(*inputs, tab, [2], gen(), nz, selection="raw")[0],
               "beam": h.decode_beam(*inputs, gen(), nz)[0]}
        for method in tsam.METHODS:
            out[method] = h.decode_sample(*inputs, gen(), nz, method)
        return out

    def gen():
        return torch.Generator().manual_seed(43)

    for devices, nz in ((2, n_z), (4, 3)):
        tab = [ts[:nz] for ts in tables]
        want = decodes(plain, nz, tab)
        got = decodes(DecodeHarness(tparams, tcfg, device="cpu", mesh=_cpu_mesh(devices)),
                      nz, tab)
        for name in want:
            assert torch.equal(got[name], want[name]), (devices, name)
    assert not torch.equal(want["multinomial"][0], want["multinomial"][1])


def test_split_baseline_and_bad_meshes():
    cfg = CaptionerConfig(vocab_size=30, image_feature_size=6, embedding_size=8,
                          hidden_size=8, attention_projection_size=4, max_caption_length=5,
                          beam_size=3)
    params = init_baseline(cfg, seed=1, device="cpu")
    feats = np.random.RandomState(2).randn(4, 3, 6).astype(np.float32)
    plain = DecodeHarness(params, cfg, device="cpu", family="baseline")
    split = DecodeHarness(params, cfg, device="cpu", family="baseline", mesh=_cpu_mesh(2))
    for h_out in (lambda h: h.decode_beam(feats, None, None, torch.Generator().manual_seed(3),
                                          1)[0],
                  lambda h: h.decode_sample(feats, None, None,
                                            torch.Generator().manual_seed(4), 2, "topp")):
        assert torch.equal(h_out(split), h_out(plain))
    with pytest.raises(ValueError, match="one process's devices"):
        DecodeHarness(params, cfg, family="baseline",
                      mesh=tmesh.Mesh((torch.device("cpu"),), world_size=2))


def test_split_decodes_every_chunk_in_a_worker_thread():
    """Every split, a device listed twice included, runs its chunks in the
    pool of one worker thread per distinct device, never in the caller's
    thread: the path a mesh of several cards takes."""
    cfg = CaptionerConfig(vocab_size=30, image_feature_size=6, embedding_size=8,
                          hidden_size=8, attention_projection_size=4, max_caption_length=5,
                          beam_size=3)
    params = init_baseline(cfg, seed=1, device="cpu")
    feats = np.random.RandomState(2).randn(4, 3, 6).astype(np.float32)
    for devices in (1, 2):
        split = DecodeHarness(params, cfg, device="cpu", family="baseline",
                              mesh=_cpu_mesh(devices))
        (chunk,) = set(split._chunk_harness.values())
        threads, real = [], chunk.decode_beam

        def spy(*args, **kw):
            threads.append(threading.current_thread())
            return real(*args, **kw)

        chunk.decode_beam = spy
        split.decode_beam(feats, None, None, torch.Generator().manual_seed(3), 2)
        assert len(threads) == devices
        assert len(set(threads)) == 1 and threads[0] is not threading.main_thread()


# ---------------------------------------- a fault of the reference, mirrored


class _Rows:
    """A dataset of ``n`` rows that collates a batch into its row indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def collate_fn(self, rows):
        return rows


def test_process_shard_drift_mirrors_jax():
    """11 rows at a global batch of 4 (2 a rank): rank 0's stride holds 6
    rows an epoch, 3 batches; rank 1's 5, 2 batches. The first two steps are
    one process's batches; at the third, rank 0 still draws from the first
    epoch while rank 1 has moved to the second, so two ranks stop being one
    process on the concatenated batch, as in JAX (``data/datasets.py:320-348``),
    whose batches the port's equal."""
    import itertools
    import random

    from style_seqcvae_tpu.data.datasets import TrainingDataset as JaxTrainingDataset
    from style_seqcvae_tpu_torch.data.datasets import TrainingDataset

    def first(cls, batch, shard, n=3):
        gen = cls.batches(_Rows(11), batch, rng=random.Random(0), process_shard=shard)
        return list(itertools.islice(gen, n))

    ranks = [first(TrainingDataset, 2, (r, 2)) for r in range(2)]
    assert ranks == [first(JaxTrainingDataset, 2, (r, 2)) for r in range(2)]
    one = first(TrainingDataset, 4, (0, 1))
    rng = random.Random(0)
    epochs = []
    for _ in range(2):
        order = list(range(11))
        rng.shuffle(order)
        epochs.append(order)
    for s in range(2):
        assert sorted(ranks[0][s] + ranks[1][s]) == sorted(one[s]) == sorted(
            epochs[0][4 * s:4 * s + 4])
    assert ranks[0][2] == epochs[0][0::2][4:6]            # rank 0: still epoch 1
    assert ranks[1][2] == epochs[1][1::2][0:2]            # rank 1: epoch 2
    assert sorted(ranks[0][2] + ranks[1][2]) != sorted(one[2])
