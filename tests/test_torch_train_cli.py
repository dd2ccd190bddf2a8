"""The port's train CLI (``style_seqcvae_tpu_torch/scripts/train.py``) against
the JAX CLI (``scripts/train.py``, loaded as a module and unchanged), and
alone.

* Both CLIs in-process on one small world (``write_train_world``), the
  port's init and z-noise patched to JAX's (its ``init_captioner`` returns
  JAX's ``jit_init`` params; its train step takes the normals JAX draws from
  its state key, as ``tests/test_torch_trainer.py`` derives them): the
  per-step loss, reconstruction and KL in ``metrics.jsonl`` within rtol
  1e-4 (f32 sums in other orders, compounded by SGD over the run).
* The port CLI alone on the CPU: checkpoints inside the run and the final
  one; a resume from a checkpoint that continues at the next step with the
  checkpoint's state (its steps equal to the trainer's own steps from that
  checkpoint on the batches the CLI feeds); ``--steps-per-dispatch 3`` and
  ``--device-corpus`` (modes 1 and 2) equal to the plain run bit for bit;
  ``--bf16-compute`` finite; the port's inference CLI decoding from the
  checkpoint directory as from the same params in a ``.npz``; ``python -m``
  as a user runs it; ``--num-model 2`` running as two ranks it starts.
* ``--model baseline``: the per-step losses equal to the JAX CLI's within
  rtol 1e-5 (the port's ``init_baseline`` patched to JAX's); checkpoints,
  a resume and the inference CLI decoding the checkpoint; the refusal of
  ``--steps-per-dispatch 2`` (JAX's message) and of a cvae checkpoint.
"""

import importlib.util
import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models import baseline as jbase
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.datasets import TrainingDataset
from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.scripts import inference as PI
from style_seqcvae_tpu_torch.scripts import train as P
from style_seqcvae_tpu_torch.training import trainer as ttrainer
from style_seqcvae_tpu_torch.training.checkpointing import CheckpointManager, read_checkpoint
from style_seqcvae_tpu_torch.weights import (
    from_jax_params,
    load_params_npz,
    named_leaves,
    save_params_npz,
)
from tests.test_torch_train_data import write_train_world

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_train_cli", ROOT / "scripts" / "train.py")
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)

METRIC_RTOL = 1e-4


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _run_port(cfg, ser, *extra):
    stats = {}
    assert P.main(["--config", str(cfg), "--serialization-dir", str(ser), "--cpu", *extra],
                  stats=stats) == 0
    return stats


def _params(path):
    return dict((k, v) for k, v in named_leaves(read_checkpoint(str(path))["params"]))


def _assert_same_params(a, b):
    pa, pb = _params(a), _params(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("mode", [1, 2])
def test_port_cli_losses_match_jax_cli(tmp_path, monkeypatch, mode):
    # batch 8: the JAX CLI's mesh spans the 8 CPU devices of tests/conftest.py
    cfg = write_train_world(tmp_path / "w", mode=mode, attribs=mode == 2, n_images=40,
                            iterations=6, batch=8)
    C = Config(str(cfg))
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", str(cfg), "--cpu",
                                      "--checkpoint-every", "100",
                                      "--serialization-dir", str(tmp_path / "jax")])
    J.main()

    def jax_init(model_cfg, seed, device, embedding_table):
        jp = jit_init(jcap.init_captioner, jcap.CaptionerConfig(*model_cfg),
                      jax.random.PRNGKey(seed), embedding_table)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device=device)

    key = jax.random.PRNGKey(C.RANDOM_SEED + 1)
    B, T1, Z = C.OPTIM.BATCH_SIZE, C.DATA.MAX_CAPTION_LENGTH + 1, C.MODEL.Z_SPACE

    def make_train_step(model_cfg, kld_weight, compute_dtype=None, mesh=None):
        step = ttrainer.make_train_step(model_cfg, kld_weight, compute_dtype, mesh)

        def with_jax_noise(state, batch):
            nonlocal key
            key, step_rng = jax.random.split(key)
            eps = np.stack([np.asarray(jax.random.normal(k, (B, Z), jax.numpy.float32))
                            for k in jax.random.split(step_rng, T1)])
            return step(state, batch, eps=eps)

        return with_jax_noise

    monkeypatch.setattr(P, "init_captioner", jax_init)
    monkeypatch.setattr(P, "make_train_step", make_train_step)
    _run_port(cfg, tmp_path / "port", "--checkpoint-every", "100")
    jrows, trows = _rows(tmp_path / "jax" / "metrics.jsonl"), _rows(tmp_path / "port" /
                                                                    "metrics.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == list(range(1, 7))
    for j, t in zip(jrows, trows):
        for name in ("loss", "reconstr_loss", "kld_loss"):
            np.testing.assert_allclose(t[name], j[name], rtol=METRIC_RTOL,
                                       err_msg=f"step {t['step']} {name}")


def _host_batches(C, n):
    """The first ``n`` batches the CLI feeds (a fresh seeded shuffle)."""
    voc = Vocabulary.from_files(C.DATA.VOCABULARY)
    ds = TrainingDataset.from_config(C, vocabulary=voc)
    it = ds.batches(C.OPTIM.BATCH_SIZE, rng=random.Random(C.RANDOM_SEED))
    return [{k: b[k] for k in ("caption_tokens", "sentiment", "image_features")}
            for b in (next(it) for _ in range(n))]


def test_train_cli_checkpoints_resume_and_decode(tmp_path, capsys):
    cfg = write_train_world(tmp_path / "w", iterations=8)
    C = Config(str(cfg))
    straight, part = tmp_path / "straight", tmp_path / "part"
    _run_port(cfg, straight, "--checkpoint-every", "4")
    assert {p.name for p in straight.iterdir()} >= {"checkpoint_4", "checkpoint_8",
                                                     "checkpoint_best", "config.yml",
                                                     "metrics.jsonl"}
    assert [r["step"] for r in _rows(straight / "metrics.jsonl")] == list(range(1, 9))
    stats = _run_port(cfg, part, "--checkpoint-every", "4", "--max-iterations", "4")
    assert stats["steps"] == 4 and stats["step_ms"] > 0 and "data_ms" in stats
    _assert_same_params(straight / "checkpoint_4", part / "checkpoint_4")
    capsys.readouterr()
    stats = _run_port(cfg, part, "--checkpoint-every", "4", "--start-from-checkpoint",
                      "checkpoint_4")
    assert "resumed from step 4" in capsys.readouterr().out
    assert stats["start"] == 5 and stats["steps"] == 4
    assert [r["step"] for r in _rows(part / "metrics.jsonl")] == list(range(1, 9))

    # the resumed run is the checkpoint's state stepped on the batches the
    # CLI feeds after a restart (its shuffle starts again from the seed)
    model_cfg = tcap.CaptionerConfig.from_config(C, Vocabulary.from_files(C.DATA.VOCABULARY))
    state = ttrainer.create_train_state(
        tcap.init_captioner(model_cfg, seed=1, device="cpu",
                            embedding_table=np.zeros((model_cfg.vocab_size, 300), np.float32)),
        C, model_cfg, seed=9, device="cpu")
    state = CheckpointManager(str(part)).restore("checkpoint_4", state)
    step = ttrainer.make_train_step(model_cfg, C.MODEL.KLD_WEIGHT)
    for b in _host_batches(C, 4):
        state, _ = step(state, b)
    got = _params(part / "checkpoint_8")
    for path, p in named_leaves(state.params):
        np.testing.assert_array_equal(got[path], p.detach().numpy(), err_msg=path)

    # the inference CLI reads the checkpoint directory as it reads the same
    # params in a .npz
    save_params_npz(read_checkpoint(str(part / "checkpoint_best"))["params"],
                    str(tmp_path / "params.npz"))
    assert load_params_npz(str(tmp_path / "params.npz")).keys() >= {"embedding", "cell"}
    over = ["--config-override", "DATA.DO_LOAD_COCO", "false", "DATA.DO_LOAD_SENTICAP", "false",
            "MODEL.USE_CBS", "false", "MODEL.N_Z_SAMPLES", "2", "MODEL.BEAM_SIZE", "2"]
    outs = []
    for name, ckpt in (("dir", ["--checkpoint-path", str(part), "--checkpoint-name",
                                "checkpoint_best"]),
                       ("npz", ["--checkpoint-path", str(tmp_path / "params.npz")])):
        out = tmp_path / f"preds_{name}.json"
        assert PI.main(["--config", str(cfg), "--output-path", str(out), "--cpu", *ckpt,
                        *over]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1] and len(outs[0]) == 2 * 4
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        PI.main(["--config", str(cfg), "--output-path", str(tmp_path / "x.json"), "--cpu",
                 "--checkpoint-path", str(part), "--checkpoint-name", "checkpoint_9", *over])


@pytest.mark.parametrize("variant", ["steps_per_dispatch", "device_corpus_mode1",
                                     "device_corpus_mode2"])
def test_train_cli_variants_equal_plain_run(tmp_path, variant):
    mode = 2 if variant.endswith("mode2") else 1
    cfg = write_train_world(tmp_path / "w", mode=mode, attribs=mode == 2, n_images=40,
                            iterations=8)
    extra = (["--steps-per-dispatch", "3"] if variant == "steps_per_dispatch"
             else ["--device-corpus"])
    _run_port(cfg, tmp_path / "plain", "--checkpoint-every", "100")
    _run_port(cfg, tmp_path / "variant", "--checkpoint-every", "100", *extra)
    _assert_same_params(tmp_path / "plain" / "checkpoint_8", tmp_path / "variant" /
                        "checkpoint_8")
    a, b = _rows(tmp_path / "plain" / "metrics.jsonl"), _rows(tmp_path / "variant" /
                                                               "metrics.jsonl")
    assert [(r["step"], r["loss"]) for r in a] == [(r["step"], r["loss"]) for r in b]


def test_train_cli_bf16_compute(tmp_path):
    cfg = write_train_world(tmp_path / "w", iterations=4)
    _run_port(cfg, tmp_path / "r", "--bf16-compute")
    rows = _rows(tmp_path / "r" / "metrics.jsonl")
    assert len(rows) == 4 and all(np.isfinite(r["loss"]) for r in rows)
    assert _params(tmp_path / "r" / "checkpoint_4")["embedding"].dtype == np.float32


def test_train_cli_refusals(tmp_path):
    cfg = write_train_world(tmp_path / "w", iterations=2)
    base = ["--config", str(cfg), "--serialization-dir", str(tmp_path / "r"), "--cpu"]
    # the baseline family runs (it was refused until it was ported)
    assert P.main(base + ["--model", "baseline"]) == 0
    assert "language_lstm" in read_checkpoint(str(tmp_path / "r" / "checkpoint_2"))["params"][
        "cell"]
    # data parallelism runs since it was ported (tests/test_torch_ddp.py), and
    # tensor parallelism since it was: a plain --num-model 2 starts two ranks
    # (held to --num-model 1 in tests/test_torch_tensor_parallel.py)
    for model, extra in (("cvae", []), ("baseline", ["--bf16-compute"])):
        stats = {}
        ser = tmp_path / f"tp_{model}"
        args = ["--config", str(cfg), "--serialization-dir", str(ser), "--cpu",
                "--model", model, "--num-model", "2", *extra]
        assert P.main(args, stats=stats) == 0 and stats == {"ranks": 2}
        assert int(read_checkpoint(str(ser / "checkpoint_2"))["opt_state"]["step"]) == 2
        assert all(np.isfinite(r["loss"]) for r in _rows(ser / "metrics.jsonl"))
    with pytest.raises(ValueError, match="--num-model 0"):
        P.main(base + ["--num-model", "0"])


def test_port_cli_baseline_losses_match_jax_cli(tmp_path, monkeypatch):
    # batch 8: the JAX CLI's mesh spans the 8 CPU devices of tests/conftest.py
    cfg = write_train_world(tmp_path / "w", n_images=40, iterations=6, batch=8)
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", str(cfg), "--cpu", "--model",
                                      "baseline", "--checkpoint-every", "100",
                                      "--serialization-dir", str(tmp_path / "jax")])
    J.main()

    def jax_init(model_cfg, seed, device, embedding_table):
        jp = jit_init(jbase.init_baseline, jcap.CaptionerConfig(*model_cfg),
                      jax.random.PRNGKey(seed), embedding_table)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device=device)

    monkeypatch.setattr(P, "init_baseline", jax_init)
    _run_port(cfg, tmp_path / "port", "--model", "baseline", "--checkpoint-every", "100")
    jrows, trows = _rows(tmp_path / "jax" / "metrics.jsonl"), _rows(tmp_path / "port" /
                                                                    "metrics.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == list(range(1, 7))
    for j, t in zip(jrows, trows):
        for name in ("loss", "reconstr_loss", "kld_loss"):
            np.testing.assert_allclose(t[name], j[name], rtol=1e-5,
                                       err_msg=f"step {t['step']} {name}")
        assert t["kld_loss"] == 0.0


def test_train_cli_baseline_checkpoints_resume_and_refusals(tmp_path, capsys):
    cfg = write_train_world(tmp_path / "w", iterations=6)
    C = Config(str(cfg))
    part = tmp_path / "part"
    _run_port(cfg, part, "--model", "baseline", "--checkpoint-every", "3", "--max-iterations", "3")
    capsys.readouterr()
    stats = _run_port(cfg, part, "--model", "baseline", "--checkpoint-every", "3",
                      "--start-from-checkpoint", "checkpoint_3")
    assert "resumed from step 3" in capsys.readouterr().out
    assert stats["start"] == 4 and stats["steps"] == 3
    # the resumed run is the checkpoint's state stepped on the batches the
    # CLI feeds after a restart
    model_cfg = tcap.CaptionerConfig.from_config(C, Vocabulary.from_files(C.DATA.VOCABULARY))
    from style_seqcvae_tpu_torch.models.baseline import init_baseline

    state = ttrainer.create_train_state(
        init_baseline(model_cfg, seed=1, device="cpu",
                      embedding_table=np.zeros((model_cfg.vocab_size, 300), np.float32)),
        C, model_cfg, seed=9, device="cpu")
    state = CheckpointManager(str(part)).restore("checkpoint_3", state)
    step = ttrainer.make_baseline_train_step(model_cfg)
    for b in _host_batches(C, 3):
        state, _ = step(state, b)
    got = _params(part / "checkpoint_6")
    assert set(read_checkpoint(str(part / "checkpoint_6"))["params"]["cell"]) == {
        "attention_lstm", "attention", "language_lstm"}
    for path, p in named_leaves(state.params):
        np.testing.assert_array_equal(got[path], p.detach().numpy(), err_msg=path)

    # the inference CLI decodes the baseline checkpoint; a cvae model is refused it
    over = ["--config-override", "DATA.DO_LOAD_COCO", "false", "DATA.DO_LOAD_SENTICAP", "false",
            "MODEL.USE_CBS", "false", "MODEL.N_Z_SAMPLES", "2", "MODEL.BEAM_SIZE", "2"]
    ckpt = ["--checkpoint-path", str(part), "--checkpoint-name", "checkpoint_6"]
    out = tmp_path / "preds.json"
    assert PI.main(["--config", str(cfg), "--output-path", str(out), "--cpu", "--model",
                    "baseline", *ckpt, *over]) == 0
    assert len(json.loads(out.read_text())) == 4            # one z-sample an image
    with pytest.raises(ValueError, match="parameters are the baseline family's"):
        PI.main(["--config", str(cfg), "--output-path", str(out), "--cpu", *ckpt, *over])

    # JAX's refusal of chained steps for the baseline, and a cvae checkpoint
    with pytest.raises(SystemExit, match="supports the cvae family"):
        _run_port(cfg, tmp_path / "k", "--model", "baseline", "--steps-per-dispatch", "2")
    _run_port(cfg, tmp_path / "cvae", "--max-iterations", "2")
    with pytest.raises(ValueError, match="holds the cvae family's parameters"):
        _run_port(cfg, tmp_path / "cvae", "--model", "baseline", "--start-from-checkpoint",
                  "checkpoint_2")


def test_train_cli_runs_as_a_module(tmp_path):
    cfg = write_train_world(tmp_path / "w", iterations=2)
    res = subprocess.run([sys.executable, "-m", "style_seqcvae_tpu_torch.scripts.train",
                          "--config", str(cfg), "--serialization-dir", str(tmp_path / "r"),
                          "--cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "done." in res.stdout
    assert (tmp_path / "r" / "checkpoint_2" / "state.npz").exists()
