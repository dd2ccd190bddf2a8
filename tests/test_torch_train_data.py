"""The port's training data path and checkpoints.

* ``TrainingDataset`` (``data/datasets.py``) against the JAX package's on
  the same files: length, items (UNK padding, sentiment 0 → -1), collates,
  ``feature_table``, ``obj_att_embed_table`` and the first batches of
  ``batches(…, random.Random(seed), process_shard)``, for COCO + Senticap
  (20× oversampling) + expert captions with Senticap's test images removed
  and captions without a feature row dropped, for Senticap alone, and with
  the attribute filter; the ``ValueError`` on a batch larger than the data.
* ``CheckpointManager`` (``training/checkpointing.py``): a round trip of
  params, momentum, step, LR and generator; a resume (k steps, save,
  restore, N − k steps) equal to N steps straight; ``keep`` pruning and the
  best checkpoint; a directory in another layout refused by name.
* ``weights.to_jax_params`` inverts ``from_jax_params``;
  ``utils/torch_import.py::import_captioner_state_dict`` equals JAX's on a
  synthetic reference-layout state dict; the metrics writer's records.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch

from style_seqcvae_tpu import config as j_config
from style_seqcvae_tpu.data import datasets as j_ds
from style_seqcvae_tpu.data import latents as j_lat
from style_seqcvae_tpu.data import vocabulary as j_voc
from style_seqcvae_tpu.utils import torch_import as j_imp
from style_seqcvae_tpu_torch import config as t_config
from style_seqcvae_tpu_torch.data import datasets as t_ds
from style_seqcvae_tpu_torch.data import latents as t_lat
from style_seqcvae_tpu_torch.data import vocabulary as t_voc
from style_seqcvae_tpu_torch.data.readers import CocoAttributesReader
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.training import trainer as ttrainer
from style_seqcvae_tpu_torch.training.checkpointing import CheckpointManager
from style_seqcvae_tpu_torch.utils import torch_import as t_imp
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter, pack_obj_atts
from style_seqcvae_tpu_torch.utils.logging import MetricsWriter, StepTimer, device_sync
from style_seqcvae_tpu_torch.weights import from_jax_params, named_leaves, to_jax_params
from tests.test_torch_data import attribute_images, write_attribs_dir
from tests.test_torch_train import jax_leaves, jax_params, make_batch, model_kw, port_params

torch.set_num_threads(1)

WORDS = ["a", "the", "on", "in", "dog", "cat", "car", "table", "runs", "sits", "red", "blue",
         "park", "good", "bad", "lovely", "ugly", "shiny", "fluffy", "empty", "sporty", "bulky"]
OBJECTS = ["car", "cat", "dog", "table"]
PHRASES = ["a red dog runs in the park", "the cat sits on a table",
           "a blue car in the zebra park",              # "zebra": an UNK inside
           "a dog", "the shiny car sits in a lovely park on the blue table"]


def write_train_world(d, n_images=24, boxes=4, feat_dim=8, mode=1, coco=True, senticap=True,
                      expert=True, attribs=False, remove_without_attribs=False, batch=4,
                      iterations=6, model=""):
    """A small training world in ``d``, written with the port's own code:
    the vocabulary, COCO captions (two an image, one with an UNK inside),
    Senticap captions over train, val and test splits (images 990 and 991
    have no feature row), expert captions, a train features.h5 without the
    last two images and a second one (INFER_FEATURES) holding the last four
    (two overlap, with other features), the COCO-Attributes pickles and, in
    mode 2, SentiWordNet scores; returns the YAML config's path."""
    d.mkdir(parents=True, exist_ok=True)
    t_voc.Vocabulary([t_voc.UNK_TOKEN, t_voc.BOUNDARY_TOKEN] + WORDS).save_to_files(
        str(d / "vocab"))
    images = attribute_images(n_images)
    ids = sorted(images)
    write_attribs_dir(d / "attribs", images)
    anns = [{"id": k, "image_id": iid, "caption": PHRASES[(iid + j) % len(PHRASES)]}
            for k, (iid, j) in enumerate((i, j) for i in ids for j in range(2))]
    (d / "captions.json").write_text(json.dumps({"annotations": anns}))
    senti = [{"filename": f"COCO_val2014_{iid:012d}.jpg",
              "split": ["train", "val", "test"][iid % 3],
              "sentences": [{"raw": "a lovely dog in the park", "sentiment": 1},
                            {"raw": "an ugly car", "sentiment": 0}]}
             for iid in ids[::2] + [990, 991]]
    (d / "senticap.json").write_text(json.dumps({"images": senti}))
    (d / "expert.json").write_text(json.dumps(
        [{"image_id": str(iid), "caption": "a good cat", "sentiment": 1} for iid in ids[:3]]))
    rng = np.random.RandomState(2)
    att_names = ["shiny", "fluffy", "empty", "sporty", "bulky"]
    inventory = CocoAttributesReader(str(d / "attribs")).attrib_names
    att_ids = [inventory.index(a) for a in att_names if a in inventory] or [0, 1, 2]

    def features(path, which):
        w = FeaturesWriter(str(path), len(which))
        for i, iid in enumerate(which):
            n = 1 + (iid % boxes)
            objs = [1 + rng.randint(len(OBJECTS)) for _ in range(n)]
            atts = [list(rng.choice(att_ids, rng.randint(3), False)) for _ in range(n)]
            w.write(i, iid, rng.randn(n, feat_dim).astype(np.float32),
                    pack_obj_atts(objs, atts), np.zeros((0,), np.float32))
        w.close()

    features(d / "features.h5", ids[:-2])
    features(d / "features_val.h5", ids[-4:])
    (d / "swn.json").write_text(json.dumps({a: [0.1 * k, 0.5, 0.05 * k]
                                            for k, a in enumerate(att_names + ["car", "dog"])}))
    (d / "cfg.yml").write_text(f"""
RANDOM_SEED: 3
PRINT_EVERY_N_BATCHES: 1
DATA:
  VOCABULARY: {d}/vocab
  TRAIN_FEATURES: {d}/features.h5
  INFER_FEATURES: {d}/features_val.h5
  TRAIN_CAPTIONS: {d}/captions.json
  SENTICAP_CAPTIONS: {d / 'senticap.json' if senticap else "''"}
  EXPERT_CAPTIONS: {d / 'expert.json' if expert else "''"}
  DO_LOAD_COCO: {'true' if coco else 'false'}
  DO_LOAD_SENTICAP: {'true' if senticap else 'false'}
  COCO_ATTRIBS_OBJS: {d / 'attribs' if attribs else "''"}
  REMOVE_SAMPLES_WITHOUT_ATTRIBS: {'true' if remove_without_attribs else 'false'}
  SWN_SCORES: {d}/swn.json
  MAX_CAPTION_LENGTH: 6
  MAX_BOXES: {boxes + 2}
  CBS:
    WORDFORMS: ''
    WORDFORMS_ATTRIBS: ''
MODEL:
  IMAGE_FEATURE_SIZE: {feat_dim}
  EMBEDDING_SIZE: 300
  HIDDEN_SIZE: 8
  ATTENTION_PROJECTION_SIZE: 6
  Z_SPACE: 4
  SENTIMENT_VAE: {mode}
  SIMPLE_VAE: false
  LATENT_EMBEDDING: {'senti_word_net' if mode == 2 else 'glove'}
  KLD_WEIGHT: 750
{model}OPTIM:
  BATCH_SIZE: {batch}
  NUM_ITERATIONS: {iterations}
  LR: 0.05
  CLIP_GRADIENTS: 12.5
  EPOCH_START_DECODER_TRAINING: 2
  BEFORE_UPDATE_DECODER_EVERY: 2
""")
    return d / "cfg.yml"


def _datasets(cfg_path):
    out = []
    for cmod, vmod, dmod in ((j_config, j_voc, j_ds), (t_config, t_voc, t_ds)):
        c = cmod.Config(str(cfg_path))
        v = vmod.Vocabulary.from_files(c.DATA.VOCABULARY)
        out.append((c, dmod.TrainingDataset.from_config(c, vocabulary=v)))
    return out


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


WORLDS = {
    "coco_senticap_expert": dict(),
    "senticap_only": dict(coco=False, expert=False),
    "attribute_filter_mode2": dict(mode=2, attribs=True, remove_without_attribs=True,
                                   n_images=40),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_training_dataset_matches_jax(tmp_path, capsys, world):
    cfg = write_train_world(tmp_path, **WORLDS[world])
    (jc, jd), (tc, td) = _datasets(cfg)
    jout = capsys.readouterr().out
    assert len(td) == len(jd) > 0
    if world == "coco_senticap_expert":
        # Senticap's 20x oversampling and the counted drop of images 990/991
        assert "dropped" in jout and len(td) > 20 * 2
    for i in range(len(jd)):
        _eq(jd[i], td[i], f"item {i}")
    assert {td[i]["sentiment"] for i in range(len(td))} <= {-1, 0, 1}
    idx = list(range(0, len(jd), 3))[:8]
    _eq(jd.collate_fn([jd[i] for i in idx]), td.collate_fn([td[i] for i in idx]), "collate")
    (jt, jrow), (tt, trow) = jd.feature_table(), td.feature_table()
    np.testing.assert_array_equal(tt, jt)
    assert trow == jrow
    if WORLDS[world].get("mode") == 2:
        jl = j_lat.LatentDictionary.from_swn_scores(jc.DATA.SWN_SCORES, 4)
        tl = t_lat.LatentDictionary.from_swn_scores(tc.DATA.SWN_SCORES, 4)
        jo, to = jd.obj_att_embed_table(jl, jrow), td.obj_att_embed_table(tl, trow)
        assert np.abs(to).sum() > 0
        np.testing.assert_array_equal(to, jo)
    for shard in ((0, 1), (1, 2)):
        jb = jd.batches(4, rng=random.Random(5), process_shard=shard)
        tb = td.batches(4, rng=random.Random(5), process_shard=shard)
        for k in range(3):
            _eq(next(jb), next(tb), f"batch {k} of shard {shard}")
    td.skip_feature_read = True
    assert td[0]["image_features"] is None


def test_batches_refuse_a_batch_larger_than_the_data(tmp_path):
    _, (_, td) = _datasets(write_train_world(tmp_path, coco=False, expert=False))
    with pytest.raises(ValueError, match="exceeds dataset size"):
        next(td.batches(len(td) + 1))
    with pytest.raises(ValueError, match="exceeds dataset size"):
        next(td.batches(len(td) // 2 + 1, process_shard=(0, 2)))


OVERRIDES = ["OPTIM.LR", "0.05", "OPTIM.NUM_ITERATIONS", "20",
             "OPTIM.EPOCH_START_DECODER_TRAINING", "3", "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "2"]


def _state(kw, seed=4):
    cfg = tcap.CaptionerConfig(**kw)
    return cfg, ttrainer.create_train_state(
        port_params(jax_params(kw), requires_grad=False),
        t_config.Config(config_override=OVERRIDES), cfg, seed=seed, device="cpu")


def _run(state, cfg, steps, first=0):
    step = ttrainer.make_train_step(cfg, 750.0)
    for i in range(steps):                  # z-noise from the state's generator
        state, _ = step(state, make_batch(model_kw("mode1_tied"), seed=first + i))
    return state


def test_checkpoint_round_trip(tmp_path):
    kw = model_kw("mode1_tied")
    cfg, s = _state(kw)
    s = _run(s, cfg, 3)
    ck = CheckpointManager(str(tmp_path))
    ck.save(s, "checkpoint_3")
    assert sorted(p.name for p in (tmp_path / "checkpoint_3").iterdir()) == ["state.npz"]
    _, r = _state(kw, seed=99)
    r = ck.restore("checkpoint_3", r)
    assert r.step == 3
    for (pa, ta), (_, tb) in zip(named_leaves(s.params), named_leaves(r.params)):
        assert torch.equal(ta, tb), pa
    ma, mb = s.tx.momentum(), r.tx.momentum()
    for path, label in s.tx.labels.items():
        if label != "never":
            assert torch.equal(ma[path], mb[path]), path
    assert torch.equal(s.generator.get_state(), r.generator.get_state())
    assert r.optimizer.param_groups[0]["lr"] == s.optimizer.param_groups[0]["lr"]
    data = np.load(tmp_path / "checkpoint_3" / "state.npz")
    assert "params/cell/decoder_lstm/w" in data.files
    assert "opt_state/trace/cell/decoder_lstm/w" in data.files
    assert int(data["opt_state/step"]) == 3


def test_resume_equals_straight_run(tmp_path):
    kw = model_kw("mode1_tied")
    N, k = 6, 2
    cfg, straight = _state(kw)
    straight = _run(straight, cfg, N)
    _, first = _state(kw)
    first = _run(first, cfg, k)
    ck = CheckpointManager(str(tmp_path))
    ck.save(first, f"checkpoint_{k}")
    _, resumed = _state(kw, seed=123)
    resumed = ck.restore(f"checkpoint_{k}", resumed)
    resumed = _run(resumed, cfg, N - k, first=k)
    assert resumed.step == straight.step == N
    for (pa, ta), (_, tb) in zip(named_leaves(straight.params), named_leaves(resumed.params)):
        assert torch.equal(ta, tb), pa


def test_checkpoint_manager_keep_and_best(tmp_path):
    kw = model_kw("mode1_tied")
    cfg, s = _state(kw)
    ck = CheckpointManager(str(tmp_path), keep=2)
    for it in (1, 2, 3):
        s = _run(s, cfg, 1, first=it)
        ck.step(s, metric=0.0, iteration=it, config_dump="A: 1\n")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint_2", "checkpoint_2.config.yml", "checkpoint_3",
                     "checkpoint_3.config.yml", "checkpoint_best"]
    assert ck.latest_iteration() == 3
    _, r = _state(kw)
    assert ck.restore("checkpoint_best", r).step == 3        # a tie refreshes best


def test_other_checkpoint_layouts_are_refused(tmp_path):
    orbax_like = tmp_path / "checkpoint_5"
    (orbax_like / "d").mkdir(parents=True)
    (orbax_like / "_CHECKPOINT_METADATA").write_text("{}")
    _, s = _state(model_kw("mode1_tied"))
    with pytest.raises(ValueError, match="_CHECKPOINT_METADATA"):
        CheckpointManager(str(tmp_path)).restore("checkpoint_5", s)


@pytest.mark.parametrize("case", ["mode1_tied", "mode0_untied", "mode2_swn_untied"])
def test_to_jax_params_inverts_from_jax_params(case):
    tree = jax.tree_util.tree_map(np.asarray, jax_params(model_kw(case)))
    back = to_jax_params(from_jax_params(tree, device="cpu"))
    want = jax_leaves(tree)
    got = dict(named_leaves(back))
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert isinstance(back["cell"], dict) and isinstance(back["cell"]["decoder_lstm"], dict)


def _reference_state_dict(kw, tied, seed=0):
    """A synthetic state dict in the reference ``UpDownCaptioner`` layout."""
    r = np.random.RandomState(seed)
    V, E, H = kw["vocab_size"], kw["embedding_size"], kw["hidden_size"]
    F, P, Z = kw["image_feature_size"], kw["attention_projection_size"], kw["z_space"]
    cond = 1
    sd = {"_embedding_layer.weight": r.randn(V, E)}
    for name, n_in in (("_attention_lstm_cell", E + F + 2 * H),
                       ("_language_lstm_cell_encoder", cond + F + 2 * H),
                       ("_language_lstm_cell_decoder", cond + F + 2 * H + Z)):
        p = f"_updown_cell.{name}"
        sd.update({p + ".weight_ih": r.randn(4 * H, n_in), p + ".weight_hh": r.randn(4 * H, H),
                   p + ".bias_ih": r.randn(4 * H), p + ".bias_hh": r.randn(4 * H)})
    butd = "_updown_cell._butd_attention."
    sd.update({butd + "_query_vector_projection_layer.weight": r.randn(P, H),
               butd + "_image_features_projection_layer.weight": r.randn(P, F),
               butd + "_attention_layer.weight": r.randn(1, P),
               "_updown_cell.fc_mean.weight": r.randn(Z, H), "_updown_cell.fc_mean.bias": r.randn(Z),
               "_updown_cell.fc_log_var.weight": r.randn(Z, H),
               "_updown_cell.fc_log_var.bias": r.randn(Z)})
    if tied:
        sd.update({"_output_projection.0.weight": r.randn(E, H),
                   "_output_projection.0.bias": r.randn(E)})
    else:
        sd.update({"_output_layer.weight": r.randn(V, H), "_output_layer.bias": r.randn(V)})
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("case", ["mode1_tied", "mode1_simple_untied"])
def test_import_captioner_state_dict_matches_jax(case, tmp_path):
    kw = dict(model_kw(case), simple_vae=False)
    tied = kw["embedding_size"] in (300, 600)
    sd = _reference_state_dict(kw, tied)
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, tmp_path / "ref.pth")
    loaded = t_imp.load_torch_checkpoint(str(tmp_path / "ref.pth"))
    assert loaded.keys() == sd.keys()
    jp = j_imp.import_captioner_state_dict(sd, jax_params(kw))
    tp = t_imp.import_captioner_state_dict(loaded, port_params(jax_params(kw),
                                                               requires_grad=False))
    want = jax_leaves(jp)
    got = {p: t.numpy() for p, t in named_leaves(tp)}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_metrics_writer_and_timer(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.scalars(3, {"loss": torch.tensor(1.5), "step_ms": 2})
    w.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {
        "step": 3, "loss": 1.5, "step_ms": 2.0}
    t = StepTimer()
    with t.phase("step", count=4):
        pass
    assert set(t.summary()) == {"step_ms"}
    assert device_sync(torch.tensor(2.0)) == 2.0
