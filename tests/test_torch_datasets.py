"""The port's evaluation datasets (``data/datasets.py``) against the JAX
package's: items and collates equal, candidates drawn from the same seeded
``random`` module. Covers the plain dataset with Senticap ids, CBS in
sentiment mode, ``cbs_simple`` with COCO attributes, and the grounded mode
with more objects than ``MAX_GIVEN_OBJECTS`` (its negative slice)."""

import json
import random

import numpy as np
import pytest
import torch

from style_seqcvae_tpu import config as j_config
from style_seqcvae_tpu.data import datasets as j_ds
from style_seqcvae_tpu.data import vocabulary as j_voc
from style_seqcvae_tpu_torch import config as t_config
from style_seqcvae_tpu_torch.data import datasets as t_ds
from style_seqcvae_tpu_torch.data import vocabulary as t_voc
from style_seqcvae_tpu_torch.data.readers import CocoAttributesReader
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter, pack_obj_atts
from tests.test_torch_data import attribute_images, write_attribs_dir

torch.set_num_threads(1)

OBJECTS = ["car", "cat", "dog", "table"]            # attribute reader ids 1-4, sorted
ATTRIBUTES = ["shiny", "fluffy", "empty", "sporty", "bulky"]
WORDS = ["a", "the", "on", "near", "good", "great", "nice", "bad", "car", "cars", "cat",
         "cats", "dog", "dogs", "table", "shiny", "glossy", "fluffy", "empty", "sporty", "bulky"]

KINDS = {
    "plain": "  USE_CBS: false\n",
    "sentiment": "  USE_CBS: true\n  CBS_SIMPLE: true\n",
    "simple_attributes": "  USE_CBS: true\n  CBS_SIMPLE: true\n",
    "grounded": "  USE_CBS: true\n  CBS_SIMPLE: false\n",
}


def write_world(d, kind="sentiment", n_images=40, boxes=4, feat_dim=8, n_z=3, model=""):
    """A small evaluation world in ``d``: vocabulary, wordform TSVs, a
    features.h5 from the port's writer (one object a box, packed attribute
    ids), the COCO-Attributes pickles, constraint boxes, a class hierarchy,
    Senticap captions, and ``cfg.yml`` for ``kind`` (see ``KINDS``).
    ``model`` is appended under MODEL."""
    d.mkdir(parents=True, exist_ok=True)
    t_voc.Vocabulary([t_voc.UNK_TOKEN, t_voc.BOUNDARY_TOKEN] + WORDS).save_to_files(
        str(d / "vocab"))
    (d / "wordforms.tsv").write_text("pos\tgood,great,nice\nneg\tbad\ncar\tcar,cars\n"
                                     "cat\tcat,cats\ndog\tdog,dogs\ntable\ttable\n")
    (d / "wordforms_attribs.tsv").write_text(
        "shiny\tshiny,glossy\nfluffy\tfluffy\nempty\tempty\nsporty\tsporty\nbulky\tbulky\n")
    rng = np.random.RandomState(1)
    images = attribute_images(n_images)
    ids = sorted(images)
    write_attribs_dir(d / "attribs", images)
    names = CocoAttributesReader(str(d / "attribs")).attrib_names
    att_ids = [names.index(a) for a in ATTRIBUTES if a in names]
    w = FeaturesWriter(str(d / "features.h5"), len(ids))
    for i, iid in enumerate(ids):
        objs = [1 + rng.randint(len(OBJECTS)) for _ in range(boxes)]
        atts = [list(rng.choice(att_ids, rng.randint(3), False)) for _ in range(boxes)]
        w.write(i, iid, rng.randn(boxes, feat_dim).astype(np.float32),
                pack_obj_atts(objs, atts), np.zeros((0,), np.float32))
    w.close()
    anns = [{"image_id": iid, "bbox": [1.0 * k, 2.0, 3.0 + k, 4.0 + 2 * k],
             "category_id": 1 + (iid + 3 * k) % 10, "score": 0.9}
            for iid in ids for k in range(8)]
    # six classes that never carry attributes: grounded mode's objects
    # without attributes
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(
        OBJECTS + ["bird", "boat", "kite", "bench", "cup", "vase"])]
    (d / "boxes.json").write_text(json.dumps({"annotations": anns, "categories": cats}))
    (d / "hierarchy.json").write_text(json.dumps(
        {"LabelName": "entity", "Subcategory": [{"LabelName": "dog"}, {"LabelName": "cat"}]}))
    senti = [{"filename": f"COCO_val2014_{iid:012d}.jpg", "split": ["test", "train"][iid % 2],
              "sentences": [{"raw": "a good dog", "sentiment": 1}]} for iid in ids]
    (d / "senticap.json").write_text(json.dumps({"images": senti}))
    attribs = kind in ("simple_attributes", "grounded")
    (d / "cfg.yml").write_text(f"""
RANDOM_SEED: 3
DATA:
  VOCABULARY: {d}/vocab
  TRAIN_FEATURES: ''
  INFER_FEATURES: {d}/features.h5
  DO_LOAD_COCO: false
  DO_LOAD_SENTICAP: {'true' if kind == 'plain' else 'false'}
  SENTICAP_CAPTIONS: {d / 'senticap.json' if kind == 'plain' else "''"}
  SENTICAP_SENTIMENT: pos
  COCO_ATTRIBS_OBJS: {d / 'attribs' if attribs else "''"}
  MAX_CAPTION_LENGTH: 6
  MAX_BOXES: {boxes + 2}
  CBS:
    INFER_BOXES: {d / 'boxes.json' if kind == 'grounded' else "''"}
    CLASS_HIERARCHY: {d / 'hierarchy.json'}
    WORDFORMS: {d}/wordforms.tsv
    WORDFORMS_ATTRIBS: {d}/wordforms_attribs.tsv
    MAX_GIVEN_OBJECTS: 2
MODEL:
  IMAGE_FEATURE_SIZE: {feat_dim}
  EMBEDDING_SIZE: 300
  HIDDEN_SIZE: 16
  ATTENTION_PROJECTION_SIZE: 8
  Z_SPACE: 6
  SENTIMENT_VAE: 1
  SIMPLE_VAE: false
  BEAM_SIZE: 3
  N_Z_SAMPLES: {n_z}
  STATE_MACHINE_PER_Z_SAMPLE: true
{KINDS[kind]}{model}""")
    return d / "cfg.yml"


def _dataset(config_mod, voc_mod, ds_mod, cfg_path, seed):
    c = config_mod.Config(str(cfg_path))
    v = voc_mod.Vocabulary.from_files(c.DATA.VOCABULARY)
    voc_mod.add_constraint_words_to_vocabulary(v, c.DATA.CBS.WORDFORMS)
    voc_mod.add_constraint_words_to_vocabulary(v, c.DATA.CBS.WORDFORMS_ATTRIBS)
    random.seed(seed)
    if c.MODEL.USE_CBS:
        return ds_mod.EvaluationDatasetWithConstraints.from_config(c, vocabulary=v)
    return ds_mod.EvaluationDataset.from_config(c)


def _assert_equal(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, tuple) and hasattr(want, "_fields"):      # FSMTables
        assert got._fields == want._fields, where
        for f in want._fields:
            _assert_equal(getattr(got, f), getattr(want, f), f"{where}.{f}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dataset_items_and_collates_equal_jax(tmp_path, kind):
    cfg = write_world(tmp_path, kind)
    out = {}
    for side, mods in (("jax", (j_config, j_voc, j_ds)), ("port", (t_config, t_voc, t_ds))):
        ds = _dataset(*mods, cfg, seed=11)
        items = [ds[i] for i in range(len(ds))]
        out[side] = (len(ds), items, [ds.collate_fn([it]) for it in items])
    assert out["port"][0] == out["jax"][0] > 0
    _assert_equal(out["port"][1], out["jax"][1], "items")
    _assert_equal(out["port"][2], out["jax"][2], "collates")
    items = out["port"][1]
    if kind == "grounded":
        # three objects with attributes, more than MAX_GIVEN_OBJECTS = 2: the
        # slot count is negative, and the slice [:n] of a negative n still
        # adds objects without attributes (a clamp at 0 would add none)
        assert any(len([c for c in z if c[1]]) == 3 and any(not c[1] for c in z)
                   for it in items for z in it["candidates"])
    if kind == "sentiment":
        assert all(z == ["pos"] * 3 for it in items for z in it["candidates"])
    if kind == "simple_attributes":
        assert all(len(it["fsm"]) == 3 for it in items)          # an FSM per z
        assert len({tuple(z) for it in items for z in it["candidates"]}) > 3


def test_collate_helpers_equal_jax():
    feats = [np.ones((3, 2), np.float32), np.full((7, 2), 2.0, np.float32)]
    np.testing.assert_array_equal(t_ds.collate_image_features(feats, 5),
                                  j_ds.collate_image_features(feats, 5))
    for batch in ([{"obj_atts": None}, {"obj_atts": None}],
                  [{"obj_atts": None}, {"obj_atts": [[1, []]]}]):
        assert t_ds._collate_obj_atts(batch) == j_ds._collate_obj_atts(batch)
    assert t_ds.OBJ_NAME_FIXUPS == j_ds.OBJ_NAME_FIXUPS
