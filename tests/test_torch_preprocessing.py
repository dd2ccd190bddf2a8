"""The port's data tooling against the JAX package's, on the CPU:
``preprocessing.py`` function by function, every subcommand of
``scripts/preprocess.py``, ``scripts/build_vocabulary.py`` and
``scripts/make_synthetic_corpus.py``.

No SentiCap, COCO, COCO-Attributes or GloVe data is in the repository, so
each fixture is built here from a seed: a Senticap JSON, COCO captions and
instances, a cocottributes pickle, wordform TSVs, per-image attribute
detections, a GloVe text file of seeded 300-d vectors and a word-sentiment
table. Every JSON, pickle and vocabulary file must be the JAX CLI's byte
for byte (the JAX CLIs run in this process with ``sys.argv`` patched);
features.h5, which the port writes without h5py, must hold the same
datasets, read back with h5py.

``pos_tags`` takes nltk's tagger when it loads, else the rule-based
fallback: both branches run, one with a stand-in ``nltk`` module whose
tagger is a seeded table, one with nltk blocked.
"""

import importlib.util
import json
import pickle
import random
import sys
import types
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from style_seqcvae_tpu import preprocessing as jpp
from style_seqcvae_tpu_torch import preprocessing as tpp
from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection
from style_seqcvae_tpu_torch.scripts import build_vocabulary as t_vocab_cli
from style_seqcvae_tpu_torch.scripts import make_synthetic_corpus as t_corpus
from style_seqcvae_tpu_torch.scripts import preprocess as t_pre_cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OBJECTS = ["dog", "cat", "man", "car", "tree", "bench"]
ATTRS = ["red", "old", "wooden", "shiny", "fluffy"]
POS, NEG = ["happy", "beautiful", "lovely"], ["ugly", "sad", "dirty"]
FILLER = "a the on near with sits runs is quickly very".split()


def _sentence(rng, extra=()):
    words = [FILLER[rng.randint(2)]]
    pool = list(extra) + ATTRS
    for _ in range(rng.randint(0, 3)):
        words.append(pool[rng.randint(len(pool))])
    words.append(OBJECTS[rng.randint(len(OBJECTS))])
    words += [FILLER[rng.randint(2, len(FILLER))], FILLER[rng.randint(2)],
              OBJECTS[rng.randint(len(OBJECTS))]]
    return " ".join(words) + rng.choice([".", "", " ,"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The seeded fixture files, and their contents."""
    d = tmp_path_factory.mktemp("pre")
    rng = np.random.RandomState(0)
    ids = list(range(100, 130))
    senticap = {"images": [{
        "filename": f"COCO_val2014_{iid:012d}.jpg",
        "split": ["train", "val", "test", "restval"][k % 4],
        "sentences": [{"raw": _sentence(rng, POS if s else NEG), "sentiment": int(s)}
                      for s in rng.randint(0, 2, rng.randint(1, 4))]}
        for k, iid in enumerate(ids)]}
    coco = {"annotations": [{"id": n, "image_id": ids[n % len(ids)],
                             "caption": _sentence(rng)} for n in range(150)]}
    instances = [{"categories": [{"id": i + 1, "name": o} for i, o in enumerate(OBJECTS)],
                  "annotations": [{"id": 1000 * s + n, "image_id": ids[n % len(ids)],
                                   "category_id": 1 + n % len(OBJECTS)} for n in range(40)]}
                 for s in range(2)]
    cocottributes = {
        "ann_vecs": {7000 + n: rng.rand(len(ATTRS)).round(2).tolist() for n in range(25)},
        "patch_id_to_ann_id": {7000 + n: 1000 * (n % 2) + n for n in range(25)},
        "attributes": [{"id": i, "name": a} for i, a in enumerate(ATTRS)]}
    att_dets = [{"image_id": iid, "candidates": [
        [OBJECTS[rng.randint(len(OBJECTS))],
         [[ATTRS[j], float(rng.rand())] for j in rng.choice(len(ATTRS), rng.randint(0, 3),
                                                            replace=False)]]
        for _ in range(rng.randint(1, 3))]} for iid in ids[::2]]
    files = {"senticap": (senticap, "json"), "coco": (coco, "json"),
             "inst0": (instances[0], "json"), "inst1": (instances[1], "json"),
             "att_dets": (att_dets, "json"), "cocottributes": (cocottributes, "pkl")}
    paths = {}
    for name, (obj, kind) in files.items():
        paths[name] = d / f"{name}.{kind}"
        if kind == "json":
            paths[name].write_text(json.dumps(obj))
        else:
            paths[name].write_bytes(pickle.dumps(obj))
    paths["objects_tsv"] = d / "objects.tsv"
    paths["objects_tsv"].write_text("".join(f"{o}\t{o},{o}s\n" for o in OBJECTS))
    paths["attribs_tsv"] = d / "attribs.tsv"
    paths["attribs_tsv"].write_text("".join(f"{a}\t{a},{a}er\n" for a in ATTRS))
    # GloVe: seeded 300-d vectors for the attribute inventory's first words
    first = sorted({k.split(" ")[0] for k in attrib_selection})
    vec = np.random.RandomState(1).randn(len(first), 300).astype(np.float32)
    paths["glove"] = d / "glove.txt"
    paths["glove"].write_text("".join(
        w + " " + " ".join(f"{x:.5f}" for x in v) + "\n" for w, v in zip(first[:-3], vec)))
    sent = np.random.RandomState(2).rand(len(first), 3).round(3)
    paths["sentiments"] = d / "sentiments.json"
    paths["sentiments"].write_text(json.dumps({w: s.tolist() for w, s in zip(first, sent)
                                               if sum(map(ord, w)) % 5}))
    return dict(dir=d, paths=paths, senticap=senticap, coco=coco, instances=instances,
                cocottributes=cocottributes, att_dets=att_dets)


@pytest.fixture(params=["nltk_tagger", "nltk_blocked"])
def tagger(request, monkeypatch):
    """nltk's branch of ``pos_tags`` with a stand-in tagger (nltk's own
    needs data that is not installed), or nltk blocked (the fallback)."""
    if request.param == "nltk_blocked":
        monkeypatch.setitem(sys.modules, "nltk", None)
    else:
        tags = ("NN", "JJ", "RB", "DT", "IN", "VBZ")
        fake = types.ModuleType("nltk")
        fake.pos_tag = lambda toks: [(t, tags[sum(map(ord, t)) % len(tags)]) for t in toks]
        monkeypatch.setitem(sys.modules, "nltk", fake)
    return request.param


def test_pos_tags_both_branches_match_jax(tagger):
    toks = "a very old dog sits quickly on the wooden bench near a running man".split()
    assert tpp.pos_tags(toks) == jpp.pos_tags(toks)
    if tagger == "nltk_blocked":
        assert tpp.pos_tags(toks) == tpp._fallback_pos_tags(toks)


def test_split_id_maps_and_attribute_index_match_jax(data, tmp_path):
    assert tpp.split_senticap_by_sentiment(data["senticap"]) == \
        jpp.split_senticap_by_sentiment(data["senticap"])
    assert tpp.build_senticap_id_maps(data["senticap"]) == \
        jpp.build_senticap_id_maps(data["senticap"])
    jpp.build_attribute_index(data["instances"], data["cocottributes"], str(tmp_path / "j"))
    tpp.build_attribute_index(data["instances"], data["cocottributes"], str(tmp_path / "t"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 8 and names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_caption_augmentation_matches_jax(data, tagger):
    """analyze_senticap, generate_balanced_dataset, analyze_attribs and
    generate_att_balanced_dataset on the same seeds."""
    objs = tpp.read_wordform_classes(str(data["paths"]["objects_tsv"]))
    assert objs == jpp.read_wordform_classes(str(data["paths"]["objects_tsv"]))
    attribs = tpp.read_wordform_classes(str(data["paths"]["attribs_tsv"]))
    wf = {"pos": {"words": {w: 0 for w in POS}}, "neg": {"words": {w: 0 for w in NEG}}}
    caps = [{"image_id": 1, "caption": s["raw"]} for im in data["senticap"]["images"]
            for s in im["sentences"]]
    got = tpp.analyze_senticap(caps, objs, wf)
    assert got == jpp.analyze_senticap(caps, objs, wf)
    coco = data["coco"]["annotations"]
    for pol in ("pos", "neg"):
        t = tpp.generate_balanced_dataset(coco, got[2][pol], got[0], set(NEG),
                                          rng=random.Random(3))
        j = jpp.generate_balanced_dataset(coco, got[2][pol], got[0], set(NEG),
                                          rng=random.Random(3))
        assert t == j and t[0], pol                     # some captions change
    counts = tpp.analyze_attribs(data["att_dets"])
    assert counts == jpp.analyze_attribs(data["att_dets"])
    t = tpp.generate_att_balanced_dataset(coco, data["att_dets"], objs, attribs, counts,
                                          rng=random.Random(4))
    assert t and t == jpp.generate_att_balanced_dataset(coco, data["att_dets"], objs, attribs,
                                                        counts, rng=random.Random(4))


def test_pca_and_sentiglove_match_jax(data):
    fit = np.random.RandomState(5).randn(20, 300).astype(np.float32)
    for t, j in zip(tpp.pca_fit_transform(fit, 10)[:2], jpp.pca_fit_transform(fit, 10)[:2]):
        np.testing.assert_array_equal(t, j)
    table = np.random.RandomState(6).randn(400, 300).astype(np.float32)

    def lookup(w):
        return table[sum(map(ord, w)) % len(table)]

    sents = json.loads(data["paths"]["sentiments"].read_text())
    t = tpp.prep_sentiglove(lookup, sents, attrib_selection)
    j = jpp.prep_sentiglove(lookup, sents, attrib_selection)
    assert list(t) == list(j) and len(t) > 20
    for w in t:
        np.testing.assert_array_equal(t[w], j[w])


def _subcommands(p):
    return {
        "split-senticap": ["--senticap-json", p["senticap"]],
        "id-maps": ["--senticap-json", p["senticap"]],
        "attribute-index": ["--instances-json", p["inst0"], p["inst1"],
                            "--cocottributes-pkl", p["cocottributes"]],
        "balanced-captions": ["--coco-captions", p["coco"], "--senticap-json", p["senticap"],
                              "--objects-tsv", p["objects_tsv"], "--attribs-pos", *POS,
                              "--attribs-neg", *NEG, "--seed", "3"],
        "att-balanced-captions": ["--coco-captions", p["coco"], "--attrib-detections",
                                  p["att_dets"], "--objects-tsv", p["objects_tsv"],
                                  "--attribs-tsv", p["attribs_tsv"], "--seed", "4"],
        "sentiglove": ["--glove-txt", p["glove"], "--word-sentiments-json", p["sentiments"]],
    }


@pytest.mark.parametrize("cmd", ["split-senticap", "id-maps", "attribute-index",
                                 "balanced-captions", "att-balanced-captions", "sentiglove"])
def test_preprocess_cli_files_equal_jax(data, tmp_path, monkeypatch, cmd):
    monkeypatch.setitem(sys.modules, "nltk", None)         # as on the card's machine
    args = [str(a) for a in _subcommands(data["paths"])[cmd]]
    outs = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        out_args = (["--output", str(out / "sentiglove10.pkl")] if cmd == "sentiglove"
                    else ["--output-dir", str(out)])
        out.mkdir()
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["preprocess.py", cmd, *args, *out_args])
            _jax_script("preprocess").main()
        else:
            assert t_pre_cli.main([cmd, *args, *out_args]) == 0
        outs[side] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert outs["jax"] and outs["port"] == outs["jax"]
    if cmd in ("balanced-captions", "att-balanced-captions"):
        assert any(len(json.loads(b)) for b in outs["port"].values())


def test_build_vocabulary_cli_files_equal_jax(data, tmp_path, monkeypatch):
    p = data["paths"]
    args = ["-c", str(p["coco"]), "-s", str(p["senticap"]), "-t", "2", "-st", "1"]
    monkeypatch.setattr(sys, "argv", ["build_vocabulary.py", *args, "-o", str(tmp_path / "j")])
    _jax_script("build_vocabulary").main()
    assert t_vocab_cli.main([*args, "-o", str(tmp_path / "t")]) == 0
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "t").iterdir())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_make_synthetic_corpus_matches_jax(tmp_path):
    kw = dict(num_images=24, senticap_images=10, captions_per_image=3, boxes=5,
              feature_dim=16, nouns=40, adjectives=30, verbs=20, adverbs=20,
              sentiment_words=8, seed=7)
    j = _jax_script("make_synthetic_corpus").make_corpus(str(tmp_path / "j"), **kw)
    t = t_corpus.make_corpus(str(tmp_path / "t"), **kw)
    assert {k: v for k, v in t.items() if k not in ("config", "h5_bytes")} == \
        {k: v for k, v in j.items() if k not in ("config", "h5_bytes")}
    for name in ("captions_train.json", "senticap_dataset.json", "vocabulary/tokens.txt",
                 "vocabulary/non_padded_namespaces.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    cfg_t = (tmp_path / "t" / "config.yml").read_text()
    assert cfg_t == (tmp_path / "j" / "config.yml").read_text().replace(
        str(tmp_path / "j"), str(tmp_path / "t"))
    with h5py.File(tmp_path / "j" / "features_train.h5", "r") as fj, \
            h5py.File(tmp_path / "t" / "features_train.h5", "r") as ft:
        assert sorted(fj) == sorted(ft)
        for name in fj:
            a, b = fj[name][()], ft[name][()]
            assert len(a) == len(b) == 24, name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=name)
