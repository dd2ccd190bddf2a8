"""The port's host data modules against the JAX package's: tokenizer,
vocabulary, the attribute whitelist, the FSM builder (dense, packed and
exception tables), the constraint filter, the readers and the latent
dictionary. Every comparison is exact: these are copies in numpy and plain
Python, so outputs must be equal."""

import json
import pickle

import numpy as np
import pytest
import torch

from style_seqcvae_tpu.data import config_attrib_selection as j_sel
from style_seqcvae_tpu.data import latents as j_lat
from style_seqcvae_tpu.data import readers as j_readers
from style_seqcvae_tpu.data import tokenizer as j_tok
from style_seqcvae_tpu.data import vocabulary as j_voc
from style_seqcvae_tpu.decoding import constraint_filter as j_cf
from style_seqcvae_tpu.decoding import fsm as j_fsm
from style_seqcvae_tpu_torch.data import config_attrib_selection as t_sel
from style_seqcvae_tpu_torch.data import latents as t_lat
from style_seqcvae_tpu_torch.data import readers as t_readers
from style_seqcvae_tpu_torch.data import tokenizer as t_tok
from style_seqcvae_tpu_torch.data import vocabulary as t_voc
from style_seqcvae_tpu_torch.decoding import constraint_filter as t_cf
from style_seqcvae_tpu_torch.decoding import fsm as t_fsm

torch.set_num_threads(1)

CAPTIONS = ["A man riding a horse.", "The dog's toy, on the couch!",
            "it isn't (really) good...", 'She said "wow" -- twice; then: left?',
            "cannot gimme 'tis [a] {b} <c> 3,000 people @ 5:30"]


def test_tokenizer_equals_jax():
    for cap in CAPTIONS:
        assert t_tok.tokenize_caption(cap) == j_tok.tokenize_caption(cap)
        assert t_tok.word_tokenize(cap) == j_tok.word_tokenize(cap)
    assert t_tok.PUNCTUATIONS == j_tok.PUNCTUATIONS


def test_vocabulary_files_and_constraint_words_equal_jax(tmp_path):
    tsv = tmp_path / "wf.tsv"
    tsv.write_text("dog\tdog,dogs\nfire hydrant\tfire hydrant,fire hydrants\n"
                   "pos\tgood,very good\n")
    out = {}
    for side, mod in (("jax", j_voc), ("port", t_voc)):
        v = mod.Vocabulary([mod.UNK_TOKEN, mod.BOUNDARY_TOKEN, "dog", "a"])
        mod.add_constraint_words_to_vocabulary(v, str(tsv))
        v.save_to_files(str(tmp_path / side))
        back = mod.Vocabulary.from_files(str(tmp_path / side))
        out[side] = (back.get_token_to_index_vocabulary(), back.unk_index,
                     back.boundary_index, back.get_token_index("zebra"))
    assert out["jax"] == out["port"]
    for f in ("tokens.txt", "non_padded_namespaces.txt"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()
    assert t_voc.UNK_TOKEN == j_voc.UNK_TOKEN and t_voc.BOUNDARY_TOKEN == j_voc.BOUNDARY_TOKEN
    with pytest.raises(ValueError):
        t_voc.Vocabulary(["a"])


def test_build_caption_vocabulary_equals_jax():
    coco = [{"id": i, "image_id": i % 4, "caption": c}
            for i, c in enumerate(CAPTIONS * 6 + ["rare zebra"])]
    senti = [{"filename": "COCO_val2014_000000000003.jpg", "split": "train",
              "sentences": [{"raw": "lovely zebra", "sentiment": 1},
                            {"raw": "lovely horse", "sentiment": 0}]}]
    for thr in (2, 5):
        assert (t_voc.build_caption_vocabulary(coco, senti, thr, 2)
                == j_voc.build_caption_vocabulary(coco, senti, thr, 2))


def test_attrib_selection_equals_jax_in_order():
    assert list(t_sel.attrib_selection.items()) == list(j_sel.attrib_selection.items())
    assert len(t_sel.attrib_selection) == 204


# ------------------------------------------------------------------ FSM

WORDS = ["dog", "dogs", "cat", "fire", "hydrant", "hydrants", "salt", "and", "pepper",
         "red", "shiny", "glossy", "fluffy", "empty", "standing"]
FSM_CASES = {
    "single_word": ["dog"],
    "two": ["dog", "cat"],
    "multi_word": ["fire hydrant"],
    "three_words": ["salt and pepper"],
    "shared_wordform": ["fire", "fire hydrant"],
    "repeated": ["dog", "dog"],
    "repeated_three": ["dog", "dog", "dog"],
    "three_constraints": ["salt and pepper", "dog", "cat"],
    "all_class": ["all", "dog"],
}


def _builders(tmp_path):
    wf = tmp_path / "wf.tsv"
    wf.write_text("dog\tdog,dogs\ncat\tcat\nfire\tfire\nhydrant\thydrant,hydrants\n"
                  "salt\tsalt\nand\tand\npepper\tpepper\nred\tred\n")
    # attribute wordforms: "shiny", "fluffy" and "empty" are whitelisted,
    # "standing" is not: the "all" class merges the whitelisted ones and the
    # builder drops the others
    wa = tmp_path / "wa.tsv"
    wa.write_text("shiny\tshiny,glossy\nfluffy\tfluffy\nempty\tempty\nstanding\tstanding\n")
    out = []
    for voc, fsm, sel in ((j_voc, j_fsm, j_sel), (t_voc, t_fsm, t_sel)):
        v = voc.Vocabulary([voc.UNK_TOKEN, voc.BOUNDARY_TOKEN] + WORDS)
        out.append(fsm.FiniteStateMachineBuilder(
            v, str(wf), str(wa), 3, 3, use_coco_attributes=True,
            attrib_selection=sel.attrib_selection))
    return out


@pytest.mark.parametrize("case", sorted(FSM_CASES))
def test_fsm_builder_equals_jax(tmp_path, case):
    jb, tb = _builders(tmp_path)
    assert tb.wordforms == jb.wordforms
    assert tb.num_total_states == jb.num_total_states
    constraints = FSM_CASES[case]
    jd, jused, jc2s = jb.build(constraints)
    td, tused, tc2s = tb.build(constraints)
    assert td.dtype == jd.dtype == np.uint8
    np.testing.assert_array_equal(td, jd)                   # dense, bit for bit
    assert (tused, tc2s) == (jused, jc2s)
    for num_states in (None, 8, jused + 2):
        jp = jb.build_packed(constraints, num_states)
        tp = tb.build_packed(constraints, num_states)
        np.testing.assert_array_equal(tp[0], jp[0])
        assert tp[1:] == jp[1:]
        jt, jtu, jtc = jb.build_tables(constraints, num_states)
        tt, ttu, ttc = tb.build_tables(constraints, num_states)
        assert (ttu, ttc) == (jtu, jtc)
        for f in jt._fields:
            got, want = np.asarray(getattr(tt, f)), np.asarray(getattr(jt, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


def test_fsm_all_class_merges_whitelisted_attributes(tmp_path):
    _, tb = _builders(tmp_path)
    assert tb.wordforms["all"] == ["empty", "fluffy", "glossy", "shiny"]
    assert "standing" not in tb.wordforms and "shiny" in tb.wordforms


# ------------------------------------------------------------ the filter


@pytest.fixture
def hierarchy(tmp_path):
    h = {"LabelName": "entity", "Subcategory": [
        {"LabelName": "animal", "Subcategory": [{"LabelName": "dog"}, {"LabelName": "cat"}]},
        {"LabelName": "vehicle", "Subcategory": [{"LabelName": "car"}]}]}
    p = tmp_path / "hierarchy.json"
    p.write_text(json.dumps(h))
    return str(p)


FILTER_CASES = [   # the fixtures of tests/test_constraint_filter.py, and a few more
    (2, 0.85, [[0, 0, 10, 10], [100, 100, 110, 110], [200, 200, 210, 210],
               [300, 300, 310, 310]], ["dog", "person", "car", "cat"], [0.9, 0.99, 0.8, 0.7]),
    (3, 0.85, [[0, 0, 10, 10], [0, 0, 10, 10]], ["dog", "animal"], [0.5, 0.9]),
    (3, 0.85, [[0, 0, 10, 10], [100, 100, 110, 110]], ["dog", "animal"], [0.5, 0.9]),
    (3, 0.85, [[0, 0, 10, 10]], ["kitchen & dining room table"], [0.9]),
    (3, 0.5, [[0, 0, 10, 10], [1, 1, 11, 11], [2, 2, 9, 9], [50, 50, 60, 60]],
     ["animal", "dog", "vehicle", "luggage and bags"], [0.4, 0.6, 0.0, 0.3]),
    (3, 0.85, np.zeros((0, 4)), [], []),
]


@pytest.mark.parametrize("case", range(len(FILTER_CASES)))
def test_constraint_filter_equals_jax(hierarchy, case):
    k, thr, boxes, names, scores = FILTER_CASES[case]
    args = (np.asarray(boxes, float).reshape(-1, 4), list(names), np.asarray(scores, float))
    want = j_cf.ConstraintFilter(hierarchy, thr, k)(*args)
    got = t_cf.ConstraintFilter(hierarchy, thr, k)(*args)
    assert sorted(got) == sorted(want)
    assert t_cf.BLACKLIST == j_cf.BLACKLIST and t_cf.REPLACEMENTS == j_cf.REPLACEMENTS


# ------------------------------------------------------------- readers


def write_attribs_dir(path, images):
    """A COCO-Attributes pickle index (the schema ``scripts/make_world.py``
    writes): ``images`` maps image id -> [(object name, [attribute names])]."""
    path.mkdir(parents=True, exist_ok=True)
    inventory = list(j_sel.attrib_selection.keys())
    pos = {n: i for i, n in enumerate(inventory)}
    obj_names = sorted({o for objs in images.values() for o, _ in objs})
    obj_id = {n: i + 1 for i, n in enumerate(obj_names)}
    tables = {k: {} for k in ("attrib_inst2attrib_vector", "attrib_inst2obj_inst",
                              "obj_inst2attrib_inst", "obj_inst2image", "image2obj_insts",
                              "obj_inst2obj_id")}
    oi = 0
    for iid, objs in images.items():
        for name, atts in objs:
            oi += 1
            tables["obj_inst2image"][oi] = iid
            tables["image2obj_insts"].setdefault(iid, []).append(oi)
            tables["obj_inst2obj_id"][oi] = obj_id[name]
            if atts:
                vec = np.zeros((len(inventory),), np.float32)
                for a in atts:
                    vec[pos[a]] = 0.6
                tables["attrib_inst2attrib_vector"][oi] = vec
                tables["attrib_inst2obj_inst"][oi] = oi
                tables["obj_inst2attrib_inst"][oi] = oi
    tables["attrib2string"] = dict(enumerate(inventory))
    tables["obj_id2obj_name"] = {i: n for n, i in obj_id.items()}
    for k, v in tables.items():
        with open(path / f"{k}.pkl", "wb") as f:
            pickle.dump(v, f)
    return str(path)


def attribute_images(n=24, seed=0):
    """Images with 1-4 objects each, each with 0-3 whitelisted attributes
    (the reader keeps an attribute seen on >= 20 images)."""
    rng = np.random.RandomState(seed)
    objs = ["dog", "cat", "car", "table"]
    atts = ["shiny", "fluffy", "empty", "sporty", "bulky"]
    return {100 + i: [(objs[rng.randint(4)], list(rng.choice(atts, rng.randint(4), False)))
                      for _ in range(1 + rng.randint(4))] for i in range(n)}


def test_readers_equal_jax(tmp_path):
    d = tmp_path
    coco = {"annotations": [{"id": i, "image_id": 100 + i % 5, "caption": c}
                            for i, c in enumerate(CAPTIONS * 2)]}
    senti = {"images": [{"filename": f"COCO_val2014_{100 + i:012d}.jpg",
                         "split": ["train", "val", "test"][i % 3],
                         "sentences": [{"raw": CAPTIONS[i % 5], "sentiment": i % 2},
                                       {"raw": "a lovely dog", "sentiment": 1}]}
                        for i in range(9)]}
    expert = [{"image_id": str(100 + i), "caption": CAPTIONS[i], "sentiment": -1} for i in range(3)]
    boxes = {"annotations": [{"image_id": 100 + i % 3, "bbox": [i, i, 5 + i, 6], "category_id": 1 + i % 2,
                              **({"score": 0.5} if i % 2 else {})} for i in range(7)],
             "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "cat"}]}
    for name, obj in (("coco", coco), ("senti", senti), ("expert", expert), ("boxes", boxes)):
        (d / f"{name}.json").write_text(json.dumps(obj))
    j, t = j_readers, t_readers
    assert t.CocoCaptionsReader(str(d / "coco.json"))._captions == \
        j.CocoCaptionsReader(str(d / "coco.json"))._captions
    for kw in (dict(train_split=True), dict(val_split=True, sentiment="pos"),
               dict(test_split=True, sentiment="neg"), dict(test_split=True)):
        a, b = (m.SenticapReader(str(d / "senti.json"), **kw) for m in (j, t))
        assert (b._captions, b._image_ids) == (a._captions, a._image_ids), kw
    a, b = (m.ExpertReader(str(d / "expert.json")) for m in (j, t))
    assert (b._captions, b._image_ids) == (a._captions, a._image_ids)
    a, b = (m.ConstraintBoxesReader(str(d / "boxes.json")) for m in (j, t))
    for iid in (100, 101, 102, 999):
        x, y = a[iid], b[iid]
        np.testing.assert_array_equal(y["boxes"], x["boxes"])
        np.testing.assert_array_equal(y["scores"], x["scores"])
        assert y["class_names"] == x["class_names"]
    images = attribute_images()
    adir = write_attribs_dir(d / "attribs", images)
    a, b = j_readers.CocoAttributesReader(adir), t_readers.CocoAttributesReader(adir)
    assert b.attrib_names == a.attrib_names and len(b.attrib_names) > 0
    assert sorted(b.image_ids) == sorted(a.image_ids)
    assert (b.avail_obj_names, b.avail_obj_ids) == (a.avail_obj_names, a.avail_obj_ids)
    np.testing.assert_array_equal(b.att_counts, a.att_counts)
    for iid in images:
        assert repr(b[iid]) == repr(a[iid])
    obj_voc = ["", "car", "cat", "dog", "table"]
    packed = [[3, [[0, 0.9], [1, 0.1]]], [1, [[2, 0.4]]], [4, []]]
    for use_preds in (False, True):
        assert t_readers.obj_atts_id2string(obj_voc, b.attrib_names, packed, {"dog"}, 0.3,
                                            use_preds) == \
            j_readers.obj_atts_id2string(obj_voc, a.attrib_names, packed, {"dog"}, 0.3,
                                         use_preds)


# --------------------------------------------------------------- latents


def test_latent_dictionary_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    glove = {w: rng.randn(10).astype(np.float32) for w in ("shiny", "fluffy", "big")}
    with open(tmp_path / "sg.pkl", "wb") as f:
        pickle.dump(glove, f)
    (tmp_path / "swn.json").write_text(json.dumps({"shiny": [0.5, 0.25, 0.125],
                                                   "fluffy": [0.0, 0.5, 0.5]}))
    obj_atts = [[["dog", ["shiny", "fluffy big"]], ["cat", []], ["car", ["unknown"]]],
                [], [["dog", [["shiny", 0.7], ["fluffy", 0.4]]]]]
    image_atts = [[["dog", [["very shiny", 0.9], ["fluffy", 0.3]]], ["cat", [["shiny", 0.5]]]],
                  None, []]
    for build in ("from_sentiglove", "from_swn_scores"):
        path = str(tmp_path / ("sg.pkl" if build == "from_sentiglove" else "swn.json"))
        jd = getattr(j_lat.LatentDictionary, build)(path, 20, 1.5)
        td = getattr(t_lat.LatentDictionary, build)(path, 20, 1.5)
        for boxes in (2, 4):
            np.testing.assert_array_equal(td.translate_obj_atts(obj_atts, boxes),
                                          jd.translate_obj_atts(obj_atts, boxes))
        jt, tt = jd.embed_table(["shiny", "fluffy x", "nothing"]), \
            td.embed_table(["shiny", "fluffy x", "nothing"])
        np.testing.assert_array_equal(tt.table, jt.table)
        np.testing.assert_array_equal(tt.has, jt.has)
        np.testing.assert_array_equal(td.batch_calc_attrib_mean(image_atts),
                                      jd.batch_calc_attrib_mean(image_atts))
