"""Offline preprocessing of a user's caption and attribute data (counterpart
of ``style_seqcvae_tpu/preprocessing.py``, copied function for function;
numpy and the standard library only).

* :func:`split_senticap_by_sentiment`: senticap_dataset.json → six
  per-split, per-sentiment COCO-style JSONs.
* :func:`build_senticap_id_maps`: the coco2senti / senti2coco maps, both
  the identity over the Senticap image ids (which are COCO ids).
* :func:`build_attribute_index`: the COCO-Attributes reader's pickles from
  COCO instances JSONs and the cocottributes pickle.
* :func:`analyze_senticap` / :func:`generate_balanced_dataset`: mine
  (attribute, object) adjacency from Senticap and insert sentiment
  adjectives into COCO captions (POS-gated position, a → an fixup).
* :func:`analyze_attribs` / :func:`generate_att_balanced_dataset`: the
  same for COCO-Attributes adjectives, drawn with 1 / count² weights.
* :func:`prep_sentiglove`: PCA(10) of attribute-word GloVe vectors fitted
  on the top-10 positive and negative anchors (numpy SVD).

:func:`pos_tags` uses nltk's perceptron tagger when nltk and its data
load, else a small rule-based tagger (:func:`_fallback_pos_tags`), as the
JAX package does. Random draws go through ``random.Random`` streams, so a
seed gives the JAX package's captions.
"""

from __future__ import annotations

import copy
import csv
import os
import pickle
import random as _random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from style_seqcvae_tpu_torch.data.tokenizer import PUNCTUATIONS, word_tokenize


def split_senticap_by_sentiment(senticap: dict) -> Dict[str, dict]:
    """→ {"{split}_{pos|neg}": {"images": [...], "annotations": [...]}}."""
    out = {f"{s}_{p}": {"images": [], "annotations": []}
           for s in ("train", "val", "test") for p in ("pos", "neg")}
    for image in senticap["images"]:
        image_id = int(image["filename"].split(".")[0].split("_")[2])
        new_image = {"id": image_id, "file_name": image["filename"]}
        split = image["split"] if image["split"] in ("train", "val") else "test"
        has = {"pos": False, "neg": False}
        for c in image["sentences"]:
            pol = "pos" if c["sentiment"] else "neg"
            out[f"{split}_{pol}"]["annotations"].append(
                {"image_id": image_id, "caption": c["raw"]})
            has[pol] = True
        for pol in ("pos", "neg"):
            if has[pol]:
                out[f"{split}_{pol}"]["images"].append(new_image)
    return out


def build_senticap_id_maps(senticap: dict) -> Tuple[Dict[int, int], Dict[int, int]]:
    ids = {int(im["filename"].split(".")[0].split("_")[2])
           for im in senticap["images"]}
    ident = {i: i for i in ids}
    return dict(ident), dict(ident)


def build_attribute_index(instances_jsons: Sequence[dict],
                          cocottributes: dict, out_dir: str) -> None:
    """Write the reader-consumed pickles. ``cocottributes`` uses the public
    pickle's keys: ``ann_vecs`` {attrib_inst: vector},
    ``patch_id_to_ann_id`` {attrib_inst: coco annotation id}, and
    ``attributes`` [{"id", "name"}...]."""
    os.makedirs(out_dir, exist_ok=True)
    obj_id2obj_name: Dict[int, str] = {}
    image2obj_insts: Dict[int, List[int]] = {}
    obj_inst2image: Dict[int, int] = {}
    obj_inst2obj_id: Dict[int, int] = {}

    for obj in instances_jsons[0]["categories"]:
        obj_id2obj_name[obj["id"]] = obj["name"]
    for inst_file in instances_jsons:
        for inst in inst_file["annotations"]:
            image2obj_insts.setdefault(inst["image_id"], []).append(inst["id"])
            obj_inst2image[inst["id"]] = inst["image_id"]
            obj_inst2obj_id[inst["id"]] = inst["category_id"]

    attrib_inst2obj_inst = dict(cocottributes["patch_id_to_ann_id"])
    obj_inst2attrib_inst = {v: k for k, v in attrib_inst2obj_inst.items()}
    attrib_inst2attrib_vector = {k: np.asarray(v, np.float32)
                                 for k, v in cocottributes["ann_vecs"].items()}
    attrib2string = {a["id"]: a["name"] for a in cocottributes["attributes"]}

    def save(obj, name):
        with open(os.path.join(out_dir, name + ".pkl"), "wb") as f:
            pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)

    save(obj_id2obj_name, "obj_id2obj_name")
    save(image2obj_insts, "image2obj_insts")
    save(obj_inst2image, "obj_inst2image")
    save(obj_inst2obj_id, "obj_inst2obj_id")
    save(obj_inst2attrib_inst, "obj_inst2attrib_inst")
    save(attrib_inst2obj_inst, "attrib_inst2obj_inst")
    save(attrib_inst2attrib_vector, "attrib_inst2attrib_vector")
    save(attrib2string, "attrib2string")


# ----------------------------------------------------------------- POS tags
_DETERMINERS = {"a", "an", "the", "this", "that", "these", "those"}
_PREPOSITIONS = {"in", "on", "at", "of", "with", "by", "for", "to", "from",
                 "over", "under", "near", "into", "and", "or"}
_VERB_SUFFIX = ("ing", "ed")


def _fallback_pos_tags(tokens: List[str]) -> List[str]:
    tags = []
    for t in tokens:
        if t in _DETERMINERS:
            tags.append("DT")
        elif t in _PREPOSITIONS:
            tags.append("IN")
        elif t.endswith("ly"):
            tags.append("RB")
        elif t.endswith(_VERB_SUFFIX):
            tags.append("VBG")
        else:
            tags.append("NN")
    return tags


def pos_tags(tokens: List[str]) -> List[str]:
    try:
        import nltk

        return [t[1] for t in nltk.pos_tag(tokens)]
    except Exception:
        return _fallback_pos_tags(tokens)


def analyze_senticap(captions: List[dict], wordforms_objects: Dict,
                     wordforms_attribs: Dict):
    """Mine attribute-object adjacency (prep_senti_data.py:100-200):
    whenever an object wordform appears, the one/two preceding tokens that
    are known pos/neg attribute words are counted per object."""
    wordforms_objects = copy.deepcopy(wordforms_objects)
    wordforms_attribs = copy.deepcopy(wordforms_attribs)
    attribs_per_object: Dict[str, Dict] = {"pos": {}, "neg": {}}

    def credit(pol: str, obj: str, attrib: Optional[str]) -> bool:
        if attrib is None or attrib not in wordforms_attribs[pol]["words"]:
            return False
        wordforms_attribs[pol]["words"][attrib] += 1
        attribs_per_object[pol].setdefault(obj, {})
        attribs_per_object[pol][obj][attrib] = (
            attribs_per_object[pol][obj].get(attrib, 0) + 1)
        return True

    for c in captions:
        toks = [t for t in word_tokenize(c["caption"].lower().strip())
                if t not in PUNCTUATIONS]
        for wf_obj, entry in wordforms_objects.items():
            skip_next = False
            for word_obj in entry["words"]:
                if skip_next:
                    skip_next = False
                    continue
                if word_obj in toks:
                    entry["counts"] += 1
                    entry["words"][word_obj] += 1
                    idx = toks.index(word_obj)
                    a1 = toks[idx - 1] if idx > 0 else None
                    a2 = toks[idx - 2] if idx > 1 else None
                    for a in (a1, a2):
                        if credit("pos", wf_obj, a) or credit("neg", wf_obj, a):
                            skip_next = True
    return wordforms_objects, wordforms_attribs, attribs_per_object


def generate_balanced_dataset(captions: List[dict], attribs_per_obj: Dict,
                              wordforms_objects: Dict, attrib_blacklist: set,
                              rng: Optional[_random.Random] = None
                              ) -> Tuple[List[dict], List[dict]]:
    """Inject mined attributes before object mentions
    (prep_senti_data.py:207-287): POS-gated insertion position, ATTRIB
    break tag, a→an article fixup. Returns (modified, untouched)."""
    rng = rng or _random
    skip_tags = ["NN", "JJ", "RB"]
    break_tags = ["ATTRIB"]
    captions_new, captions_factual = [], []

    for caption in captions:
        toks = [t for t in word_tokenize(caption["caption"].lower().strip())
                if t not in PUNCTUATIONS and t not in attrib_blacklist]
        tags = pos_tags(toks)
        modified = False

        for obj in attribs_per_obj.keys():
            for w in wordforms_objects[obj]["words"]:
                if w in toks:
                    idx = toks.index(w)
                    attribs = list(attribs_per_obj[obj].keys())
                    probs = [0 if a in toks else 1 for a in attribs]
                    if not any(probs):
                        continue
                    sample = rng.choices(attribs, probs)[0]
                    if sample in toks:
                        continue
                    added_at = -1
                    if (idx > 1 and tags[idx - 2] in skip_tags
                            and tags[idx - 1] in skip_tags
                            and tags[idx - 2] not in break_tags
                            and (idx < 3 or tags[idx - 3] not in break_tags)):
                        toks.insert(idx - 2, sample)
                        tags.insert(idx - 2, "ATTRIB")
                        added_at = idx - 2
                    elif (idx and tags[idx - 1] in skip_tags
                          and tags[idx - 1] not in break_tags
                          and (idx < 2 or tags[idx - 2] not in break_tags)):
                        toks.insert(idx - 1, sample)
                        tags.insert(idx - 1, "ATTRIB")
                        added_at = idx - 1
                    elif (tags[idx] not in break_tags
                          and (idx < 1 or tags[idx - 1] not in break_tags)):
                        toks.insert(idx, sample)
                        tags.insert(idx, "ATTRIB")
                        added_at = idx
                    modified = True
                    if (added_at > 0 and sample[0] in "aeiou"
                            and toks[added_at - 1] == "a"):
                        toks[added_at - 1] = "an"

        target = captions_new if modified else captions_factual
        target.append({"image_id": caption["image_id"], "caption": " ".join(toks)})
    return captions_new, captions_factual


def analyze_attribs(image_id2attribs: List[dict]) -> Dict[str, int]:
    """Global attribute-name frequency over the per-image detection
    candidates (misc/prep_coco_att_data.py:52-61). ``image_id2attribs`` is
    the attribute-detections JSON: a list of
    ``{"image_id": id, "candidates": [[obj_name, [[att_name, ...], ...]],
    ...]}`` records. The counts drive the inverse-square sampling weights of
    :func:`generate_att_balanced_dataset` (rare attributes are favoured —
    that is the 'balanced' in the output name)."""
    result: Dict[str, int] = {}
    for item in image_id2attribs:
        for o in item["candidates"]:
            for a in o[1]:
                result[a[0]] = result.get(a[0], 0) + 1
    return result


def generate_att_balanced_dataset(captions: List[dict],
                                  image_id2attribs: List[dict],
                                  wordforms_objects: Dict,
                                  wordforms_attribs: Dict,
                                  att_counts: Optional[Dict[str, int]] = None,
                                  rng: Optional[_random.Random] = None
                                  ) -> List[dict]:
    """COCO-Attributes caption augmentation
    (misc/prep_coco_att_data.py:113-195): for every image with detected
    (object, attributes) candidates, each caption mentioning a detected
    object's wordform gets one attribute wordform inserted before the
    mention — the attribute is drawn with 1/count² weighting over the
    object's detected attributes (rare attributes favoured), its cleaned
    name (last word of a multi-word attribute) indexes the attribute
    wordform table, and a concrete surface form is sampled uniformly.
    Insertion positions are POS-gated exactly like the sentiment variant;
    the a→an fixup skips 'useful' (reference :188) and — unlike the
    senticap variant — never applies to the insert-at-idx branch (the
    reference leaves ``added_at=-1`` there).

    Returns the modified-caption records
    ``{"image_id", "caption", "attributes"}`` (attributes = the image's
    candidate list, as the reference emits).

    Divergences from the reference, both guards for its crash paths: an
    object candidate with no attributes is skipped (``random.choices`` on
    an empty population raises), and a cleaned attribute name absent from
    the wordform TSV is skipped (KeyError)."""
    rng = rng or _random
    if att_counts is None:
        att_counts = analyze_attribs(image_id2attribs)
    skip_tags = ["NN", "JJ", "RB"]
    break_tags = ["ATTRIB"]

    image_id2captions: Dict[int, List[str]] = {}
    for annot in captions:
        image_id2captions.setdefault(annot["image_id"], []).append(
            annot["caption"])

    captions_new: List[dict] = []
    for image in image_id2attribs:
        caps = image_id2captions.get(image["image_id"])
        if caps is None:
            continue
        attributes = image["candidates"]
        for c in caps:
            toks = [t for t in word_tokenize(c.lower().strip())
                    if t not in PUNCTUATIONS]
            tags = pos_tags(toks)
            modified = False
            for o in attributes:
                for w in wordforms_objects[o[0]]["words"]:
                    if w not in toks:
                        continue
                    idx = toks.index(w)
                    o_a = [a[0] for a in o[1]]
                    if not o_a:
                        continue
                    o_a_p = [1.0 / att_counts[a] ** 2 for a in o_a]
                    sample = rng.choices(o_a, o_a_p)[0]
                    sample_cleaned = (sample.split(" ")[-1]
                                      or sample.split(" ")[-2])
                    if sample_cleaned not in wordforms_attribs:
                        continue
                    add_att = rng.choice(
                        list(wordforms_attribs[sample_cleaned]["words"]))
                    if add_att in toks:
                        continue
                    added_at = -1
                    if (idx > 1 and tags[idx - 2] in skip_tags
                            and tags[idx - 1] in skip_tags
                            and tags[idx - 2] not in break_tags
                            and (idx < 3 or tags[idx - 3] not in break_tags)):
                        toks.insert(idx - 2, add_att)
                        tags.insert(idx - 2, "ATTRIB")
                        added_at = idx - 2
                    elif (idx and tags[idx - 1] in skip_tags
                          and tags[idx - 1] not in break_tags
                          and (idx < 2 or tags[idx - 2] not in break_tags)):
                        toks.insert(idx - 1, add_att)
                        tags.insert(idx - 1, "ATTRIB")
                        added_at = idx - 1
                    elif (tags[idx] not in break_tags
                          and (idx < 1 or tags[idx - 1] not in break_tags)):
                        toks.insert(idx, add_att)
                        tags.insert(idx, "ATTRIB")
                        # reference keeps added_at = -1 on this branch —
                        # no a→an fixup for insert-at-mention
                    modified = True
                    if (added_at > 0 and add_att[0] in "aeiou"
                            and add_att != "useful"
                            and toks[added_at - 1] == "a"):
                        toks[added_at - 1] = "an"
            if modified:
                captions_new.append({"image_id": image["image_id"],
                                     "caption": " ".join(toks),
                                     "attributes": attributes})
    return captions_new


def read_wordform_classes(tsv_path: str) -> Dict[str, Dict]:
    """TSV → {class: {"counts": 0, "words": {word: 0}}}
    (prep_senti_data / prep_expl_lat_space loading shape)."""
    out: Dict[str, Dict] = {}
    with open(tsv_path) as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=["class_name", "words"])
        for row in reader:
            out[row["class_name"]] = {
                "counts": 0, "words": {w: 0 for w in row["words"].split(",")}}
    return out


def pca_fit_transform(fit_data: np.ndarray, n_components: int
                      ) -> Tuple[np.ndarray, np.ndarray, Callable[[np.ndarray], np.ndarray]]:
    """sklearn-compatible PCA via SVD: returns (mean, components,
    transform_fn)."""
    mean = fit_data.mean(axis=0)
    centered = fit_data - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    components = vt[:n_components]

    def transform(x: np.ndarray) -> np.ndarray:
        return (x - mean) @ components.T

    return mean, components, transform


def prep_sentiglove(glove_lookup: Callable[[str], np.ndarray],
                    word_sentiments: Dict[str, Sequence[float]],
                    attrib_selection: Dict[str, bool],
                    n_components: int = 10) -> Dict[str, np.ndarray]:
    """SentiGloVe latent dictionary (prep_expl_lat_space.py): sort attribute
    first-words by SentiWordNet polarity, fit PCA on the GloVe vectors of
    the top-10 pos + top-10 neg anchors, project ALL attribute words."""
    first_words = {k.split(" ")[0]: v for k, v in attrib_selection.items()}
    scored = [[w, word_sentiments[w][0] - word_sentiments[w][2]]
              for w in first_words if w in word_sentiments]
    scored.sort(key=lambda kv: kv[1])
    ordered = [w for w, _ in scored]
    anchors = ordered[-10:] + ordered[:10]
    fit = np.stack([glove_lookup(w) for w in anchors])
    _, _, transform = pca_fit_transform(fit, n_components)
    all_vecs = np.stack([glove_lookup(w) for w in ordered])
    return dict(zip(ordered, transform(all_vecs)))
