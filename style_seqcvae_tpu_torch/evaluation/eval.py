"""Offline evaluation of a predictions JSON (a copy of
``style_seqcvae_tpu/evaluation/eval.py``, the modular port of the
reference's eval/eval.py, which the port may not import).

For N z-sample prediction sets per image: per-sample BLEU-1..4, ROUGE-L,
CIDEr and METEOR (the mean over samples), the top-1 oracle re-score (the
per-image argmax over samples per metric, then the corpus re-scored,
eval.py:350-437), n-gram diversity Div-1 and Div-2 over all samples and over
the top 5 by CIDEr (eval.py:441-472), and sentiment precision, recall and
has-ANP against the wordform lexicon (eval.py:95-131). Host Python only.
"""
from __future__ import annotations

import csv
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from style_seqcvae_tpu_torch.data.tokenizer import tokenize_caption, word_tokenize
from style_seqcvae_tpu_torch.evaluation.metrics import (
    Bleu,
    Cider,
    Meteor,
    Rouge,
    meteor_available,
)


@lru_cache(maxsize=1 << 18)
def _cached_tokens(caption: str) -> tuple:
    """Tokenization is a pure function and the Div-1/2 sweeps re-tokenize
    the same caption strings four times (all + top-5 sets, two n sizes) —
    plus diverse sampling repeats captions across z. Memoize."""
    return tuple(word_tokenize(caption))


def read_wordforms(path: str) -> Dict[str, List[str]]:
    wordforms = {}
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=["class_name", "words"])
        for row in reader:
            wordforms[row["class_name"]] = row["words"].split(",")
    return wordforms


def preprocess_coco_annots(coco_annots: dict, id_map: Optional[dict] = None) -> Dict:
    """COCO captions json → {image_id: [tokenized caption strings]}
    (eval.py:31-55); optional COCO→Senticap id remap."""
    result: Dict = {}
    for e in coco_annots["annotations"]:
        image_id = e["image_id"]
        if id_map is not None:
            image_id = id_map[image_id]
        caption = " ".join(tokenize_caption(e["caption"]))
        result.setdefault(image_id, []).append(caption)
    return result


def preprocess_updown_output(updown_res: List[dict], gts: Dict,
                             id_map: Optional[dict] = None
                             ) -> Tuple[List[Dict], Dict]:
    """Group the flat predictions JSON into one dict per z-sample index
    (eval.py:191-215). Images missing predictions are dropped from gts."""
    res_temp: Dict = {}
    for e in updown_res:
        res_temp.setdefault(e["image_id"], []).append(e["caption"])

    n_caps = len(next(iter(res_temp.values())))
    res: List[Dict] = [{} for _ in range(n_caps)]
    gts_out = dict(gts)
    for key in list(gts_out.keys()):
        try:
            src = key if id_map is None else id_map[key]
            for k in range(n_caps):
                res[k][key] = [res_temp[src][k]]
        except (KeyError, IndexError):
            del gts_out[key]
    return res, gts_out


def n_gram_diversity(captions: List[dict], n_gram_size: int = 1) -> float:
    """Div-n (eval.py:145-172): unique n-grams / words, per image, averaged."""
    by_image: Dict = {}
    for c in captions:
        by_image.setdefault(c["image_id"], []).append(c["caption"])
    score = 0.0
    for image_id, caps in by_image.items():
        uniq = set()
        n_words = 0
        for c in caps:
            toks = _cached_tokens(c)
            n_words += len(toks)
            for i in range(len(toks) - n_gram_size + 1):
                uniq.add(tuple(toks[i:i + n_gram_size]))
        # all-empty captions for an image contribute 0 diversity instead of
        # crashing the whole sweep (the reference divides by zero here)
        score += len(uniq) / n_words if n_words else 0.0
    return score / len(by_image)


def eval_style(gts: Dict, res: List[Dict], wordforms: Dict[str, List[str]]
               ) -> Tuple[float, float, float]:
    """Sentiment precision/recall/has-ANP (eval.py:95-131): set-level match
    of lexicon tokens between all predictions and all references."""
    senti_words = set(w for words in wordforms.values() for w in words)
    p_match = p_cnt = r_match = r_cnt = anp = 0
    for image_id in gts:
        gts_tokens = set()
        for c in gts[image_id]:
            gts_tokens.update(t for t in c.split() if t in senti_words)
        res_tokens = set()
        for preds in res:
            for c in preds[image_id]:
                res_tokens.update(t for t in c.split() if t in senti_words)
        if res_tokens:
            anp += 1
        for t in res_tokens:
            p_cnt += 1
            p_match += t in gts_tokens
        for t in gts_tokens:
            r_cnt += 1
            r_match += t in res_tokens
    return (p_match / p_cnt if p_cnt else 0.0,
            r_match / r_cnt if r_cnt else 0.0,
            anp / len(gts) if gts else 0.0)


def evaluate(updown_res: List[dict], gts: Dict,
             wordforms: Optional[Dict[str, List[str]]] = None,
             id_map: Optional[dict] = None,
             do_meteor: Optional[bool] = None) -> Dict[str, float]:
    """Full evaluation → flat dict of all the numbers eval.py prints."""
    res, gts = preprocess_updown_output(updown_res, gts, id_map)
    image_ids = list(gts.keys())
    do_meteor = meteor_available() if do_meteor is None else do_meteor

    bleu, rouge, cider = Bleu(), Rouge(), Cider()
    # reference-side BLEU/CIDEr state (doc freq, ref vectors/ngrams) is
    # shared across the per-z and oracle scoring calls below — build once
    bleu_corpus = bleu.make_corpus(gts)
    cider_corpus = cider.make_corpus(gts)
    meteor = Meteor() if do_meteor else None

    per_metric_all: Dict[str, List[List[float]]] = {
        k: [] for k in ("B1", "B2", "B3", "B4", "rouge", "cider", "meteor")}
    means: Dict[str, List[float]] = {k: [] for k in per_metric_all}

    for k in range(len(res)):
        bm, bs = bleu.compute_score(gts, res[k], corpus=bleu_corpus)
        for i in range(4):
            per_metric_all[f"B{i+1}"].append(bs[i])
            means[f"B{i+1}"].append(bm[i])
        rm, rs = rouge.compute_score(gts, res[k])
        per_metric_all["rouge"].append(rs)
        means["rouge"].append(rm)
        cm, cs = cider.compute_score(gts, res[k], corpus=cider_corpus)
        per_metric_all["cider"].append(cs)
        means["cider"].append(cm)
        if meteor:
            mm, ms = meteor.compute_score(gts, res[k])
            per_metric_all["meteor"].append(ms)
            means["meteor"].append(mm)

    out: Dict[str, float] = {}
    out["Div-1"] = n_gram_diversity(updown_res, 1)
    out["Div-2"] = n_gram_diversity(updown_res, 2)

    # oracle: per-image argmax over z-samples per metric, re-score corpus
    # (eval.py:350-437)
    def oracle(metric_key: str, corpus_index: Optional[int] = None) -> float:
        arr = np.stack(per_metric_all[metric_key], axis=1)   # (imgs, samples)
        argmax = np.argmax(arr, axis=1)
        res_best = {iid: res[argmax[j]][iid] for j, iid in enumerate(image_ids)}
        if metric_key.startswith("B"):
            return bleu.compute_score(gts, res_best,
                                      corpus=bleu_corpus)[0][corpus_index]
        if metric_key == "rouge":
            return rouge.compute_score(gts, res_best)[0]
        if metric_key == "cider":
            return cider.compute_score(gts, res_best, corpus=cider_corpus)[0]
        if metric_key == "meteor":
            return meteor.compute_score(gts, res_best)[0]
        raise KeyError(metric_key)

    for i in range(4):
        out[f"B{i+1}"] = oracle(f"B{i+1}", i)
        out[f"mean B{i+1}"] = float(np.mean(means[f"B{i+1}"]))
    out["rouge"] = oracle("rouge")
    out["mean rouge"] = float(np.mean(means["rouge"]))
    out["cider"] = oracle("cider")
    out["mean cider"] = float(np.mean(means["cider"]))
    if meteor:
        out["meteor"] = oracle("meteor")
        out["mean meteor"] = float(np.mean(means["meteor"]))

    # top-5 by CIDEr diversity (eval.py:366-376, :471-472)
    if len(res) >= 5:
        cider_all = np.stack(per_metric_all["cider"], axis=1)
        order = np.argsort(cider_all, axis=1)
        filtered = []
        for j, image_id in enumerate(image_ids):
            for r in range(1, 6):
                filtered.append({"image_id": image_id,
                                 "caption": res[order[j, -r]][image_id][0]})
        out["top5 Div-1"] = n_gram_diversity(filtered, 1)
        out["top5 Div-2"] = n_gram_diversity(filtered, 2)

    if wordforms:
        p, r, anp = eval_style(gts, res, wordforms)
        out["senti_prec"] = p
        out["senti_rec"] = r
        out["has_anp"] = anp
    return out
