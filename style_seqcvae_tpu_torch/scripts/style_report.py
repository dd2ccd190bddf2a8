"""The sentiment-control (style) report over the workflow's decoded
captions (counterpart of the repository's ``scripts/style_report.py``).

    python -m style_seqcvae_tpu_torch.scripts.style_report --world W --run RUN \
        [--output o.json]

For each of ``RUN/preds_{pos,neg,neutral,cbs_pos,pos_topp}.json`` that
exists: the share of captions holding a positive and a negative lexicon
word (``world.json``); the control margins, each conditioned run's rate less
the neutral run's, and the crossovers; and ``eval_style``'s sentiment
precision, recall and has-ANP against the polarity-matched test
references. Host only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from style_seqcvae_tpu_torch.evaluation.eval import (
    eval_style,
    preprocess_coco_annots,
    preprocess_updown_output,
    read_wordforms,
)

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--world", required=True)
parser.add_argument("--run", required=True)
parser.add_argument("--output", default="")


def lexicon_rates(preds, pos_words, neg_words):
    n = len(preds)
    n_pos = n_neg = 0
    for p in preds:
        toks = set(p["caption"].split())
        n_pos += bool(toks & pos_words)
        n_neg += bool(toks & neg_words)
    return {"captions": n,
            "pos_rate": n_pos / n if n else 0.0,
            "neg_rate": n_neg / n if n else 0.0}


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)
    world = _read_json(os.path.join(args.world, "world.json"))
    pos_words, neg_words = set(world["pos_words"]), set(world["neg_words"])
    wordforms = read_wordforms(
        os.path.join(args.world, "wordforms_senti.tsv"))

    report = {"runs": {}}
    for name in ("pos", "neg", "neutral", "cbs_pos", "pos_topp"):
        path = os.path.join(args.run, f"preds_{name}.json")
        if not os.path.exists(path):
            continue
        preds = _read_json(path)
        report["runs"][name] = lexicon_rates(preds, pos_words, neg_words)

    r = report["runs"]
    if {"pos", "neg", "neutral"} <= set(r):
        report["control"] = {
            "pos_margin": r["pos"]["pos_rate"] - r["neutral"]["pos_rate"],
            "neg_margin": r["neg"]["neg_rate"] - r["neutral"]["neg_rate"],
            "pos_crossover": r["pos"]["neg_rate"],
            "neg_crossover": r["neg"]["pos_rate"],
        }

    # eval_style P/R/has-ANP vs polarity-matched references
    for name, ref_file in (("pos", "captions_test_pos.json"),
                           ("neg", "captions_test_neg.json")):
        path = os.path.join(args.run, f"preds_{name}.json")
        ref_path = os.path.join(args.world, ref_file)
        if not (os.path.exists(path) and os.path.exists(ref_path)):
            continue
        gts = preprocess_coco_annots(_read_json(ref_path))
        res, gts2 = preprocess_updown_output(_read_json(path), gts)
        p, rec, anp = eval_style(gts2, res, wordforms)
        report["runs"][name].update(
            {"senti_prec": p, "senti_rec": rec, "has_anp": anp})

    print(json.dumps(report, indent=1))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
