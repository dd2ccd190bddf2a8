"""Offline caption evaluation (counterpart of the JAX package's
``scripts/eval.py``, the CLI around its eval/eval.py port).

    python -m style_seqcvae_tpu_torch.scripts.eval --predictions preds.json \\
        --references captions.json [--wordforms forms.tsv] [--id-map map.pkl] \\
        [--output scores.json]

Per-z-sample means and the top-1 oracle of BLEU-1..4, ROUGE-L, CIDEr and
METEOR (the meteor-1.5 jar when ``METEOR_JAR`` and java are there, else the
pure-Python exact + stem METEOR), Div-1 and Div-2 (over all samples and over
the top 5 by CIDEr) and, with ``--wordforms``, sentiment precision, recall
and has-ANP. It reads the predictions JSON that the inference CLI writes and
a COCO-style captions JSON, prints one line a number as the JAX CLI prints
them and writes the numbers to ``--output``. It runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import List, Optional

from style_seqcvae_tpu_torch.evaluation.eval import (
    evaluate,
    preprocess_coco_annots,
    read_wordforms,
)

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--predictions", required=True,
                    help="predictions JSON from scripts/inference.py")
parser.add_argument("--references", required=True,
                    help="COCO-format captions JSON (annotations list)")
parser.add_argument("--wordforms", default="",
                    help="sentiment/attribute wordform TSV for style metrics")
parser.add_argument("--id-map", default="",
                    help="optional pickle mapping reference ids (senti2coco)")
parser.add_argument("--output", default="", help="optional JSON output path")


def _shown(key: str, value: float) -> float:
    """The printed form: percent to 2 places, diversity and style to 4."""
    if "Div" not in key and "senti" not in key and key != "has_anp":
        return round(value * 100, 2)
    return round(value, 4)


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)
    with open(args.predictions) as f:
        preds = json.load(f)
    with open(args.references) as f:
        gts = preprocess_coco_annots(json.load(f))
    wordforms = read_wordforms(args.wordforms) if args.wordforms else None
    id_map = None
    if args.id_map:
        with open(args.id_map, "rb") as f:
            id_map = pickle.load(f)

    out = evaluate(preds, gts, wordforms=wordforms, id_map=id_map)
    for k, v in out.items():
        print(f"{k}: {_shown(k, v)}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
