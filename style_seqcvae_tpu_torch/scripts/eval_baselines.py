"""The model against a random and a retrieval baseline through the same
evaluation (counterpart of the repository's ``scripts/eval_baselines.py``).

    python -m style_seqcvae_tpu_torch.scripts.eval_baselines --world W --run RUN \
        [--n-z 20] [--seed 0] [--output o.json]

Against the neutral test references of a ``make_world`` world, it scores:

* **model**: the workflow's predictions (``RUN/preds_neutral.json``);
* **random**: for each test image, ``--n-z`` train captions drawn
  uniformly (fluent, in-domain, not grounded in the image);
* **retrieval**: the nearest train image by cosine similarity of the mean
  extracted feature (``RUN/features_{train,test}.h5``), with that image's
  reference captions;

each through ``evaluation/eval.py::evaluate``, plus the grounding precision
and recall of content words (shapes and attributes) against ``world.json``'s
scenes. Host only: the similarities are numpy products, as in the JAX
script, so the nearest neighbours and the numbers are its own.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
from typing import List, Optional

import numpy as np

from style_seqcvae_tpu_torch.evaluation.eval import evaluate, preprocess_coco_annots
from style_seqcvae_tpu_torch.utils.features_io import FeaturesReader

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--world", required=True, help="make_world.py output dir")
parser.add_argument("--run", required=True, help="three_stage.py run dir")
parser.add_argument("--n-z", type=int, default=20)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--output", default="")


def mean_feature_index(h5path):
    """The image ids of a features.h5 and each image's mean box feature,
    scaled to unit length (numpy, as the JAX script)."""
    reader = FeaturesReader(h5path)
    ids, vecs = [], []
    for iid in reader.image_ids:
        feats, _ = reader[iid]
        v = feats.mean(axis=0)
        n = np.linalg.norm(v) + 1e-8
        ids.append(iid)
        vecs.append(v / n)
    reader.close()
    return ids, np.stack(vecs)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    refs_test = _read_json(os.path.join(args.world, "captions_test.json"))
    gts = preprocess_coco_annots(refs_test)
    test_ids = sorted(gts.keys())

    train_caps = _read_json(os.path.join(args.world, "captions_train.json"))["annotations"]
    by_train_image = {}
    for a in train_caps:
        by_train_image.setdefault(a["image_id"], []).append(a["caption"])
    pool = [(a["image_id"], a["caption"]) for a in train_caps]

    # --- random: train captions of other images, n_z per test image ---
    random_preds = []
    for iid in test_ids:
        picks = rng.randint(0, len(pool), size=args.n_z)
        for p in picks:
            random_preds.append({"image_id": iid, "caption": pool[p][1]})

    # --- retrieval: nearest train image by mean extracted feature ---
    tr_ids, tr_vecs = mean_feature_index(
        os.path.join(args.run, "features_train.h5"))
    te_ids, te_vecs = mean_feature_index(
        os.path.join(args.run, "features_test.h5"))
    te_pos = {iid: i for i, iid in enumerate(te_ids)}
    retrieval_preds = []
    nn_of = {}
    for iid in test_ids:
        sims = tr_vecs @ te_vecs[te_pos[iid]]
        nn = tr_ids[int(np.argmax(sims))]
        nn_of[iid] = nn
        caps = by_train_image[nn]
        for z in range(args.n_z):
            retrieval_preds.append({"image_id": iid,
                                    "caption": caps[z % len(caps)]})

    # grounding precision/recall: content words (shape nouns + attribute
    # adjectives) vs the image's KNOWN scene (world.json). On a closed
    # template grammar every fluent caption matches the function-word
    # n-grams, so BLEU saturates for random text too — grounding precision
    # is the metric that separates "describes THIS image" from "fluent
    # about some image" (and grounding is the paper's actual claim).
    world = _read_json(os.path.join(args.world, "world.json"))
    content = set(world["shapes"]) | set(world["attrs"])

    def grounding(preds):
        by_img = collections.defaultdict(list)
        for p in preds:
            by_img[p["image_id"]].append(p["caption"])
        hit = tot = ref_hit = ref_tot = 0
        for iid, caps in by_img.items():
            scene = world["images"][str(iid)]["scene"]
            truth = ({o["shape"] for o in scene}
                     | {a for o in scene for a in o["attrs"]})
            mentioned = set()
            for c in caps:
                words = set(c.split()) & content
                tot += len(words)
                hit += len(words & truth)
                mentioned |= words
            ref_tot += len(truth)
            ref_hit += len(truth & mentioned)
        return (hit / max(tot, 1), ref_hit / max(ref_tot, 1))

    out = {}
    model_path = os.path.join(args.run, "preds_neutral.json")
    if os.path.exists(model_path):
        model_preds = _read_json(model_path)
        out["model"] = evaluate(model_preds, gts)
        out["model"]["grounding_P"], out["model"]["grounding_R"] = grounding(
            model_preds)
    out["random"] = evaluate(random_preds, gts)
    out["random"]["grounding_P"], out["random"]["grounding_R"] = grounding(
        random_preds)
    out["retrieval"] = evaluate(retrieval_preds, gts)
    (out["retrieval"]["grounding_P"],
     out["retrieval"]["grounding_R"]) = grounding(retrieval_preds)

    # evaluate() naming follows the reference: "B4" is the top-1 ORACLE
    # re-score, "mean B4" the per-z mean (eval.py:350-437)
    keys = ["mean B4", "B4", "mean cider", "cider", "Div-1", "Div-2",
            "grounding_P", "grounding_R"]
    header = "system     " + "".join(f"{k:>13}" for k in keys)
    print(header)
    for name in ("model", "random", "retrieval"):
        if name in out:
            row = "".join(f"{out[name].get(k, float('nan')):13.4f}"
                          for k in keys)
            print(f"{name:<11}{row}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
