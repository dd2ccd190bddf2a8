"""A synthetic grammar corpus at the reference training scale (counterpart
of the repository's ``scripts/make_synthetic_corpus.py``): the same
``np.random.RandomState`` stream, so every file is the JAX script's.

    python -m style_seqcvae_tpu_torch.scripts.make_synthetic_corpus --out-dir DIR \
        [--num-images 3000] [--senticap-images 400] [--seed 0] ...

It writes what the train CLI reads, in the reference's schemas:

* ``captions_train.json``: COCO captions (an annotations list);
* ``senticap_dataset.json``: Senticap (images, sentences, splits, sentiment
  0 / 1) with train / val / test splits;
* ``features_train.h5``: the features file, written by the port's
  ``utils/features_io.py::FeaturesWriter`` (h5py reads it);
* ``vocabulary/``: the AllenNLP-format vocabulary by the count thresholds;
* ``config.yml``: a training config at the reference widths.

Captions come from a small grammar ("the ADJ NOUN VERB ADV PREP the ADJ
NOUN") with skewed word draws, each image's captions name its objects, and
the feature rows are noisy copies of per-object prototypes, so a loss curve
on the corpus means something. Host only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary, build_caption_vocabulary
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter, pack_obj_atts

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--out-dir", required=True)
parser.add_argument("--num-images", type=int, default=3000)
parser.add_argument("--senticap-images", type=int, default=400,
                    help="images that also carry sentiment captions "
                         "(split 70/10/20 into train/val/test)")
parser.add_argument("--captions-per-image", type=int, default=7)
parser.add_argument("--boxes", type=int, default=36)
parser.add_argument("--feature-dim", type=int, default=2048)
parser.add_argument("--nouns", type=int, default=4000)
parser.add_argument("--adjectives", type=int, default=2600)
parser.add_argument("--verbs", type=int, default=1600)
parser.add_argument("--adverbs", type=int, default=1600)
parser.add_argument("--sentiment-words", type=int, default=160,
                    help="per polarity")
parser.add_argument("--seed", type=int, default=0)


def _zipf_choice(rng, n, size=None):
    """Skewed-but-flat draw over [0, n): p ~ (rank+2)^-0.3. A full 1/rank
    zipf would leave most of the 10k-word inventory under the vocab count
    threshold (measured: 2,090 surviving words); exponent 0.3 keeps a
    realistic head-heavy shape while ~all words clear count >= 5, matching
    the reference's ~10.5k-word vocabulary scale."""
    ranks = np.arange(n)
    p = (ranks + 2.0) ** -0.3
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def make_corpus(out_dir, num_images=3000, senticap_images=400,
                captions_per_image=7, boxes=36, feature_dim=2048,
                nouns=4000, adjectives=2600, verbs=1600, adverbs=1600,
                sentiment_words=160, seed=0):
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    NOUN = [f"obj{i}" for i in range(nouns)]
    ADJ = [f"attr{i}" for i in range(adjectives)]
    VERB = [f"act{i}" for i in range(verbs)]
    ADV = [f"adv{i}" for i in range(adverbs)]
    POS = [f"good{i}" for i in range(sentiment_words)]
    NEG = [f"bad{i}" for i in range(sentiment_words)]
    DET = ["the", "a"]
    PREP = ["on", "in", "near", "with", "under", "beside"]

    # per-image scene: 2-4 objects (noun ids), per-object prototype features
    n_prototypes = nouns
    prototypes = rng.randn(n_prototypes, feature_dim).astype(np.float32)
    image_ids = [100000 + i for i in range(num_images)]
    scene_objs = [rng.choice(n_prototypes, size=rng.randint(2, 5),
                             replace=False) for _ in range(num_images)]

    def noun_phrase(obj_idx, senti_word=None):
        words = [DET[rng.randint(2)]]
        if senti_word is not None:
            words.append(senti_word)
        if rng.rand() < 0.8:
            words.append(ADJ[_zipf_choice(rng, adjectives)])
        words.append(NOUN[obj_idx])
        return words

    def sentence(objs, sentiment=0):
        senti_word = None
        if sentiment == 1:
            senti_word = POS[_zipf_choice(rng, sentiment_words)]
        elif sentiment == -1:
            senti_word = NEG[_zipf_choice(rng, sentiment_words)]
        first = objs[rng.randint(len(objs))]
        words = noun_phrase(first, senti_word)
        words.append(VERB[_zipf_choice(rng, verbs)])
        if rng.rand() < 0.7:
            words.append(ADV[_zipf_choice(rng, adverbs)])
        if rng.rand() < 0.8:
            words.append(PREP[rng.randint(len(PREP))])
            words.extend(noun_phrase(objs[rng.randint(len(objs))]))
        return " ".join(words)

    # --- COCO captions ---
    annotations = []
    ann_id = 1
    for i, iid in enumerate(image_ids):
        for _ in range(captions_per_image):
            annotations.append({"id": ann_id, "image_id": iid,
                                "caption": sentence(scene_objs[i])})
            ann_id += 1
    with open(os.path.join(out_dir, "captions_train.json"), "w") as f:
        json.dump({"annotations": annotations}, f)

    # --- Senticap (train/val/test ≈ 70/10/20) ---
    senti_idx = rng.choice(num_images, size=min(senticap_images, num_images),
                           replace=False)
    senti_images = []
    for j, i in enumerate(senti_idx):
        split = ("train" if j < 0.7 * len(senti_idx)
                 else "val" if j < 0.8 * len(senti_idx) else "test")
        sentences = []
        for _ in range(3):
            senti = int(rng.rand() < 0.5)            # 1=pos, 0=neg (schema)
            sentences.append({
                "raw": sentence(scene_objs[i], 1 if senti else -1),
                "sentiment": senti})
        senti_images.append({
            "filename": f"COCO_train2014_{image_ids[i]:012d}.jpg",
            "split": split, "sentences": sentences})
    with open(os.path.join(out_dir, "senticap_dataset.json"), "w") as f:
        json.dump({"images": senti_images}, f)

    # --- features.h5: per-box feature = object prototype + noise ---
    h5_path = os.path.join(out_dir, "features_train.h5")
    writer = FeaturesWriter(h5_path, num_images)
    for i, iid in enumerate(image_ids):
        objs = scene_objs[i]
        box_obj = objs[rng.randint(len(objs), size=boxes)]
        feats = (prototypes[box_obj]
                 + 0.3 * rng.randn(boxes, feature_dim).astype(np.float32))
        obj_ids = (box_obj % 80) + 1                  # 80 COCO-ish classes
        att_lists = [list(rng.randint(0, 98, size=rng.randint(0, 3)))
                     for _ in range(boxes)]
        writer.write(i, iid, feats.astype(np.float32),
                     pack_obj_atts(obj_ids.tolist(), att_lists),
                     np.zeros((0,), np.float32))
    writer.close()

    # --- vocabulary (ported count-threshold rules) ---
    tokens = build_caption_vocabulary(annotations, senti_images)
    vocab = Vocabulary(tokens)
    vocab.save_to_files(os.path.join(out_dir, "vocabulary"))

    # --- training config at the reference dims ---
    config = f"""RANDOM_SEED: 42
PRINT_EVERY_N_BATCHES: 100
DATA:
  VOCABULARY: {out_dir}/vocabulary
  TRAIN_FEATURES: {h5_path}
  INFER_FEATURES: ""
  TRAIN_CAPTIONS: {out_dir}/captions_train.json
  SENTICAP_CAPTIONS: {out_dir}/senticap_dataset.json
  DO_LOAD_COCO: true
  DO_LOAD_SENTICAP: true
  MAX_CAPTION_LENGTH: 20
  MAX_BOXES: {boxes}
MODEL:
  IMAGE_FEATURE_SIZE: {feature_dim}
  EMBEDDING_SIZE: 600
  HIDDEN_SIZE: 900
  ATTENTION_PROJECTION_SIZE: 768
  Z_SPACE: 150
  SENTIMENT_VAE: 1
  SIMPLE_VAE: false
  SENTI_PRIOR_MULTIP: 0.5
  KLD_WEIGHT: 750
  PRIOR_STD: 1.0
  N_Z_SAMPLES: 20
OPTIM:
  BATCH_SIZE: 150
  NUM_ITERATIONS: 70000
"""
    cfg_path = os.path.join(out_dir, "config.yml")
    with open(cfg_path, "w") as f:
        f.write(config)
    return {"config": cfg_path, "vocab_size": vocab.get_vocab_size(),
            "num_captions": len(annotations), "h5_bytes": os.path.getsize(h5_path)}


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)
    info = make_corpus(
        args.out_dir, num_images=args.num_images,
        senticap_images=args.senticap_images,
        captions_per_image=args.captions_per_image, boxes=args.boxes,
        feature_dim=args.feature_dim, nouns=args.nouns,
        adjectives=args.adjectives, verbs=args.verbs, adverbs=args.adverbs,
        sentiment_words=args.sentiment_words, seed=args.seed)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
