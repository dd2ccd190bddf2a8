"""Offline preprocessing CLI (counterpart of the repository's
``scripts/preprocess.py``): the same six subcommands, flags and output
files, over the port's ``preprocessing.py``.

    python -m style_seqcvae_tpu_torch.scripts.preprocess <subcommand> ...

Subcommands:
  split-senticap         senticap_dataset.json → 6 per-split/sentiment JSONs
  id-maps                coco2senti / senti2coco pickles
  attribute-index        COCO instances + cocottributes pickle → reader pickles
  balanced-captions      sentiment-adjective-augmented COCO captions
  att-balanced-captions  COCO-Attributes adjective-augmented COCO captions
  sentiglove             PCA-10 SentiGloVe latent dictionary

Host only. Each seeded subcommand draws from ``random.Random(--seed)``, as
the JAX CLI does, so its files are the JAX CLI's byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
from typing import List, Optional

import numpy as np

from style_seqcvae_tpu_torch import preprocessing as pp
from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
sub = parser.add_subparsers(dest="cmd", required=True)

_p = sub.add_parser("split-senticap")
_p.add_argument("--senticap-json", required=True)
_p.add_argument("--output-dir", required=True)

_p = sub.add_parser("id-maps")
_p.add_argument("--senticap-json", required=True)
_p.add_argument("--output-dir", required=True)

_p = sub.add_parser("attribute-index")
_p.add_argument("--instances-json", nargs="+", required=True)
_p.add_argument("--cocottributes-pkl", required=True)
_p.add_argument("--output-dir", required=True)

_p = sub.add_parser("balanced-captions")
_p.add_argument("--coco-captions", required=True)
_p.add_argument("--senticap-json", required=True)
_p.add_argument("--objects-tsv", required=True)
_p.add_argument("--attribs-pos", nargs="*", default=[])
_p.add_argument("--attribs-neg", nargs="*", default=[])
_p.add_argument("--output-dir", required=True)
_p.add_argument("--seed", type=int, default=0)

_p = sub.add_parser(
    "att-balanced-captions",
    help="insert COCO-Attributes adjectives into COCO captions from per-image "
         "attribute detections")
_p.add_argument("--coco-captions", required=True,
                help="COCO captions JSON (annotations list)")
_p.add_argument("--attrib-detections", required=True,
                help="per-image candidates JSON: [{'image_id', "
                     "'candidates': [[obj, [[att, ...], ...]], ...]}, ...]")
_p.add_argument("--objects-tsv", required=True,
                help="object wordforms TSV (constraint_wordforms_exp.tsv)")
_p.add_argument("--attribs-tsv", required=True,
                help="attribute wordforms TSV (constraint_wordforms_attribs_exp.tsv)")
_p.add_argument("--output-dir", required=True)
_p.add_argument("--seed", type=int, default=0)

_p = sub.add_parser("sentiglove")
_p.add_argument("--glove-txt", required=True)
_p.add_argument("--word-sentiments-json", required=True)
_p.add_argument("--output", default="sentiglove10.pkl")
_p.add_argument("--n-components", type=int, default=10)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)

    if args.cmd == "split-senticap":
        out = pp.split_senticap_by_sentiment(_read_json(args.senticap_json))
        os.makedirs(args.output_dir, exist_ok=True)
        for key, data in out.items():
            path = os.path.join(args.output_dir, f"senticap_{key}.json")
            _write_json(data, path)
            print(f"{path}: {len(data['images'])} images, "
                  f"{len(data['annotations'])} captions")

    elif args.cmd == "id-maps":
        c2s, s2c = pp.build_senticap_id_maps(_read_json(args.senticap_json))
        os.makedirs(args.output_dir, exist_ok=True)
        _write_pickle(c2s, os.path.join(args.output_dir, "coco2senti.pik"))
        _write_pickle(s2c, os.path.join(args.output_dir, "senti2coco.pik"))
        print(f"{len(c2s)} id mappings written")

    elif args.cmd == "attribute-index":
        instances = [_read_json(p) for p in args.instances_json]
        with open(args.cocottributes_pkl, "rb") as f:
            cocottributes = pickle.load(f, encoding="latin1")
        pp.build_attribute_index(instances, cocottributes, args.output_dir)
        print(f"attribute index written to {args.output_dir}")

    elif args.cmd == "balanced-captions":
        coco = _read_json(args.coco_captions)["annotations"]
        splits = pp.split_senticap_by_sentiment(_read_json(args.senticap_json))
        wordforms_objects = pp.read_wordform_classes(args.objects_tsv)
        wf_attribs = {"pos": {"words": {w: 0 for w in args.attribs_pos}},
                      "neg": {"words": {w: 0 for w in args.attribs_neg}}}
        os.makedirs(args.output_dir, exist_ok=True)
        outputs = {}
        for pol in ("pos", "neg"):
            caps = sum((splits[f"{s}_{pol}"]["annotations"] for s in ("train", "val", "test")),
                       [])
            objs, _, per_obj = pp.analyze_senticap(caps, wordforms_objects, wf_attribs)
            other = "neg" if pol == "pos" else "pos"
            new, _ = pp.generate_balanced_dataset(coco, per_obj[pol], objs,
                                                  set(wf_attribs[other]["words"]),
                                                  rng=random.Random(args.seed))
            for c in new:
                c["sentiment"] = 1 if pol == "pos" else -1
            outputs[pol] = new
            path = os.path.join(args.output_dir, f"captions_new_{pol}_balanced.json")
            _write_json(new, path)
            print(f"{path}: {len(new)} captions")
        _write_json(outputs["pos"] + outputs["neg"],
                    os.path.join(args.output_dir, "captions_new_balanced.json"))

    elif args.cmd == "att-balanced-captions":
        coco = _read_json(args.coco_captions)
        coco = coco["annotations"] if isinstance(coco, dict) else coco
        image_id2attribs = _read_json(args.attrib_detections)
        att_counts = pp.analyze_attribs(image_id2attribs)
        new = pp.generate_att_balanced_dataset(
            coco, image_id2attribs, pp.read_wordform_classes(args.objects_tsv),
            pp.read_wordform_classes(args.attribs_tsv), att_counts,
            rng=random.Random(args.seed))
        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir, "att_captions_new_balanced.json")
        _write_json(new, path)
        print(f"{path}: {len(new)} captions "
              f"({len(att_counts)} distinct attributes in detections)")

    elif args.cmd == "sentiglove":
        word_sentiments = _read_json(args.word_sentiments_json)
        vectors = {}
        wanted = {k.split(" ")[0] for k in attrib_selection}
        with open(args.glove_txt, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if parts[0] in wanted:
                    vectors[parts[0]] = np.asarray(parts[1:], np.float32)

        def lookup(w):
            return vectors.get(w, np.zeros(300, np.float32))

        table = pp.prep_sentiglove(lookup, word_sentiments, attrib_selection,
                                   args.n_components)
        _write_pickle(table, args.output)
        print(f"{args.output}: {len(table)} words, {args.n_components} dims")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
