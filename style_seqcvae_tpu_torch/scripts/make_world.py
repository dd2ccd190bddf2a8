"""A synthetic visual world for the three-stage workflow (counterpart of
the repository's ``scripts/make_world.py``).

    python -m style_seqcvae_tpu_torch.scripts.make_world --out-dir DIR \
        [--num-train 800] [--num-val 100] [--num-test 100] [--seed 0] \
        [--image-format jpeg|png]

It renders images of coloured shapes (12 classes) carrying visual
attributes (8 whitelisted COCO-Attributes adjectives, each a rendered
texture) and writes every artifact of the workflow in the reference's
schemas: ``images/`` with ``instances_{train,val,test}.json`` (COCO
detection), ``attribs/`` (the COCO-Attributes pickle index),
``captions_{train,val,test}.json`` from a shared template grammar,
``senticap_dataset.json`` with ``captions_test_{pos,neg}.json``, the
wordform TSVs, ``class_hierarchy.json``, ``sentiglove10.pkl``,
``world.json`` (the scenes, for the baselines) and ``vocabulary/``.

The renderer and its ``np.random.RandomState`` stream are the JAX script's,
copied: every pixel array, JSON, pickle and TSV comes out the same. The
images are where the two differ. JAX writes JPEG through PIL at quality 92;
here JPEG (the default) is encoded on the card by libnvjpeg at quality 92
and 4:2:0 (``data/image_encode.py``), whose bytes and decoded pixels are
not PIL's, and it needs the card: with none it raises before anything is
written. ``--image-format png`` writes lossless PNG on the host instead,
named ``img_<id>.png`` in the instances files.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection
from style_seqcvae_tpu_torch.data.image_encode import encode_jpeg, encode_png
from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary, build_caption_vocabulary
from style_seqcvae_tpu_torch.device import resolve_device

SHAPES = ["circle", "ring", "square", "diamond", "triangle", "cross",
          "bar", "hexagon", "star", "ell", "tee", "vee"]
# whitelisted single-word COCO-Attributes adjectives (config_attrib_selection
# True entries) that do NOT collide with the sentiment lexicons below
ATTRS = ["shiny", "fluffy", "empty", "fuzzy", "furry", "sporty", "bulky",
         "sneaky"]
POS_WORDS = ["wonderful", "lovely", "nice", "pretty", "beautiful",
             "pleasant", "charming", "splendid"]
NEG_WORDS = ["ugly", "terrible", "awful", "nasty", "broken", "horrible",
             "gloomy", "miserable"]
VERBS = ["sits", "stands", "rests", "appears"]
PREPS = ["near", "beside", "above", "below", "behind"]

PALETTE = np.array([
    [220, 60, 60], [60, 180, 60], [70, 90, 220], [220, 200, 50],
    [200, 80, 200], [60, 200, 200], [230, 140, 40], [120, 220, 120],
    [180, 120, 80], [100, 100, 230],
], np.float32)

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--out-dir", required=True)
parser.add_argument("--num-train", type=int, default=800)
parser.add_argument("--num-val", type=int, default=100)
parser.add_argument("--num-test", type=int, default=100)
parser.add_argument("--senticap-train", type=int, default=100,
                    help="train images that also carry sentiment captions")
parser.add_argument("--height", type=int, default=384)
parser.add_argument("--width", type=int, default=512)
parser.add_argument("--captions-per-image", type=int, default=6)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--image-format", choices=("jpeg", "png"), default="jpeg",
                    help="jpeg: encoded on the card by nvjpeg (quality 92, 4:2:0), named "
                         ".jpg; png: encoded on the host with zlib, named .png")


def shape_mask(name, h, w, cy, cx, s):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    r = np.sqrt(dx * dx + dy * dy)
    hs = s / 2.0
    if name == "circle":
        return r <= hs
    if name == "ring":
        return (r <= hs) & (r >= hs * 0.55)
    if name == "square":
        return (np.abs(dx) <= hs) & (np.abs(dy) <= hs)
    if name == "diamond":
        return np.abs(dx) + np.abs(dy) <= hs
    if name == "triangle":
        return (dy >= -hs) & (dy <= hs) & (np.abs(dx) <= (dy + hs) / 2)
    if name == "cross":
        a = (np.abs(dx) <= s / 6) & (np.abs(dy) <= hs)
        b = (np.abs(dy) <= s / 6) & (np.abs(dx) <= hs)
        return a | b
    if name == "bar":
        return (np.abs(dx) <= hs) & (np.abs(dy) <= s / 5)
    if name == "hexagon":
        return ((np.abs(dy) <= hs * 0.866) & (np.abs(dx) <= hs)
                & (0.866 * np.abs(dx) + 0.5 * np.abs(dy) <= 0.866 * hs))
    if name == "star":
        theta = np.arctan2(dy, dx)
        rad = hs * (0.45 + 0.55 * (0.5 + 0.5 * np.cos(5 * theta)))
        return r <= rad
    if name == "ell":
        a = (dx >= -hs) & (dx <= -hs + s / 3) & (np.abs(dy) <= hs)
        b = (dy >= hs - s / 3) & (dy <= hs) & (np.abs(dx) <= hs)
        return a | b
    if name == "tee":
        a = (dy >= -hs) & (dy <= -hs + s / 3) & (np.abs(dx) <= hs)
        b = (np.abs(dx) <= s / 6) & (np.abs(dy) <= hs)
        return a | b
    if name == "vee":
        return ((np.abs(dy) <= hs)
                & (np.abs(np.abs(dx) - (dy + hs) / 2) <= s / 7))
    raise ValueError(name)


def _erode(mask, k=3):
    out = mask.copy()
    for ax, sh in ((0, k), (0, -k), (1, k), (1, -k)):
        out &= np.roll(mask, sh, axis=ax)
    return out


def _dilate(mask, k=3):
    out = mask.copy()
    for ax, sh in ((0, k), (0, -k), (1, k), (1, -k)):
        out |= np.roll(mask, sh, axis=ax)
    return out


def render_object(img, rng, name, attrs, cy, cx, s, color):
    """Draw one object; each attribute is a distinct visual transform the
    detector's attribute head can learn."""
    h, w = img.shape[:2]
    mask = shape_mask(name, h, w, cy, cx, s)
    fill = color.copy()
    alpha = np.where(mask, 1.0, 0.0)

    if "shiny" in attrs:
        fill = np.clip(fill * 1.45 + 40, 0, 255)
    if "sneaky" in attrs:
        alpha *= 0.45
    if "empty" in attrs:
        inner = _erode(mask, max(2, int(s / 14)))
        alpha = np.where(mask & ~inner, alpha, 0.0)
    draw = alpha[:, :, None] * fill[None, None, :]
    base = img * (1 - alpha[:, :, None])
    img[:] = base + draw

    region = mask
    if "fuzzy" in attrs:
        noise = rng.rand(h, w, 1).astype(np.float32) * 0.9 + 0.55
        img[region] = np.clip(img[region] * noise[region], 0, 255)
    if "fluffy" in attrs:
        band = region & ~_erode(region, max(2, int(s / 10)))
        keep = rng.rand(h, w) < 0.5
        img[band & keep] = img[band & keep] * 0.3 + 180 * 0.7
    if "furry" in attrs:
        band = _dilate(region, max(2, int(s / 9))) & ~region
        keep = rng.rand(h, w) < 0.35
        img[band & keep] = fill
    if "sporty" in attrs:
        yy, xx = np.mgrid[0:h, 0:w]
        stripe = ((xx + yy) % max(int(s / 3), 6)) < max(int(s / 9), 2)
        img[region & stripe] = 245.0
    if "bulky" in attrs:
        border = region & ~_erode(region, max(3, int(s / 8)))
        img[border] = 25.0
    if "shiny" in attrs:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        hl = ((yy - (cy - s / 5)) ** 2 + (xx - (cx - s / 5)) ** 2
              ) <= (s / 6) ** 2
        img[region & hl] = np.clip(img[region & hl] + 120, 0, 255)

    ys, xs = np.nonzero(mask)
    return [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]


def render_image(rng, h, w, scene):
    """Smooth gradient background + objects."""
    gy = rng.rand() * 60 + 40
    gx = rng.rand() * 60 + 40
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (gy + (gx - gy) * (yy / h + xx / w) / 2)[:, :, None]
    img = base + rng.randn(h, w, 3).astype(np.float32) * 6 + np.array(
        [rng.rand() * 30, rng.rand() * 30, rng.rand() * 30], np.float32)
    img = np.clip(img, 0, 255)
    boxes = []
    for obj in scene:
        box = render_object(img, rng, obj["shape"], obj["attrs"],
                            obj["cy"], obj["cx"], obj["s"],
                            PALETTE[obj["color"]])
        boxes.append(box)
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def sample_scene(rng, h, w):
    n = rng.randint(3, 7)
    scene = []
    for _ in range(n):
        for _try in range(30):
            s = rng.randint(56, 121)
            cy = rng.randint(s // 2 + 4, h - s // 2 - 4)
            cx = rng.randint(s // 2 + 4, w - s // 2 - 4)
            ok = all((abs(cy - o["cy"]) + abs(cx - o["cx"]))
                     > (s + o["s"]) * 0.55 for o in scene)
            if ok:
                break
        else:
            continue
        n_attr = rng.choice([0, 1, 1, 2])
        scene.append({
            "shape": SHAPES[rng.randint(len(SHAPES))],
            "attrs": sorted(rng.choice(ATTRS, size=n_attr,
                                       replace=False).tolist()),
            "cy": int(cy), "cx": int(cx), "s": int(s),
            "color": int(rng.randint(len(PALETTE))),
        })
    return scene


def noun_phrase(rng, obj, senti_word=None):
    words = []
    if senti_word:
        words.append(senti_word)
    if obj["attrs"] and rng.rand() < 0.75:
        words.append(obj["attrs"][rng.randint(len(obj["attrs"]))])
    words.append(obj["shape"])
    return " ".join(words)


def caption(rng, scene, sentiment=0):
    """Shared-template grammar: the small closed template/word inventory
    makes 3/4-grams repeat across references of one image (and across
    images), so corpus-level BLEU-3/4 discriminates learned captions from
    random ones."""
    senti_word = None
    if sentiment > 0:
        senti_word = POS_WORDS[rng.randint(len(POS_WORDS))]
    elif sentiment < 0:
        senti_word = NEG_WORDS[rng.randint(len(NEG_WORDS))]
    i = rng.randint(len(scene))
    j = rng.randint(len(scene))
    while len(scene) > 1 and j == i:
        j = rng.randint(len(scene))
    o1 = noun_phrase(rng, scene[i], senti_word)
    o2 = noun_phrase(rng, scene[j])
    v = VERBS[rng.randint(len(VERBS))]
    p = PREPS[rng.randint(len(PREPS))]
    t = rng.randint(5)
    if t == 0:
        return f"a {o1} {v} {p} the {o2}"
    if t == 1:
        return f"the {o1} {v} {p} a {o2}"
    if t == 2:
        return f"there is a {o1} {p} the {o2}"
    if t == 3:
        return f"a {o1} and a {o2} {v} here"
    return f"the picture shows a {o1} {p} a {o2}"


def write_attribs_dir(path, ann_records):
    """COCO-Attributes pickle index (cocoatts.py schema). attrib2string
    carries the full 204-entry inventory in config_attrib_selection order so
    the reader's positional whitelist filtering lines up exactly."""
    os.makedirs(path, exist_ok=True)
    names = list(attrib_selection.keys())
    pos = {n: i for i, n in enumerate(names)}
    attrib2string = {i: n for i, n in enumerate(names)}

    attrib_inst2attrib_vector = {}
    attrib_inst2obj_inst = {}
    obj_inst2attrib_inst = {}
    obj_inst2image = {}
    image2obj_insts = {}
    obj_inst2obj_id = {}
    obj_id2obj_name = {i + 1: n for i, n in enumerate(SHAPES)}
    for rec in ann_records:
        oi = rec["ann_id"]
        obj_inst2image[oi] = rec["image_id"]
        image2obj_insts.setdefault(rec["image_id"], []).append(oi)
        obj_inst2obj_id[oi] = rec["cat_id"]
        if rec["attrs"]:
            vec = np.zeros((len(names),), np.float32)
            for a in rec["attrs"]:
                vec[pos[a]] = 0.6
            attrib_inst2attrib_vector[oi] = vec
            attrib_inst2obj_inst[oi] = oi
            obj_inst2attrib_inst[oi] = oi

    def dump(name, obj):
        with open(os.path.join(path, name + ".pkl"), "wb") as f:
            pickle.dump(obj, f)

    dump("attrib_inst2attrib_vector", attrib_inst2attrib_vector)
    dump("attrib_inst2obj_inst", attrib_inst2obj_inst)
    dump("obj_inst2attrib_inst", obj_inst2attrib_inst)
    dump("obj_inst2image", obj_inst2image)
    dump("image2obj_insts", image2obj_insts)
    dump("attrib2string", attrib2string)
    dump("obj_inst2obj_id", obj_inst2obj_id)
    dump("obj_id2obj_name", obj_id2obj_name)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code. ``stats``, when given, receives ``images``, ``render_s`` (the
    scenes and pixels on the host) and ``encode_s`` (the image files,
    encoded and written; under JPEG each image is copied to the card,
    encoded there and its bitstream copied back)."""
    args = parser.parse_args(argv)
    device = None
    if args.image_format == "jpeg":
        # refused before anything is written: never PNG in JPEG's place
        if not torch.cuda.is_available():
            raise RuntimeError("--image-format jpeg encodes on the card (libnvjpeg) and no CUDA "
                               "device is available; pass --image-format png to write PNG")
        device = resolve_device(None)
    ext = "jpg" if device is not None else "png"
    render_s = encode_s = 0.0

    out = args.out_dir
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    rng = np.random.RandomState(args.seed)
    h, w = args.height, args.width

    splits = {"train": args.num_train, "val": args.num_val,
              "test": args.num_test}
    categories = [{"id": i + 1, "name": n} for i, n in enumerate(SHAPES)]
    world = {"shapes": SHAPES, "attrs": ATTRS, "pos_words": POS_WORDS,
             "neg_words": NEG_WORDS, "images": {}}
    ann_records = []
    next_img, next_ann = 100001, 1
    split_ids = {}
    for split, count in splits.items():
        images, annotations = [], []
        ids = []
        for _ in range(count):
            iid = next_img
            next_img += 1
            t0 = time.perf_counter()
            scene = sample_scene(rng, h, w)
            img, boxes = render_image(rng, h, w, scene)
            t1 = time.perf_counter()
            fname = f"img_{iid}.{ext}"
            data = (encode_png(img) if device is None
                    else encode_jpeg(torch.from_numpy(img).to(device)))
            with open(os.path.join(out, "images", fname), "wb") as f:
                f.write(data)
            render_s += t1 - t0
            encode_s += time.perf_counter() - t1
            images.append({"id": iid, "file_name": fname,
                           "height": h, "width": w})
            for obj, box in zip(scene, boxes):
                x1, y1, x2, y2 = box
                annotations.append({
                    "id": next_ann, "image_id": iid,
                    "category_id": SHAPES.index(obj["shape"]) + 1,
                    "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                    "area": (x2 - x1 + 1) * (y2 - y1 + 1), "iscrowd": 0})
                ann_records.append({"ann_id": next_ann, "image_id": iid,
                                    "cat_id": SHAPES.index(obj["shape"]) + 1,
                                    "attrs": obj["attrs"]})
                next_ann += 1
            world["images"][str(iid)] = {
                "split": split,
                "scene": [{"shape": o["shape"], "attrs": o["attrs"]}
                          for o in scene]}
            ids.append(iid)
        split_ids[split] = ids
        with open(os.path.join(out, f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)

    write_attribs_dir(os.path.join(out, "attribs"), ann_records)

    # --- captions: N neutral references per train AND test image ---
    def scene_of(iid):
        return [dict(o, cy=0, cx=0, s=0, color=0)
                for o in world["images"][str(iid)]["scene"]]

    for split, fname in (("train", "captions_train.json"),
                         ("val", "captions_val.json"),
                         ("test", "captions_test.json")):
        ann_id, annots = 1, []
        for iid in split_ids[split]:
            for _ in range(args.captions_per_image):
                annots.append({"id": ann_id, "image_id": iid,
                               "caption": caption(rng, scene_of(iid))})
                ann_id += 1
        with open(os.path.join(out, fname), "w") as f:
            json.dump({"annotations": annots}, f)

    # --- senticap: sentiment captions for a subset of train images
    # (training signal) and ALL test images (style references) ---
    senti_train = list(rng.choice(split_ids["train"],
                                  size=min(args.senticap_train,
                                           len(split_ids["train"])),
                                  replace=False))
    senti_images = []
    pos_refs, neg_refs = [], []
    ann_id = 1
    # senticap "val" entries ride on TRAIN images: the captioner's training
    # reader loads train+val splits and only train-split images have rows
    # in features_train.h5 (world-val images are the detector's mAP split)
    senti_val = [i for i in split_ids["train"] if i not in set(senti_train)][:20]
    for split_name, ids in (("train", senti_train),
                            ("val", senti_val),
                            ("test", split_ids["test"])):
        for iid in ids:
            sentences = []
            for senti in (1, 1, 0, 0):   # schema: 1=pos, 0=neg
                raw = caption(rng, scene_of(iid), 1 if senti else -1)
                sentences.append({"raw": raw, "sentiment": senti})
                if split_name == "test":
                    target = pos_refs if senti else neg_refs
                    target.append({"id": ann_id, "image_id": int(iid),
                                   "caption": raw})
                    ann_id += 1
            senti_images.append({
                "filename": f"COCO_train2014_{iid:012d}.jpg",
                "split": split_name, "sentences": sentences})
    with open(os.path.join(out, "senticap_dataset.json"), "w") as f:
        json.dump({"images": senti_images}, f)
    with open(os.path.join(out, "captions_test_pos.json"), "w") as f:
        json.dump({"annotations": pos_refs}, f)
    with open(os.path.join(out, "captions_test_neg.json"), "w") as f:
        json.dump({"annotations": neg_refs}, f)

    # --- wordform TSVs (constraint_wordforms_*.tsv schema) ---
    with open(os.path.join(out, "wordforms_senti.tsv"), "w") as f:
        f.write("pos\t" + ",".join(POS_WORDS) + "\n")
        f.write("neg\t" + ",".join(NEG_WORDS) + "\n")
    with open(os.path.join(out, "wordforms_objects.tsv"), "w") as f:
        for s in SHAPES:
            f.write(f"{s}\t{s},{s}s\n")
    # attribute TSV with pos/neg rows merged — the reference ships ONE
    # merged constraint_wordforms_attrib_senti.tsv as WORDFORMS_ATTRIBS so
    # cbs_simple sentiment constraints resolve (constraints.py:298-327)
    with open(os.path.join(out, "wordforms_attribs.tsv"), "w") as f:
        for a in ATTRS:
            f.write(f"{a}\t{a}\n")
        f.write("pos\t" + ",".join(POS_WORDS) + "\n")
        f.write("neg\t" + ",".join(NEG_WORDS) + "\n")

    # flat Open-Images-style class hierarchy for the CBS constraint filter
    # (constraints.py:155-209 walks LabelName/Subcategory)
    with open(os.path.join(out, "class_hierarchy.json"), "w") as f:
        json.dump({"LabelName": "entity",
                   "Subcategory": [{"LabelName": s} for s in SHAPES]}, f)

    # SentiGloVe-style 10-d latent dictionary (misc/prep_expl_lat_space.py
    # → sentiglove10.pkl; consumed by LatentDictionary.from_sentiglove for
    # mode-2 attribute priors). Deterministic per-word vectors.
    sg_rng = np.random.RandomState(1234)
    sentiglove = {w: sg_rng.randn(10).astype(np.float32)
                  for w in ATTRS + POS_WORDS + NEG_WORDS}
    with open(os.path.join(out, "sentiglove10.pkl"), "wb") as f:
        pickle.dump(sentiglove, f)

    with open(os.path.join(out, "world.json"), "w") as f:
        json.dump(world, f)

    # --- vocabulary from the generated captions ---
    coco_annots = json.load(open(os.path.join(out, "captions_train.json")))
    tokens = build_caption_vocabulary(coco_annots["annotations"], senti_images)
    vocab = Vocabulary(tokens)
    vocab.save_to_files(os.path.join(out, "vocabulary"))

    n_anns = len(ann_records)
    print(json.dumps({
        "out": out, "images": sum(splits.values()), "annotations": n_anns,
        "vocab_size": vocab.get_vocab_size(),
        "senticap_images": len(senti_images)}))
    if stats is not None:
        stats.update(images=sum(splits.values()), render_s=render_s, encode_s=encode_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
