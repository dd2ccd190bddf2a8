"""Detection evaluation CLI (counterpart of the JAX package's
``scripts/eval_detections.py``): COCO mAP of a detections file by the
COCOeval protocol (``evaluation/detection_eval.py``), on the host, and
optionally the detections drawn onto the images.

    python -m style_seqcvae_tpu_torch.scripts.eval_detections \\
        --detections dets.json --instances-json instances.json [--output o.json] \\
        [--vis-dir V --image-root D [--vis-thresh 0.5] [--cpu]]

The detections are COCO results, as the port's extract CLI writes them
with ``--detections-output``. Crowd annotations are left out of the ground
truth. ``--vis-dir`` draws each image's detections above ``--vis-thresh``
(``utils/visualize.py``, PIL's pixels without PIL) and writes
``V/{image_id}.png``. Images are read from ``--image-root`` by the
instances file's ``file_name`` (default ``{id}.jpg``) and decoded by
``data/image_decode.py``: PNG and PPM on the host, JPEG on the card with
nvjpeg (so on the card unless ``--cpu`` is given; under ``--cpu`` a JPEG
raises ``ImageFormatError``). A file that is missing is counted and
skipped, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.data.image_decode import ImageFormatError, decode_image_bgr
from style_seqcvae_tpu_torch.data.image_encode import encode_png
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.evaluation.detection_eval import evaluate_detections
from style_seqcvae_tpu_torch.utils.visualize import check_label, vis_image_detections

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--detections", required=True,
                    help="COCO results JSON from the extract CLI")
parser.add_argument("--instances-json", required=True,
                    help="COCO instances JSON with the ground-truth annotations")
parser.add_argument("--output", default="")
parser.add_argument("--vis-dir", default="",
                    help="draw boxes onto each image named in the detections (requires "
                         "--image-root) and save annotated PNGs here")
parser.add_argument("--image-root", default="",
                    help="directory holding the raw images for --vis-dir")
parser.add_argument("--vis-thresh", type=float, default=0.5)
parser.add_argument("--cpu", action="store_true",
                    help="decode the images on the CPU (PNG and PPM; a JPEG raises)")


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code. ``stats``, when given, receives the result dict and, with
    ``--vis-dir``, ``vis_written``, ``vis_missing`` and the host clock
    seconds of the images' ``decode_s`` (read, decode, fetch), ``draw_s``
    and ``encode_s`` (PNG encode and write)."""
    args = parser.parse_args(argv)
    if args.vis_dir and not args.image_root:
        parser.error("--vis-dir needs --image-root (without it every image path check fails "
                     "and zero PNGs are written)")
    # the card decodes the JPEGs: without one the run stops here, not after the mAP
    device = resolve_device("cpu" if args.cpu else None) if args.vis_dir else None
    with open(args.detections) as f:
        dets = json.load(f)
    with open(args.instances_json) as f:
        gt = json.load(f)
    cat_ids = [c["id"] for c in gt["categories"]]
    anns = [a for a in gt["annotations"] if not a.get("iscrowd", 0)]
    out = evaluate_detections(dets, anns, cat_ids)
    print(f"mAP@[.5:.95]: {out['mAP']:.4f}")
    print(f"AP50:         {out['AP50']:.4f}")
    print(f"AP75:         {out['AP75']:.4f}")
    for cid, ap in sorted(out["AP_per_class"].items()):
        name = next((c["name"] for c in gt["categories"] if c["id"] == cid), cid)
        print(f"  {name}: {ap:.4f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
    if stats is not None:
        stats.update(out)
    if args.vis_dir:
        vis = write_visualizations(dets, gt, args.vis_dir, args.image_root, args.vis_thresh,
                                   device)
        if stats is not None:
            stats.update(vis)
    return 0


def write_visualizations(dets: List[Dict[str, Any]], gt: Dict[str, Any], vis_dir: str,
                         image_root: str, thresh: float, device: torch.device
                         ) -> Dict[str, Any]:
    """Draw each image's detections and write ``vis_dir/{image_id}.png``
    (JAX ``scripts/eval_detections.py:48-84``); prints the summary line.
    Returns the counts and the host seconds by part."""
    os.makedirs(vis_dir, exist_ok=True)
    names = {c["id"]: c["name"] for c in gt["categories"]}
    # id-indexed list for vis_image_detections (COCO ids are sparse)
    names_list = [names.get(i, str(i)) for i in range(max(names, default=0) + 1)]
    for cid in sorted({d["category_id"] for d in dets}):
        if cid < len(names_list):
            check_label(names_list[cid])
    files = {im["id"]: im.get("file_name", f"{im['id']}.jpg") for im in gt.get("images", [])}
    by_image: Dict[Any, List[Dict[str, Any]]] = {}
    for d in dets:
        by_image.setdefault(d["image_id"], []).append(d)
    st = {"vis_written": 0, "vis_missing": 0, "decode_s": 0.0, "draw_s": 0.0, "encode_s": 0.0}
    for image_id, img_dets in by_image.items():
        path = os.path.join(image_root, files.get(image_id, ""))
        if not os.path.isfile(path):
            st["vis_missing"] += 1
            continue
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            data = f.read()
        try:
            bgr = decode_image_bgr(data, device)
        except ImageFormatError as e:
            raise ImageFormatError(f"{path}: {e}") from None
        # the decoded values are whole numbers 0-255: the cast is exact
        img = bgr.flip(-1).to(torch.uint8).cpu().numpy()
        t1 = time.perf_counter()
        boxes = np.asarray([[d["bbox"][0], d["bbox"][1], d["bbox"][0] + d["bbox"][2],
                             d["bbox"][1] + d["bbox"][3]] for d in img_dets], np.float32)
        scores = np.asarray([d["score"] for d in img_dets], np.float32)
        labels = np.asarray([d["category_id"] for d in img_dets])
        out_img = vis_image_detections(img, boxes, scores, labels, names_list, thresh=thresh)
        t2 = time.perf_counter()
        with open(os.path.join(vis_dir, f"{image_id}.png"), "wb") as f:
            f.write(encode_png(out_img))
        t3 = time.perf_counter()
        st["decode_s"] += t1 - t0
        st["draw_s"] += t2 - t1
        st["encode_s"] += t3 - t2
        st["vis_written"] += 1
    print(f"wrote {st['vis_written']} visualization(s) to {vis_dir}"
          + (f" ({st['vis_missing']} image file(s) not found under {image_root})"
             if st["vis_missing"] else ""))
    return st


if __name__ == "__main__":
    raise SystemExit(main())
