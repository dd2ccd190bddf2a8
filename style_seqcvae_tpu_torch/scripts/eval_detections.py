"""Detection evaluation CLI (counterpart of the JAX package's
``scripts/eval_detections.py``): COCO mAP of a detections file by the
COCOeval protocol (``evaluation/detection_eval.py``), on the host.

    python -m style_seqcvae_tpu_torch.scripts.eval_detections \\
        --detections dets.json --instances-json instances.json [--output o.json]

The detections are COCO results, as the port's extract CLI writes them
with ``--detections-output``. Crowd annotations are left out of the ground
truth. ``--vis-dir`` (drawing the boxes onto the images) is refused: it
draws text with PIL, which the port does not use (ROADMAP A13.5).
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from style_seqcvae_tpu_torch.evaluation.detection_eval import evaluate_detections

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--detections", required=True,
                    help="COCO results JSON from the extract CLI")
parser.add_argument("--instances-json", required=True,
                    help="COCO instances JSON with the ground-truth annotations")
parser.add_argument("--output", default="")
parser.add_argument("--vis-dir", default="",
                    help="not ported: drawing needs PIL (ROADMAP A13.5)")
parser.add_argument("--image-root", default="")
parser.add_argument("--vis-thresh", type=float, default=0.5)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code. ``stats``, when given, receives the result dict."""
    args = parser.parse_args(argv)
    if args.vis_dir:
        parser.error("--vis-dir is not ported: drawing the detections needs PIL, which the "
                     "port does not use (ROADMAP A13.5)")
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
