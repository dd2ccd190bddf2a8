"""Bottom-up feature and attribute extraction (counterpart of the JAX
package's ``scripts/extract_features.py``, itself a mirror of
frcnn/test_net.py --feat_extract, :311-542).

    python -m style_seqcvae_tpu_torch.scripts.extract_features \\
        --instances-json instances.json --image-root images/ \\
        --checkpoint-path detector.npz --output features.h5 [--cpu]

Images are decoded (``data/image_decode.py``: PNG and PPM on the host, JPEG
on the card), mean-subtracted and resized on the device, bucketed by
``canvas_for`` and padded by repetition to ``--batch-size``. Each batch runs
``detector_forward_test`` (kernels C and D on the card) and the box decode
on the device, and its outputs are fetched to the host once; then, per
image, as the JAX CLI: the nearest-GT labels at IoU >= 0.5,
``select_detections`` at ``--thresh``, ``extraction_row``, and an all-zero
row when nothing is selected. Rows go to features.h5 through
``FeaturesWriter``, detections to ``--detections-output`` (COCO results).

Flags are the JAX CLI's. ``--checkpoint-path`` names a ``.npz`` of the JAX
detector tree (``weights.save_params_npz``) or a reference ``.pth``
(``weights.load_detector_params``); Orbax directories are refused. Without
it the weights are ``init_detector``'s, seeded 0 (not JAX's PRNGKey(0)
draws). An image that the decoder refuses or finds corrupt, or that cannot
be read, gets the JAX CLI's all-zero row; any other error, a CUDA one
included, stops the run. It runs on ``cuda`` unless ``--cpu`` is given, and
raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.detection import (
    CocoDetectionDataset,
    canvas_for,
    load_image_bgr,
    make_batch,
    prepare_image,
)
from style_seqcvae_tpu_torch.data.image_decode import ImageError
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.detector.extract import (
    decode_boxes,
    extraction_row,
    select_detections,
)
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import (
    DetectorConfig,
    detector_forward_test,
    init_detector,
)
from style_seqcvae_tpu_torch.ops.boxes import bbox_overlaps
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter
from style_seqcvae_tpu_torch.weights import load_detector_params

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--instances-json", required=True)
parser.add_argument("--image-root", default="")
parser.add_argument("--attribs-dir", default="")
parser.add_argument("--senticap-json", default="")
parser.add_argument("--checkpoint-path", default="",
                    help="a .npz of the JAX detector tree (weights.save_params_npz) or a "
                         "reference .pth; Orbax directories are refused")
parser.add_argument("--checkpoint-name", default="",
                    help="names an Orbax checkpoint in the JAX CLI; refused here")
parser.add_argument("--output", default="features.h5")
parser.add_argument("--detections-output", default="",
                    help="also write COCO-results-format detections JSON")
parser.add_argument("--canvas", type=int, nargs=2, default=[640, 1024])
parser.add_argument("--batch-size", type=int, default=16,
                    help="images per detector forward (grouped by canvas orientation)")
parser.add_argument("--max-images", type=int, default=0)
parser.add_argument("--depth", type=int, default=101, choices=[50, 101],
                    help="ResNet depth")
parser.add_argument("--thresh", type=float, default=0.5)
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions)")
parser.add_argument("--config-override", nargs="*", default=[])

# what an unreadable image costs: the JAX CLI's all-zero row (test_net.py:313-318)
_SKIPPED = (ImageError, OSError)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the
    exit code. ``stats``, when given, receives ``images``, ``skipped``,
    ``batches``, ``detections`` (per written image) and host clock seconds:
    ``setup_s``, ``decode_prepare_s`` (reading, decoding, resizing),
    ``forward_s`` (batching, the forward, the box decode, the IoUs and the
    fetch to the host), ``post_s`` (selection and packing), ``write_s``
    and ``wall_s``."""
    _A = parser.parse_args(argv)
    if _A.checkpoint_name:
        parser.error("--checkpoint-name names an Orbax checkpoint, which the port does not "
                     "read: pass a .npz of the detector tree or a .pth as --checkpoint-path")
    device = resolve_device("cpu" if _A.cpu else None)
    t_start = time.perf_counter()
    st: Dict[str, Any] = {k: 0.0 for k in ("decode_prepare_s", "forward_s", "post_s",
                                           "write_s")}
    st.update(batches=0, detections=[])

    _C = Config(config_override=_A.config_override)
    D = _C.DET
    dataset = CocoDetectionDataset(_A.instances_json, _A.image_root, _A.senticap_json,
                                   _A.attribs_dir, exclude_senticap_test=False)
    det_cfg = DetectorConfig(
        num_classes=dataset.num_classes, num_att_classes=dataset.n_attribs, depth=_A.depth,
        pooling_mode=D.POOLING_MODE, anchor_scales=tuple(D.ANCHOR_SCALES),
        anchor_ratios=tuple(D.ANCHOR_RATIOS))
    if _A.checkpoint_path:
        params = load_detector_params(_A.checkpoint_path, depth=_A.depth,
                                      num_anchors=det_cfg.num_anchors, device=device)
    else:
        params = init_detector(det_cfg, seed=0, device=device)

    n_images = len(dataset) if not _A.max_images else min(_A.max_images, len(dataset))
    writer = FeaturesWriter(_A.output, n_images)
    all_detections: List[Dict[str, Any]] = []
    class_to_cat = {v: k for k, v in dataset.cat_id_to_class.items()}
    n_atts = max(dataset.n_attribs, 1)
    st["setup_s"] = time.perf_counter() - t_start

    def write(i: int, image_id: int, feats, oa, oad) -> None:
        t0 = time.perf_counter()
        writer.write(i, image_id, feats, oa, oad)
        st["write_s"] += time.perf_counter() - t0

    @torch.inference_mode()
    def forward(canvas, items):
        """One detector forward over the bucket, padded by repeating its last
        image; returns the batch and its outputs on the host."""
        while len(items) < bs:
            items.append(items[-1])
        batch = make_batch([it[1] for it in items], [it[2] for it in items],
                           [it[3] for it in items], canvas, D.MAX_NUM_GT_BOXES, n_atts)
        im_info = batch["im_info"]
        out = detector_forward_test(params, det_cfg, batch["images"], im_info,
                                    post_nms_top_n=D.TEST.RPN_POST_NMS_TOP_N,
                                    pre_nms_top_n=D.TEST.RPN_PRE_NMS_TOP_N,
                                    nms_thresh=D.TEST.RPN_NMS_THRESH)
        rois = out["rois"][..., 1:5]
        fetch = {"pred_boxes": decode_boxes(rois, out["bbox_pred"], im_info,
                                            D.TRAIN.BBOX_NORMALIZE_STDS,
                                            D.TRAIN.BBOX_NORMALIZE_MEANS, im_info[:, 2],
                                            dataset.num_classes),
                 # GT label assignment: IoU of every RoI with every GT box
                 "ious": bbox_overlaps(rois, batch["gt_boxes"][..., :4]),
                 **{k: out[k] for k in ("cls_prob", "pooled_feat", "cls_prob_atts")
                    if k in out}}
        # one device-to-host transfer per field
        host = {k: v.cpu().numpy() for k, v in fetch.items()}
        return {k: v.cpu().numpy() for k, v in batch.items() if k != "images"}, host

    def postprocess(i: int, rec, batch, out, b: int) -> None:
        """The per-image host post: nearest-GT labels, selection, the row."""
        t0 = time.perf_counter()
        n_gt = int(batch["num_gt"][b])
        rois_label = gt_att_rows = None
        if n_gt:
            ious = out["ious"][b][:, :n_gt]
            best, best_iou = ious.argmax(axis=1), ious.max(axis=1)
            gt = batch["gt_boxes"][b]
            rois_label = np.where(best_iou >= 0.5, gt[best, 4], 0).astype(np.int64)
            gt_att_rows = np.where(best_iou[:, None] >= 0.5, batch["gt_atts"][b][best], 0.0)
        selected = select_detections(
            out["cls_prob"][b], out["pred_boxes"][b], out["pooled_feat"][b],
            scores_atts=out["cls_prob_atts"][b] if "cls_prob_atts" in out else None,
            rois_label=rois_label, gt_atts=gt_att_rows, thresh=_A.thresh,
            nms_thresh=D.TEST.NMS, max_per_image=D.TEST.MAX_PER_IMAGE)
        feats, oa, oad = extraction_row(selected, _C.DATA.ATT_PRED_THRESH)
        if feats.size == 0:
            feats = np.zeros((1, 2048), np.float32)
        n_det = len(selected.get("boxes", []))
        if _A.detections_output and n_det:
            for box, score, cls in zip(selected["boxes"], selected["scores"],
                                       selected["class_ids"]):
                x1, y1, x2, y2 = [float(v) for v in box]
                all_detections.append({"image_id": int(rec["image_id"]),
                                       "category_id": int(class_to_cat[int(cls)]),
                                       "bbox": [x1, y1, x2 - x1, y2 - y1],
                                       "score": float(score)})
        st["post_s"] += time.perf_counter() - t0
        st["detections"].append(n_det)
        write(i, rec["image_id"], feats, oa, oad)

    bs = max(_A.batch_size, 1)
    done = [0]

    def flush(canvas, items):
        n_real = len(items)
        t0 = time.perf_counter()
        batch, out = forward(canvas, items)
        st["forward_s"] += time.perf_counter() - t0
        st["batches"] += 1
        for b in range(n_real):
            postprocess(items[b][0], items[b][1], batch, out, b)
        done[0] += n_real
        if done[0] // 20 != (done[0] - n_real) // 20:
            print(f"{done[0]}/{n_images} images")

    skipped = 0
    buckets: Dict[Any, list] = {}
    for i in range(n_images):
        rec = dataset.record(i)
        t0 = time.perf_counter()
        try:
            img = load_image_bgr(rec["file_name"], device)
        except _SKIPPED as e:
            print(f"skip {rec['image_id']}: {e}")
            skipped += 1
            write(i, rec["image_id"], np.zeros((1, 2048), np.float32),
                  np.zeros((0,), np.uint8), np.zeros((0,), np.float32))
            continue
        img, scale = prepare_image(img, D.TEST.SCALES[0], D.TEST.MAX_SIZE)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        st["decode_prepare_s"] += time.perf_counter() - t0
        canvas = canvas_for(rec, tuple(_A.canvas))
        buckets.setdefault(canvas, []).append((i, rec, img, scale))
        if len(buckets[canvas]) == bs:
            flush(canvas, buckets.pop(canvas))
    for canvas, items in sorted(buckets.items()):
        flush(canvas, items)
    t0 = time.perf_counter()
    writer.close()
    st["write_s"] += time.perf_counter() - t0
    print(f"wrote {n_images} rows ({skipped} skipped) to {_A.output}")
    if _A.detections_output:
        with open(_A.detections_output, "w") as f:
            json.dump(all_detections, f)
        print(f"wrote {len(all_detections)} detections to {_A.detections_output}")
    if stats is not None:
        stats.update(st, images=n_images, skipped=skipped,
                     wall_s=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
