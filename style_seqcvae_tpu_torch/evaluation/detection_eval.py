"""COCO-style detection evaluation, numpy (a copy of
``style_seqcvae_tpu/evaluation/detection_eval.py``).

Average precision per class by the COCOeval protocol: 101-point
interpolated precision at IoU thresholds .5:.05:.95, area all, at most 100
detections per image; the summary mAP, AP50 and AP75.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU of det (D, 4) and gt (G, 4) in xywh (COCO's convention, no +1)."""
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    inter_w = np.clip(np.minimum(dx2[:, None], gx2[None, :])
                      - np.maximum(dx1[:, None], gx1[None, :]), 0, None)
    inter_h = np.clip(np.minimum(dy2[:, None], gy2[None, :])
                      - np.maximum(dy1[:, None], gy1[None, :]), 0, None)
    inter = inter_w * inter_h
    areas_d = det[:, 2] * det[:, 3]
    areas_g = gt[:, 2] * gt[:, 3]
    return inter / (areas_d[:, None] + areas_g[None, :] - inter + 1e-12)


def evaluate_detections(detections: List[dict], ground_truth: List[dict],
                        category_ids: Sequence[int], max_dets: int = 100) -> Dict[str, float]:
    """detections: COCO results [{image_id, category_id, bbox (xywh),
    score}]; ground_truth: COCO annotations [{image_id, category_id, bbox}].

    Returns {"mAP", "AP50", "AP75", "AP_per_class": {category id: AP}}."""
    gt_by_img_cat: Dict = {}
    for g in ground_truth:
        gt_by_img_cat.setdefault((g["image_id"], g["category_id"]), []).append(g)
    det_by_cat: Dict = {}
    for d in detections:
        det_by_cat.setdefault(d["category_id"], []).append(d)

    image_ids = sorted({g["image_id"] for g in ground_truth})
    ap_per_class: Dict[int, float] = {}
    ap50_per_class: Dict[int, float] = {}
    ap75_per_class: Dict[int, float] = {}

    for cid in category_ids:
        n_gt = sum(len(gt_by_img_cat.get((i, cid), [])) for i in image_ids)
        if n_gt == 0:
            continue
        dets = sorted(det_by_cat.get(cid, []), key=lambda d: -d["score"])
        # at most max_dets per image, the best first
        capped: Dict[int, int] = {}
        dets_kept = []
        for d in dets:
            c = capped.get(d["image_id"], 0)
            if c < max_dets:
                dets_kept.append(d)
                capped[d["image_id"]] = c + 1
        D = len(dets_kept)
        tps = np.zeros((len(IOU_THRESHOLDS), D), bool)
        matched: Dict = {t: {} for t in range(len(IOU_THRESHOLDS))}
        for di, d in enumerate(dets_kept):
            gts = gt_by_img_cat.get((d["image_id"], cid), [])
            if not gts:
                continue
            ious = _iou_xywh(np.asarray([d["bbox"]], np.float64),
                             np.asarray([g["bbox"] for g in gts], np.float64))[0]
            for ti, thr in enumerate(IOU_THRESHOLDS):
                used = matched[ti].setdefault(d["image_id"], set())
                best, best_iou = -1, thr
                for gi, iou in enumerate(ious):
                    if gi not in used and iou >= best_iou:
                        best, best_iou = gi, iou
                if best >= 0:
                    used.add(best)
                    tps[ti, di] = True

        aps = np.zeros(len(IOU_THRESHOLDS))
        # no detections: AP 0 at every threshold
        for ti in range(len(IOU_THRESHOLDS) if D else 0):
            tp = np.cumsum(tps[ti])
            fp = np.cumsum(~tps[ti])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-12)
            # the monotone precision envelope, read at 101 recall points
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            prec_at = np.where(idx < len(precision),
                               precision[np.clip(idx, 0, max(len(precision) - 1, 0))], 0.0)
            aps[ti] = prec_at.mean()

        ap_per_class[cid] = float(aps.mean())
        ap50_per_class[cid] = float(aps[0])
        ap75_per_class[cid] = float(aps[5])

    if not ap_per_class:
        return {"mAP": 0.0, "AP50": 0.0, "AP75": 0.0, "AP_per_class": {}}
    return {
        "mAP": float(np.mean(list(ap_per_class.values()))),
        "AP50": float(np.mean(list(ap50_per_class.values()))),
        "AP75": float(np.mean(list(ap75_per_class.values()))),
        "AP_per_class": ap_per_class,
    }
