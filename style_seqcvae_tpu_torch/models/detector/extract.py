"""Bottom-up feature extraction: the detector → captioner bridge
(counterpart of ``style_seqcvae_tpu/models/detector/extract.py`` and of the
``extract_feats`` chain of the JAX bench's end-to-end phase).

Two selections share the reference's algorithm (frcnn/test_net.py:379-482):

* on the device, batched over images: :func:`decode_boxes` (also the host
  path's box decode, on the forward's outputs) and
  :func:`select_detections_device`. The per-class NMS of every (image,
  class) pair runs as one batched call of kernel D on CUDA (its plain
  version on the CPU), so a forward launches kernel D twice: once in the
  proposal layer and once here;
* on the host, one image at a time in numpy: :func:`select_detections`
  and :func:`extraction_row`, the features.h5 writer's path, whose stream
  order is part of the file's schema (class-major, every box tied at the
  cap's score kept). It is the only path for ``class_agnostic`` detectors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from style_seqcvae_tpu_torch.device import as_tensor, resolve_device
from style_seqcvae_tpu_torch.models.detector.defaults import InferenceConfig
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import (
    DetectorConfig,
    detector_forward_test,
)
from style_seqcvae_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from style_seqcvae_tpu_torch.ops.kernels import nms as nms_kernel
from style_seqcvae_tpu_torch.ops.nms import nms_reference
from style_seqcvae_tpu_torch.ops.topk import top_k
from style_seqcvae_tpu_torch.utils.features_io import pack_obj_atts, pack_obj_atts_det
from style_seqcvae_tpu_torch.utils.tracing import DETECT_SELECT, span

_TEST = InferenceConfig()


def decode_boxes(rois_xyxy: torch.Tensor, bbox_pred: torch.Tensor, im_info: torch.Tensor,
                 bbox_normalize_stds: Sequence[float], bbox_normalize_means: Sequence[float],
                 im_scale: torch.Tensor, num_classes: int,
                 class_agnostic: bool = False) -> torch.Tensor:
    """Un-normalize the deltas, apply them, clip to the image and divide by
    its scale: rois (B, P, 4), bbox_pred (B, P, 4k), im_info (B, 3),
    im_scale (B,) → boxes (B, P, 4k) f32 at the original image's scale."""
    reps = 1 if class_agnostic else num_classes
    dev = bbox_pred.device
    stds = torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev).repeat(reps)
    means = torch.tensor(bbox_normalize_means, dtype=torch.float32, device=dev).repeat(reps)
    deltas = bbox_pred.float() * stds + means
    pred = bbox_transform_inv(rois_xyxy.float(), deltas)
    pred = clip_boxes(pred, im_info[:, 0, None, None], im_info[:, 1, None, None])
    return pred / im_scale[:, None, None]


def select_detections(
    scores: np.ndarray,                         # (P, C) softmax
    pred_boxes: np.ndarray,                     # (P, 4C) or (P, 4) decoded, image scale
    pooled_feat: np.ndarray,                    # (P, F)
    scores_atts: Optional[np.ndarray] = None,   # (P, A) sigmoid
    rois_label: Optional[np.ndarray] = None,    # (P,) GT class of each RoI
    gt_atts: Optional[np.ndarray] = None,       # (P, A) GT multi-hot
    *,
    thresh: float = 0.5,
    nms_thresh: float = 0.3,
    max_per_image: int = 100,
    class_agnostic: bool = False,
    start_index: int = 1,
) -> Dict[str, np.ndarray]:
    """The host selection of one image (JAX ``:49-108``): per class, the
    boxes scoring above ``thresh`` through greedy NMS (``nms_reference``),
    then a global cap that keeps every box scoring at least the
    ``max_per_image``-th highest score (ties kept). Returns arrays over the
    selected boxes in class-major order: boxes, scores, class_ids,
    features and, when their inputs are given, att_scores, gt_labels and
    gt_att_rows."""
    C = scores.shape[1]
    per_class: List[Dict[str, np.ndarray]] = []
    for j in range(start_index, C):
        inds = np.where(scores[:, j] > thresh)[0]
        if len(inds) == 0:
            continue
        cls_scores = scores[inds, j]
        order = np.argsort(-cls_scores)
        cls_boxes = pred_boxes[inds, :4] if class_agnostic else pred_boxes[inds, j * 4:(j + 1) * 4]
        keep = nms_reference(cls_boxes[order], cls_scores[order], nms_thresh)
        sel = inds[order][keep]
        entry = {"boxes": cls_boxes[order][keep], "scores": cls_scores[order][keep],
                 "class_ids": np.full(len(keep), j, np.int64), "features": pooled_feat[sel]}
        if scores_atts is not None:
            entry["att_scores"] = scores_atts[sel]
        if rois_label is not None:
            entry["gt_labels"] = np.asarray(rois_label)[sel]
        if gt_atts is not None:
            entry["gt_att_rows"] = np.asarray(gt_atts)[sel]
        per_class.append(entry)

    if not per_class:
        return {k: np.zeros((0,)) for k in ("boxes", "scores", "class_ids", "features")}

    all_scores = np.concatenate([e["scores"] for e in per_class])
    if max_per_image > 0 and len(all_scores) > max_per_image:
        image_thresh = np.sort(all_scores)[-max_per_image]
        per_class = [{k: v[e["scores"] >= image_thresh] for k, v in e.items()}
                     for e in per_class]
    return {k: np.concatenate([e[k] for e in per_class], axis=0) for k in per_class[0]}


def extraction_row(selected: Dict[str, np.ndarray], att_pred_thresh: float = 0.3
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (features, obj_atts, obj_atts_det) row of features.h5 from one
    image's :func:`select_detections` (JAX ``:187-203``): the packed GT
    stream when any selected box has a GT label, and then the packed
    detected-attribute stream at ``att_pred_thresh``."""
    feats = np.asarray(selected.get("features", np.zeros((0, 0))), np.float32)
    labelled = "gt_labels" in selected and np.asarray(selected["gt_labels"]).sum() > 0
    obj_atts = np.zeros((0,), np.uint8)
    if labelled:
        att_lists = [np.nonzero(row)[0] for row in selected["gt_att_rows"]]
        obj_atts = pack_obj_atts(np.asarray(selected["gt_labels"], np.int64), att_lists)
    obj_atts_det = np.zeros((0,), np.float32)
    if "att_scores" in selected and len(selected.get("class_ids", [])) > 0 and labelled:
        obj_atts_det = pack_obj_atts_det(selected["class_ids"], selected["att_scores"],
                                         att_pred_thresh)
    return feats, obj_atts, obj_atts_det


def select_detections_device(scores: torch.Tensor, pred_boxes: torch.Tensor,
                             pooled_feat: torch.Tensor,
                             scores_atts: Optional[torch.Tensor] = None, *,
                             thresh: float = _TEST.score_thresh,
                             nms_thresh: float = _TEST.nms_thresh,
                             max_per_image: int = _TEST.max_per_image,
                             start_index: int = 1) -> Dict[str, torch.Tensor]:
    """Per-class greedy NMS, then the global top ``max_per_image`` by score,
    for each image: scores (B, P, C) softmax, pred_boxes (B, P, 4C),
    pooled_feat (B, P, F), scores_atts (B, P, A) or None.

    Returns fixed-shape tensors over M = min(max_per_image, (C - start) · P)
    rows in descending score order: features (B, M, F) with invalid rows
    zeroed (row 0 all ones when nothing survives), boxes (B, M, 4), scores
    (B, M), class_ids (B, M), valid (B, M) and, with ``scores_atts``,
    att_scores (B, M, A), and roi_index (B, M), the row of P each detection
    came from (0 where invalid)."""
    B, P, C = scores.shape
    if C < 2:
        raise ValueError("class-specific boxes expected")
    ncls = C - start_index
    cls_scores = scores[:, :, start_index:].float().transpose(1, 2)           # (B, ncls, P)
    boxes_pc = pred_boxes.float().reshape(B, P, C, 4).transpose(1, 2)[:, start_index:]
    valid = cls_scores > thresh
    # non-candidates score 0: they sort last and can suppress only each other
    nms_scores = torch.where(valid, cls_scores, 0.0)
    _, keep = nms_kernel.nms(boxes_pc.reshape(B * ncls, P, 4).contiguous(),
                             nms_scores.reshape(B * ncls, P), nms_thresh)
    cand = valid & keep.reshape(B, ncls, P)
    flat = torch.where(cand, cls_scores, -1.0).reshape(B, ncls * P)
    k = min(max_per_image, ncls * P)
    top_s, top_i = top_k(flat, k)
    ok = top_s > -0.5
    box_idx = top_i % P
    Fdim = pooled_feat.shape[-1]
    feats = torch.gather(pooled_feat, 1, box_idx[..., None].expand(B, k, Fdim))
    feats = torch.where(ok[..., None], feats, 0.0)
    # no survivors → a single all-ones row (the zero-detection fallback)
    none = ~ok.any(dim=1)
    feats[:, 0] = torch.where(none[:, None], 1.0, feats[:, 0])
    boxes = torch.gather(boxes_pc.reshape(B, ncls * P, 4), 1, top_i[..., None].expand(B, k, 4))
    out = {
        "features": feats,
        "boxes": torch.where(ok[..., None], boxes, 0.0),
        "scores": torch.where(ok, top_s, 0.0),
        "class_ids": torch.where(ok, top_i // P + start_index, 0),
        "valid": ok,
        "roi_index": torch.where(ok, box_idx, 0),
    }
    if scores_atts is not None:
        att = torch.gather(scores_atts, 1,
                           box_idx[..., None].expand(B, k, scores_atts.shape[-1]))
        out["att_scores"] = torch.where(ok[..., None], att, 0.0)
    return out


@torch.inference_mode()
def extract_device_features(
    params: Dict[str, Any], cfg: DetectorConfig, images, im_info, *,
    max_boxes: int = 100,
    test: InferenceConfig = _TEST,
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Raw canvases → the captioner's per-image box features.

    images (B, H, W, 3) BGR, mean-subtracted, and im_info (B, 3) rows
    (height, width, scale), numpy or tensors; ``params`` already on
    ``device`` (``init_detector`` or ``from_jax_detector_params``). Runs
    ``detector_forward_test`` → :func:`decode_boxes` →
    :func:`select_detections_device` with the settings of ``test``, keeping
    at most ``min(test.max_per_image, max_boxes)`` detections, and zero-pads
    to ``max_boxes`` rows.

    Returns features (B, max_boxes, 2048) in ``dtype`` (what
    ``DecodeHarness.decode_cbs`` takes), and valid, boxes, scores,
    class_ids, roi_index and, with an attribute head, att_scores over the
    same rows, and the proposals they came from, rois (B, P, 5) and
    roi_valid (B, P). The box
    decoding and the selection run in the span ``ssc.detect.select``."""
    dev = resolve_device(device)
    param_dev = params["rpn"]["conv"]["w"].device
    if param_dev.type != dev.type:
        raise ValueError(f"params on {param_dev}, extraction on {dev}")
    if cfg.class_agnostic:
        raise NotImplementedError("the device selection needs class-specific boxes")
    param_dtype = params["rpn"]["conv"]["w"].dtype
    images = as_tensor(images, dev, param_dtype)
    im_info = as_tensor(im_info, dev, torch.float32)
    out = detector_forward_test(params, cfg, images, im_info,
                                post_nms_top_n=test.rpn_post_nms_top_n,
                                pre_nms_top_n=test.rpn_pre_nms_top_n,
                                nms_thresh=test.rpn_nms_thresh)
    with span(DETECT_SELECT):
        pred = decode_boxes(out["rois"][..., 1:5], out["bbox_pred"], im_info,
                            test.bbox_normalize_stds, test.bbox_normalize_means,
                            im_info[:, 2], cfg.num_classes)
        sel = select_detections_device(out["cls_prob"], pred, out["pooled_feat"],
                                       out.get("cls_prob_atts"), thresh=test.score_thresh,
                                       nms_thresh=test.nms_thresh,
                                       max_per_image=min(test.max_per_image, max_boxes))
        pad = max_boxes - sel["valid"].shape[1]
        if pad > 0:
            for key, t in sel.items():
                widths = (0, 0) * (t.dim() - 2) + (0, pad)
                sel[key] = F.pad(t, widths) if t.dtype != torch.bool else \
                    F.pad(t.to(torch.uint8), widths).bool()
        sel["features"] = sel["features"].to(dtype)
    sel["rois"], sel["roi_valid"] = out["rois"], out["roi_valid"]
    return sel
