"""Bottom-up feature extraction on the device: the detector → captioner
bridge (counterpart of ``style_seqcvae_tpu/models/detector/extract.py``'s
``decode_boxes_jax`` and ``select_detections_device``, and of the
``extract_feats`` chain of the JAX bench's end-to-end phase).

Both functions are batched over images. The per-class NMS of every (image,
class) pair runs as one batched call of kernel D on CUDA (its plain version
on the CPU), so a forward launches kernel D twice: once in the proposal
layer and once here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

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
from style_seqcvae_tpu_torch.ops.topk import top_k

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
    att_scores (B, M, A)."""
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
    class_ids and, with an attribute head, att_scores over the same rows."""
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
    pred = decode_boxes(out["rois"][..., 1:5], out["bbox_pred"], im_info,
                        test.bbox_normalize_stds, test.bbox_normalize_means, im_info[:, 2],
                        cfg.num_classes)
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
    return sel
