"""Faster R-CNN with the per-RoI attribute head, inference forward
(counterpart of ``style_seqcvae_tpu/models/detector/faster_rcnn.py``).

backbone (ResNet C4) → RPN → proposal layer → RoIAlign → layer4 + global
average pool (the 2048-d bottom-up feature) → class softmax, class-specific
box deltas and sigmoid attribute scores. RoIAlign is kernel C
(``ops/kernels/roi_align.py``) on CUDA and its plain version on the CPU.

Parameters are a plain dict in the JAX package's nesting: ``resnet``
(``conv1``, ``bn1``, ``layer1`` .. ``layer4``), ``rpn`` (``conv``, ``cls``,
``bbox``), ``cls_score``, ``bbox_pred`` and ``cls_score_atts`` ({"w": (in,
out), "b": (out,)}).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.detector import resnet
from style_seqcvae_tpu_torch.models.detector.defaults import InferenceConfig
from style_seqcvae_tpu_torch.models.detector.rpn import (
    anchors_for,
    init_rpn,
    proposal_layer,
    rpn_heads,
)
from style_seqcvae_tpu_torch.ops.kernels import roi_align as roi_align_kernel

_TEST = InferenceConfig()


class DetectorConfig(NamedTuple):
    """The architecture (the JAX package's ``DetectorConfig`` without its
    training-only fields: the RPN's and the RoI sampler's training settings,
    the class-balanced losses and remat)."""
    num_classes: int = 81
    num_att_classes: int = 196
    backbone: str = "resnet"            # "resnet" | "vgg16" (vgg16 not ported yet)
    depth: int = 101
    pooling_mode: str = "align"          # "align" | "crop" | "pool" (align only so far)
    pooling_size: int = 7
    feat_stride: int = 16
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    class_agnostic: bool = False

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


def _require_ported(cfg: DetectorConfig) -> None:
    if cfg.backbone != "resnet":
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} is not ported yet (ROADMAP A8.1, the VGG16 backbone)")
    if cfg.pooling_mode != "align":
        raise NotImplementedError(
            f"pooling_mode {cfg.pooling_mode!r} is not ported yet (ROADMAP A8.2, "
            "roi_pool and roi_crop)")


def init_detector(cfg: DetectorConfig, *, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None,
                  dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``: the
    JAX package's shapes and init ranges, not its numbers (use
    ``weights.from_jax_detector_params`` for those)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "resnet": resnet.init_resnet(gen, cfg.depth, device=dev, dtype=dtype),
        "rpn": init_rpn(gen, 1024, cfg.num_anchors, device=dev, dtype=dtype),
    }

    def linear(fan_in, out, std):
        w = torch.randn((fan_in, out), generator=gen, device=dev) * std
        return {"w": w.to(dtype), "b": torch.zeros((out,), device=dev, dtype=dtype)}

    params["cls_score"] = linear(2048, cfg.num_classes, 0.01)
    params["bbox_pred"] = linear(2048, 4 if cfg.class_agnostic else 4 * cfg.num_classes,
                                 0.001)
    if cfg.num_att_classes:
        params["cls_score_atts"] = linear(2048, cfg.num_att_classes, 0.01)
    return params


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def _backbone(params: Dict[str, Any], cfg: DetectorConfig, images: torch.Tensor
              ) -> torch.Tensor:
    _require_ported(cfg)
    return resnet.backbone(params["resnet"], images)


def _pool_rois(params: Dict[str, Any], cfg: DetectorConfig, base_feat: torch.Tensor,
               rois_flat: torch.Tensor) -> torch.Tensor:
    """RoIAlign of (R, 5) rois over the C4 map, then layer4 + GAP → (R, 2048)."""
    _require_ported(cfg)
    pooled = roi_align_kernel.roi_align(
        base_feat.contiguous(), rois_flat.float().contiguous(),
        spatial_scale=1.0 / cfg.feat_stride, pooled_height=cfg.pooling_size,
        pooled_width=cfg.pooling_size, sampling_ratio=2)
    return resnet.head_to_tail(params["resnet"], pooled.to(base_feat.dtype))


def detector_forward_test(params: Dict[str, Any], cfg: DetectorConfig,
                          images: torch.Tensor, im_info: torch.Tensor,
                          post_nms_top_n: int = _TEST.rpn_post_nms_top_n,
                          pre_nms_top_n: int = _TEST.rpn_pre_nms_top_n,
                          nms_thresh: float = _TEST.rpn_nms_thresh) -> Dict[str, torch.Tensor]:
    """Inference forward. images (B, H, W, 3), im_info (B, 3) rows (height,
    width, scale), both on the params' device.

    Returns rois (B, P, 5), roi_valid (B, P), cls_prob (B, P, C), bbox_pred
    (B, P, 4C), pooled_feat (B, P, 2048) and, with an attribute head,
    cls_prob_atts (B, P, A)."""
    B = images.shape[0]
    base_feat = _backbone(params, cfg, images)
    anchors = anchors_for(base_feat.shape[1], base_feat.shape[2], cfg.feat_stride,
                          cfg.anchor_scales, cfg.anchor_ratios, base_feat.device)
    cls_logits, bbox_deltas = rpn_heads(params["rpn"], base_feat)
    rois, _, roi_valid = proposal_layer(
        cls_logits, bbox_deltas, anchors, im_info, pre_nms_top_n=pre_nms_top_n,
        post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh)

    P = rois.shape[1]
    pooled_feat = _pool_rois(params, cfg, base_feat, rois.reshape(B * P, 5))
    cls_prob = torch.softmax(_linear(params["cls_score"], pooled_feat), dim=-1)
    bbox_pred = _linear(params["bbox_pred"], pooled_feat)
    out = {
        "rois": rois, "roi_valid": roi_valid,
        "cls_prob": cls_prob.reshape(B, P, -1),
        "bbox_pred": bbox_pred.reshape(B, P, -1),
        "pooled_feat": pooled_feat.reshape(B, P, -1),
    }
    if cfg.num_att_classes:
        out["cls_prob_atts"] = torch.sigmoid(
            _linear(params["cls_score_atts"], pooled_feat)).reshape(B, P, -1)
    return out
