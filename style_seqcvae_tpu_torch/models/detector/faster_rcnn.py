"""Faster R-CNN with the per-RoI attribute head: the inference and the
training forward (counterpart of
``style_seqcvae_tpu/models/detector/faster_rcnn.py``).

backbone (ResNet C4 or VGG16) → RPN → proposal layer → [training: anchor
targets and RoI sampling] → RoI pooling (``align``, ``pool`` or ``crop``) →
the head (ResNet layer4 + global average pool, 2048-d; or VGG fc6 / fc7,
4096-d) → class softmax, class-specific box deltas and sigmoid attribute
scores. RoIAlign is kernel C (``ops/kernels/roi_align.py``) on CUDA, with
the backward kernel for its gradient, and its plain version on the CPU;
``pool`` and ``crop`` are plain PyTorch (no TPU kernel lies behind them).

Training (:func:`detector_forward_train`) returns the reference's losses:
the RPN's cross entropy and smooth-L1 (sigma 3), the RCNN's cross entropy
and smooth-L1 (sigma 1, the assigned class's deltas), and the class-balanced
attribute loss over the RoIs that carry attributes; ``total`` weighs the
attribute loss by ``att_loss_weight``. JAX draws the sampling's uniforms
from a PRNG key; here they are one :class:`TrainDraws` (or a
``torch.Generator`` to draw them from). Under ``remat`` every ResNet
bottleneck is recomputed in the backward (``torch.utils.checkpoint``). JAX
also splits RoIAlign into chunks under ``remat``, because its XLA gather
materialises the corner tensor; kernel C and its backward never do, so the
port does not chunk.

Parameters are a plain dict in the JAX package's nesting: ``resnet``
(``conv1``, ``bn1``, ``layer1`` .. ``layer4``) or ``vgg`` (``convs``,
``fc6``, ``fc7``), ``rpn`` (``conv``, ``cls``, ``bbox``), ``cls_score``,
``bbox_pred`` and ``cls_score_atts`` ({"w": (in, out), "b": (out,)}). As in
JAX, VGG16 has no attribute head, so it runs with ``num_att_classes=0``
only (a ``ValueError`` says so).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.detector import resnet, vgg
from style_seqcvae_tpu_torch.models.detector.defaults import InferenceConfig
from style_seqcvae_tpu_torch.models.detector.layers import linear_f32
from style_seqcvae_tpu_torch.models.detector.rpn import (
    RPNConfig,
    anchor_target,
    anchors_for,
    init_rpn,
    proposal_layer,
    rpn_heads,
    rpn_losses,
    smooth_l1_loss,
)
from style_seqcvae_tpu_torch.models.detector.targets import (
    ProposalTargetConfig,
    proposal_target,
)
from style_seqcvae_tpu_torch.ops.kernels import roi_align as roi_align_kernel
from style_seqcvae_tpu_torch.ops.roi_align import roi_pool
from style_seqcvae_tpu_torch.ops.roi_crop import roi_crop
from style_seqcvae_tpu_torch.parallel.collectives import global_sum, world_size
from style_seqcvae_tpu_torch.utils.tracing import (
    DETECT_BACKBONE,
    DETECT_ROI_HEAD,
    DETECT_RPN,
    span,
)

_TEST = InferenceConfig()


class DetectorConfig(NamedTuple):
    """The architecture and the training settings (JAX ``:40-57``)."""
    num_classes: int = 81
    num_att_classes: int = 196
    backbone: str = "resnet"            # "resnet" | "vgg16" (no attribute head on vgg16)
    depth: int = 101
    pooling_mode: str = "align"          # "align" | "crop" | "pool"
    pooling_size: int = 7
    feat_stride: int = 16
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    class_agnostic: bool = False
    rpn: RPNConfig = RPNConfig()
    pt: ProposalTargetConfig = ProposalTargetConfig()
    cb_beta: float = 0.9
    cb_gamma: float = 1.0                # the focal modulator's exponent
    cb_loss_type: str = "sigmoid"        # "sigmoid" | "focal" | "softmax"
    att_loss_weight: float = 0.5
    remat: bool = False                  # recompute the backbone's bottlenecks

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


class TrainDraws(NamedTuple):
    """The uniforms in [0, 1) of one training step's sampling: the anchor
    targets' foreground and background priorities (B, N anchors) and the
    RoI sampler's foreground priorities (B, P proposals) and background
    picks (B, R RoIs)."""
    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


def draw_train_uniforms(gen: torch.Generator, batch: int, anchors: int, proposals: int,
                        rois: int, device) -> TrainDraws:
    """One step's :class:`TrainDraws` from ``gen`` (on ``device``)."""
    def u(n):
        return torch.rand((batch, n), generator=gen, device=device)

    return TrainDraws(u(anchors), u(anchors), u(proposals), u(rois))


def _check_cfg(cfg: DetectorConfig) -> None:
    if cfg.backbone not in ("resnet", "vgg16"):
        raise ValueError(f"unknown backbone {cfg.backbone!r}")
    if cfg.pooling_mode not in ("align", "crop", "pool"):
        raise ValueError(f"unknown pooling_mode {cfg.pooling_mode!r}")
    if cfg.backbone == "vgg16" and cfg.num_att_classes:
        raise ValueError("the vgg16 detector has no attribute head (as the JAX package's): "
                         "use num_att_classes=0")


def init_detector(cfg: DetectorConfig, *, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None,
                  dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``: the
    JAX package's shapes and init ranges, not its numbers (use
    ``weights.from_jax_detector_params`` for those)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.backbone == "vgg16":
        params: Dict[str, Any] = {
            "vgg": vgg.init_vgg16(gen, device=dev, dtype=dtype),
            "rpn": init_rpn(gen, 512, cfg.num_anchors, device=dev, dtype=dtype)}
    else:
        params = {"resnet": resnet.init_resnet(gen, cfg.depth, device=dev, dtype=dtype),
                  "rpn": init_rpn(gen, 1024, cfg.num_anchors, device=dev, dtype=dtype)}

    def linear(fan_in, out, std):
        w = torch.randn((fan_in, out), generator=gen, device=dev) * std
        return {"w": w.to(dtype), "b": torch.zeros((out,), device=dev, dtype=dtype)}

    feat_dim = 4096 if cfg.backbone == "vgg16" else 2048
    params["cls_score"] = linear(feat_dim, cfg.num_classes, 0.01)
    params["bbox_pred"] = linear(feat_dim, 4 if cfg.class_agnostic else 4 * cfg.num_classes,
                                 0.001)
    if cfg.num_att_classes:
        params["cls_score_atts"] = linear(feat_dim, cfg.num_att_classes, 0.01)
    return params


def _backbone(params: Dict[str, Any], cfg: DetectorConfig, images: torch.Tensor
              ) -> torch.Tensor:
    _check_cfg(cfg)
    if cfg.backbone == "vgg16":
        return vgg.backbone(params["vgg"], images)
    return resnet.backbone(params["resnet"], images, remat=cfg.remat)


def _pool_rois(params: Dict[str, Any], cfg: DetectorConfig, base_feat: torch.Tensor,
               rois_flat: torch.Tensor) -> torch.Tensor:
    """RoI pooling of (R, 5) rois over the backbone's map, then the head:
    (R, 2048) for ResNet, (R, 4096) for VGG16."""
    kw = dict(spatial_scale=1.0 / cfg.feat_stride, pooled_height=cfg.pooling_size,
              pooled_width=cfg.pooling_size)
    rois_flat = rois_flat.float().contiguous()
    if cfg.pooling_mode == "align":
        pooled = roi_align_kernel.roi_align(base_feat.contiguous(), rois_flat,
                                            sampling_ratio=2, **kw)
    elif cfg.pooling_mode == "crop":
        pooled = roi_crop(base_feat, rois_flat, max_pool=True, **kw)
    else:
        pooled = roi_pool(base_feat, rois_flat, **kw)
    pooled = pooled.to(base_feat.dtype)
    if cfg.backbone == "vgg16":
        return vgg.head_to_tail(params["vgg"], pooled)
    return resnet.head_to_tail(params["resnet"], pooled)


def _stable_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``binary_cross_entropy_with_logits``, no reduction."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) for every x (JAX's ``logaddexp(x, 0)``)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _cb_example_weights(labels_mh: torch.Tensor, samples_per_cls: torch.Tensor, beta: float,
                        n_cls: int) -> torch.Tensor:
    """Each row's class-balanced weight Σ_c labels · (1 - β) / (1 - β^n_c),
    the class weights normalised to sum to ``n_cls``; counts clamp to at
    least 1 (a class with no instance would make the weights inf / inf)."""
    eff = 1.0 - torch.pow(beta, samples_per_cls.clamp(min=1.0))
    w = (1.0 - beta) / eff
    w = w / w.sum() * n_cls
    return (w[None, :] * labels_mh).sum(dim=1, keepdim=True)             # (R, 1)


def cb_sigmoid_loss(labels_mh: torch.Tensor, logits: torch.Tensor,
                    samples_per_cls: torch.Tensor, beta: float) -> torch.Tensor:
    """Class-balanced sigmoid BCE, (R, C)."""
    per_ex = _cb_example_weights(labels_mh, samples_per_cls, beta, logits.shape[-1])
    return per_ex * _stable_bce_with_logits(logits, labels_mh)


def cb_focal_loss(labels_mh: torch.Tensor, logits: torch.Tensor,
                  samples_per_cls: torch.Tensor, beta: float, gamma: float,
                  group=None) -> torch.Tensor:
    """Class-balanced focal loss, a scalar: Σ w · exp(-γ·y·x - γ·softplus(-x))
    · BCE over the positive labels' count (at least 1; with a process
    ``group``, the count over every rank's rows)."""
    per_ex = _cb_example_weights(labels_mh, samples_per_cls, beta, logits.shape[-1])
    bce = _stable_bce_with_logits(logits, labels_mh)
    modulator = torch.exp(-gamma * labels_mh * logits - gamma * _softplus(-logits))
    total = (per_ex * modulator * bce).sum()
    return total / global_sum(labels_mh.sum(), group).clamp(min=1.0)


def cb_softmax_loss(labels_mh: torch.Tensor, logits: torch.Tensor,
                    samples_per_cls: torch.Tensor, beta: float) -> torch.Tensor:
    """The reference's 'softmax' branch, quirk kept: the row softmax is fed
    to the BCE as if it were logits. (R, C)."""
    per_ex = _cb_example_weights(labels_mh, samples_per_cls, beta, logits.shape[-1])
    return per_ex * _stable_bce_with_logits(torch.softmax(logits, dim=-1), labels_mh)


def detector_forward_train(params: Dict[str, Any], cfg: DetectorConfig,
                           batch: Dict[str, torch.Tensor],
                           draws: Union[TrainDraws, torch.Generator],
                           group=None) -> Dict[str, torch.Tensor]:
    """The training forward. batch: images (B, H, W, 3), im_info (B, 3),
    gt_boxes (B, G, 5), num_gt (B,), gt_atts (B, G, A) and, with an
    attribute head, att_counts (A,). ``draws``: the step's uniforms, or a
    generator to draw them from. Returns the losses ``rpn_cls``,
    ``rpn_box``, ``rcnn_cls``, ``rcnn_box``, ``rcnn_cls_atts`` (with an
    attribute head) and ``total``, f32 scalars.

    With a process ``group`` the batch is this rank's contiguous block of
    B images of a global batch of B·world (``parallel/mesh.py::
    local_rows``), and each returned loss is the rank's share of the global
    loss that one process computes on the whole batch: every term divides
    its local numerator by its global denominator (anchor, RoI and
    attribute counts summed over the ranks before their ``max(·, 1)``), so
    the ranks' losses and gradients sum to the global ones. A generator
    draws the global batch's uniforms and the rank keeps its images'; the
    anchors' border test reads the global first image's size, as JAX's."""
    _check_cfg(cfg)
    images, im_info = batch["images"], batch["im_info"]
    gt_boxes, num_gt, gt_atts = batch["gt_boxes"], batch["num_gt"], batch["gt_atts"]
    B = images.shape[0]
    R = cfg.pt.rois_per_image
    world = world_size(group)
    # the border test reads the batch's first image, the global one in a group
    first_info = im_info[:1]
    if group is not None:
        first_info = first_info.clone()
        dist.broadcast(first_info, src=dist.get_global_rank(group, 0), group=group)

    base_feat = _backbone(params, cfg, images)
    fh, fw = base_feat.shape[1], base_feat.shape[2]
    anchors = anchors_for(fh, fw, cfg.feat_stride, cfg.anchor_scales, cfg.anchor_ratios,
                          base_feat.device)
    cls_logits, bbox_deltas = rpn_heads(params["rpn"], base_feat)
    if isinstance(draws, torch.Generator):
        draws = draw_train_uniforms(draws, B * world, anchors.shape[0],
                                    cfg.rpn.post_nms_top_n, R, base_feat.device)
        if world > 1:
            mine = slice(dist.get_rank(group) * B, (dist.get_rank(group) + 1) * B)
            draws = TrainDraws(*[d[mine] for d in draws])
    with torch.no_grad():        # proposals are training data, not differentiated
        rois, _, roi_valid = proposal_layer(
            cls_logits.detach(), bbox_deltas.detach(), anchors, im_info,
            pre_nms_top_n=cfg.rpn.pre_nms_top_n, post_nms_top_n=cfg.rpn.post_nms_top_n,
            nms_thresh=cfg.rpn.nms_thresh)
        labels_a, targets_a, in_w_a, out_w_a = anchor_target(
            anchors, gt_boxes, num_gt, first_info, (draws.anchor_fg, draws.anchor_bg),
            cfg.rpn)
        rois_s, labels, bbox_targets, inside_w, labels_atts, _ = proposal_target(
            rois, roi_valid, gt_boxes, num_gt, gt_atts, (draws.roi_fg, draws.roi_bg), cfg.pt)
    rpn_loss_cls, rpn_loss_box = rpn_losses(cls_logits, bbox_deltas, labels_a, targets_a,
                                            in_w_a, out_w_a, group=group)

    pooled_feat = _pool_rois(params, cfg, base_feat, rois_s.reshape(B * R, 5))
    cls_score = linear_f32(params["cls_score"], pooled_feat)              # (BR, C)
    bbox_pred = linear_f32(params["bbox_pred"], pooled_feat)
    labels_flat = labels.reshape(B * R).long()
    if not cfg.class_agnostic:
        bp = bbox_pred.reshape(B * R, -1, 4)
        bbox_pred = torch.gather(bp, 1, labels_flat[:, None, None].expand(B * R, 1, 4))[:, 0]
    logp = torch.log_softmax(cls_score, dim=-1)
    nll = -torch.gather(logp, 1, labels_flat[:, None])
    loss_cls = nll.mean() if group is None else nll.sum() / (B * R * world)
    # outside weights are the inside weights (the foreground indicator)
    iw = inside_w.reshape(B * R, 4)
    loss_bbox = smooth_l1_loss(bbox_pred.reshape(B * R, 4), bbox_targets.reshape(B * R, 4),
                               iw, iw, sigma=1.0, reduce_dims=(1,), group=group)
    losses = {"rpn_cls": rpn_loss_cls, "rpn_box": rpn_loss_box, "rcnn_cls": loss_cls,
              "rcnn_box": loss_bbox}

    if cfg.num_att_classes:
        att_logits = linear_f32(params["cls_score_atts"], pooled_feat)
        atts_flat = labels_atts.reshape(B * R, -1)
        att_counts = torch.as_tensor(batch["att_counts"], dtype=torch.float32,
                                     device=att_logits.device)
        if cfg.cb_loss_type == "focal":
            loss_atts = cb_focal_loss(atts_flat, att_logits, att_counts, cfg.cb_beta,
                                      cfg.cb_gamma, group=group)
        else:
            if cfg.cb_loss_type == "sigmoid":
                cb = cb_sigmoid_loss(atts_flat, att_logits, att_counts, cfg.cb_beta)
            elif cfg.cb_loss_type == "softmax":
                cb = cb_softmax_loss(atts_flat, att_logits, att_counts, cfg.cb_beta)
            else:
                raise ValueError(f"unknown cb_loss_type {cfg.cb_loss_type!r}")
            has_atts = atts_flat.sum(dim=1) > 0
            # the mean over (rows with attributes, classes)
            denom = (global_sum(has_atts.sum(), group) * cb.shape[1]).clamp(min=1)
            loss_atts = torch.where(has_atts[:, None], cb, 0.0).sum() / denom
        any_atts = global_sum(atts_flat.sum(), group) > 0
        losses["rcnn_cls_atts"] = torch.where(any_atts, loss_atts, 0.0)

    losses["total"] = (losses["rpn_cls"] + losses["rpn_box"] + losses["rcnn_cls"]
                       + cfg.att_loss_weight * losses.get("rcnn_cls_atts", 0.0)
                       + losses["rcnn_box"])
    return losses


def detector_forward_test(params: Dict[str, Any], cfg: DetectorConfig,
                          images: torch.Tensor, im_info: torch.Tensor,
                          post_nms_top_n: int = _TEST.rpn_post_nms_top_n,
                          pre_nms_top_n: int = _TEST.rpn_pre_nms_top_n,
                          nms_thresh: float = _TEST.rpn_nms_thresh) -> Dict[str, torch.Tensor]:
    """Inference forward. images (B, H, W, 3), im_info (B, 3) rows (height,
    width, scale), both on the params' device.

    Returns rois (B, P, 5), roi_valid (B, P), cls_prob (B, P, C), bbox_pred
    (B, P, 4C), pooled_feat (B, P, 2048; 4096 for VGG16) and, with an
    attribute head, cls_prob_atts (B, P, A). Opens the spans
    ``ssc.detect.backbone``, ``ssc.detect.rpn`` and ``ssc.detect.roi_head``
    (``utils/tracing.py``)."""
    B = images.shape[0]
    with span(DETECT_BACKBONE):
        base_feat = _backbone(params, cfg, images)
    with span(DETECT_RPN):
        anchors = anchors_for(base_feat.shape[1], base_feat.shape[2], cfg.feat_stride,
                              cfg.anchor_scales, cfg.anchor_ratios, base_feat.device)
        cls_logits, bbox_deltas = rpn_heads(params["rpn"], base_feat)
        rois, _, roi_valid = proposal_layer(
            cls_logits, bbox_deltas, anchors, im_info, pre_nms_top_n=pre_nms_top_n,
            post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh)

    with span(DETECT_ROI_HEAD):
        P = rois.shape[1]
        pooled_feat = _pool_rois(params, cfg, base_feat, rois.reshape(B * P, 5))
        cls_prob = torch.softmax(linear_f32(params["cls_score"], pooled_feat), dim=-1)
        bbox_pred = linear_f32(params["bbox_pred"], pooled_feat)
        out = {
            "rois": rois, "roi_valid": roi_valid,
            "cls_prob": cls_prob.reshape(B, P, -1),
            "bbox_pred": bbox_pred.reshape(B, P, -1),
            "pooled_feat": pooled_feat.reshape(B, P, -1),
        }
        if cfg.num_att_classes:
            out["cls_prob_atts"] = torch.sigmoid(
                linear_f32(params["cls_score_atts"], pooled_feat)).reshape(B, P, -1)
    return out


def detector_trainable_labels(params: Dict[str, Any], freeze_backbone: bool = True) -> Any:
    """The optimizer's label of every leaf, in ``params``' nesting: the
    backbone's frozen pieces ``"never"`` (``resnet.trainable_label`` /
    ``vgg.trainable_label``), the rest ``"always"``.

    ``freeze_backbone=False`` (training from scratch): only BatchNorm's
    running statistics stay frozen, and the stem conv, which sees
    pixel-scale inputs and whose init folds in 1 / the pixel std, is
    ``"input_conv"`` (the optimizer rescales its gradient)."""

    def label(keys):
        if not freeze_backbone:
            if keys[-1] in ("mean", "var"):
                return "never"
            if (("conv1" in keys or "conv1_1" in keys)
                    and not any(k.startswith("layer") for k in keys)):
                return "input_conv"
            return "always"
        if "resnet" in keys:
            return resnet.trainable_label([k for k in keys if k != "resnet"])
        if "vgg" in keys:
            return vgg.trainable_label([k for k in keys if k != "vgg"])
        return "always"

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            # list items are named "[i]", as JAX's tree paths name them
            return [walk(v, keys + [f"[{i}]"]) for i, v in enumerate(node)]
        return label(keys)

    return walk(params, [])
