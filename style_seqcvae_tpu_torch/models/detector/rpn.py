"""Region proposal network, proposal layer and anchor-target layer
(counterpart of ``style_seqcvae_tpu/models/detector/rpn.py``).

Everything has a fixed shape: the proposal layer decodes all grid anchors,
takes the ``pre_nms_top_n`` best by score, runs greedy NMS and emits exactly
``post_nms_top_n`` rois per image, zero-padded. On CUDA the NMS is kernel D
(``ops/kernels/nms.py``), one launch for the whole batch; on the CPU its
plain version.

The anchor-target layer labels every anchor and subsamples the RPN's
minibatch as JAX's does: a uniform subset without replacement by a stable
sort of uniform priorities. JAX draws those uniforms from PRNG keys inside;
here they are inputs, (B, N) each for the foreground and the background
subsampling, so that a caller (or a test, with JAX's own draws) decides them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from style_seqcvae_tpu_torch.models.detector.anchors import generate_anchors, shifted_anchors
from style_seqcvae_tpu_torch.models.detector.layers import conv_bias
from style_seqcvae_tpu_torch.ops.boxes import (
    bbox_overlaps,
    bbox_transform,
    bbox_transform_inv,
    clip_boxes,
)
from style_seqcvae_tpu_torch.ops.kernels import nms as nms_kernel
from style_seqcvae_tpu_torch.parallel.collectives import global_sum, world_size


class RPNConfig(NamedTuple):
    """The RPN's training settings (JAX ``rpn.py:28-40``)."""
    feat_stride: int = 16
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_top_n: int = 12000
    post_nms_top_n: int = 2000
    nms_thresh: float = 0.7
    rpn_batch_size: int = 256
    fg_fraction: float = 0.5
    positive_overlap: float = 0.7
    negative_overlap: float = 0.3
    allowed_border: int = 0
    clobber_positives: bool = False


def init_rpn(gen: torch.Generator, in_ch: int = 1024, num_anchors: int = 12, *,
             device, dtype=torch.float32) -> Dict[str, Any]:
    """3×3 conv → 512, then the 1×1 class and box heads; normal(0, 0.01)
    kernels (OIHW, channels_last memory), zero biases."""
    def conv(out_ch, in_ch_, k):
        w = torch.randn((out_ch, in_ch_, k, k), generator=gen, device=device) * 0.01
        return {"w": w.to(dtype).contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((out_ch,), device=device, dtype=dtype)}

    return {"conv": conv(512, in_ch, 3), "cls": conv(num_anchors * 2, 512, 1),
            "bbox": conv(num_anchors * 4, 512, 1)}


def rpn_heads(params: Dict[str, Any], base_feat: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, h, w, C) NHWC → class logits (B, h, w, A, 2), deltas
    (B, h, w, A, 4). The heads' outputs are reshaped from NHWC, which gives
    the (h, w, A) anchor order of ``shifted_anchors``."""
    x = F.relu(conv_bias(base_feat.permute(0, 3, 1, 2), params["conv"]))
    B, _, h, w = x.shape
    cls = conv_bias(x, params["cls"]).permute(0, 2, 3, 1).reshape(B, h, w, -1, 2)
    bbox = conv_bias(x, params["bbox"]).permute(0, 2, 3, 1).reshape(B, h, w, -1, 4)
    return cls, bbox


def proposal_candidates(cls_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                        all_anchors: torch.Tensor, im_info: torch.Tensor, *,
                        pre_nms_top_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode and clip every anchor's box, then keep the ``pre_nms_top_n``
    best by foreground score in ``lax.top_k``'s order (ties to the lower
    index): (B, k, 4) f32 boxes and (B, k) scores, score-sorted."""
    B = cls_logits.shape[0]
    N = all_anchors.shape[0]
    scores = torch.softmax(cls_logits, dim=-1)[..., 1].reshape(B, N)
    deltas = bbox_deltas.reshape(B, N, 4)
    proposals = bbox_transform_inv(all_anchors.expand(B, N, 4), deltas)
    # im_info rows: (height, width, scale)
    proposals = clip_boxes(proposals, im_info[:, 0, None, None], im_info[:, 1, None, None])
    k = min(pre_nms_top_n, N)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_props = torch.gather(proposals, 1, top_idx[..., None].expand(B, k, 4))
    return top_props.float().contiguous(), top_scores


def proposal_nms(top_props: torch.Tensor, top_scores: torch.Tensor, *,
                 post_nms_top_n: int, nms_thresh: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS of the score-sorted candidates → rois (B, post, 5)
    ``[batch_idx, x1, y1, x2, y2]``, their scores (B, post) and valid
    (B, post); padding rows are all zero."""
    B, k, _ = top_props.shape
    keep_idx, _ = nms_kernel.nms(top_props, top_scores, nms_thresh,
                                 max_out=post_nms_top_n, presorted=True)
    if keep_idx.shape[1] < post_nms_top_n:
        # fewer candidates than the post-NMS budget: pad with -1
        keep_idx = F.pad(keep_idx, (0, post_nms_top_n - keep_idx.shape[1]), value=-1)
    valid = keep_idx >= 0
    safe = keep_idx.clamp(0, k - 1).long()
    boxes = torch.gather(top_props, 1, safe[..., None].expand(B, post_nms_top_n, 4))
    boxes = torch.where(valid[..., None], boxes, 0.0)
    scores = torch.where(valid, torch.gather(top_scores, 1, safe), 0.0)
    batch_col = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    batch_col = batch_col[:, None, None].expand(B, post_nms_top_n, 1)
    return torch.cat([batch_col, boxes], dim=-1), scores, valid


def proposal_layer(cls_logits, bbox_deltas, all_anchors, im_info, *, pre_nms_top_n: int,
                   post_nms_top_n: int, nms_thresh: float):
    """Decode + clip + top-k + NMS → (rois (B, post, 5), scores (B, post),
    valid (B, post))."""
    top_props, top_scores = proposal_candidates(cls_logits, bbox_deltas, all_anchors,
                                                im_info, pre_nms_top_n=pre_nms_top_n)
    return proposal_nms(top_props, top_scores, post_nms_top_n=post_nms_top_n,
                        nms_thresh=nms_thresh)


def anchors_for(feat_h: int, feat_w: int, feat_stride: int, scales, ratios,
                device) -> torch.Tensor:
    """All (h, w, A) grid anchors as an (h·w·A, 4) f32 tensor."""
    a = shifted_anchors(feat_h, feat_w, feat_stride,
                        generate_anchors(feat_stride, ratios, scales))
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _random_subsample(mask: torch.Tensor, num_keep: torch.Tensor,
                      uniforms: torch.Tensor) -> torch.Tensor:
    """Keep ``num_keep`` (B,) of the True entries of ``mask`` (B, N): those
    with the largest ``uniforms`` (B, N) in [0, 1), ties to the lower index
    (a stable sort, as ``jnp.argsort``)."""
    priority = torch.where(mask, uniforms, -1.0)
    order = torch.argsort(-priority, dim=-1, stable=True)
    n = mask.shape[-1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=mask.device).expand_as(order))
    return mask & (rank < num_keep[..., None])


def anchor_target(all_anchors: torch.Tensor, gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                  im_info: torch.Tensor, uniforms: Tuple[torch.Tensor, torch.Tensor],
                  cfg: RPNConfig):
    """The RPN's labels and targets for every anchor.

    all_anchors (N, 4); gt_boxes (B, G, 5) (class last); num_gt (B,);
    im_info (B, 3) rows (height, width, scale); ``uniforms`` the (B, N)
    foreground and background draws of the subsampling. Returns labels
    (B, N) in {-1, 0, 1}, bbox_targets (B, N, 4) and the inside and outside
    weights (B, N). Like JAX's, the border test reads image 0's size for
    every image."""
    fg_u, bg_u = uniforms
    B, G = gt_boxes.shape[:2]
    dev = gt_boxes.device
    border = cfg.allowed_border
    inside = ((all_anchors[:, 0] >= -border) & (all_anchors[:, 1] >= -border)
              & (all_anchors[:, 2] < im_info[0, 1] + border)
              & (all_anchors[:, 3] < im_info[0, 0] + border))
    gt_valid = torch.arange(G, device=dev)[None, :] < num_gt[:, None]      # (B, G)
    ov = bbox_overlaps(all_anchors, gt_boxes[..., :4])                    # (B, N, G)
    ov = torch.where(gt_valid[:, None, :], ov, -1.0)
    max_ov = ov.amax(dim=2)
    argmax_ov = ov.argmax(dim=2)                       # the first of equal maxima
    gt_max = torch.where(inside[None, :, None], ov, -1.0).amax(dim=1)    # (B, G)
    gt_max = torch.where(gt_max == 0, 1e-5, gt_max)

    labels = torch.full(max_ov.shape, -1.0, device=dev)
    negative = inside & (max_ov < cfg.negative_overlap)
    if not cfg.clobber_positives:
        labels = torch.where(negative, 0.0, labels)
    # anchors at some gt's largest overlap (f32 equality, as JAX tests it)
    is_best = ((ov == gt_max[:, None, :]) & gt_valid[:, None, :]).any(dim=2)
    labels = torch.where(inside & is_best, 1.0, labels)
    labels = torch.where(inside & (max_ov >= cfg.positive_overlap), 1.0, labels)
    if cfg.clobber_positives:
        labels = torch.where(negative, 0.0, labels)

    num_fg = int(cfg.fg_fraction * cfg.rpn_batch_size)
    fg_mask = labels == 1
    fg_keep = _random_subsample(fg_mask, fg_mask.sum(dim=1).clamp(max=num_fg), fg_u)
    labels = torch.where(fg_mask & ~fg_keep, -1.0, labels)
    num_bg = cfg.rpn_batch_size - (labels == 1).sum(dim=1)
    bg_mask = labels == 0
    bg_keep = _random_subsample(bg_mask, torch.minimum(bg_mask.sum(dim=1), num_bg), bg_u)
    labels = torch.where(bg_mask & ~bg_keep, -1.0, labels)

    gt_of = torch.gather(gt_boxes[..., :4], 1, argmax_ov[..., None].expand(B, -1, 4))
    targets = bbox_transform(all_anchors.expand_as(gt_of), gt_of)
    num_examples = (labels >= 0).sum(dim=1).clamp(min=1)
    inside_w = torch.where(labels == 1, 1.0, 0.0)
    outside_w = torch.where(labels >= 0, 1.0 / num_examples[:, None], 0.0)
    return labels, targets, inside_w, outside_w


def rpn_losses(cls_logits: torch.Tensor, bbox_deltas: torch.Tensor, labels: torch.Tensor,
               bbox_targets: torch.Tensor, inside_w: torch.Tensor, outside_w: torch.Tensor,
               group=None):
    """The RPN's cross entropy over the sampled anchors and its smooth-L1
    (sigma 3) box loss. With a process ``group`` the batch is a rank's
    share: each term divides the local sum by the global count (the
    sampled anchors of every rank's images; the global image count)."""
    B = cls_logits.shape[0]
    logits = cls_logits.reshape(B, -1, 2)
    mask = labels >= 0
    lab = labels.clamp(0, 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
    loss_cls = torch.where(mask, ce, 0.0).sum() / global_sum(mask.sum(), group).clamp(min=1)
    deltas = bbox_deltas.reshape(B, -1, 4)
    loss_box = smooth_l1_loss(deltas, bbox_targets, inside_w[..., None], outside_w[..., None],
                              sigma=3.0, reduce_dims=(1, 2), group=group)
    return loss_cls, loss_box


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, inside_w: torch.Tensor,
                   outside_w: torch.Tensor, sigma: float = 1.0,
                   reduce_dims: Tuple[int, ...] = (1,), group=None) -> torch.Tensor:
    """Smooth L1: summed over ``reduce_dims``, then the mean over the rows;
    with a process ``group``, the local rows' sum over every rank's rows
    (each rank holds as many)."""
    sigma2 = sigma ** 2
    diff = inside_w * (pred - target)
    ad = diff.abs()
    flag = (ad < 1.0 / sigma2).to(pred.dtype)
    loss = flag * 0.5 * sigma2 * diff ** 2 + (1 - flag) * (ad - 0.5 / sigma2)
    loss = outside_w * loss
    per_row = loss.sum(dim=reduce_dims)
    if group is None:
        return per_row.mean()
    return per_row.sum() / (per_row.numel() * world_size(group))
