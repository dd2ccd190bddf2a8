"""Proposal-target layer: RoI sampling and per-RoI targets (counterpart of
``style_seqcvae_tpu/models/detector/targets.py``).

Samples ``rois_per_image`` RoIs per image from the proposals, up to
``fg_fraction`` of them foreground (uniform without replacement), the rest
background (uniform with replacement over the background list); assigns
class labels, normalized regression targets and the multi-hot attributes
of the assigned ground truth (zero for background). The branches of the
reference (foreground and background, foreground only, background only)
are masked arithmetic, as in JAX. JAX draws its uniforms from PRNG keys;
here they are inputs: (B, P) for the foreground order and (B, R) for the
background picks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from style_seqcvae_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform


class ProposalTargetConfig(NamedTuple):
    rois_per_image: int = 128
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    num_classes: int = 81


def proposal_target(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                    num_gt: torch.Tensor, gt_atts: torch.Tensor,
                    uniforms: Tuple[torch.Tensor, torch.Tensor], cfg: ProposalTargetConfig):
    """rois (B, P, 5); roi_valid (B, P) bool; gt_boxes (B, G, 5) with the
    class in column 4; num_gt (B,); gt_atts (B, G, A) multi-hot;
    ``uniforms`` (B, P) and (B, R) in [0, 1).

    Returns rois (B, R, 5) (column 0 the image), labels (B, R),
    bbox_targets (B, R, 4), inside_w (B, R, 4), labels_atts (B, R, A) and
    the foreground slots (B, R)."""
    fg_u, bg_u = uniforms
    B, P, _ = rois.shape
    G = gt_boxes.shape[1]
    R = cfg.rois_per_image
    dev = rois.device
    fg_per_image = int(round(cfg.fg_fraction * R))

    gt_valid = torch.arange(G, device=dev)[None, :] < num_gt[:, None]
    ov = bbox_overlaps(rois[..., 1:5], gt_boxes[..., :4])                # (B, P, G)
    ov = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None], ov, -1.0)
    max_ov = ov.amax(dim=2)
    gt_assign = ov.argmax(dim=2)                       # the first of equal maxima

    fg_mask = max_ov >= cfg.fg_thresh
    bg_mask = (max_ov < cfg.bg_thresh_hi) & (max_ov >= cfg.bg_thresh_lo) & roi_valid
    n_fg_avail = fg_mask.sum(dim=1)
    n_bg_avail = bg_mask.sum(dim=1)

    # foreground in random order (without replacement); the background
    # list is the background indices first, in index order (stable sorts)
    fg_order = torch.argsort(-torch.where(fg_mask, fg_u, -1.0), dim=1, stable=True)
    bg_list = torch.argsort((~bg_mask).to(torch.uint8), dim=1, stable=True)

    both = (n_fg_avail > 0) & (n_bg_avail > 0)
    n_fg = torch.where(both, n_fg_avail.clamp(max=fg_per_image),
                       torch.where(n_fg_avail > 0, R, 0))
    slots = torch.arange(R, device=dev)[None, :]
    is_fg_slot = slots < n_fg[:, None]
    # foreground slot i ← fg_order[i mod n_fg_avail] (with replacement in
    # the foreground-only case)
    fg_at = torch.where(n_fg_avail[:, None] > 0, slots % n_fg_avail.clamp(min=1)[:, None], 0)
    fg_pick = torch.gather(fg_order, 1, fg_at)
    # background slots ← uniform with replacement over bg_list[:n_bg_avail],
    # floor(u · n) in f32 as JAX computes it (an index past the end clamps,
    # as JAX's gather)
    bg_at = torch.floor(bg_u * n_bg_avail.clamp(min=1)[:, None]).long().clamp(max=P - 1)
    bg_pick = torch.gather(bg_list, 1, bg_at)
    keep = torch.where(is_fg_slot, fg_pick, bg_pick)                     # (B, R)

    assign = torch.gather(gt_assign, 1, keep)
    labels = torch.where(is_fg_slot, torch.gather(gt_boxes[..., 4], 1, assign), 0.0)
    A = gt_atts.shape[-1]
    atts_out = torch.gather(gt_atts, 1, assign[..., None].expand(B, R, A))
    atts_out = torch.where(is_fg_slot[..., None], atts_out, 0.0)
    rois_out = torch.gather(rois, 1, keep[..., None].expand(B, R, 5))
    gt_rois = torch.gather(gt_boxes[..., :4], 1, assign[..., None].expand(B, R, 4))
    targets = bbox_transform(rois_out[..., 1:5], gt_rois)
    means = torch.tensor(cfg.bbox_normalize_means, dtype=torch.float32, device=dev)
    stds = torch.tensor(cfg.bbox_normalize_stds, dtype=torch.float32, device=dev)
    targets = torch.where(is_fg_slot[..., None], (targets - means) / stds, 0.0)
    inside_w = is_fg_slot[..., None].expand(B, R, 4).to(torch.float32)
    batch_col = torch.arange(B, dtype=rois_out.dtype, device=dev)[:, None].expand(B, R)
    rois_out = torch.cat([batch_col[..., None], rois_out[..., 1:]], dim=-1)
    return rois_out, labels, targets, inside_w, atts_out, is_fg_slot
