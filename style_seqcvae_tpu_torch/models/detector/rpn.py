"""Region proposal network and proposal layer, inference only (counterpart
of ``style_seqcvae_tpu/models/detector/rpn.py``).

Everything has a fixed shape: the proposal layer decodes all grid anchors,
takes the ``pre_nms_top_n`` best by score, runs greedy NMS and emits exactly
``post_nms_top_n`` rois per image, zero-padded. On CUDA the NMS is kernel D
(``ops/kernels/nms.py``), one launch for the whole batch; on the CPU its
plain version.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from style_seqcvae_tpu_torch.models.detector.anchors import generate_anchors, shifted_anchors
from style_seqcvae_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from style_seqcvae_tpu_torch.ops.kernels import nms as nms_kernel


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


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], padding=(p["w"].shape[-1] - 1) // 2)


def rpn_heads(params: Dict[str, Any], base_feat: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, h, w, C) NHWC → class logits (B, h, w, A, 2), deltas
    (B, h, w, A, 4). The heads' outputs are reshaped from NHWC, which gives
    the (h, w, A) anchor order of ``shifted_anchors``."""
    x = F.relu(_conv(base_feat.permute(0, 3, 1, 2), params["conv"]))
    B, _, h, w = x.shape
    cls = _conv(x, params["cls"]).permute(0, 2, 3, 1).reshape(B, h, w, -1, 2)
    bbox = _conv(x, params["bbox"]).permute(0, 2, 3, 1).reshape(B, h, w, -1, 4)
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
