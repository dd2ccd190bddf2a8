"""Box geometry of the detector's inference path (counterpart of
``style_seqcvae_tpu/ops/boxes.py``: ``bbox_transform_inv``, ``clip_boxes``
and ``bbox_overlaps``).

Boxes are (x1, y1, x2, y2) inclusive, so a width is x2 - x1 + 1 (the legacy
Faster R-CNN convention). Class-specific deltas and boxes keep the strided
layout: column ``4j + c`` is coordinate c of class j.
"""

from __future__ import annotations

from typing import Union

import torch

Bound = Union[float, torch.Tensor]


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply predicted deltas to boxes: boxes (..., N, 4), deltas
    (..., N, 4k) → (..., N, 4k). ``dw`` and ``dh`` clip to ±10 so that exp
    never overflows."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0::4]
    dy = deltas[..., 1::4]
    dw = deltas[..., 2::4].clamp(-10.0, 10.0)
    dh = deltas[..., 3::4].clamp(-10.0, 10.0)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_h: Bound, im_w: Bound) -> torch.Tensor:
    """Clip (..., 4k) boxes to [0, im_w - 1] × [0, im_h - 1]. ``im_h`` and
    ``im_w`` are numbers or tensors that broadcast against (..., k)."""
    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), torch.as_tensor(hi - 1, dtype=v.dtype,
                                                               device=v.device))

    x1 = clip(boxes[..., 0::4], im_w)
    y1 = clip(boxes[..., 1::4], im_h)
    x2 = clip(boxes[..., 2::4], im_w)
    y2 = clip(boxes[..., 3::4], im_h)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def bbox_overlaps(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., N, 4) × (..., M, 4) → (..., N, M), with +1 widths
    (JAX ``bbox_overlaps`` and ``native.iou_matrix``)."""
    area_q = ((query[..., :, 2] - query[..., :, 0] + 1.0)
              * (query[..., :, 3] - query[..., :, 1] + 1.0))
    area_b = ((boxes[..., :, 2] - boxes[..., :, 0] + 1.0)
              * (boxes[..., :, 3] - boxes[..., :, 1] + 1.0))
    lt = torch.maximum(boxes[..., :, None, :2], query[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:4], query[..., None, :, 2:4])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return inter / union
