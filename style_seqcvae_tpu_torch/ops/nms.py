"""Greedy non-maximum suppression, batched over a leading group axis
(counterpart of ``style_seqcvae_tpu/ops/nms.py``).

:func:`nms` is the plain PyTorch version of kernel D
(``ops/kernels/nms.py``): the pairwise suppression matrix of the
score-sorted boxes, then a greedy scan in Python over the boxes in order.
The contract is the JAX ``nms``'s: a stable descending sort (ties go to the
lower index), a box suppresses only later boxes, and it suppresses where
``inter / (area_i + area_j - inter) > threshold`` in f32 with +1-pixel
widths. :func:`nms_reference` is the numpy golden the tests use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# (chunk of groups) x N x N pairs evaluated at once
_PAIRS_PER_CHUNK = 1 << 24


def _areas(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)


def suppression_matrix(boxes_sorted: torch.Tensor, threshold: float) -> torch.Tensor:
    """(G, N, 4) score-sorted boxes → (G, N, N) bool: [g, i, j] is set when
    j > i and IoU(i, j) > threshold (the JAX kernel's expression order)."""
    G, N, _ = boxes_sorted.shape
    out = torch.empty((G, N, N), dtype=torch.bool, device=boxes_sorted.device)
    later = torch.ones((N, N), dtype=torch.bool, device=boxes_sorted.device).triu_(1)
    step = max(1, _PAIRS_PER_CHUNK // max(N * N, 1))
    for g0 in range(0, G, step):
        b = boxes_sorted[g0:g0 + step].float()
        area = _areas(b)
        r, c = b[:, :, None, :], b[:, None, :, :]
        w = torch.minimum(r[..., 2], c[..., 2]) - torch.maximum(r[..., 0], c[..., 0]) + 1.0
        h = torch.minimum(r[..., 3], c[..., 3]) - torch.maximum(r[..., 1], c[..., 1]) + 1.0
        inter = w.clamp(min=0.0) * h.clamp(min=0.0)
        iou = inter / (area[:, :, None] + area[:, None, :] - inter)
        out[g0:g0 + step] = (iou > threshold) & later
    return out


def greedy_scan(mask: torch.Tensor) -> torch.Tensor:
    """(G, N, N) suppression matrix → (G, N) bool, alive in sorted order:
    box i, when alive, removes every box its row marks."""
    G, N, _ = mask.shape
    alive = torch.ones((G, N), dtype=torch.bool, device=mask.device)
    for i in range(N):
        alive &= ~(mask[:, i, :] & alive[:, i:i + 1])
    return alive


def compact(alive: torch.Tensor, order: torch.Tensor, max_out: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alive flags in sorted order and the sort's permutation → (keep_idx
    (G, N or max_out) int32, the kept original indices in sorted order,
    padded with -1; keep_mask (G, N) bool in the original order)."""
    G, N = alive.shape
    pos = torch.arange(N, device=alive.device).expand(G, N)
    ranked = torch.sort(torch.where(alive, pos, N), dim=1).values
    valid = ranked < N
    keep_idx = torch.where(valid, torch.gather(order, 1, ranked.clamp(max=N - 1)), -1)
    keep_mask = torch.zeros_like(alive).scatter_(1, order, alive)
    if max_out:
        keep_idx = keep_idx[:, :max_out]
    return keep_idx.to(torch.int32), keep_mask


def sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Stable descending order along the last axis (ties to the lower index,
    as ``jnp.argsort(-scores)``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
        max_out: int = 0, presorted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per group: boxes (G, N, 4), scores (G, N) → (keep_idx
    (G, N or max_out) int32 padded with -1, in descending score order;
    keep_mask (G, N) bool). Padding rows carry score <= 0 and zero boxes.
    ``presorted`` promises that every group is already in descending score
    order and skips the sort."""
    G, N = scores.shape
    if presorted:
        order = torch.arange(N, device=boxes.device).expand(G, N)
        sboxes = boxes
    else:
        order = sort_desc(scores)
        sboxes = torch.gather(boxes, 1, order[..., None].expand(G, N, 4))
    if N == 0:
        return compact(torch.zeros((G, 0), dtype=torch.bool, device=boxes.device),
                       order, max_out)
    alive = greedy_scan(suppression_matrix(sboxes, threshold))
    return compact(alive, order, max_out)


def nms_reference(boxes, scores, threshold) -> np.ndarray:
    """Numpy greedy NMS of one group, float64 (the classic CPU NMS): the
    kept indices in descending score order."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= threshold]
    return np.asarray(keep, np.int64)
