"""Anchor generation, numpy only (copy of
``style_seqcvae_tpu/models/detector/anchors.py``): ratio enumeration with
rounded widths around a (0, 0, base-1, base-1) window, then scale
enumeration, as the classic Faster R-CNN ``generate_anchors`` does."""

from __future__ import annotations

import numpy as np


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """(len(ratios) * len(scales), 4) float32 anchors, ratio-major."""
    base = np.array([1, 1, base_size, base_size], np.float64) - 1
    w, h, xc, yc = _whctrs(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = _mkanchors(ws, hs, xc, yc)
    out = []
    for ra in ratio_anchors:
        w, h, xc, yc = _whctrs(ra)
        s = np.asarray(scales, np.float64)
        out.append(_mkanchors(w * s, h * s, xc, yc))
    return np.vstack(out).astype(np.float32)


def shifted_anchors(feat_height: int, feat_width: int, feat_stride: int,
                    anchors: np.ndarray) -> np.ndarray:
    """All anchors over the feature grid, (H*W*A, 4), in (h, w, A) order:
    the order of the RPN heads' NHWC outputs reshaped to (B, h, w, A, ·)."""
    shift_x = np.arange(feat_width) * feat_stride
    shift_y = np.arange(feat_height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = anchors[None, :, :] + shifts[:, None, :].astype(np.float32)
    return all_anchors.reshape(-1, 4)
