"""RoIAlign forward and RoI max pooling, plain PyTorch (counterpart of
``style_seqcvae_tpu/ops/roi_align.py``: ``roi_align`` and ``roi_pool``).

This is kernel C's plain version (``ops/kernels/roi_align.py``). NHWC
features (B, H, W, C) and rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in
input-image coordinates → (R, PH, PW, C) in the features' dtype. Each bin is
the mean of sampling_ratio² bilinear samples, with the boundary rules of the
classic CUDA kernel: a sample outside [-1, H] × [-1, W] is empty, negative
coordinates clamp to 0 and the low corner clamps to H-1 / W-1. Arithmetic is
f32 whatever the features' dtype.

:func:`roi_pool` has no kernel behind it (no TPU kernel either): each bin's
window is gathered for all RoIs at once and reduced with ``amax``, whose
gradient divides evenly among tied maxima as JAX's ``jnp.max`` does.
"""

from __future__ import annotations

import numpy as np
import torch

# RoIs gathered at once: bounds the (chunk, PH, PW, S, S, C) corner gather
_ROIS_PER_CHUNK = 256


def _div(a: torch.Tensor, n: int) -> torch.Tensor:
    """a / n rounded as one f32 division. PyTorch's CUDA kernels divide by a
    Python scalar as a product with its reciprocal, one ulp off at times; an
    ulp of a map coordinate moves a bilinear weight by as much, which the
    features' local differences then multiply."""
    return a / torch.tensor(float(n), dtype=a.dtype, device=a.device)


def _recip(n: int) -> float:
    """1 / n rounded to f32."""
    return float(np.float32(1.0) / np.float32(n))


def sample_grid(rois: torch.Tensor, *, height: int, width: int, spatial_scale: float,
                pooled: int, sampling: int):
    """Corner offsets into one image's H·W map and bilinear weights of every
    sample: (R, P, P, S, S, 4) int64 and f32 (an empty sample has weight 0),
    and the batch index (R,) int64."""
    f32 = torch.float32
    rois = rois.to(f32)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bin_w = _div(torch.clamp(x2 - x1, min=1.0), pooled)
    bin_h = _div(torch.clamp(y2 - y1, min=1.0), pooled)

    dev = rois.device
    p = torch.arange(pooled, dtype=f32, device=dev)
    s = _div(torch.arange(sampling, dtype=f32, device=dev) + 0.5, sampling)
    # y (R, P, S) and x (R, P, S): y1 + (ph + (iy + 0.5) / S) * bin_h
    y = y1[:, None, None] + (p[None, :, None] + s[None, None, :]) * bin_h[:, None, None]
    x = x1[:, None, None] + (p[None, :, None] + s[None, None, :]) * bin_w[:, None, None]
    R = rois.shape[0]
    shape = (R, pooled, pooled, sampling, sampling)
    y = y[:, :, None, :, None].expand(shape)
    x = x[:, None, :, None, :].expand(shape)

    empty = (y < -1.0) | (y > height) | (x < -1.0) | (x > width)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y0 = torch.floor(y).long().clamp(max=height - 1)
    x0 = torch.floor(x).long().clamp(max=width - 1)
    y1i = (y0 + 1).clamp(max=height - 1)
    x1i = (x0 + 1).clamp(max=width - 1)
    ly = (y - y0.to(f32)).clamp(0.0, 1.0)
    lx = (x - x0.to(f32)).clamp(0.0, 1.0)
    hy, hx = 1.0 - ly, 1.0 - lx
    w = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], dim=-1)
    w = torch.where(empty[..., None], 0.0, w)
    offsets = torch.stack([y0 * width + x0, y0 * width + x1i,
                           y1i * width + x0, y1i * width + x1i], dim=-1)
    return offsets, w, rois[:, 0].long()


def roi_align(features: torch.Tensor, rois: torch.Tensor, *, spatial_scale: float,
              pooled_height: int = 7, pooled_width: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C); rois (R, 5) → (R, PH, PW, C), features' dtype."""
    if pooled_height != pooled_width:
        raise ValueError("square pooling only")
    B, H, W, C = features.shape
    P, S = pooled_height, sampling_ratio
    flat = features.reshape(B * H * W, C)
    out = torch.empty((rois.shape[0], P, P, C), dtype=features.dtype,
                      device=features.device)
    for r0 in range(0, rois.shape[0], _ROIS_PER_CHUNK):
        offsets, w, b = sample_grid(rois[r0:r0 + _ROIS_PER_CHUNK], height=H, width=W,
                                    spatial_scale=spatial_scale, pooled=P, sampling=S)
        idx = offsets + (b * (H * W))[:, None, None, None, None, None]
        acc = torch.zeros(idx.shape[:3] + (C,), dtype=torch.float32,
                          device=features.device)
        for corner in range(4):
            v = flat[idx[..., corner]].float()                  # (r, P, P, S, S, C)
            acc += (v * w[..., corner, None]).sum(dim=(3, 4))
        out[r0:r0 + _ROIS_PER_CHUNK] = _div(acc, S * S).to(features.dtype)
    return out


def roi_pool(features: torch.Tensor, rois: torch.Tensor, *, spatial_scale: float,
             pooled_height: int = 7, pooled_width: int = 7) -> torch.Tensor:
    """Max RoI pooling with the classic CUDA RoIPool's integer bins: the
    rounded, scaled RoI split at floor / ceil edges, empty bins 0.
    features (B, H, W, C); rois (R, 5) → (R, PH, PW, C), features' dtype.

    JAX's formulation masks ``features[batch_idx]``, an (R, H, W, C) tensor,
    for each bin. Here each bin gathers only its own window, padded to the
    longest window of the call: (R, h, w, C) with h, w at most a bin's size
    plus one (one host sync per call reads them)."""
    B, H, W, C = features.shape
    R = rois.shape[0]
    f32 = torch.float32
    rois = rois.to(f32)
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    # the bin size as JAX's roi_pool computes it under jit: XLA turns the
    # division by the constant bin count into a product with its f32
    # reciprocal, and the floor / ceil edges below are where that shows
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) * _recip(pooled_width)
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) * _recip(pooled_height)

    def edges(n_bins: int, bin_size: torch.Tensor, lo: torch.Tensor, size: int):
        p = torch.arange(n_bins, dtype=f32, device=rois.device)[None, :]
        start = (torch.floor(p * bin_size[:, None]) + lo[:, None]).clamp(0, size)
        end = (torch.ceil((p + 1) * bin_size[:, None]) + lo[:, None]).clamp(0, size)
        return start.long(), end.long()                       # (R, bins) each

    hs, he = edges(pooled_height, bin_h, y1, H)
    ws, we = edges(pooled_width, bin_w, x1, W)
    longest = torch.stack([(he - hs).max(), (we - ws).max()]) if R else None
    hl, wl = (max(int(v), 1) for v in longest.tolist()) if R else (1, 1)
    flat = features.reshape(B * H * W, C)
    base = rois[:, 0].long() * (H * W)
    di = torch.arange(hl, device=rois.device)
    dj = torch.arange(wl, device=rois.device)
    bins = []
    for ph in range(pooled_height):
        rows = hs[:, ph, None] + di[None, :]                  # (R, hl)
        row_ok = rows < he[:, ph, None]
        for pw in range(pooled_width):
            cols = ws[:, pw, None] + dj[None, :]              # (R, wl)
            ok = row_ok[:, :, None] & (cols < we[:, pw, None])[:, None, :]
            idx = (base[:, None, None] + rows.clamp(max=H - 1)[:, :, None] * W
                   + cols.clamp(max=W - 1)[:, None, :])
            v = torch.where(ok[..., None], flat[idx], float("-inf"))
            m = torch.amax(v, dim=(1, 2))                     # (R, C)
            empty = ~ok.flatten(1).any(dim=1)
            bins.append(torch.where(empty[:, None], 0.0, m).to(features.dtype))
    return torch.stack(bins, dim=1).reshape(R, pooled_height, pooled_width, C)
