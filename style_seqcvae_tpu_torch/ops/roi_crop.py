"""RoI crop pooling, the spatial-transformer mode (counterpart of
``style_seqcvae_tpu/ops/roi_crop.py``), plain PyTorch: no TPU kernel lies
behind it (the JAX package computes it with XLA).

Each RoI becomes a 2×3 affine ``theta``; the normalized grid of
``affine_grid`` (``align_corners=True``: -1 and +1 are the first and last
pixel) is sampled bilinearly with zero padding outside the map, and
``roi_crop`` max-pools the 2× grid 2×2. The sampler gathers each corner from
the flat (B·H·W, C) map, as JAX's does, so no per-RoI copy of an image is
made; ``amax`` splits the gradient of tied maxima evenly, as ``jnp.max``.
"""

from __future__ import annotations

import torch


def affine_theta(rois: torch.Tensor, height: int, width: int,
                 spatial_scale: float) -> torch.Tensor:
    """rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in image coordinates →
    theta (R, 2, 3)."""
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    zero = torch.zeros_like(x1)
    row_x = torch.stack([(x2 - x1) / (width - 1), zero,
                         (x1 + x2 - width + 1) / (width - 1)], dim=1)
    row_y = torch.stack([zero, (y2 - y1) / (height - 1),
                         (y1 + y2 - height + 1) / (height - 1)], dim=1)
    return torch.stack([row_x, row_y], dim=1)


def affine_grid(theta: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """theta (R, 2, 3) → normalized xy sampling grid (R, grid_h, grid_w, 2)
    (``F.affine_grid(..., align_corners=True)``)."""
    ys = torch.linspace(-1.0, 1.0, grid_h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, grid_w, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)     # (gh, gw, 3)
    return torch.einsum("ijk,rlk->rijl", base, theta)


def grid_sample(features: torch.Tensor, batch_idx: torch.Tensor,
                grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of features (B, H, W, C) at the normalized grid
    (R, gh, gw, 2) of each RoI's image ``batch_idx`` (R,) → (R, gh, gw, C),
    zero outside the map, in the features' dtype."""
    B, H, W, C = features.shape
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    lx = ix - x0
    ly = iy - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = features.reshape(B * H * W, C)
    roi_base = batch_idx.long()[:, None, None] * (H * W)

    def corner(yc, xc, w):
        inside = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        idx = roi_base + yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)
        return flat[idx] * (w * inside.to(w.dtype))[..., None]

    out = (corner(y0i, x0i, (1 - ly) * (1 - lx))
           + corner(y0i, x0i + 1, (1 - ly) * lx)
           + corner(y0i + 1, x0i, ly * (1 - lx))
           + corner(y0i + 1, x0i + 1, ly * lx))
    return out.to(features.dtype)


def roi_crop(features: torch.Tensor, rois: torch.Tensor, *, spatial_scale: float,
             pooled_height: int = 7, pooled_width: int = 7,
             max_pool: bool = True) -> torch.Tensor:
    """features (B, H, W, C), rois (R, 5) → (R, PH, PW, C); ``max_pool``
    samples a 2× grid, then 2×2-max-pools it."""
    B, H, W, C = features.shape
    gh = pooled_height * 2 if max_pool else pooled_height
    gw = pooled_width * 2 if max_pool else pooled_width
    theta = affine_theta(rois, H, W, spatial_scale)
    crops = grid_sample(features, rois[:, 0], affine_grid(theta, gh, gw))
    if max_pool:
        R = crops.shape[0]
        crops = torch.amax(crops.reshape(R, pooled_height, 2, pooled_width, 2, C), dim=(2, 4))
    return crops
