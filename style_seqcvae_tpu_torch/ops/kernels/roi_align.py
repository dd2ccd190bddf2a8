"""RoIAlign forward (kernel C).

Counterpart of ``style_seqcvae_tpu/ops/pallas/roi_align.py::roi_align_pallas``.
On a CUDA tensor :func:`roi_align` launches the hand-written kernel in
``csrc/roi_align.cu``; on a CPU tensor it runs :func:`roi_align_plain`
(``ops/roi_align.py::roi_align``).
"""

from __future__ import annotations

import torch

from style_seqcvae_tpu_torch.ops.roi_align import roi_align as roi_align_plain

# launches of the CUDA kernel in this process (the plain version not counted)
launches = 0

_MAX_TAPS = 32          # pooled · sampling: the kernel's per-RoI tap tables


def _check(features: torch.Tensor, rois: torch.Tensor, pooled_height: int,
           pooled_width: int, sampling_ratio: int) -> None:
    if features.dim() != 4:
        raise ValueError(f"features must be NHWC (B, H, W, C), got {tuple(features.shape)}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (R, 5), got {tuple(rois.shape)}")
    if rois.device != features.device:
        raise ValueError(f"rois on {rois.device}, features on {features.device}")
    if pooled_height != pooled_width:
        raise ValueError("square pooling only")
    if pooled_height < 1 or sampling_ratio < 1 or \
            pooled_height * sampling_ratio > _MAX_TAPS:
        raise ValueError(f"need 1 <= pooled · sampling <= {_MAX_TAPS}, got "
                         f"pooled {pooled_height}, sampling {sampling_ratio}")


def roi_align(features: torch.Tensor, rois: torch.Tensor, *, spatial_scale: float,
              pooled_height: int = 7, pooled_width: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Same contract as :func:`roi_align_plain`: features (B, H, W, C) f32 or
    bf16, NHWC-contiguous on CUDA; rois (R, 5) f32 → (R, P, P, C) in the
    features' dtype."""
    global launches
    _check(features, rois, pooled_height, pooled_width, sampling_ratio)
    kw = dict(spatial_scale=spatial_scale, pooled_height=pooled_height,
              pooled_width=pooled_width, sampling_ratio=sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, **kw)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    if not features.is_contiguous():
        raise ValueError("features must be NHWC-contiguous")
    if rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32")
    from style_seqcvae_tpu_torch.ops.kernels import _build

    lib = _build.library()
    B, H, W, C = features.shape
    R, P = rois.shape[0], pooled_height
    out = torch.empty((R, P, P, C), dtype=features.dtype, device=features.device)
    if R == 0 or C == 0:
        return out
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssc_roi_align(features.data_ptr(), rois.data_ptr(), out.data_ptr(),
                               B, H, W, C, R, float(spatial_scale), P, sampling_ratio,
                               int(features.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, "roi_align")
    launches += 1
    return out
