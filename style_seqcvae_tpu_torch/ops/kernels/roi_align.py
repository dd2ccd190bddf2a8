"""RoIAlign forward (kernel C), differentiable with respect to the features.

Counterpart of ``style_seqcvae_tpu/ops/pallas/roi_align.py::roi_align_pallas``.
On a CUDA tensor :func:`roi_align` launches the hand-written kernel in
``csrc/roi_align.cu`` inside a ``torch.autograd.Function`` whose backward is
the hand-written ``roi_align_backward_kernel`` of the same file
(:func:`roi_align_backward`); it gives the rois no gradient. On a CPU tensor
it runs :func:`roi_align_plain` (``ops/roi_align.py::roi_align``), which
autograd differentiates.

No TPU kernel lies behind the backward: the JAX package trains through
autodiff of its XLA gather (``style_seqcvae_tpu/ops/roi_align.py:51``,
reached from ``models/detector/faster_rcnn.py:143``), whose transpose is a
scatter-add. :func:`roi_align_backward_plain` is that vector-Jacobian
product of the plain forward. The kernel is a gather instead: a plan pass
writes each RoI's batch index, tap tables (the forward's) and span into a
small int32 buffer, then a block per (image, 4 x 2 tile of map pixels,
channel slab) keeps the RoIs that meet its tile and sums each pixel's
gradient in f32, in a fixed order (RoIs, row bins, column bins), in
registers. Every pixel is written once in grad_out's dtype: no atomics, no
zeroing pass, no f32 buffer and no cast for bf16, and two launches give
the same bits. Its bound at the training step's (4, 40, 64, 1024) with 512
RoIs is 0.0432 ms in f32 and 0.0216 ms in bf16 (grad_out read once, the
gradient written once, at 3.35 TB/s); it takes 0.115 and 0.098 ms there on
an NVIDIA H100 80GB HBM3 at 700.00 W (``scripts/time_detector.py``, a CUDA
graph of 10 launches), against 0.400 and 0.425 ms for the atomic design it
replaced.
"""

from __future__ import annotations

from typing import Tuple

import torch

from style_seqcvae_tpu_torch.ops.roi_align import roi_align as roi_align_plain

# launches of the CUDA kernels in this process (the plain versions not counted)
launches = 0
backward_launches = 0

_MAX_TAPS = 32          # pooled · sampling: the kernel's per-RoI tap tables


def _check(shape, dtype: torch.dtype, device: torch.device, rois: torch.Tensor,
           pooled_height: int, pooled_width: int, sampling_ratio: int) -> None:
    """The arguments both kernels take: features of ``shape`` and ``dtype``
    on ``device`` (the forward's input, the backward's output) and rois."""
    if len(shape) != 4:
        raise ValueError(f"features must be NHWC (B, H, W, C), got {tuple(shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (R, 5), got {tuple(rois.shape)}")
    if rois.device != device:
        raise ValueError(f"rois on {rois.device}, features on {device}")
    if pooled_height != pooled_width:
        raise ValueError("square pooling only")
    if pooled_height < 1 or sampling_ratio < 1 or \
            pooled_height * sampling_ratio > _MAX_TAPS:
        raise ValueError(f"need 1 <= pooled · sampling <= {_MAX_TAPS}, got "
                         f"pooled {pooled_height}, sampling {sampling_ratio}")


def _forward_kernel(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                    pooled: int, sampling_ratio: int) -> torch.Tensor:
    global launches
    if not features.is_contiguous():
        raise ValueError("features must be NHWC-contiguous")
    if rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32")
    from style_seqcvae_tpu_torch.ops.kernels import _build, record_inputs

    lib = _build.library()
    B, H, W, C = features.shape
    R, P = rois.shape[0], pooled
    record_inputs("roi_align", features=features, rois=rois, spatial_scale=spatial_scale,
                  pooled=pooled, sampling_ratio=sampling_ratio)
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


def roi_align_backward(grad_out: torch.Tensor, rois: torch.Tensor,
                       features_shape: Tuple[int, int, int, int], *, spatial_scale: float,
                       pooled_height: int = 7, pooled_width: int = 7,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """The backward kernel alone: grad_out (R, P, P, C) f32 or bf16 (the
    forward's output dtype) on CUDA, rois (R, 5) f32 → grad_features
    (B, H, W, C) in grad_out's dtype."""
    global backward_launches
    _check(features_shape, grad_out.dtype, grad_out.device, rois, pooled_height, pooled_width,
           sampling_ratio)
    B, H, W, C = features_shape
    R, P = rois.shape[0], pooled_height
    if tuple(grad_out.shape) != (R, P, P, C):
        raise ValueError(f"grad_out must be {(R, P, P, C)}, got {tuple(grad_out.shape)}")
    if grad_out.device.type != "cuda":
        raise ValueError(f"the backward kernel needs a CUDA tensor, got {grad_out.device}")
    if rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32")
    from style_seqcvae_tpu_torch.ops.kernels import _build, record_inputs

    grad_out = grad_out.contiguous()
    record_inputs("roi_align_backward", grad_out=grad_out, rois=rois,
                  features_shape=tuple(features_shape), spatial_scale=spatial_scale,
                  pooled=pooled_height, sampling_ratio=sampling_ratio)
    lib = _build.library()
    grad = torch.empty(features_shape, dtype=grad_out.dtype, device=grad_out.device)
    # each RoI's batch index, tap tables and span, from the kernel's plan pass
    plan = torch.empty(R * lib.ssc_roi_align_backward_plan_words(P, sampling_ratio),
                       dtype=torch.int32, device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssc_roi_align_backward(
            grad_out.data_ptr(), rois.data_ptr(), grad.data_ptr(), plan.data_ptr(), B, H, W, C,
            R, float(spatial_scale), P, sampling_ratio,
            int(grad_out.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, "roi_align_backward")
    backward_launches += 1
    return grad


def roi_align_backward_plain(grad_out: torch.Tensor, rois: torch.Tensor,
                             features_shape: Tuple[int, int, int, int], dtype: torch.dtype, *,
                             spatial_scale: float, pooled_height: int = 7,
                             pooled_width: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """grad_out (R, P, P, C), rois (R, 5) → the features' gradient
    (B, H, W, C) in ``dtype``: autograd of the plain forward in f32 (which is
    linear in the features, so zeros serve as the point), cast once."""
    with torch.enable_grad():
        feats = torch.zeros(features_shape, dtype=torch.float32, device=grad_out.device,
                            requires_grad=True)
        out = roi_align_plain(feats, rois, spatial_scale=spatial_scale,
                              pooled_height=pooled_height, pooled_width=pooled_width,
                              sampling_ratio=sampling_ratio)
        (grad,) = torch.autograd.grad(out, feats, grad_out.float())
    return grad.to(dtype)


class _RoIAlign(torch.autograd.Function):
    """Kernel C forward, the backward kernel for the features' gradient."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, pooled, sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.meta = (tuple(features.shape), spatial_scale, pooled, sampling_ratio)
        return _forward_kernel(features, rois, spatial_scale, pooled, sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        shape, spatial_scale, pooled, sampling_ratio = ctx.meta
        grad = roi_align_backward(grad_out, rois, shape, spatial_scale=spatial_scale,
                                  pooled_height=pooled, pooled_width=pooled,
                                  sampling_ratio=sampling_ratio)
        return grad, None, None, None, None


def roi_align(features: torch.Tensor, rois: torch.Tensor, *, spatial_scale: float,
              pooled_height: int = 7, pooled_width: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Same contract as :func:`roi_align_plain`: features (B, H, W, C) f32 or
    bf16, NHWC-contiguous on CUDA; rois (R, 5) f32 → (R, P, P, C) in the
    features' dtype, differentiable with respect to the features."""
    _check(features.shape, features.dtype, features.device, rois, pooled_height, pooled_width,
           sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, spatial_scale=spatial_scale,
                               pooled_height=pooled_height, pooled_width=pooled_width,
                               sampling_ratio=sampling_ratio)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    return _RoIAlign.apply(features, rois, float(spatial_scale), pooled_height,
                           sampling_ratio)
