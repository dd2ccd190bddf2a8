"""ResNet backbone of the detector with frozen BatchNorm (counterpart of
``style_seqcvae_tpu/models/detector/resnet.py``).

:func:`backbone` is conv1 .. layer3 (stride 16, 1024 channels, the C4 map);
:func:`head_to_tail` is layer4 plus global average pooling, the 2048-d
bottom-up feature of each RoI; :func:`trainable_label` names the pieces
that detector training keeps frozen. The public functions take and return NHWC
tensors, as the JAX package does. Inside, an NHWC tensor's
``permute(0, 3, 1, 2)`` is an NCHW view in channels_last memory, which
``F.conv2d`` takes as it is, so the layout switch costs no copy. Weights are
OIHW (``weights.from_jax_detector_params`` transposes the JAX package's
HWIO kernels) and kept in channels_last memory.

The stride of a bottleneck sits on its 1×1 conv1, not on the 3×3 (the
caffe-style ResNet the reference detector uses); the stem max-pool is
``MaxPool2d(3, 2, padding=0, ceil_mode=True)``; BatchNorm is frozen and
computed as the separate affine ``(x - mean) * rsqrt(var + 1e-5) * scale +
offset``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# Caffe-convention inputs are pixel-scale (std ~ 60); a random conv1 folds
# that scale into its init so that random-init activations stay bounded.
_INPUT_PIXEL_STD = 57.6


def _conv_init(gen: torch.Generator, shape, device, dtype) -> torch.Tensor:
    """He-normal OIHW kernel in channels_last memory."""
    fan_in = shape[1] * shape[2] * shape[3]
    w = torch.randn(shape, generator=gen, device=device) * math.sqrt(2.0 / fan_in)
    return w.to(dtype).contiguous(memory_format=torch.channels_last)


def _bn_init(ch: int, device, dtype) -> Dict[str, torch.Tensor]:
    def full(v):
        return torch.full((ch,), v, device=device, dtype=dtype)

    return {"scale": full(1.0), "offset": full(0.0), "mean": full(0.0), "var": full(1.0)}


def init_bottleneck(gen: torch.Generator, in_ch: int, planes: int, stride: int, *,
                    device, dtype) -> Dict[str, Any]:
    # conv3 starts at zero, so every residual branch starts as the identity
    conv3 = torch.zeros((planes * 4, planes, 1, 1), device=device, dtype=dtype)
    p = {
        "conv1": _conv_init(gen, (planes, in_ch, 1, 1), device, dtype),
        "bn1": _bn_init(planes, device, dtype),
        "conv2": _conv_init(gen, (planes, planes, 3, 3), device, dtype),
        "bn2": _bn_init(planes, device, dtype),
        "conv3": conv3.contiguous(memory_format=torch.channels_last),
        "bn3": _bn_init(planes * 4, device, dtype),
    }
    if stride != 1 or in_ch != planes * 4:
        p["downsample"] = {"conv": _conv_init(gen, (planes * 4, in_ch, 1, 1), device, dtype),
                           "bn": _bn_init(planes * 4, device, dtype)}
    return p


def init_resnet(gen: torch.Generator, depth: int = 101, *, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters of the same shapes and init ranges as the JAX
    package's ``init_resnet`` (not the same numbers)."""
    params: Dict[str, Any] = {
        "conv1": (_conv_init(gen, (64, 3, 7, 7), device, torch.float32)
                  / _INPUT_PIXEL_STD).to(dtype),
        "bn1": _bn_init(64, device, dtype),
    }
    in_ch = 64
    for li, (n, planes) in enumerate(zip(LAYERS[depth], (64, 128, 256, 512)), start=1):
        layer: List[Dict[str, Any]] = []
        for bi in range(n):
            stride = 1 if (li == 1 or bi > 0) else 2
            layer.append(init_bottleneck(gen, in_ch, planes, stride, device=device,
                                         dtype=dtype))
            in_ch = planes * 4
        params[f"layer{li}"] = layer
    return params


def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Frozen BatchNorm on an NCHW (channels_last) tensor."""
    def c(v):
        return v.reshape(-1, 1, 1)

    inv = torch.rsqrt(p["var"] + 1e-5)
    return (x - c(p["mean"])) * c(inv) * c(p["scale"]) + c(p["offset"])


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The JAX package's "SAME" convolution for the kernels used here: 3×3
    at stride 1 pads 1, 1×1 pads 0 at any stride."""
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bottleneck(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"], stride), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"]), p["bn2"]))
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = _bn(_conv(x, p["downsample"]["conv"], stride), p["downsample"]["bn"])
    return F.relu(out + x)


def _layer(x: torch.Tensor, blocks: List[Dict[str, Any]], first_stride: int,
           remat: bool = False) -> torch.Tensor:
    for bi, p in enumerate(blocks):
        stride = first_stride if bi == 0 else 1
        if remat and torch.is_grad_enabled():
            # keep only the blocks' outputs; recompute each block's inside in
            # the backward (JAX: jax.checkpoint of the bottleneck)
            x = checkpoint(_bottleneck, x, p, stride, use_reentrant=False)
        else:
            x = _bottleneck(x, p, stride)
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()     # no copy for channels_last


def backbone(params: Dict[str, Any], images: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """images (B, H, W, 3) BGR, mean-subtracted → C4 features
    (B, H/16, W/16, 1024), NHWC-contiguous. ``remat`` recomputes each
    bottleneck in the backward instead of keeping its activations."""
    x = _nchw(images.contiguous())
    x = F.relu(_bn(F.conv2d(x, params["conv1"], stride=2, padding=3), params["bn1"]))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0, ceil_mode=True)
    x = _layer(x, params["layer1"], 1, remat)
    x = _layer(x, params["layer2"], 2, remat)
    x = _layer(x, params["layer3"], 2, remat)
    return _nhwc(x)


def head_to_tail(params: Dict[str, Any], pooled: torch.Tensor) -> torch.Tensor:
    """RoI-pooled (R, 7, 7, 1024) NHWC → layer4 → global average pool →
    (R, 2048)."""
    x = _layer(_nchw(pooled.contiguous()), params["layer4"], 2)
    return x.mean(dim=(2, 3))


def trainable_label(path_keys: List[str]) -> str:
    """'never' for the frozen pieces (conv1, every BatchNorm, layer1), else
    'always' (the reference's FIXED_BLOCKS = 1 and its fixed BatchNorm)."""
    keys = [str(k) for k in path_keys]
    if any(k.startswith("bn") or k in ("scale", "offset", "mean", "var", "downsample_bn")
           for k in keys):
        return "never"
    if "conv1" in keys and not any(k.startswith("layer") for k in keys):
        return "never"
    if "layer1" in keys:
        return "never"
    return "always"
