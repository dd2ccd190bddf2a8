"""VGG16 backbone of the detector (counterpart of
``style_seqcvae_tpu/models/detector/vgg.py``).

:func:`backbone` is conv1_1 .. conv5_3 (13 3×3 convolutions with ReLU and
four 2×2 max-pools, the last pool dropped: stride 16, 512 channels);
:func:`head_to_tail` is fc6 and fc7 (4096 each) on the RoI flattened in
NCHW order, as torchvision's classifier reads it. The public functions take
and return NHWC tensors; inside, the NCHW view of an NHWC tensor is
channels_last memory (as in ``resnet.py``). The reference VGG variant has no
attribute head. Conv weights are OIHW in channels_last memory; ``fc6`` and
``fc7`` are {"w": (in, out), "b": (out,)}.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from style_seqcvae_tpu_torch.models.detector.layers import conv_bias, linear_f32
from style_seqcvae_tpu_torch.models.detector.resnet import _INPUT_PIXEL_STD

# conv channels per block (torchvision vgg16.features)
_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def init_vgg16(gen: torch.Generator, *, device, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters of the JAX package's ``init_vgg16`` shapes and
    ranges (He-normal convs, the first scaled by 1 / the pixel std; uniform
    fc layers), not its numbers."""
    params: Dict[str, Any] = {"convs": []}
    in_ch = 3
    for bi, (out_ch, n) in enumerate(_CFG):
        for ci in range(n):
            std = math.sqrt(2.0 / (9 * in_ch))
            if bi == 0 and ci == 0:
                std /= _INPUT_PIXEL_STD
            w = torch.randn((out_ch, in_ch, 3, 3), generator=gen, device=device) * std
            params["convs"].append({
                "w": w.to(dtype).contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((out_ch,), device=device, dtype=dtype)})
            in_ch = out_ch

    def fc(fan_in, out):
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, out), generator=gen, device=device) * 2 - 1) * bound
        return {"w": w.to(dtype), "b": torch.zeros((out,), device=device, dtype=dtype)}

    params["fc6"] = fc(512 * 7 * 7, 4096)
    params["fc7"] = fc(4096, 4096)
    return params


def backbone(params: Dict[str, Any], images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) → conv5_3 features (B, H/16, W/16, 512),
    NHWC-contiguous."""
    x = images.contiguous().permute(0, 3, 1, 2)
    ci = 0
    for bi, (_, n) in enumerate(_CFG):
        for _ in range(n):
            x = F.relu(conv_bias(x, params["convs"][ci]))
            ci += 1
        if bi < 4:                      # the last max-pool is dropped
            x = F.max_pool2d(x, kernel_size=2, stride=2)
    return x.permute(0, 2, 3, 1).contiguous()


def head_to_tail(params: Dict[str, Any], pooled: torch.Tensor) -> torch.Tensor:
    """RoI-pooled (R, 7, 7, 512) NHWC → fc6 / fc7 → (R, 4096) f32. Under
    bf16 compute fc7 takes fc6's f32 output unrounded, as JAX promotes it."""
    flat = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
    x = F.relu(linear_f32(params["fc6"], flat))
    return F.relu(linear_f32(params["fc7"], x))


def trainable_label(path_keys: List[str]) -> str:
    """'never' for the first two conv blocks (convs 0-3), else 'always'.
    List indices come as ``"[i]"``, as JAX names them."""
    keys = [str(k) for k in path_keys]
    if "convs" in keys:
        for k in keys:
            if k.startswith("[") and k.strip("[]").isdigit():
                return "never" if int(k.strip("[]")) < 4 else "always"
    return "always"
