"""Layers that the detector's modules share, rounded where JAX rounds them
under bf16 compute."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def conv_bias(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """"SAME" convolution of an NCHW (channels_last) tensor by the odd
    square kernel ``p["w"]``, then ``p["b"]`` added to its result in the
    compute dtype after its rounding, as JAX's ``conv + b`` (not fused into
    the sum)."""
    out = F.conv2d(x, p["w"], padding=(p["w"].shape[-1] - 1) // 2)
    return out + p["b"].reshape(-1, 1, 1)


def linear_f32(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (N, in) @ w + b in f32 whatever the compute dtype, as JAX's
    ``jnp.dot(..., preferred_element_type=f32)``: bf16 operands multiply
    exactly in f32, and neither an f32 operand nor the result is rounded to
    bf16. Two bf16 operands on the card outside autograd go to one cuBLAS
    bf16 GEMM that accumulates and returns f32 (``out_dtype``, which
    autograd cannot differentiate), with no f32 copy of the weight;
    otherwise both operands are upcast."""
    w = p["w"]
    if (x.is_cuda and x.dtype == w.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))):
        y = torch.mm(x, w, out_dtype=torch.float32)
    else:
        y = torch.matmul(x.float(), w.float())
    return y + p["b"].float()
