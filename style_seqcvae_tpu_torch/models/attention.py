"""Bottom-up top-down additive attention (counterpart of
``style_seqcvae_tpu/models/attention.py``).

The query carries arbitrary inner grid dims (z-samples, FSM states, beam)
between batch and H; image features stay ``(B, N, P)`` and are broadcast,
never replicated per beam. Without a gradient the weights come from
``ops/kernels/butd_attention.py`` (the CUDA kernel on the card, its plain
version on the CPU); a call that needs a gradient runs the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from style_seqcvae_tpu_torch.ops.kernels.butd_attention import (
    butd_attention,
    butd_attention_plain,
)


class AttentionParams(NamedTuple):
    w_query: torch.Tensor   # (query_size, projection_size), no bias
    w_image: torch.Tensor   # (image_feature_size, projection_size), no bias
    w_attend: torch.Tensor  # (projection_size,), no bias


def init_attention(query_size: int, image_feature_size: int, projection_size: int,
                   *, generator: torch.Generator, device: torch.device,
                   dtype=torch.float32) -> AttentionParams:
    """``nn.Linear`` default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def uni(shape, fan_in):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return ((2.0 * u - 1.0) / fan_in ** 0.5).to(dtype)

    return AttentionParams(
        w_query=uni((query_size, projection_size), query_size),
        w_image=uni((image_feature_size, projection_size), image_feature_size),
        w_attend=uni((projection_size,), projection_size),
    )


def project_image_features(params: AttentionParams, image_features: torch.Tensor) -> torch.Tensor:
    """(B, N, F) → (B, N, P). Computed once per decode."""
    return torch.matmul(image_features, params.w_image)


def attention_weights(params: AttentionParams, query: torch.Tensor,
                      projected_image_features: torch.Tensor,
                      image_features_mask: torch.Tensor) -> torch.Tensor:
    """``w_a · tanh(W_q q + W_v V)`` → masked softmax over boxes.

    query (B, ..., H); projected_image_features (B, N, P);
    image_features_mask (B, N). Returns (B, ..., N). A call that needs the
    gradient (training) runs ``butd_attention_plain``, plain PyTorch that
    autograd differentiates; every other call runs ``butd_attention``,
    whose kernel has no backward."""
    proj_query = torch.matmul(query, params.w_query)
    B, N, P = projected_image_features.shape
    if proj_query.shape[0] != B:
        raise ValueError(f"query's batch {proj_query.shape[0]} is not the features' {B}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (query, projected_image_features, *params))
    weights = (butd_attention_plain if needs_grad else butd_attention)(
        proj_query.reshape(-1, P), projected_image_features, params.w_attend,
        image_features_mask)
    return weights.reshape(tuple(proj_query.shape[:-1]) + (N,))
