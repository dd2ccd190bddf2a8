"""RoIAlign's features gradient: the port's plain backward
(``ops/kernels/roi_align.py::roi_align_backward_plain``, autograd of the plain
RoIAlign, the reference the CUDA backward kernel is held to on the card)
against ``jax.vjp`` of the JAX package's RoIAlign (``ops/roi_align.py``,
whose transpose is XLA's scatter-add), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.ops.roi_align import roi_align as j_roi_align
from style_seqcvae_tpu_torch.ops.kernels.roi_align import roi_align_backward_plain

torch.set_num_threads(1)

# f32: both sides add the same f32 products of sample weights and gradients
# per pixel, in another order (and the port merges a bin's samples that share
# a pixel first): a few ulps of the largest gradient. bf16: the port sums in
# f32 and rounds once, as JAX's f32 VJP rounded to bf16 does: one bf16 ulp
# (2^-8) of the largest gradient apart at most.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# JAX's own bf16 VJP rounds each tap's share to bf16 and scatter-adds in
# bf16 (XLA's CPU backend): 3-5% of the largest gradient from its f32 VJP on
# these inputs. The port is held to it no farther than JAX's f32 VJP,
# rounded once, is, plus one bf16 ulp of the largest gradient.
BF16_ULP = 2.0 ** -8
B, H, W, C, R = 2, 9, 11, 5, 24
SCALE = 1 / 16.0


def _inputs(seed: int, P: int):
    """Seeded features' shape, rois with the edge cases first, and a
    cotangent: past the map, the whole map, an all-zero padding row, RoIs
    under a pixel wide, then random boxes over and around the 144 x 176
    image; batch indices in [0, B)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-30, 150, (R, 2))
    wh = rng.uniform(0, 120, (R, 2))
    rois = np.concatenate([rng.randint(0, B, (R, 1)), xy, xy + wh], 1).astype(np.float32)
    rois[0] = [1, 200, 200, 260, 260]            # past the map: every sample empty
    rois[1] = [1, 0, 0, 16 * W - 1, 16 * H - 1]  # the whole map
    rois[2] = [0, 0, 0, 0, 0]                    # a padding row
    rois[3] = [0, 0, 0, 0, 0]                    # another, on the same pixels
    rois[4] = [0, 40, 50, 43, 52]                # sub-pixel on the map
    rois[5] = [1, 170, 130, 175.5, 143.9]        # sub-pixel at the far corner
    rois[6] = [0, -20, -9, 6, 4]                 # starts left of and above the map
    g = rng.randn(R, P, P, C).astype(np.float32)
    return rois, g


def _jax_vjp(rois, g, P, S, jdtype):
    def fwd(x):
        return j_roi_align(x, jnp.asarray(rois), spatial_scale=SCALE, pooled_height=P,
                           pooled_width=P, sampling_ratio=S)

    _, vjp = jax.vjp(jax.jit(fwd), jnp.zeros((B, H, W, C), jdtype))
    (grad,) = vjp(jnp.asarray(g))
    assert grad.dtype == jdtype
    return np.asarray(grad.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,S", [(7, 2), (4, 3)])
def test_plain_backward_matches_jax_vjp(P, S, dtype):
    rois, g = _inputs(P * 10 + S, P)
    # the port's grad_out arrives in the forward's dtype: make the cotangent
    # exact in it, so that both sides see the same values
    g_t = torch.from_numpy(g).to(dtype)
    g = g_t.float().numpy()
    got = roi_align_backward_plain(g_t, torch.from_numpy(rois), (B, H, W, C), dtype,
                                   spatial_scale=SCALE, pooled_height=P, pooled_width=P,
                                   sampling_ratio=S)
    assert got.dtype == dtype and tuple(got.shape) == (B, H, W, C)
    got = got.float().numpy()
    want = _jax_vjp(rois, g, P, S, jnp.float32)
    if dtype == torch.bfloat16:
        want = torch.from_numpy(want).to(dtype).float().numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (err, scale)
    # the padding rows' two pixels and the whole-map RoI carry gradient
    assert np.abs(got[0, :2, :2]).max() > 0 and np.abs(got[1]).max() > 0
    if dtype == torch.bfloat16:
        # JAX on bf16 features: its bf16 VJP
        jax_bf16 = _jax_vjp(rois, g, P, S, jnp.bfloat16)
        own = float(np.abs(want - jax_bf16).max())
        assert float(np.abs(got - jax_bf16).max()) <= own + BF16_ULP * scale
