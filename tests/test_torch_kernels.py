"""The port's vocabulary-selection kernels: their plain PyTorch versions (what
the wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode and their XLA references. The CUDA kernels themselves are
held against the plain versions in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.ops.pallas.topk_lse import top_k_with_lse as j_topk_lse
from style_seqcvae_tpu.ops.pallas.topk_lse import top_k_with_lse_xla as j_topk_lse_xla
from style_seqcvae_tpu.ops.pallas.vocab_topk_lse import (
    matmul_top_k_with_lse as j_mm_topk_lse,
)
from style_seqcvae_tpu.ops.pallas.vocab_topk_lse import (
    matmul_top_k_with_lse_xla as j_mm_topk_lse_xla,
)
from style_seqcvae_tpu_torch.ops.kernels import _build, topk_lse, vocab_topk_lse

torch.set_num_threads(1)

# f32 values: both sides form the same f32 products and differ only in
# summation order over E (<= 48 terms of magnitude ~1) -> ~1e-6; lse adds a
# tile-by-tile merge on the JAX side. Indices must match exactly.
F32_TOL = 1e-5
# bf16 inputs are converted exactly to f32 on both sides, so the same
# reasoning holds; the JAX kernel feeds bf16 into its f32-accumulating dot.
BF16_TOL = 1e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("R,V,E,k", [
    (16, 700, 40, 4), (13, 530, 24, 10),
    # the f32 CUDA kernel's boundaries (test_torch_cuda.py holds it to the
    # plain version at these shapes): R 129 (a row past a 128-row tile) and
    # 6,400 (a split decode's chunk), V below, just above and past whole
    # 128-column tiles, E with a K tail past 32-wide chunks or padded to 8
    # (33, 300, 599), k 1 and 127
    (129, 10501, 33, 1), (6400, 129, 300, 10), (129, 127, 599, 127),
])
def test_vocab_topk_lse_plain_matches_pallas(R, V, E, k):
    rng = np.random.RandomState(R)
    x = rng.randn(R, E).astype(np.float32)
    emb = rng.randn(V, E).astype(np.float32)
    jv, ji, jl = j_mm_topk_lse(jnp.asarray(x), jnp.asarray(emb), k, interpret=True,
                               block_rows=8, block_v=256)
    xv, xi, xl = j_mm_topk_lse_xla(jnp.asarray(x), jnp.asarray(emb), k)
    v, i, lse = vocab_topk_lse.matmul_top_k_with_lse(_t(x), _t(emb), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32 and lse.shape == (R,)
    for ref_i in (ji, xi):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    # the summation-order difference grows with the number of terms: at
    # E <= 48 it is F32_TOL, at E = 599 (logits ~ +-60) up to ~3e-5
    tol = F32_TOL * max(1.0, E / 48)
    for ref_v, ref_l in ((jv, jl), (xv, xl)):
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=tol, rtol=tol)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), atol=tol, rtol=tol)


def test_vocab_topk_lse_plain_ties_go_to_lower_index():
    """Duplicate embedding rows give exactly tied logits, within and across
    the JAX kernel's V tiles."""
    rng = np.random.RandomState(2)
    E = 16
    x = rng.randn(8, E).astype(np.float32)
    base = rng.randn(300, E).astype(np.float32)
    base[290] = base[3]
    base[200] = base[100]
    base[201] = base[100]
    jv, ji, _ = j_mm_topk_lse(jnp.asarray(x), jnp.asarray(base), 12, interpret=True,
                              block_rows=8, block_v=256)
    v, i, _ = vocab_topk_lse.matmul_top_k_with_lse(_t(x), _t(base), 12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=F32_TOL)


def test_vocab_topk_lse_plain_bf16():
    rng = np.random.RandomState(3)
    R, V, E, k = 8, 512, 32, 6
    x, emb = rng.randn(R, E), rng.randn(V, E)
    jv, ji, jl = j_mm_topk_lse(jnp.asarray(x, jnp.bfloat16), jnp.asarray(emb, jnp.bfloat16),
                               k, interpret=True, block_rows=8, block_v=256)
    v, i, lse = vocab_topk_lse.matmul_top_k_with_lse(_t(x, torch.bfloat16),
                                                     _t(emb, torch.bfloat16), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 10])
def test_topk_lse_plain_matches_pallas(dtype, k):
    rng = np.random.RandomState(k)
    logits = (rng.randn(18, 1000) * 3).astype(np.float32)   # 18 % 8 != 0
    logits[3, 10] = logits[3, 900] = logits[3].max() + 1.0  # a tie at the top
    logits[5, :] = 2.0                                      # a row of ties
    jx = jnp.asarray(logits, getattr(jnp, dtype))
    jv, ji, jl = j_topk_lse(jx, k, interpret=True)
    xv, xi, xl = j_topk_lse_xla(jx, k)
    v, i, lse = topk_lse.top_k_with_lse(_t(logits, getattr(torch, dtype)), k)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for ref in ((jv, ji, jl), (xv, xi, xl)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[0]), atol=tol, rtol=tol)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref[2]), atol=tol, rtol=tol)
    np.testing.assert_array_equal(i.numpy()[5], np.arange(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ties", "ascending"])
def test_topk_lse_plain_matches_pallas_hard_rows(dtype, case):
    """The rows that are hardest for kernel B's threshold filter: values on
    4 levels, where nearly every entry ties and the lower index must win,
    and rows that rise strictly, where every element passes the threshold
    (consecutive bf16 bit patterns from 1.0 up, exact in f32 too)."""
    R, V, k = 18, 1001, 10
    rng = np.random.RandomState(6)
    if case == "ties":
        logits = np.floor(rng.rand(R, V) * 4).astype(np.float32)
    else:
        bits = np.arange(0x3F80, 0x3F80 + V, dtype=np.uint32) << 16
        logits = np.tile(bits.view(np.float32), (R, 1))
    jx = jnp.asarray(logits, getattr(jnp, dtype))
    jv, ji, jl = j_topk_lse(jx, k, interpret=True)
    v, i, lse = topk_lse.top_k_with_lse_plain(_t(logits, getattr(torch, dtype)), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=F32_TOL)
    want_i = np.arange(V - 1, V - 1 - k, -1) if case == "ascending" else None
    if want_i is not None:
        np.testing.assert_array_equal(i.numpy(), np.tile(want_i, (R, 1)))


def test_topk_lse_plain_all_neg_inf_rows():
    """All -inf rows: distinct indices in index order, lse -inf (not NaN)."""
    logits = np.full((8, 10), -np.inf, np.float32)
    logits[2, 4] = 1.0                                   # one finite entry
    jv, ji, jl = j_topk_lse(jnp.asarray(logits), 3, interpret=True)
    v, i, lse = topk_lse.top_k_with_lse(_t(logits), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jl))
    assert np.isneginf(lse.numpy()[0]) and lse.numpy()[2] == 1.0


@pytest.mark.parametrize("bad", ["rank", "dtype", "k"])
def test_wrappers_reject_bad_input(bad):
    x = torch.zeros(4, 8)
    emb = torch.zeros(16, 8)
    if bad == "rank":
        with pytest.raises(ValueError):
            topk_lse.top_k_with_lse(x[0], 2)
        with pytest.raises(ValueError):
            vocab_topk_lse.matmul_top_k_with_lse(x, emb[:, :4], 2)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            topk_lse.top_k_with_lse(x.half(), 2)
        with pytest.raises(TypeError):
            vocab_topk_lse.matmul_top_k_with_lse(x, emb.bfloat16(), 2)
    else:
        with pytest.raises(ValueError):
            topk_lse.top_k_with_lse(x, 9)
        with pytest.raises(ValueError):
            vocab_topk_lse.matmul_top_k_with_lse(x, emb, 128)


def test_cpu_tensors_never_launch():
    before = (topk_lse.launches, vocab_topk_lse.launches)
    topk_lse.top_k_with_lse(torch.randn(4, 32), 3)
    vocab_topk_lse.matmul_top_k_with_lse(torch.randn(4, 8), torch.randn(32, 8), 3)
    assert (topk_lse.launches, vocab_topk_lse.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_topk_lse_width_padding_is_exact(dtype):
    """The bf16 CUDA path zero-pads E to a multiple of 8 (TMA's 16-byte
    rows): 300 -> 304 leaves the plain version's results bit for bit."""
    rng = np.random.RandomState(6)
    x = _t(np.tanh(rng.randn(37, 300)), dtype)
    emb = _t(rng.randn(530, 300), dtype)
    xp, ep = vocab_topk_lse.pad_width(x, emb)
    assert xp.shape == (37, 304) and ep.shape == (530, 304) and xp.dtype == dtype
    assert not xp[:, 300:].any() and not ep[:, 300:].any()
    assert torch.equal(xp[:, :300], x) and torch.equal(ep[:, :300], emb)
    for a, b in zip(vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, 10),
                    vocab_topk_lse.matmul_top_k_with_lse_plain(xp, ep, 10)):
        assert torch.equal(a, b)
    assert vocab_topk_lse.pad_width(xp, ep)[0] is xp                # already a multiple
    # widths that padding would make equal are still refused
    with pytest.raises(ValueError):
        vocab_topk_lse.matmul_top_k_with_lse(x, emb[:, :299], 10)


def test_launch_error_code_raises_kernel_error(monkeypatch):
    """A CUDA error code from a launch, through the wrappers' own error path
    (``_build.check``), and a build without nvcc, raise ``KernelError``: the
    inference CLI lets it through instead of falling back image by image."""

    class Lib:
        def ssc_error_string(self, rc):
            return b"an illegal memory access was encountered"

    assert issubclass(_build.KernelError, RuntimeError)
    _build.check(Lib(), 0, "vocab_topk_lse")                         # success: no raise
    with pytest.raises(_build.KernelError, match="vocab_topk_lse launch failed: CUDA "
                                                 "error 700 .an illegal memory access"):
        _build.check(Lib(), 700, "vocab_topk_lse")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build._nvcc()
