"""The detector's ops in the port against the JAX package: box decoding and
clipping, anchors, RoIAlign (kernel C's plain version, which its wrapper runs
on CPU tensors) against the Pallas kernel in interpret mode and the XLA
version, and greedy NMS (kernel D's plain version) against the Pallas kernel,
the JAX ``nms`` and the numpy golden. The CUDA kernels themselves are held
against these plain versions in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models.detector import anchors as janchors
from style_seqcvae_tpu.ops import boxes as jboxes
from style_seqcvae_tpu.ops.nms import nms as j_nms
from style_seqcvae_tpu.ops.nms import nms_reference as j_nms_reference
from style_seqcvae_tpu.ops.pallas.nms import nms_pallas, suppression_bitmask
from style_seqcvae_tpu.ops.pallas.roi_align import roi_align_pallas as _roi_align_pallas
from style_seqcvae_tpu.ops.roi_align import roi_align as _j_roi_align
from style_seqcvae_tpu_torch.models.detector import anchors as tanchors
from style_seqcvae_tpu_torch.ops import boxes as tboxes
from style_seqcvae_tpu_torch.ops import nms as tnms
from style_seqcvae_tpu_torch.ops.kernels import nms as nms_kernel
from style_seqcvae_tpu_torch.ops.kernels import roi_align as roi_align_kernel
from style_seqcvae_tpu_torch.ops.roi_align import roi_align as t_roi_align

torch.set_num_threads(1)

# f32 RoIAlign: both sides form the same f32 bilinear weights and sum 16
# products of O(1) values in another order -> a few 1e-7.
ROI_F32_TOL = 1e-5
# bf16 RoIAlign: both sides read the same bf16 values exactly as f32 and
# round the f32 mean to bf16 once; a different summation order can round
# to the neighbouring bf16 value: one bf16 ulp, 2^-7 relative.
ROI_BF16_RTOL = 2.0 ** -7

# the edge RoIs of tests/test_pallas_roi_align.py: past the map, inside,
# on the second image, mostly outside, tiny
EDGE_ROIS = np.array([
    [0, 0, 0, 100, 120],
    [0, 16, 8, 64, 96],
    [1, 5, 5, 40, 30],
    [1, 100, 100, 110, 105],
    [0, 0, 0, 3, 3],
    [0, 0, 0, 0, 0],                  # an all-zero padding row
    [1, -30, -12, 9, 7],              # starts left of and above the map
], np.float32)


_ROI_STATIC = ("spatial_scale", "pooled_height", "pooled_width", "sampling_ratio")
roi_align_pallas = jax.jit(_roi_align_pallas, static_argnames=_ROI_STATIC + ("interpret",))
j_roi_align = jax.jit(_j_roi_align, static_argnames=_ROI_STATIC)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# --------------------------------------------------------------- boxes, anchors

def test_bbox_transform_inv_and_clip_match_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(2, 9, 2).astype(np.float32) * 60
    boxes = np.concatenate([xy, xy + rng.rand(2, 9, 2).astype(np.float32) * 30], -1)
    deltas = rng.randn(2, 9, 4 * 5).astype(np.float32)
    deltas[0, 0, 2] = 30.0                       # dw past the +10 clamp
    deltas[1, 3, 7] = -25.0                      # dh past the -10 clamp
    want = np.asarray(jboxes.bbox_transform_inv(jnp.asarray(boxes), jnp.asarray(deltas)))
    got = tboxes.bbox_transform_inv(_t(boxes), _t(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # the strided layout: class j's coordinates are columns 4j..4j+3
    np.testing.assert_allclose(
        got[..., 8:12], tboxes.bbox_transform_inv(_t(boxes), _t(deltas[..., 8:12])).numpy(),
        rtol=0, atol=0)

    want_c = np.asarray(jboxes.clip_boxes(jnp.asarray(want), 50.0, 70.0))
    got_c = tboxes.clip_boxes(_t(want), 50.0, 70.0).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    # per-image bounds broadcast over (B, 1, 1)
    hw = np.array([[40.0, 60.0], [70.0, 30.0]], np.float32)
    got_b = tboxes.clip_boxes(_t(want), _t(hw[:, 0, None, None]), _t(hw[:, 1, None, None]))
    for b in range(2):
        np.testing.assert_array_equal(
            got_b[b].numpy(), np.asarray(jboxes.clip_boxes(jnp.asarray(want[b]), hw[b, 0],
                                                           hw[b, 1])))


@pytest.mark.parametrize("scales,ratios", [((4, 8, 16, 32), (0.5, 1, 2)), ((2, 4), (0.5, 1.0, 2.0))])
def test_anchors_equal_jax(scales, ratios):
    want = janchors.generate_anchors(16, ratios, scales)
    got = tanchors.generate_anchors(16, ratios, scales)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tanchors.shifted_anchors(38, 58, 16, got),
                                  janchors.shifted_anchors(38, 58, 16, want))


# ------------------------------------------------------------------- RoIAlign

@pytest.mark.parametrize("pooled,sampling", [(7, 2), (3, 1)])
def test_roi_align_plain_matches_jax_f32(pooled, sampling):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 12, 14, 8).astype(np.float32)
    kw = dict(spatial_scale=1 / 8.0, pooled_height=pooled, pooled_width=pooled,
              sampling_ratio=sampling)
    want_pallas = np.asarray(roi_align_pallas(jnp.asarray(feats), jnp.asarray(EDGE_ROIS),
                                              interpret=True, **kw))
    want_xla = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(EDGE_ROIS), **kw))
    got = t_roi_align(_t(feats), _t(EDGE_ROIS), **kw)
    assert got.dtype == torch.float32 and got.shape == (len(EDGE_ROIS), pooled, pooled, 8)
    for want in (want_pallas, want_xla):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROI_F32_TOL)
    # the kernel's wrapper runs the plain version on CPU tensors
    np.testing.assert_array_equal(
        roi_align_kernel.roi_align(_t(feats), _t(EDGE_ROIS), **kw).numpy(), got.numpy())


def test_roi_align_plain_matches_jax_bf16():
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 12, 14, 16).astype(np.float32)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    kw = dict(spatial_scale=1 / 8.0, pooled_height=7, pooled_width=7, sampling_ratio=2)
    jf = jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16)
    want_pallas = np.asarray(roi_align_pallas(jf, jnp.asarray(EDGE_ROIS), interpret=True,
                                              **kw).astype(jnp.float32))
    # the XLA version returns its f32 sums; the detector casts them
    want_xla = np.asarray(j_roi_align(jf, jnp.asarray(EDGE_ROIS), **kw)
                          .astype(jnp.bfloat16).astype(jnp.float32))
    got = t_roi_align(fb, _t(EDGE_ROIS), **kw)
    assert got.dtype == torch.bfloat16
    for want in (want_pallas, want_xla):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ROI_BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_plain_matches_pallas_subpixel_c12(dtype):
    """RoIs smaller than a feature pixel, where all samples of a bin share
    their corners (the case kernel C's merged taps exploit), and C = 12, which
    is not a multiple of the kernel's 4- or 8-channel vectors."""
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 12, 14, 12).astype(np.float32)
    R = 9
    xy = rng.rand(R, 2).astype(np.float32) * 110 - 5
    wh = rng.rand(R, 2).astype(np.float32) * 7.5          # < 1 px at 1/8
    rois = np.concatenate([rng.randint(0, 2, (R, 1)).astype(np.float32), xy, xy + wh], 1)
    kw = dict(spatial_scale=1 / 8.0, pooled_height=7, pooled_width=7, sampling_ratio=2)
    tf = _t(feats, getattr(torch, dtype))
    jf = jnp.asarray(tf.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(roi_align_pallas(jf, jnp.asarray(rois), interpret=True, **kw)
                      .astype(jnp.float32))
    got = t_roi_align(tf, _t(rois), **kw)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROI_F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ROI_BF16_RTOL, atol=1e-6)
    np.testing.assert_array_equal(roi_align_kernel.roi_align(tf, _t(rois), **kw).float().numpy(),
                                  got.float().numpy())


def test_roi_align_chunks_cover_many_rois():
    """More RoIs than one gather chunk: the chunked loop matches the XLA
    version row for row."""
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 9, 11, 4).astype(np.float32)
    R = 600
    xy = rng.rand(R, 2).astype(np.float32) * 150 - 10
    wh = rng.rand(R, 2).astype(np.float32) * 80
    rois = np.concatenate([rng.randint(0, 3, (R, 1)).astype(np.float32), xy, xy + wh], 1)
    kw = dict(spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7, sampling_ratio=2)
    want = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(rois), **kw))
    np.testing.assert_allclose(t_roi_align(_t(feats), _t(rois), **kw).numpy(), want,
                               rtol=0, atol=ROI_F32_TOL)


# ------------------------------------------------------------------------ NMS

def random_boxes(rng, n, extent=60.0, size=30.0):
    ctr = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * size + 2
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


_JAX_NMS_CACHE = {}


def _jax_nms(boxes, scores, thr, max_out=0, presorted=False):
    """(keep_idx, keep_mask) of the Pallas kernel (interpret mode) and of
    the JAX ``nms``, per group; computed once per input for both impls."""
    key = (boxes.tobytes(), scores.tobytes(), boxes.shape, thr, max_out, presorted)
    if key not in _JAX_NMS_CACHE:
        _JAX_NMS_CACHE[key] = _jax_nms_uncached(boxes, scores, thr, max_out, presorted)
    return _JAX_NMS_CACHE[key]


_J_NMS_PALLAS = jax.jit(nms_pallas, static_argnums=(2,),
                        static_argnames=("max_out", "interpret", "presorted"))
_J_NMS = jax.jit(j_nms, static_argnums=(2,), static_argnames=("max_out",))


def _jax_nms_uncached(boxes, scores, thr, max_out, presorted):
    outs = []
    for b, s in zip(boxes, scores):
        kp = _J_NMS_PALLAS(jnp.asarray(b), jnp.asarray(s), thr, max_out=max_out,
                           interpret=True, presorted=presorted)
        kx = _J_NMS(jnp.asarray(b), jnp.asarray(s), thr, max_out=max_out)
        outs.append(((np.asarray(kp[0]), np.asarray(kp[1])),
                     (np.asarray(kx[0]), np.asarray(kx[1]))))
    return outs


IMPLS = {"plain": tnms.nms, "kernel_wrapper": nms_kernel.nms}


def chain_boxes(rng, n):
    """A chain of n boxes 10 px wide, each 3 px right of the one before:
    neighbours overlap at IoU 70 / 130 > 0.5, boxes two apart at 40 / 160.
    Scores fall along the chain, so greedy NMS at 0.5 keeps every other box;
    boxes and scores are shuffled together, so the sort has work to do."""
    x = 3.0 * np.arange(n)
    boxes = np.stack([x, np.zeros(n), x + 9.0, np.full(n, 9.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    perm = rng.permutation(n)
    return boxes[perm], scores[perm]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("n,thr,max_out,chain", [
    pytest.param(60, 0.5, 0, False, id="60-0.5-0"),
    pytest.param(200, 0.7, 0, False, id="200-0.7-0"),
    pytest.param(130, 0.3, 17, False, id="130-0.3-17"),
    pytest.param(130, 0.5, 0, True, id="chain-130-0.5-0"),    # crosses two word boundaries
])
def test_nms_matches_jax_and_reference(impl, n, thr, max_out, chain):
    rng = np.random.RandomState(n)
    G = 3
    if chain:
        boxes, scores = map(np.stack, zip(*[chain_boxes(rng, n) for _ in range(G)]))
    else:
        boxes = np.stack([random_boxes(rng, n) for _ in range(G)])
        scores = rng.rand(G, n).astype(np.float32)
    before = (nms_kernel.launches, dict(nms_kernel.launches_by_shape))
    keep_idx, keep_mask = IMPLS[impl](_t(boxes), _t(scores), thr, max_out=max_out)
    # on CPU tensors the wrapper runs the plain version and counts no launch
    assert (nms_kernel.launches, dict(nms_kernel.launches_by_shape)) == before
    assert keep_idx.dtype == torch.int32 and keep_mask.dtype == torch.bool
    assert keep_idx.shape == (G, max_out or n) and keep_mask.shape == (G, n)
    for g, refs in enumerate(_jax_nms(boxes, scores, thr, max_out)):
        for ref_idx, ref_mask in refs:
            np.testing.assert_array_equal(keep_idx[g].numpy(), ref_idx)
            np.testing.assert_array_equal(keep_mask[g].numpy(), ref_mask)
        golden = j_nms_reference(boxes[g], scores[g], thr)
        np.testing.assert_array_equal(tnms.nms_reference(boxes[g], scores[g], thr), golden)
        kept = keep_idx[g].numpy()
        kept = kept[kept >= 0]
        np.testing.assert_array_equal(kept, golden[:len(kept)])
        assert keep_mask[g].sum().item() == len(golden)
        if chain:
            np.testing.assert_array_equal(golden, np.argsort(-scores[g])[::2])


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_nms_ties_zero_area_and_padding(impl):
    """Exact score ties go to the lower index; duplicate boxes, zero-area
    and degenerate (x2 < x1) boxes, zero padding rows at score 0; N not a
    multiple of 64."""
    rng = np.random.RandomState(5)
    n = 77
    boxes = random_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    scores[10:20] = 0.5                                   # a run of exact ties
    boxes[11] = boxes[10]                                 # duplicate, tied score
    boxes[30] = [5, 5, 5, 5]                              # zero extent: area 1 under +1
    boxes[31] = [9, 9, 7, 8]                              # x2 < x1: area 0
    boxes[32] = boxes[30]
    scores[32] = scores[30]
    boxes[70:] = 0.0                                      # padding rows
    scores[70:] = 0.0
    boxes, scores = boxes[None], scores[None]
    for thr in (0.3, 0.7):
        keep_idx, keep_mask = IMPLS[impl](_t(boxes), _t(scores), thr)
        for ref_idx, ref_mask in _jax_nms(boxes, scores, thr)[0]:
            np.testing.assert_array_equal(keep_idx[0].numpy(), ref_idx)
            np.testing.assert_array_equal(keep_mask[0].numpy(), ref_mask)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_nms_presorted(impl):
    """``presorted`` skips the sort and gives what the sorting call gives on
    score-sorted input (the RPN's case, ties included)."""
    rng = np.random.RandomState(9)
    n = 150
    boxes = random_boxes(rng, n, extent=40.0)
    scores = np.sort(rng.rand(n).astype(np.float32))[::-1].copy()
    scores[40:45] = scores[40]
    b, s = _t(boxes[None]), _t(scores[None])
    got = IMPLS[impl](b, s, 0.7, max_out=60, presorted=True)
    want = IMPLS[impl](b, s, 0.7, max_out=60)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    (ref_idx, ref_mask), _ = _jax_nms(boxes[None], scores[None], 0.7, 60, presorted=True)[0]
    np.testing.assert_array_equal(got[0][0].numpy(), ref_idx)
    np.testing.assert_array_equal(got[1][0].numpy(), ref_mask)


def pack_words(matrix: torch.Tensor, below: int = -1) -> torch.Tensor:
    """(G, N, N) bool suppression matrix → kernel D's (G, N, ceil(N / 64))
    int64 words (bit k of word w of row i: box 64 w + k). Every word below
    the diagonal is ``below``, by default -1, all bits set: the scan must
    not read it."""
    m = matrix.numpy()
    G, N, _ = m.shape
    words = -(-N // 64)
    padded = np.zeros((G, N, words * 64), bool)
    padded[..., :N] = m
    w = np.packbits(padded, axis=-1, bitorder="little").view(np.int64).copy()
    w[:, np.arange(words)[None, :] < (np.arange(N) // 64)[:, None]] = below
    return torch.from_numpy(w)


@pytest.mark.parametrize("n,max_out", [(1, 0), (63, 0), (63, 17), (64, 0), (65, 17),
                                       (300, 0), (300, 40), ("chain", 0), ("chain", 40)])
def test_greedy_scan_plain_matches_nms_and_jax(n, max_out):
    """The scan alone: the packed words of the port's suppression matrix
    through ``greedy_scan_plain`` (and ``greedy_scan``, which runs it on CPU
    tensors) give the plain NMS's outputs, the Pallas kernel's (interpret
    mode) and the JAX ``nms``'s, sorted by the permutation and presorted;
    the chain (130 boxes) crosses the 63 → 64 and 127 → 128 word edges."""
    rng = np.random.RandomState(7 if n == "chain" else n)
    G, thr = 2, 0.5
    if n == "chain":
        n = 130
        boxes, scores = map(np.stack, zip(*[chain_boxes(rng, n) for _ in range(G)]))
    else:
        boxes = np.stack([random_boxes(rng, n) for _ in range(G)])
        scores = rng.rand(G, n).astype(np.float32)
    tb, ts = _t(boxes), _t(scores)
    order = tnms.sort_desc(ts)
    sboxes = torch.gather(tb, 1, order[..., None].expand(G, n, 4))
    words = pack_words(tnms.suppression_matrix(sboxes, thr))
    want = tnms.nms(tb, ts, thr, max_out=max_out)
    before = nms_kernel.launches
    for scan in (nms_kernel.greedy_scan_plain, nms_kernel.greedy_scan):
        got = scan(words, order.to(torch.int32), max_out)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert nms_kernel.launches == before
    for g, refs in enumerate(_jax_nms(boxes, scores, thr, max_out)):
        for ref_idx, ref_mask in refs:
            np.testing.assert_array_equal(want[0][g].numpy(), ref_idx)
            np.testing.assert_array_equal(want[1][g].numpy(), ref_mask)
    # presorted: the identity order
    got = nms_kernel.greedy_scan_plain(words, None, max_out)
    want = tnms.nms(sboxes, torch.gather(ts, 1, order), thr, max_out=max_out, presorted=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_greedy_scan_plain_ignores_words_below_diagonal_and_bits_past_n():
    """Only the strict upper triangle of rows < N counts: random bits at or
    below the diagonal and at or past N change nothing."""
    rng = np.random.RandomState(1)
    G, n = 2, 100
    matrix = torch.from_numpy(rng.rand(G, n, n) < 0.05).triu(1)
    # the bits that count: j > i, j < N, in words from the diagonal on
    counted = pack_words(torch.ones_like(matrix).triu(1), below=0)
    noise = torch.from_numpy(rng.randint(-2 ** 63, 2 ** 63 - 1, counted.shape, dtype=np.int64))
    words = (pack_words(matrix) & counted) | (noise & ~counted)
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(G)]).astype(np.int32))
    want = tnms.compact(tnms.greedy_scan(matrix), perm.long())
    for x, y in zip(nms_kernel.greedy_scan_plain(words, perm), want):
        assert torch.equal(x, y)


def test_suppression_matrix_equals_pallas_bitmask():
    """Bit for bit: the port's pairwise suppression matrix against the Pallas
    kernel's packed words (16 bits per int32), unpacked."""
    rng = np.random.RandomState(3)
    n = 128
    boxes = random_boxes(rng, n, extent=30.0)
    for thr in (0.3, 0.7):
        words = np.asarray(suppression_bitmask(jnp.asarray(boxes), thr, interpret=True))
        want = ((words[:, :, None] >> np.arange(16)) & 1).reshape(n, n).astype(bool)
        got = tnms.suppression_matrix(_t(boxes[None]), thr)[0].numpy()
        np.testing.assert_array_equal(got, want)


THRESHOLDS = (0.3, 0.5, 0.7, 0.9)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_suppression_matrix_equals_pallas_bitmask_at_boundary(thr):
    """Bit for bit at the rounding boundary: pairs of one-pixel-high boxes
    whose IoU is exactly c / U, c = round(t U) ± 2 (7 / 10 among them),
    through the port's suppression matrix and the Pallas kernel (interpret
    mode). This pins the reference semantics the CUDA bitmask is held to."""
    n = 256
    boxes = nms_kernel.boundary_boxes(1, n, thr, seed=int(thr * 10))[0].numpy()
    words = np.asarray(suppression_bitmask(jnp.asarray(boxes), thr, interpret=True))
    want = ((words[:, :, None] >> np.arange(16)) & 1).reshape(n, n).astype(bool)
    got = tnms.suppression_matrix(_t(boxes[None]), thr)[0].numpy()
    np.testing.assert_array_equal(got, want)
    # the pair 10 / 7 rounds to t = fl(0.7) itself: not above it
    assert not got[0, 1] or thr < 0.7
    assert (got[np.arange(0, n, 2), np.arange(1, n, 2)].any()
            and not got[np.arange(0, n, 2), np.arange(1, n, 2)].all())


def _adversarial_pairs(rng, t, n):
    """f32 (inter, union): unions over many scales (and integers), inters
    within 3 ulps of fl(t * union), then the degenerate cases."""
    union = np.concatenate([np.exp(rng.uniform(-60, 60, n // 2)),
                            np.round(np.exp(rng.uniform(0, 14, n - n // 2)))]).astype(np.float32)
    inter = (np.float32(t) * union).astype(np.float32)
    steps = rng.randint(-3, 4, n)
    toward = np.where(steps > 0, np.float32(np.inf), np.float32(-np.inf))
    for k in range(3):
        inter = np.where(np.abs(steps) > k, np.nextafter(inter, toward), inter)
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, 1e-38, 3e38],
                       np.float32)
    di, du = np.meshgrid(special, special)
    inter = np.concatenate([inter, di.ravel(), special * np.float32(0.7)])
    union = np.concatenate([union, du.ravel(), special])
    return torch.from_numpy(inter.astype(np.float32)), torch.from_numpy(union.astype(np.float32))


@pytest.mark.parametrize("thr", THRESHOLDS + (0.0, -0.5, 1e-40, 1.0, 3e6))
def test_iou_exceeds_plain_equals_division(thr):
    """The bitmask kernel's division-free test, mirrored on the CPU, against
    ``inter / union > t`` in f32: 10^6 pairs within 3 ulps of the boundary,
    the degenerate values (0, -0, negative, inf, NaN, subnormal), and
    thresholds where the test's premises fail (0, negative, subnormal,
    above 2^20), which take the division."""
    rng = np.random.RandomState(17)
    inter, union = _adversarial_pairs(rng, thr, 1_000_000)
    got = nms_kernel.iou_exceeds_plain(inter, union, thr)
    assert torch.equal(got, inter / union > thr)
    if thr in THRESHOLDS:
        assert 0.2 < got[:1_000_000].float().mean().item() < 0.8


@pytest.mark.parametrize("thr", THRESHOLDS + (0.0, -0.5))
def test_bitmask_rule_on_boxes_equals_suppression_matrix(thr):
    """The kernel's decision as it runs per box, emulated in numpy f32: each
    box carries h, or NaN when its area leaves [2 FLT_MIN / h, FLT_MAX / 4],
    the test's intersection clamps w only, and a pair divides (with both
    clamps) only where e == h u or a value is NaN. Held bit for bit against
    the suppression matrix on the boundary set, random boxes, and
    degenerate ones (zero, negative and huge areas, inf, NaN)."""
    f32 = np.float32
    rng = np.random.RandomState(5)
    rnd = rng.rand(300, 4).astype(f32) * 50
    rnd[:, 2:] += rnd[:, :2]
    degenerate = np.array([[5, 5, 4, 3], [5, 5, 4, 3], [0, 0, 0, 0], [5, 5, 3, 8], [1, 1, -5, -5],
                           [0, 0, 1e30, 1e30], [0, 0, 3e38, 3e38], [0, 0, np.inf, 5],
                           [0, 0, np.nan, 3], [2, 2, 2, 2], [1e-30, 0, 2e-30, 0]], f32)
    cases = [nms_kernel.boundary_boxes(1, 300, thr, seed=3)[0].numpy(), rnd,
             np.concatenate([degenerate, rnd[:20], degenerate])]
    t, h = nms_kernel.fast_test_constants(thr)
    amin, amax = (f32(2) * np.finfo(f32).tiny / h, np.finfo(f32).max / f32(4)) \
        if not np.isnan(h) else (f32(0), f32(0))
    for b in cases:
        with np.errstate(all="ignore"):
            a = (b[:, 2] - b[:, 0] + f32(1)) * (b[:, 3] - b[:, 1] + f32(1))
            hb = np.where((a >= amin) & (a <= amax), h, f32(np.nan)).astype(f32)
            r, c = b[:, None, :], b[None, :, :]
            w = np.minimum(r[..., 2], c[..., 2]) - np.maximum(r[..., 0], c[..., 0]) + f32(1)
            hh = np.minimum(r[..., 3], c[..., 3]) - np.maximum(r[..., 1], c[..., 1]) + f32(1)
            area_sum = a[:, None] + a[None, :]
            inter = np.maximum(w, f32(0)) * hh
            u = area_sum - inter
            e = (inter.astype(np.float64) - np.float64(t) * u.astype(np.float64)).astype(f32)
            hu = hb[None, :] * u
            above = e > hu
            unsure = (~(e < hu) & ~above) | np.isnan(hb)[:, None]
            inter = np.maximum(w, f32(0)) * np.maximum(hh, f32(0))
            got = np.where(unsure, inter / (area_sum - inter) > t, above)
        n = len(b)
        want = tnms.suppression_matrix(_t(b[None]), thr)[0].numpy()
        np.testing.assert_array_equal(got & np.triu(np.ones((n, n), bool), 1), want)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130])
def test_pack_words_and_suppression_bitmask_plain(n):
    """``pack_words`` gives the kernel's word layout (bit k of word w of row
    i: box 64 w + k), and ``suppression_bitmask_plain`` packs the
    suppression matrix, its words below the diagonal 0."""
    rng = np.random.RandomState(n)
    matrix = rng.rand(2, n, n) < 0.3
    padded = np.zeros((2, n, -(-n // 64) * 64), bool)
    padded[..., :n] = matrix
    want = np.packbits(padded, axis=-1, bitorder="little").view(np.int64)
    np.testing.assert_array_equal(nms_kernel.pack_words(torch.from_numpy(matrix)).numpy(), want)
    boxes = _t(np.stack([random_boxes(rng, n) for _ in range(2)]))
    words = nms_kernel.suppression_bitmask_plain(boxes, 0.5)
    assert torch.equal(words, pack_words(tnms.suppression_matrix(boxes, 0.5), below=0))


def test_nms_empty_and_grouped_shapes():
    keep_idx, keep_mask = tnms.nms(torch.zeros((2, 0, 4)), torch.zeros((2, 0)), 0.5)
    assert keep_idx.shape == (2, 0) and keep_mask.shape == (2, 0)
    with pytest.raises(ValueError):
        nms_kernel.nms(torch.zeros((5, 4)), torch.zeros((5,)), 0.5)      # not grouped
    with pytest.raises(TypeError):
        nms_kernel.nms(torch.zeros((1, 5, 4), dtype=torch.float64), torch.zeros((1, 5)), 0.5)
