"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA GPU and skips without one. This file imports
neither JAX nor the JAX package, so on a machine with the card it runs
without the JAX-side test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data import image_decode as idec
from style_seqcvae_tpu_torch.data.detection import decode_image_bgr
from style_seqcvae_tpu_torch.data.datasets import EvaluationDatasetWithConstraints
from style_seqcvae_tpu_torch.data.vocabulary import (
    BOUNDARY_TOKEN,
    UNK_TOKEN,
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.decoding import beam_search as tbs
from style_seqcvae_tpu_torch.decoding import cbs as tdense
from style_seqcvae_tpu_torch.decoding import samplers as tsam
from style_seqcvae_tpu_torch.decoding.cbs_fast import fsm_to_tables
from style_seqcvae_tpu_torch.decoding.device_fsm import build_attribute_wordform_table, draw_gumbel
from style_seqcvae_tpu_torch.decoding.fsm import pack_fsm
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness, pad_tables_batch
from style_seqcvae_tpu_torch.models import captioner as tcap
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig, init_detector
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state
from style_seqcvae_tpu_torch.models.attention import AttentionParams, attention_weights
from style_seqcvae_tpu_torch.ops.kernels import (
    butd_attention,
    nms,
    roi_align,
    topk_lse,
    vocab_topk_lse,
)
from style_seqcvae_tpu_torch.scripts import inference as cli
from style_seqcvae_tpu_torch.serving import make_serve_fn
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter, pack_obj_atts
from style_seqcvae_tpu_torch.weights import to_device

# Kernel A sums each E-long f32 dot product in another order than the plain
# matmul: values and lse ~1e-5 apart at these widths, a few 1e-4 at worst
# over thousands of rows; an index may swap only between two logits that
# close. Kernel B reads the same f32 values as the
# plain version and selects in the same order: values and indices are equal;
# its logsumexp sums the row in another order.
A_TOL = 1e-3
LSE_TOL = 1e-3
# Kernel C sums the 16 weighted corner reads of a bin in another order than
# its plain version (same f32 weights): a few 1e-7 on O(1) features; in bf16
# the f32 means may then round to neighbouring bf16 values, one ulp apart.
ROI_F32_TOL = 1e-5
ROI_BF16_RTOL = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V,E,k", [(300, 5003, 96, 10), (33, 257, 600, 127), (1, 10, 8, 10)])
def test_vocab_topk_lse_kernel(dev, dtype, R, V, E, k):
    gen = torch.Generator(device=dev).manual_seed(R)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev)).to(dtype)
    emb = torch.randn(V, E, generator=gen, device=dev).to(dtype)
    emb[V // 2] = emb[V - 1]                                # exact ties across tiles
    before = vocab_topk_lse.launches
    got = vocab_topk_lse.matmul_top_k_with_lse(x, emb, k)
    want = vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, k)
    torch.cuda.synchronize()
    assert vocab_topk_lse.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=A_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)
    swapped = got[1] != want[1]
    assert swapped.float().mean().item() < 1e-3
    assert all(len(set(row)) == k for row in got[1].tolist())     # distinct indices


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,E,k", [
    (1, 10500, 600, 10), (300, 10500, 600, 10), (12801, 10500, 600, 10),   # ragged R
    (300, 10, 600, 10), (300, 257, 600, 10),                               # ragged V
    (300, 10500, 8, 10), (300, 10500, 300, 10),                            # E: 8, 300 (padded)
    (300, 10500, 600, 127),
])
def test_vocab_topk_lse_bf16_kernel(dev, R, V, E, k):
    """The bf16 tensor-core kernel. Columns 1, V // 2 and V - 1 share one
    embedding row, scaled up so that it often tops a row: exact ties across
    vocabulary tiles and, at these R, across the blocks' runs of tiles."""
    gen = torch.Generator(device=dev).manual_seed(R + V + E + k)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev)).to(torch.bfloat16)
    emb = torch.randn(V, E, generator=gen, device=dev).to(torch.bfloat16)
    tied = [1, V // 2, V - 1]
    emb[tied] = 3 * emb[1]
    before = vocab_topk_lse.launches
    got = vocab_topk_lse.matmul_top_k_with_lse(x, emb, k)
    want = vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, k)
    torch.cuda.synchronize()
    assert vocab_topk_lse.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=A_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)
    swapped = got[1] != want[1]
    assert swapped.float().mean().item() < 1e-3
    assert all(len(set(row)) == k for row in got[1].tolist())     # distinct indices
    assert bool(((got[1] >= 0) & (got[1] < V)).all())
    # equal values in selection order: lower index first
    same = got[0][:, 1:] == got[0][:, :-1]
    assert bool((got[1][:, 1:] > got[1][:, :-1])[same].all())
    top_tied = torch.isin(want[1][:, 0], torch.tensor(tied, device=dev))
    if R > 1 and V > k:
        assert top_tied.any()
    assert torch.equal(got[1][top_tied, :2], want[1][top_tied, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,E,k", [
    (129, 10501, 33, 1), (129, 127, 599, 127), (129, 129, 300, 10),   # a row past a tile
    (6400, 10500, 600, 10), (6400, 129, 599, 1), (6400, 10501, 33, 127),  # a split chunk
])
def test_vocab_topk_lse_f32_kernel(dev, R, V, E, k):
    """The f32 CUDA-core kernel across the boundaries of its work split: R
    129 and 6,400, V below, just above and past whole 128-column tiles, E
    with a K tail past 32-wide chunks or padded to 8, k 1 and 127. Columns
    1, V // 2 and V - 1 share one embedding row, scaled up so that it often
    tops a row (exact ties across tiles and blocks), and the last row of x
    is zero: all its logits tie at 0."""
    gen = torch.Generator(device=dev).manual_seed(R + V + E + k)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev))
    x[-1] = 0.0
    emb = torch.randn(V, E, generator=gen, device=dev)
    tied = [1, V // 2, V - 1]
    emb[tied] = 3 * emb[1]
    before = vocab_topk_lse.launches
    got = vocab_topk_lse.matmul_top_k_with_lse(x, emb, k)
    want = vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, k)
    torch.cuda.synchronize()
    assert vocab_topk_lse.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=A_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)
    swapped = got[1] != want[1]
    assert swapped.float().mean().item() < 1e-3
    assert all(len(set(row)) == k for row in got[1].tolist())     # distinct indices
    assert bool(((got[1] >= 0) & (got[1] < V)).all())
    same = got[0][:, 1:] == got[0][:, :-1]
    assert bool((got[1][:, 1:] > got[1][:, :-1])[same].all())     # ties: lower index first
    top_tied = torch.isin(want[1][:, 0], torch.tensor(tied, device=dev))
    assert top_tied.any()
    assert torch.equal(got[1][top_tied, :2], want[1][top_tied, :2])
    # the row of all-equal logits: the k lowest indices, lse = log V
    assert got[1][-1].tolist() == list(range(k))
    assert got[0][-1].eq(0).all()
    assert abs(got[2][-1].item() - float(np.log(V))) < LSE_TOL


@pytest.mark.cuda
def test_vocab_topk_lse_f32_topk_spans_segments(dev):
    """Row 0's top 10 lie in the runs of different persistent blocks (its
    row tile crosses segments), with one exact tie between two of them:
    the merge of the partial lists must give the plain version's order."""
    R, V, E, k = 6400, 10500, 600, 10
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.tanh(torch.randn(R, E, generator=gen, device=dev))
    emb = torch.randn(V, E, generator=gen, device=dev)
    plan = vocab_topk_lse.plan(R, V, E + (-E % 8), k, torch.float32)
    tiles, blocks = -(-V // 128), plan["blocks"]
    units = -(-R // 128) * tiles
    start = [b * units // blocks for b in range(blocks + 1)]
    # the blocks whose runs hold units of row tile 0 (units 0 .. tiles - 1)
    owners = [b for b in range(blocks) if start[b] < tiles and start[b + 1] > 0]
    assert len(owners) >= 2
    first, last = (range(start[b] * 128, min(start[b + 1] * 128, V))
                   for b in (owners[0], owners[-1]))
    cols = [first[7], last[3], first[40], last[60], first[99], last[11], first[3],
            last[20], first[70], last[-1]]
    unit = x[0] / x[0].norm()
    for j, c in enumerate(cols):
        emb[c] = (20.0 - j) * unit                           # row 0's top 10, in this order
    emb[last[3]] = emb[first[7]]                             # a tie across the segments
    got = vocab_topk_lse.matmul_top_k_with_lse(x, emb, k)
    want = vocab_topk_lse.matmul_top_k_with_lse_plain(x, emb, k)
    torch.cuda.synchronize()
    assert sorted(got[1][0].tolist()) == sorted(cols)
    assert got[1][0, :2].tolist() == sorted([first[7], last[3]])
    assert torch.equal(got[1][0], want[1][0])
    torch.testing.assert_close(got[0], want[0], atol=A_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)
    assert (got[1] != want[1]).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V,k", [(300, 10500, 10), (7, 130, 127)])
def test_topk_lse_kernel(dev, dtype, R, V, k):
    gen = torch.Generator(device=dev).manual_seed(R)
    logits = (3 * torch.randn(R, V, generator=gen, device=dev)).to(dtype)
    logits[0] = float("-inf")                               # distinct indices, lse -inf
    logits[1] = 2.0                                         # all tied
    logits[2, 5] = logits[2, V - 1] = 100.0                 # a tie at the top
    before = topk_lse.launches
    got = topk_lse.top_k_with_lse(logits, k)
    want = topk_lse.top_k_with_lse_plain(logits, k)
    torch.cuda.synchronize()
    assert topk_lse.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)
    assert got[1][0].tolist() == list(range(k)) and torch.isneginf(got[2][0])


def _ascending(R, V, dtype, dev):
    """Rows that rise strictly along V, so every element passes the kernel's
    threshold: consecutive bf16 bit patterns from 1.0 up (all finite), or
    0, 1, 2, ... in f32."""
    if dtype == torch.bfloat16:
        bits = torch.arange(0x3F80, 0x3F80 + V, dtype=torch.int32, device=dev)
        row = bits.to(torch.int16).view(torch.bfloat16)
    else:
        row = torch.arange(V, dtype=torch.float32, device=dev)
    return row.expand(R, V).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,R,V,k", [
    ("misaligned", 2200, 10501, 10),   # odd V: bf16 rows start anywhere; a warp per row
    ("two_warps", 1500, 3001, 10),     # on 132 SMs, 2 warps share each row
    ("four_warps", 700, 3001, 10),     # and 4
    ("small_odd", 29, 129, 10),        # few rows: 8 warps share each row
    ("ties", 300, 10500, 10),          # 4 levels only
    ("ascending", 5, 10500, 10),       # every element passes the threshold
    ("k1", 64, 1001, 1),
    ("k32", 50, 2000, 32),             # the largest k whose threshold is seeded
    ("k127", 40, 4099, 127),
    ("one_row", 1, 10500, 10),
])
def test_topk_lse_kernel_edges(dev, dtype, case, R, V, k):
    gen = torch.Generator(device=dev).manual_seed(V + k)
    if case == "ties":
        logits = torch.floor(4 * torch.rand(R, V, generator=gen, device=dev)).to(dtype)
    elif case == "ascending":
        logits = _ascending(R, V, dtype, dev)
    else:
        logits = (3 * torch.randn(R, V, generator=gen, device=dev)).to(dtype)
    before = topk_lse.launches
    got = topk_lse.top_k_with_lse(logits, k)
    want = topk_lse.top_k_with_lse_plain(logits, k)
    torch.cuda.synchronize()
    assert topk_lse.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)


@pytest.mark.cuda
def test_topk_lse_kernel_past_old_cap(dev):
    """f32 rows of 65,537: the shared-memory row of the old kernel refused
    V > 58,112; the misaligned start and odd length need the peeled edges."""
    gen = torch.Generator(device=dev).manual_seed(65537)
    logits = 3 * torch.randn(50, 65537, generator=gen, device=dev)
    got = topk_lse.top_k_with_lse(logits, 10)
    want = topk_lse.top_k_with_lse_plain(logits, 10)
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=LSE_TOL, rtol=0)


def _rois(gen, dev, R, B, extent):
    """Seeded RoIs: random boxes, boxes that leave the map, tiny boxes and
    all-zero padding rows."""
    xy = torch.rand(R, 2, generator=gen, device=dev) * extent * 1.2 - 0.1 * extent
    wh = torch.rand(R, 2, generator=gen, device=dev) * extent * 0.5
    b = torch.randint(0, B, (R, 1), generator=gen, device=dev).float()
    rois = torch.cat([b, xy, xy + wh], dim=1)
    rois[1::7, 3:] = rois[1::7, 1:3] + 0.5                  # tiny
    rois[2::7] = 0.0                                         # padding rows
    return rois.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,R,P,S", [(2, 38, 58, 1024, 300, 7, 2),
                                           (3, 11, 13, 200, 50, 3, 1),
                                           (2, 9, 10, 64, 40, 4, 3)])   # S² = 9: a division
def test_roi_align_kernel(dev, dtype, B, H, W, C, R, P, S):
    gen = torch.Generator(device=dev).manual_seed(C)
    feats = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    rois = _rois(gen, dev, R, B, 16.0 * max(H, W))
    kw = dict(spatial_scale=1 / 16.0, pooled_height=P, pooled_width=P, sampling_ratio=S)
    before = roi_align.launches
    got = roi_align.roi_align(feats, rois, **kw)
    want = roi_align.roi_align_plain(feats, rois, **kw)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    assert got.dtype == dtype and got.shape == (R, P, P, C)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ROI_F32_TOL, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=ROI_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["c13", "c36", "subpixel", "whole_map", "batch_past_b"])
def test_roi_align_kernel_edges(dev, dtype, case):
    """C = 13 and C = 36 (f32 rows of 144 bytes take 16-byte vectors, bf16
    rows of 72 bytes do not); RoIs under a feature pixel; RoIs over the whole
    38 x 58 map and past it; batch indices past B and below 0, which the
    kernel clamps."""
    B, H, W, stride = 2, 38, 58, 16.0
    C = {"c13": 13, "c36": 36}.get(case, 64)
    gen = torch.Generator(device=dev).manual_seed(C)
    feats = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    rois = _rois(gen, dev, 60, B, stride * max(H, W))
    if case == "subpixel":
        rois[:, 3:] = rois[:, 1:3] + torch.rand(60, 2, generator=gen, device=dev) * stride
    elif case == "whole_map":
        rois[0] = torch.tensor([0.0, 0.0, 0.0, stride * W - 1, stride * H - 1], device=dev)
        rois[1] = torch.tensor([1.0, -40.0, -40.0, stride * W + 40, stride * H + 40],
                               device=dev)
        rois[2:] = rois[:2].repeat(29, 1)
    kw = dict(spatial_scale=1 / stride, pooled_height=7, pooled_width=7, sampling_ratio=2)
    want_rois = rois
    if case == "batch_past_b":
        rois[0::3, 0] = B + 2.0
        rois[1::3, 0] = -1.0
        want_rois = torch.cat([rois[:, :1].clamp(0, B - 1), rois[:, 1:]], dim=1)
    got = roi_align.roi_align(feats, rois, **kw)
    want = roi_align.roi_align_plain(feats, want_rois, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ROI_F32_TOL, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=ROI_BF16_RTOL)


def _boxes(gen, dev, G, N, extent=600.0):
    ctr = torch.rand(G, N, 2, generator=gen, device=dev) * extent
    wh = torch.rand(G, N, 2, generator=gen, device=dev) * 150 + 1
    return torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,thr,max_out,presorted", [
    (16, 6000, 0.7, 300, True),       # the RPN's call at full width
    (1280, 300, 0.3, 0, False),       # the per-class call at full width
    (5, 77, 0.5, 10, False),          # N not a multiple of 64
    (3, 64, 0.5, 100, True),          # max_out beyond N
    (4, 1001, 0.9, 0, False),
    (2, 6001, 0.3, 300, True),
])
def test_nms_kernel(dev, G, N, thr, max_out, presorted):
    """Seeded boxes (ties, a duplicate, a box of area 0), then the boundary
    set (pairs whose IoU is c / U exactly, at and around t), through the
    kernels against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(N)
    boxes = _boxes(gen, dev, G, N)
    scores = torch.rand(G, N, generator=gen, device=dev)
    scores[:, 3:9] = 0.5                                     # exact ties
    boxes[:, 4] = boxes[:, 3]                                # a tied duplicate
    boxes[:, 10] = torch.tensor([5.0, 5.0, 4.0, 3.0], device=dev)   # x2 < x1: area 0
    for case in (boxes, nms.boundary_boxes(G, N, thr, seed=N).to(dev)):
        b, sc = case, scores
        if presorted:
            order = torch.sort(scores, dim=1, descending=True, stable=True).indices
            sc = torch.gather(scores, 1, order)
            b = torch.gather(case, 1, order[..., None].expand(G, N, 4)).contiguous()
        before, before_shape = nms.launches, nms.launches_by_shape[(G, N)]
        got = nms.nms(b, sc, thr, max_out=max_out, presorted=presorted)
        want = nms.nms_plain(b, sc, thr, max_out=max_out, presorted=presorted)
        torch.cuda.synchronize()
        assert nms.launches == before + 1
        assert nms.launches_by_shape[(G, N)] == before_shape + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


def _check_bitmask(boxes, thr):
    """The kernel's words of sorted boxes (G, N, 4) against
    ``suppression_bitmask_plain`` on the CPU, in the strict upper triangle
    only (each row's words from its diagonal word on); launched once more
    on a buffer of -1 through the C interface, the words below the diagonal
    must stay -1."""
    from style_seqcvae_tpu_torch.ops.kernels import _build

    G, N, _ = boxes.shape
    got = nms.suppression_bitmask(boxes, thr)
    want = nms.suppression_bitmask_plain(boxes.cpu(), thr)
    words = got.shape[-1]
    upper = torch.arange(words)[None, :] >= (torch.arange(N) // 64)[:, None]
    mismatched = (got.cpu() != want) & upper
    assert int(mismatched.sum()) == 0, mismatched.nonzero()[:5].tolist()
    filled = torch.full_like(got, -1)
    lib = _build.library()
    _build.check(lib, lib.ssc_nms_bitmask(boxes.data_ptr(), filled.data_ptr(), G, N, float(thr),
                                          torch.cuda.current_stream().cuda_stream), "bitmask")
    filled = filled.cpu()
    assert torch.equal(filled[:, upper], got.cpu()[:, upper])
    assert bool((filled[:, ~upper] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 64, 65, 300, 6000, 6001])
@pytest.mark.parametrize("site,thr", [("rpn", 0.7), ("per_class", 0.3)])
def test_nms_bitmask_kernel(dev, site, thr, N):
    """The bitmask alone on proposal-like boxes (16 to 400 px over a
    600 x 900 image, as chip_smoke.py seeds both call sites), at the site's
    threshold."""
    G = 2 if N > 1000 else 24
    gen = torch.Generator(device=dev).manual_seed(N + int(thr * 10))
    ctr = torch.rand(G, N, 2, generator=gen, device=dev) * torch.tensor([900.0, 600.0],
                                                                         device=dev)
    wh = torch.rand(G, N, 2, generator=gen, device=dev) * 384.0 + 16.0
    _check_bitmask(torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1).contiguous(), thr)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7, 0.9])
def test_nms_bitmask_kernel_boundary(dev, thr):
    """The boundary set: pairs of one-pixel-high boxes with inter = c and
    union = U exactly, c = round(t U) ± 2 (7 / 10 among them), U up to 10^6
    and multiples of 2^-4 up to 2^19."""
    for G, N in ((2, 6000), (64, 300), (3, 65)):
        _check_bitmask(nms.boundary_boxes(G, N, thr, seed=N).to(dev), thr)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7, 0.9, 0.0, -0.5, 1e-40])
def test_nms_bitmask_kernel_degenerate(dev, thr):
    """Zero, negative and huge areas, identical and all-zero boxes, inf and
    NaN coordinates, among random ones; and thresholds where the
    division-free test does not hold (0, negative, subnormal), which send
    every pair to the division."""
    gen = torch.Generator(device=dev).manual_seed(3)
    odd = torch.tensor([[5, 5, 4, 3], [5, 5, 4, 3], [0, 0, 0, 0], [5, 5, 3, 8], [1, 1, -5, -5],
                        [0, 0, 1e30, 1e30], [0, 0, 3e38, 3e38], [0, 0, float("inf"), 5],
                        [0, 0, float("nan"), 3], [2, 2, 2, 2], [0, 0, 0, 0]], device=dev)
    boxes = _boxes(gen, dev, 3, 130, extent=60.0)
    boxes[:, ::12] = odd[: len(range(0, 130, 12))]
    boxes[:, 1::12] = boxes[:, ::12]                       # identical to the one before
    _check_bitmask(boxes.contiguous(), thr)


def _scan_words(rng, G, N, density):
    """Synthetic words (G, N, ceil(N / 64)) int64 for the scan alone: random
    bits at ``density`` in every word from the diagonal on (bits at or below
    the diagonal and at or past N included, which the scan must ignore), or
    the chain (row i marks only box i + 1, so every other box is kept);
    every word below the diagonal -1, so that a read there shows."""
    words = -(-N // 64)
    if density == "chain":
        bits = np.zeros((G, N, words * 64), bool)
        bits[:, np.arange(N - 1), np.arange(1, N)] = True
    else:
        bits = rng.randint(0, 1 << 16, (G, N, words * 64), dtype=np.int32) < density * (1 << 16)
    w = np.packbits(bits, axis=-1, bitorder="little").view(np.int64).copy()
    w[:, np.arange(words)[None, :] < (np.arange(N) // 64)[:, None]] = -1
    return torch.from_numpy(w)


@pytest.mark.cuda
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 6000, 6001])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0, "chain"])
def test_greedy_scan_kernel(dev, density, N, permuted):
    """The scan kernel alone against greedy_scan_plain, for max_out 0, 300
    and N + 5, with the identity order or a random permutation."""
    rng = np.random.RandomState(N)
    G = 2 if N > 1000 else 3
    words = _scan_words(rng, G, N, density)
    order = torch.from_numpy(np.stack([rng.permutation(N) for _ in range(G)]).astype(np.int32)) \
        if permuted else None
    want_idx, want_mask = nms.greedy_scan_plain(words, order, 0)
    if density == 1.0:                                       # only the first box survives
        assert int(want_mask.sum()) == G
    for max_out in (0, 300, N + 5):
        got_idx, got_mask = nms.greedy_scan(words.to(dev), None if order is None
                                            else order.to(dev), max_out)
        torch.cuda.synchronize()
        out_len = min(max_out, N) if max_out else N
        assert torch.equal(got_idx.cpu(), want_idx[:, :out_len])
        assert torch.equal(got_mask.cpu(), want_mask)


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_misuse(dev):
    x = torch.randn(8, 16, device=dev)
    with pytest.raises(ValueError):
        topk_lse.top_k_with_lse(x.T, 2)                     # not contiguous
    with pytest.raises(ValueError):
        vocab_topk_lse.matmul_top_k_with_lse(x, torch.randn(32, 16), 2)  # mixed devices
    feats = torch.randn(1, 4, 4, 8, device=dev)
    rois = torch.zeros(2, 5, device=dev)
    with pytest.raises(ValueError):
        roi_align.roi_align(feats.permute(0, 2, 1, 3), rois, spatial_scale=1.0)  # not NHWC
    with pytest.raises(ValueError):
        roi_align.roi_align(feats, rois.cpu(), spatial_scale=1.0)             # mixed devices
    with pytest.raises(TypeError):
        nms.nms(torch.zeros(1, 5, 4, device=dev, dtype=torch.float64),
                torch.zeros(1, 5, device=dev), 0.5)
    with pytest.raises(ValueError):
        nms.suppression_bitmask(torch.zeros(2, 5, 4, device=dev).transpose(0, 1), 0.5)
    with pytest.raises(ValueError):
        nms.suppression_bitmask(torch.zeros(41, device=dev)[1:].view(1, 10, 4), 0.5)  # 4 B off


# ---------------------------------------------------------------- attention
# The BUTD attention kernel against its plain version (plain PyTorch ops on
# the card). f32: the kernel's tanh is tanhf, the plain version's,
# and its P-long sums and its softmax run in another order than cuBLAS's
# matvec and PyTorch's reductions: weights a few 1e-7 apart. bf16: the
# kernel sums, takes the tanh (tanh.approx.f32, relative error ~2^-11) and
# the softmax in f32 and rounds the weights once, so its f32 logits are held
# to the plain arithmetic run in f32 on the same bf16 inputs. Readings on an
# H100 at these shapes: f32 weights at most 7.5e-8 apart, bf16 logits 7.0e-6,
# the tanh sweep 0 (the f32 route's tanh is tanhf itself).
ATTN_F32_TOL = 1e-5
ATTN_BF16_LOGITS_TOL = 1e-4
ATTN_TANH_TOL = 2e-7


def _attention_inputs(dev, dtype, B, rpi, N, P, seed, ragged=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (0.3 * torch.randn(B * rpi, P, generator=gen, device=dev)).to(dtype)
    pv = (0.6 * torch.randn(B, N, P, generator=gen, device=dev)).to(dtype)
    w = ((2 * torch.rand(P, generator=gen, device=dev) - 1) / P ** 0.5).to(dtype)
    mask = torch.ones(B, N, dtype=torch.bool, device=dev)
    if ragged:
        mask = torch.arange(N, device=dev) < torch.randint(1, N + 1, (B, 1), generator=gen,
                                                           device=dev)
        if B > 1:
            mask[-1] = False                                # a fully masked image
    return q, pv, w, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,rpi,N,P,ragged", [
    (16, 800, 100, 768, False),      # the cells' decode step
    (1, 800, 100, 768, True),        # a serve request over fewer real boxes
    (3, 40, 37, 768, True),
    (2, 7, 1, 100, True),
    (2, 33, 150, 768, True),         # boxes past one tile: running max and sum
    (2, 9, 37, 101, True),           # odd width: 2-byte bf16 copies, 4-byte f32
])
def test_butd_attention_kernel(dev, dtype, B, rpi, N, P, ragged):
    q, pv, w, mask = _attention_inputs(dev, dtype, B, rpi, N, P, seed=B * rpi + N, ragged=ragged)
    before = butd_attention.launches
    got, logits = butd_attention.butd_attention_logits(q, pv, w, mask)
    again = butd_attention.butd_attention(q, pv, w, mask)
    want = butd_attention.butd_attention_plain(q, pv, w, mask)
    torch.cuda.synchronize()
    assert butd_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == (B * rpi, N)
    assert torch.equal(got, again)                          # two launches bit-equal
    keep = mask.repeat_interleave(rpi, dim=0)
    assert (got[~keep] == 0).all()                          # masked boxes, masked rows
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATTN_F32_TOL, rtol=0)
    else:
        f32 = torch.matmul((q.float().reshape(B, rpi, 1, P) + pv.float()[:, None]).tanh(),
                           w.float()).reshape(B * rpi, N)
        torch.testing.assert_close(logits[keep], f32[keep], atol=ATTN_BF16_LOGITS_TOL, rtol=0)
        # the weights: the f32 softmax of the kernel's own logits, rounded
        # once; its sum runs in another order, so a value may round to the
        # neighbouring bf16 (one ulp, 2^-8 to 2^-7 relative)
        soft = butd_attention.masked_softmax(logits, keep)
        torch.testing.assert_close(got.float(), soft.to(dtype).float(), atol=0, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_butd_attention_tanh_sweep(dev):
    """The f32 route's tanh against tanhf (``torch.tanh``) over [-12, 12],
    its special values and a sweep near 0: one box, width 1, w = 1."""
    x = torch.cat([torch.linspace(-12, 12, 1 << 20, device=dev),
                   torch.tensor([0.0, -0.0, 1e-30, 0.55, 0.6, 9.0, 9.1, float("inf"),
                                 float("-inf")], device=dev)])
    x = torch.cat([x, x * 1e-3])[:, None].contiguous()
    _, got = butd_attention.butd_attention_logits(
        x, torch.zeros(1, 1, 1, device=dev), torch.ones(1, device=dev),
        torch.ones(1, 1, dtype=torch.bool, device=dev))
    assert (got[:, 0] - torch.tanh(x[:, 0])).abs().max().item() <= ATTN_TANH_TOL


@pytest.mark.cuda
def test_attention_weights_routes_on_gpu(dev):
    """Without a gradient the weights come from the kernel and match the
    plain version; under grad the plain version runs and the kernel does
    not."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params = AttentionParams(*(0.1 * torch.randn(s, generator=gen, device=dev)
                               for s in ((24, 16), (32, 16), (16,))))
    query = torch.randn(3, 2, 4, 24, generator=gen, device=dev)
    pv = torch.randn(3, 6, 16, generator=gen, device=dev)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1] * 6, [0] * 6], device=dev) > 0
    before = butd_attention.launches
    with torch.no_grad():
        got = attention_weights(params, query, pv, mask)
    assert butd_attention.launches == before + 1
    grads = [t.clone().requires_grad_(True) for t in (*params, query)]
    want = attention_weights(AttentionParams(*grads[:3]), grads[3], pv, mask)
    want.sum().backward()
    assert butd_attention.launches == before + 1
    assert all(g.grad is not None for g in (grads[0], grads[2], grads[3]))
    torch.testing.assert_close(got, want.detach(), atol=ATTN_F32_TOL, rtol=0)


@pytest.mark.cuda
def test_butd_attention_raises_on_cuda_misuse(dev):
    q, pv, w, mask = _attention_inputs(dev, torch.float32, 2, 4, 6, 16, seed=0)
    with pytest.raises(ValueError):
        butd_attention.butd_attention(q, pv.transpose(1, 2).contiguous().transpose(1, 2), w,
                                      mask)                 # pv not contiguous
    with pytest.raises(TypeError):
        butd_attention.butd_attention(q, pv.bfloat16(), w, mask)   # mixed dtypes
    with pytest.raises(ValueError):
        butd_attention.butd_attention(q, pv.cpu(), w, mask)        # mixed devices


# ---------------------------------------------------------------- decodes
# A small f32 model decoded on the GPU and on the CPU on the same seeded
# noise. Every selection here runs without a selection kernel, so the two
# differ only in how cuBLAS and the CPU sum the step's products and how the
# attention kernel sums its scores (~1e-6): tokens must be identical, scores
# within DECODE_LP_TOL.
DECODE_LP_TOL = 1e-3
DEC = dict(vocab_size=300, image_feature_size=32, embedding_size=300, hidden_size=24,
           attention_projection_size=16, z_space=8, sentiment_vae=1, simple_vae=False,
           max_caption_length=8, beam_size=4)
DEC_B, DEC_NZ, DEC_S = 3, 2, 8


def _decode_model(dev, **kw):
    cfg = tcap.CaptionerConfig(**{**DEC, **kw})
    params = tcap.init_captioner(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(4)
    feats = rng.randn(DEC_B, 6, cfg.image_feature_size).astype(np.float32)
    sent = rng.choice([-1.0, 1.0], (DEC_B, 1)).astype(np.float32)
    return cfg, params, to_device(params, dev), feats, sent


def _simple_fsm(rng, vocab):
    f = np.zeros((DEC_S, DEC_S, vocab), np.uint8)
    for s in range(DEC_S):
        f[s, s, :] = 1
    toks = rng.randint(2, vocab, (3, 2))
    for c in range(3):
        for s in range(DEC_S):
            if not (s & 2 ** c) and (s | 2 ** c) < DEC_S:
                for t in toks[c]:
                    f[s, s | 2 ** c, t], f[s, s, t] = 1, 0
    return f


def _same(got, want, lp_got, lp_want, live=None):
    live = torch.ones_like(lp_want, dtype=torch.bool) if live is None else live
    assert torch.equal(got.cpu()[live], want[live])
    assert (lp_got.cpu()[live] - lp_want[live]).abs().max().item() <= DECODE_LP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["raw", "logprob"])
def test_decode_cbs_selection_gpu_matches_cpu(dev, selection):
    cfg, params, params_gpu, feats, sent = _decode_model(dev)
    rng = np.random.RandomState(5)
    tables = pad_tables_batch([[fsm_to_tables(_simple_fsm(rng, cfg.vocab_size))]
                               for _ in range(DEC_B)], DEC_NZ)
    noise = rng.randn(DEC_NZ, cfg.max_caption_length, DEC_B, DEC_S, cfg.beam_size,
                      cfg.z_space).astype(np.float32)
    args = (feats, sent, None, tables, 3, noise, DEC_NZ)
    want = DecodeHarness(params, cfg, device="cpu").decode_cbs(*args, selection=selection,
                                                               return_all=True)
    counts = (vocab_topk_lse.launches, topk_lse.launches)
    got = DecodeHarness(params_gpu, cfg, device=dev).decode_cbs(*args, selection=selection,
                                                                return_all=True)
    assert (vocab_topk_lse.launches, topk_lse.launches) == counts     # no kernel
    _same(got[0], want[0], got[1], want[1], live=want[1] > -1e18)


@pytest.mark.cuda
def test_decode_beam_gpu_matches_cpu(dev):
    cfg, params, params_gpu, feats, sent = _decode_model(dev, embedding_size=16)
    noise = np.random.RandomState(6).randn(DEC_NZ, cfg.max_caption_length, DEC_B,
                                           cfg.beam_size, cfg.z_space).astype(np.float32)
    want = DecodeHarness(params, cfg, device="cpu").decode_beam(feats, sent, None, noise, DEC_NZ)
    got = DecodeHarness(params_gpu, cfg, device=dev).decode_beam(feats, sent, None, noise,
                                                                 DEC_NZ)
    assert got[0].device.type == "cuda"
    _same(got[0], want[0], got[1], want[1])


@pytest.mark.cuda
def test_greedy_and_dense_cbs_gpu_match_cpu(dev):
    cfg, params, params_gpu, feats, sent = _decode_model(dev)
    T, K = cfg.max_caption_length, cfg.beam_size
    rng = np.random.RandomState(7)
    packed = np.stack([pack_fsm(_simple_fsm(rng, cfg.vocab_size)) for _ in range(DEC_B)])
    noise = torch.from_numpy(rng.randn(T, DEC_B, DEC_S, K, cfg.z_space).astype(np.float32))
    out = {}
    for d, p in ((torch.device("cpu"), params), (dev, params_gpu)):
        ctx = tcap.make_decode_context(p, cfg, torch.from_numpy(feats).to(d),
                                       sentiment=torch.from_numpy(sent).to(d))
        step = tcap.make_optimized_step_fn(p, cfg, ctx)
        start = torch.full((DEC_B,), cfg.boundary_index, device=d)
        st = init_cell_state((DEC_B,), cfg.hidden_size, device=d)
        out[d.type] = (
            tbs.greedy_decode(step, start, st, noise[:, :, 0, :1].to(d), max_steps=T,
                              end_index=cfg.boundary_index),
            tdense.constrained_beam_search(step, start, st, packed, noise.to(d), max_steps=T,
                                           beam_size=K, per_node_beam_size=K // 2,
                                           end_index=cfg.boundary_index))
    (g_cpu, (s_cpu, l_cpu)), (g_gpu, (s_gpu, l_gpu)) = out["cpu"], out["cuda"]
    assert torch.equal(g_gpu.cpu(), g_cpu)
    _same(s_gpu, s_cpu, l_gpu, l_cpu, live=l_cpu > -1e18)


@pytest.mark.cuda
def test_decodes_raise_on_cuda_misuse(dev):
    cfg, _, params_gpu, feats, sent = _decode_model(dev)
    harness = DecodeHarness(params_gpu, cfg, device=dev)
    T, K = cfg.max_caption_length, cfg.beam_size
    good = torch.zeros(DEC_NZ, T, DEC_B, K, cfg.z_space, device=dev)
    with pytest.raises(ValueError):
        harness.decode_beam(feats, sent, None, torch.Generator(), DEC_NZ)   # CPU generator
    with pytest.raises(ValueError):
        harness.decode_beam(feats, sent, None, good.long(), DEC_NZ)          # integer noise
    with pytest.raises(ValueError):
        harness.decode_beam(feats, sent, None, good[:, 1:], DEC_NZ)          # T - 1 rows
    with pytest.raises(ValueError):
        harness.decode_cbs(feats, sent, None, [[fsm_to_tables(_simple_fsm(
            np.random.RandomState(0), cfg.vocab_size))]] * DEC_B, 3,
            torch.Generator(), DEC_NZ, selection="raw")
    ctx = tcap.make_decode_context(params_gpu, cfg, torch.from_numpy(feats).to(dev),
                                   sentiment=torch.from_numpy(sent).to(dev))
    step = tcap.make_optimized_step_fn(params_gpu, cfg, ctx)
    start = torch.full((DEC_B,), cfg.boundary_index, device=dev)
    st = init_cell_state((DEC_B,), cfg.hidden_size, device=dev)
    with pytest.raises(ValueError):
        tbs.beam_search(step, start, st, good[0].cpu(), max_steps=T, beam_size=K,
                        end_index=1)                                          # noise on the CPU
    with pytest.raises(ValueError):
        tbs.greedy_decode(step, start, st, good[0, :, :, :1].half().long(), max_steps=T,
                          end_index=1)
    packed = np.zeros((DEC_B, DEC_S, cfg.vocab_size), np.uint32)
    noise = torch.zeros(T, DEC_B, DEC_S, K, cfg.z_space, device=dev)
    with pytest.raises(ValueError):
        tdense.constrained_beam_search(step, start, st, torch.from_numpy(
            packed.astype(np.float32)).to(dev), noise, max_steps=T, beam_size=K, end_index=1)
    with pytest.raises(ValueError):
        tdense.constrained_beam_search(step, start, st, packed[:, :, :, None], noise,
                                       max_steps=T, beam_size=K, end_index=1)


# the samplers on the GPU against the CPU: the same f32 model, z-noise and
# Gumbel noise on both sides, no kernel on the path, so the tokens must be
# identical
SAMPLE_METHODS = {"multinomial": {}, "topk": {}, "topp": {"temperature": 0.8}, "gumbel": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(SAMPLE_METHODS))
def test_decode_sample_gpu_matches_cpu(dev, method):
    cfg, params, params_gpu, feats, sent = _decode_model(dev)
    T, K = cfg.max_caption_length, cfg.beam_size
    rng = np.random.RandomState(8)
    inner = (K,) if method == "gumbel" else ()
    z = rng.randn(DEC_NZ, T, DEC_B, K if inner else 1, cfg.z_space).astype(np.float32)
    g = -np.log(rng.exponential(size=(DEC_NZ, T, DEC_B) + inner + (cfg.vocab_size,))
                ).astype(np.float32)
    args = (feats, sent, None, (z, g), DEC_NZ, method)
    want = DecodeHarness(params, cfg, device="cpu").decode_sample(*args, **SAMPLE_METHODS[method])
    counts = (vocab_topk_lse.launches, topk_lse.launches)
    got = DecodeHarness(params_gpu, cfg, device=dev).decode_sample(*args,
                                                                   **SAMPLE_METHODS[method])
    assert (vocab_topk_lse.launches, topk_lse.launches) == counts     # no kernel
    assert got.device.type == dev.type and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["raw", "prehead"])
def test_decode_cbs_mode2_gpu_matches_cpu(dev, selection):
    """Mode 2 (the per-step attention-weighted attribute prior). ``raw`` has
    no kernel: identical tokens. ``prehead`` runs kernel A (f32) on the GPU
    and its plain version on the CPU, whose sums differ in order: a near-tie
    may flip a beam, so 90% of the best captions must be identical."""
    cfg, params, params_gpu, feats, sent = _decode_model(dev, sentiment_vae=2)
    rng = np.random.RandomState(9)
    oae = rng.randn(DEC_B, feats.shape[1], cfg.z_space).astype(np.float32)
    tables = pad_tables_batch([[fsm_to_tables(_simple_fsm(rng, cfg.vocab_size))]
                               for _ in range(DEC_B)], DEC_NZ)
    noise = rng.randn(DEC_NZ, cfg.max_caption_length, DEC_B, DEC_S, cfg.beam_size,
                      cfg.z_space).astype(np.float32)
    args = (feats, sent, oae, tables, 3, noise, DEC_NZ)
    want = DecodeHarness(params, cfg, device="cpu").decode_cbs(*args, selection=selection)
    before = vocab_topk_lse.launches
    got = DecodeHarness(params_gpu, cfg, device=dev).decode_cbs(*args, selection=selection)
    launched = vocab_topk_lse.launches - before
    if selection == "raw":
        assert launched == 0
        _same(got[0], want[0], got[1], want[1])
    else:
        assert launched == cfg.max_caption_length - 1
        same = (got[0].cpu() == want[0]).all(dim=-1)
        assert same.float().mean().item() >= 0.9
        assert (got[1].cpu() - want[1])[same].abs().max().item() <= DECODE_LP_TOL


@pytest.mark.cuda
def test_decode_sample_raises_on_cuda_misuse(dev):
    cfg, _, params_gpu, feats, sent = _decode_model(dev)
    harness = DecodeHarness(params_gpu, cfg, device=dev)
    T, V = cfg.max_caption_length, cfg.vocab_size
    z = torch.zeros(DEC_NZ, T, DEC_B, 1, cfg.z_space, device=dev)
    g = torch.zeros(DEC_NZ, T, DEC_B, V, device=dev)
    with pytest.raises(ValueError):
        harness.decode_sample(feats, sent, None, torch.Generator(), DEC_NZ, "topk")  # CPU gen
    with pytest.raises(ValueError):
        harness.decode_sample(feats, sent, None, torch.Generator(device=dev), DEC_NZ, "top-k")
    with pytest.raises(ValueError):
        harness.decode_sample(feats, sent, None, (z, g[..., :-1]), DEC_NZ, "multinomial")
    with pytest.raises(ValueError):
        harness.decode_sample(feats, sent, None, (z, g), DEC_NZ, "gumbel")   # no beam axis
    with pytest.raises(ValueError):
        harness.decode_sample(feats, sent, None, (z, g.long()), DEC_NZ, "multinomial")
    ctx = tcap.make_decode_context(params_gpu, cfg, torch.from_numpy(feats).to(dev),
                                   sentiment=torch.from_numpy(sent).to(dev))
    step = tcap.make_optimized_step_fn(params_gpu, cfg, ctx)
    start = torch.full((DEC_B,), cfg.boundary_index, device=dev)
    st = init_cell_state((DEC_B,), cfg.hidden_size, device=dev)
    with pytest.raises(ValueError):          # Gumbel noise on the CPU
        tsam.sample_decode(step, start, st, (z[0], g[0].cpu()), max_steps=T, end_index=1)
    with pytest.raises(ValueError):          # a CPU generator for a GPU decode
        tsam.gumbel_beam_search(step, start, st, torch.Generator(), max_steps=T,
                                beam_size=cfg.beam_size, end_index=1)


# ------------------------------------------------------------------- CLI
# A small evaluation world written by the port's own code (no h5py, no
# YAML library): CBS in sentiment mode, 5 images, 3 z-samples.
CLI_IMAGES, CLI_NZ, CLI_T = 5, 3, 8


def _cli_world(d, vocab_size=300, boxes=6, feat_dim=16):
    Vocabulary([UNK_TOKEN, BOUNDARY_TOKEN] + [f"w{i}" for i in range(vocab_size - 5)]
               ).save_to_files(str(d / "vocab"))
    (d / "wordforms.tsv").write_text("pos\tgood,great,nice\n")
    rng = np.random.RandomState(0)
    w = FeaturesWriter(str(d / "features.h5"), CLI_IMAGES)
    for i in range(CLI_IMAGES):
        w.write(i, 100 + i, rng.randn(boxes, feat_dim).astype(np.float32),
                pack_obj_atts(list(range(1, boxes + 1)), [[0]] * boxes), np.zeros((0,), np.float32))
    w.close()
    (d / "cfg.yml").write_text(f"""
DATA:
  VOCABULARY: {d}/vocab
  TRAIN_FEATURES: ''
  INFER_FEATURES: {d}/features.h5
  DO_LOAD_COCO: false
  DO_LOAD_SENTICAP: false
  SENTICAP_SENTIMENT: pos
  MAX_CAPTION_LENGTH: {CLI_T}
  MAX_BOXES: {boxes}
  CBS:
    INFER_BOXES: ''
    CLASS_HIERARCHY: ''
    WORDFORMS: {d}/wordforms.tsv
MODEL:
  IMAGE_FEATURE_SIZE: {feat_dim}
  EMBEDDING_SIZE: 300
  HIDDEN_SIZE: 24
  ATTENTION_PROJECTION_SIZE: 12
  Z_SPACE: 10
  SENTIMENT_VAE: 1
  SIMPLE_VAE: false
  BEAM_SIZE: 4
  N_Z_SAMPLES: {CLI_NZ}
  STATE_MACHINE_PER_Z_SAMPLE: true
  USE_CBS: true
  CBS_SIMPLE: true
""")
    return d / "cfg.yml"


@pytest.mark.cuda
def test_cli_group_gpu_matches_cpu(dev, tmp_path):
    """``_dispatch_group`` + ``_collect_group`` on the GPU against the same
    calls on the CPU, on the same noise stacks. The CBS decode runs kernel A
    (f32) on the GPU and its plain version on the CPU: a near-tie may flip a
    beam, so 90% of the captions must be identical."""
    C = Config(str(_cli_world(tmp_path)))
    voc = Vocabulary.from_files(C.DATA.VOCABULARY)
    add_constraint_words_to_vocabulary(voc, C.DATA.CBS.WORDFORMS)
    random.seed(C.RANDOM_SEED)
    ds = EvaluationDatasetWithConstraints.from_config(C, vocabulary=voc)
    prepared = [(ds.collate_fn([ds[i]]), None) for i in range(CLI_IMAGES)]
    cfg = tcap.CaptionerConfig.from_config(C, voc)
    params = tcap.init_captioner(cfg, seed=0, device="cpu")
    noise = np.random.RandomState(5).randn(CLI_NZ, CLI_T, CLI_IMAGES, DEC_S, cfg.beam_size,
                                           cfg.z_space).astype(np.float32)
    out = {}
    for side, d, p in (("cpu", torch.device("cpu"), params), ("gpu", dev, to_device(params, dev))):
        before = vocab_topk_lse.launches
        kind_out = cli._dispatch_group(C, cfg, DecodeHarness(p, cfg, device=d), prepared,
                                       noise, CLI_NZ)
        out[side] = np.stack(cli._collect_group(C, cfg, kind_out, prepared, CLI_NZ))
        assert vocab_topk_lse.launches - before == (CLI_T - 1 if side == "gpu" else 0)
    assert out["gpu"].shape == (CLI_IMAGES, CLI_NZ, CLI_T)
    assert (out["gpu"] == out["cpu"]).all(axis=-1).mean() >= 0.9


@pytest.mark.cuda
def test_cli_main_on_gpu(dev, tmp_path):
    """The whole CLI on the card: groups of two and a tail image, every
    group's CBS decode through kernel A, no fallback; and the sampler path
    without a kernel."""
    cfg = _cli_world(tmp_path)
    for extra, launches in ((["--bf16"], 3 * (CLI_T - 1)), (["--sampler", "topp"], 0)):
        stats, before = {}, vocab_topk_lse.launches
        assert cli.main(["--config", str(cfg), "--output-path", str(tmp_path / "p.json"),
                         "--batch-images", "2", *extra], stats=stats) == 0
        preds = json.loads((tmp_path / "p.json").read_text())
        assert [p["image_id"] for p in preds] == [100 + i for i in range(CLI_IMAGES)
                                                  for _ in range(CLI_NZ)]
        assert stats["fallbacks"] == 0
        assert vocab_topk_lse.launches - before == launches



# training: the card's f32 train step (TF32 off) against the CPU's on the
# same params, batch and z-noise; products sum in other orders, so the
# metrics agree to 1e-5 and each leaf after the steps to 1e-5 of its norm
TRAIN_METRIC_RTOL = 1e-5
TRAIN_PARAM_REL = 1e-5


def _train_setup(sentiment_vae=1, embedding_size=300):
    from style_seqcvae_tpu_torch.config import Config

    cfg = tcap.CaptionerConfig(vocab_size=40, image_feature_size=32, embedding_size=embedding_size,
                               hidden_size=24, attention_projection_size=16, z_space=8,
                               sentiment_vae=sentiment_vae, simple_vae=False,
                               max_caption_length=7)
    config = Config(config_override=["OPTIM.LR", "0.05", "OPTIM.EPOCH_START_DECODER_TRAINING",
                                     "1", "OPTIM.BEFORE_UPDATE_DECODER_EVERY", "30"])
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        toks = rng.randint(2, 40, (6, 7)).astype(np.int32)
        toks[0, 4:] = 0
        b = {"image_features": rng.randn(6, 5, 32).astype(np.float32),
             "caption_tokens": toks,
             "sentiment": rng.choice([-1.0, 1.0], (6, 1)).astype(np.float32)}
        if sentiment_vae == 2:
            b["obj_att_embeds"] = rng.randn(6, 5, 8).astype(np.float32)
        batches.append((b, rng.randn(8, 6, 8).astype(np.float32)))
    return cfg, config, tcap.init_captioner(cfg, seed=1, device="cpu"), batches


@pytest.mark.cuda
@pytest.mark.parametrize("mode,emb", [(0, 16), (1, 300), (2, 300)])
def test_train_step_gpu_matches_cpu(dev, mode, emb):
    from style_seqcvae_tpu_torch.training.trainer import create_train_state, make_train_step
    from style_seqcvae_tpu_torch.weights import named_leaves

    cfg, config, params, batches = _train_setup(mode, emb)
    step = make_train_step(cfg, config.MODEL.KLD_WEIGHT)
    states = [create_train_state(params, config, cfg, seed=0, device=d) for d in ("cpu", dev)]
    for b, eps in batches:
        out = [step(s, b, eps=eps) for s in states]
        states = [o[0] for o in out]
        for name in out[0][1]:
            torch.testing.assert_close(out[1][1][name].cpu(), out[0][1][name],
                                       rtol=TRAIN_METRIC_RTOL, atol=0)
    for (path, c), (_, g) in zip(named_leaves(states[0].params), named_leaves(states[1].params)):
        err = ((g.detach().cpu() - c.detach()).norm() / c.detach().norm()).item()
        assert err <= TRAIN_PARAM_REL, f"{path}: off by {err:.3g}"


@pytest.mark.cuda
def test_train_step_bf16_finite_and_frozen_leaves_have_no_grad(dev):
    from style_seqcvae_tpu_torch.training.optimizer import make_labels
    from style_seqcvae_tpu_torch.training.trainer import create_train_state, make_train_step
    from style_seqcvae_tpu_torch.weights import named_leaves

    cfg, config, params, batches = _train_setup()
    state = create_train_state(params, config, cfg, seed=0, device=dev)
    step = make_train_step(cfg, config.MODEL.KLD_WEIGHT, compute_dtype=torch.bfloat16)
    labels = make_labels(state.params, freeze_embedding=True)
    for it, (b, _) in enumerate(batches, start=1):
        state, m = step(state, b)
        assert all(torch.isfinite(v).item() for v in m.values())
        frozen = {"never"} | ({"decoder"} if it == 1 else set())
        for path, p in named_leaves(state.params):
            assert p.dtype == torch.float32 and p.is_cuda
            assert (p.grad is None) == (labels[path] in frozen), (it, path)


# the baseline family on the GPU against the CPU: no kernel on its path, so
# its f32 decodes must be token-identical and its train steps agree to the
# f32 train step's tolerances
def _baseline_model(dev):
    from style_seqcvae_tpu_torch.models.baseline import init_baseline

    cfg = tcap.CaptionerConfig(**DEC)
    params = init_baseline(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(4)
    feats = rng.randn(DEC_B, 6, cfg.image_feature_size).astype(np.float32)
    return cfg, params, to_device(params, dev), feats


@pytest.mark.cuda
def test_baseline_decodes_gpu_match_cpu(dev):
    cfg, params, params_gpu, feats = _baseline_model(dev)
    cpu = DecodeHarness(params, cfg, device="cpu", family="baseline")
    gpu = DecodeHarness(params_gpu, cfg, device=dev, family="baseline")
    rng = np.random.RandomState(5)
    tables = pad_tables_batch([[fsm_to_tables(_simple_fsm(rng, cfg.vocab_size))]
                               for _ in range(DEC_B)], 1)
    T, K = cfg.max_caption_length, cfg.beam_size
    counts = (vocab_topk_lse.launches, topk_lse.launches)
    noise = rng.randn(1, T, DEC_B, DEC_S, K, cfg.z_space).astype(np.float32)
    want = cpu.decode_cbs(feats, None, None, tables, 3, noise, 1)
    got = gpu.decode_cbs(feats, None, None, tables, 3, noise, 1)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4)
    want = cpu.decode_beam(feats, None, None, noise[:, :, :, 0], 1)
    got = gpu.decode_beam(feats, None, None, noise[:, :, :, 0], 1)
    assert torch.equal(got[0].cpu(), want[0])
    for method, kw in SAMPLE_METHODS.items():
        inner = (K,) if method == "gumbel" else ()
        z = rng.randn(DEC_NZ, T, DEC_B, K if inner else 1, cfg.z_space).astype(np.float32)
        g = -np.log(rng.exponential(size=(DEC_NZ, T, DEC_B) + inner + (cfg.vocab_size,))
                    ).astype(np.float32)
        args = (feats, None, None, (z, g), DEC_NZ, method)
        assert torch.equal(gpu.decode_sample(*args, **kw).cpu(), cpu.decode_sample(*args, **kw))
    assert (vocab_topk_lse.launches, topk_lse.launches) == counts     # no kernel


@pytest.mark.cuda
def test_baseline_train_step_gpu_matches_cpu(dev):
    from style_seqcvae_tpu_torch.models.baseline import init_baseline
    from style_seqcvae_tpu_torch.training.trainer import (
        create_train_state,
        make_baseline_train_step,
    )
    from style_seqcvae_tpu_torch.weights import named_leaves

    cfg, config, _, batches = _train_setup()
    params = init_baseline(cfg, seed=1, device="cpu")
    step = make_baseline_train_step(cfg)
    states = [create_train_state(params, config, cfg, seed=0, device=d) for d in ("cpu", dev)]
    for b, _ in batches:
        out = [step(s, b) for s in states]
        states = [o[0] for o in out]
        for name in out[0][1]:
            torch.testing.assert_close(out[1][1][name].cpu(), out[0][1][name],
                                       rtol=TRAIN_METRIC_RTOL, atol=0)
    for (path, c), (_, g) in zip(named_leaves(states[0].params), named_leaves(states[1].params)):
        err = ((g.detach().cpu() - c.detach()).norm() / c.detach().norm()).item()
        assert err <= TRAIN_PARAM_REL, f"{path}: off by {err:.3g}"


# ----------------------------------------------------- images and serving

IMAGE_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
# each JPEG fixture's subsampling and its own measured bound against PIL
NVJPEG_BOUNDS = json.loads((IMAGE_FIXTURES / "nvjpeg_bounds.json").read_text())["fixtures"]


@pytest.mark.cuda
def test_nvjpeg_fixtures_against_pil(dev):
    """nvjpeg on the card against PIL's decode of each fixture, within
    its own bound (``tests/fixtures/images/nvjpeg_bounds.json``); PIL's PNG
    of ``photo_a`` decodes to its pixels exactly and PPM on the card equals
    the host's decode; a JPEG cut short is refused before the card sees it."""
    for name, bound in NVJPEG_BOUNDS.items():
        data = (IMAGE_FIXTURES / f"{name}.jpg").read_bytes()
        got = decode_image_bgr(data, dev)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        want = np.load(IMAGE_FIXTURES / f"{name}.npy")[:, :, ::-1].astype(np.float32)
        diff = np.abs(got.cpu().numpy() - want)
        assert diff.mean() <= bound["bound"]["mean"] and diff.max() <= bound["bound"]["max"], \
            (name, diff.mean(), diff.max())
    with pytest.raises(idec.ImageDecodeError, match="cut short"):
        decode_image_bgr(data[:len(data) // 2], dev)
    rgb = (np.arange(5 * 7 * 3) % 251).astype(np.uint8).reshape(5, 7, 3)
    ppm = b"P6\n7 5\n255\n" + rgb.tobytes()
    np.testing.assert_array_equal(decode_image_bgr(ppm, dev).cpu().numpy(),
                                  decode_image_bgr(ppm, "cpu").numpy())
    png = decode_image_bgr((IMAGE_FIXTURES / "photo_a.png").read_bytes(), dev)
    np.testing.assert_array_equal(png.cpu().numpy(),
                                  np.load(IMAGE_FIXTURES / "photo_a.npy")[:, :, ::-1])


@pytest.mark.cuda
def test_nvjpeg_encode_round_trip(dev):
    """nvjpeg's encoder (quality 92, 4:2:0, as make_world writes its images):
    a JPEG of the fixture's size that nvjpeg decodes back near the encoded
    pixels; a host tensor is refused."""
    from style_seqcvae_tpu_torch.data.image_encode import encode_jpeg

    rgb = np.load(IMAGE_FIXTURES / "photo_a.npy")
    data = encode_jpeg(torch.from_numpy(rgb).to(dev))
    assert idec.sniff_format(data) == "JPEG"
    assert idec.jpeg_header(data)[2:] == (rgb.shape[0], rgb.shape[1], 3)
    back = idec.decode_jpeg(data, dev).cpu().numpy()[:, :, ::-1].astype(np.float32)
    diff = np.abs(back - rgb)
    assert diff.mean() <= 3.0 and diff.max() <= 160, (diff.mean(), diff.max())
    with pytest.raises(idec.ImageFormatError):
        encode_jpeg(torch.from_numpy(rgb))


@pytest.mark.cuda
def test_serve_gpu_matches_cpu_from_shared_detections(dev):
    """The serve chain after the detector, on the card against the CPU from
    the card's own detector outputs, f32: equal tables and constraint
    counts, token-identical captions (kernel A against its plain version),
    log-probs within 1e-5."""
    names = ["wooden", "red", "blue", "furry", "plastic", "shiny", "tall"]
    vocab = Vocabulary([UNK_TOKEN, BOUNDARY_TOKEN] + names + [f"w{i}" for i in range(40)])
    table = build_attribute_wordform_table(names, {n: [n] for n in names}, vocab)
    det_cfg = DetectorConfig(num_classes=5, num_att_classes=len(names), depth=50,
                             anchor_scales=(2, 4))
    cap_cfg = tcap.CaptionerConfig(vocab_size=vocab.get_vocab_size(), image_feature_size=2048,
                                   embedding_size=300, hidden_size=16,
                                   attention_projection_size=8, z_space=4, sentiment_vae=1,
                                   simple_vae=False, max_caption_length=8, beam_size=3)
    det_cpu = init_detector(det_cfg, seed=0, device="cpu")
    cap_cpu = tcap.init_captioner(cap_cfg, seed=1, device="cpu")
    kw = dict(n_z=3, beam_size=3, max_boxes=10, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=30,
              dtype=torch.float32)
    serve_gpu = make_serve_fn(det_cfg, cap_cfg, table, device=dev, **kw)
    serve_cpu = make_serve_fn(det_cfg, cap_cfg, table, device="cpu", **kw)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((2, 96, 128, 3), generator=gen) * 255 - 120
    info = torch.tensor([[96.0, 128.0, 1.0], [90.0, 120.0, 1.0]])
    sel = serve_gpu.detect(to_device(det_cpu, dev), images.to(dev), info.to(dev))
    sel_cpu = {k: v.cpu() for k, v in sel.items()}
    gumbel = draw_gumbel((3, 2, 3, len(names)), gen)
    ids_g, n_g, tables_g = serve_gpu.constrain(sel, gumbel.to(dev))
    ids_c, n_c, tables_c = serve_cpu.constrain(sel_cpu, gumbel)
    assert torch.equal(ids_g.cpu(), ids_c) and torch.equal(n_g.cpu(), n_c) and (n_c > 0).all()
    for a, b in zip(tables_g, tables_c):
        assert torch.equal(a.cpu(), b)
    noise = torch.randn((3, 8, 2, 8, 3, 4), generator=gen)
    sentiment = torch.tensor([[1.0], [-1.0]])
    launches = vocab_topk_lse.launches
    best_g, lp_g = serve_gpu.caption(to_device(cap_cpu, dev), sel, sentiment.to(dev), tables_g,
                                     n_g, noise.to(dev))
    assert vocab_topk_lse.launches - launches == 7
    best_c, lp_c = serve_cpu.caption(cap_cpu, sel_cpu, sentiment, tables_c, n_c, noise)
    assert torch.equal(best_g.cpu(), best_c)
    torch.testing.assert_close(lp_g.cpu(), lp_c, rtol=1e-5, atol=0)


# The RoIAlign backward kernel gathers each pixel's gradient in f32 in a
# fixed order (RoIs, then row bins, then column bins) and merges samples that
# share a pixel before weighting: a few ulps of the largest gradient apart
# from autograd of the plain version in f32. In bf16 both round their f32
# sums once, so neighbours one bf16 ulp (2^-8 of the largest) apart.
ROI_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _train_rois(gen, dev, B, H, W, per_image):
    """RoIs as proposal_target emits them: image-major, per_image an image,
    boxes over the image (overlapping heavily) and some padding rows."""
    R = B * per_image
    ctr = torch.rand(R, 2, generator=gen, device=dev) * torch.tensor([16.0 * W, 16.0 * H],
                                                                    device=dev)
    wh = torch.rand(R, 2, generator=gen, device=dev) * 300.0 + 8.0
    b = torch.arange(B, device=dev).repeat_interleave(per_image).float()[:, None]
    rois = torch.cat([b, ctr - wh / 2, ctr + wh / 2], dim=1)
    rois[per_image - 3::per_image, 1:] = 0.0
    return rois.contiguous()


# the edge RoIs (tests/test_torch_roi_backward.py's) on a 9 x 11 map at 1/16
_EDGE_ROIS = [[1, 200, 200, 260, 260],        # past the map: every sample empty
              [1, 0, 0, 16 * 11 - 1, 16 * 9 - 1],  # the whole map
              [0, 0, 0, 0, 0],                # a padding row
              [0, 40, 50, 43, 52],            # sub-pixel on the map
              [1, 170, 130, 175.5, 143.9],    # sub-pixel at the far corner
              [0, -20, -9, 6, 4]]             # starts left of and above the map

ROI_BWD_CASES = ["train", "c13", "c512", "edges", "padding_stack", "batch_out_of_range",
                 "empty_image", "no_rois", "unaligned", "shuffled"]


def _backward_case(case, gen, dev, dtype):
    """(grad_out, rois, features shape, rois for the plain version) of a named
    case of the backward kernel's tests."""
    shape, per_image = {"train": ((4, 40, 64, 1024), 128), "c512": ((2, 38, 58, 512), 128),
                        "padding_stack": ((4, 40, 64, 64), 128),
                        "empty_image": ((3, 20, 24, 96), 30)}.get(case, ((2, 9, 11, 13), 20))
    B, H, W, C = shape
    rois = _train_rois(gen, dev, B, H, W, per_image)
    if case == "edges":
        rois[:len(_EDGE_ROIS)] = torch.tensor(_EDGE_ROIS, device=dev)
    elif case == "padding_stack":
        # half of each image's rows all-zero padding: 256 RoIs on pixels (0..1, 0..1)
        rois.view(B, per_image, 5)[:, per_image // 2:, 1:] = 0.0
    elif case == "empty_image":
        rois[:, 0] = torch.where(rois[:, 0] == 1, 2.0, rois[:, 0])   # nothing on image 1
    elif case == "no_rois":
        rois = rois[:0]
    elif case == "shuffled":
        rois = rois[torch.randperm(rois.shape[0], generator=gen, device=dev)].contiguous()
    plain_rois = rois
    if case == "batch_out_of_range":
        rois[0, 0], rois[1, 0], rois[2, 0] = -3.0, float(B), B + 5.0
        # the kernels clamp the batch index into [0, B); the plain version
        # indexes with it as given
        plain_rois = rois.clone()
        plain_rois[:, 0] = plain_rois[:, 0].clamp(0, B - 1)
    R = rois.shape[0]
    grad_out = torch.randn(R, 7, 7, C, generator=gen, device=dev).to(dtype)
    if case == "unaligned":
        # a view one element into its storage: off the 16-byte vectors
        flat = torch.randn(R * 49 * C + 1, generator=gen, device=dev).to(dtype)
        grad_out = flat[1:].view(R, 7, 7, C)
        assert grad_out.data_ptr() % 16 != 0
    return grad_out, rois, shape, plain_rois


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ROI_BWD_CASES)
def test_roi_align_backward_kernel(dev, dtype, case):
    gen = torch.Generator(device=dev).manual_seed(ROI_BWD_CASES.index(case))
    grad_out, rois, shape, plain_rois = _backward_case(case, gen, dev, dtype)
    B, H, W, C = shape
    R = rois.shape[0]
    kw = dict(spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7, sampling_ratio=2)
    before = roi_align.backward_launches
    got = roi_align.roi_align_backward(grad_out, rois, shape, **kw)
    torch.cuda.synchronize()
    assert roi_align.backward_launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    if case == "no_rois":       # every pixel written, as zeros
        assert torch.equal(got, torch.zeros_like(got))
        return
    want = roi_align.roi_align_backward_plain(grad_out, plain_rois, shape, dtype, **kw)
    if case == "empty_image":
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    scale = want.float().abs().max().item()
    assert scale > 0
    assert (got.float() - want.float()).abs().max().item() <= ROI_BWD_TOL[dtype] * scale

    # through autograd: kernel C forward, this kernel backward
    feats = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype).requires_grad_(True)
    c_before = roi_align.launches
    roi_align.roi_align(feats, rois, **kw).backward(grad_out)
    torch.cuda.synchronize()
    assert roi_align.launches == c_before + 1 and roi_align.backward_launches == before + 2
    assert (feats.grad.float() - want.float()).abs().max().item() <= \
        ROI_BWD_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["train", "padding_stack"])
def test_roi_align_backward_deterministic(dev, dtype, case):
    """Two launches on the same inputs are equal to the bit, also where
    hundreds of RoIs add into the same pixels."""
    gen = torch.Generator(device=dev).manual_seed(7)
    grad_out, rois, shape, _ = _backward_case(case, gen, dev, dtype)
    kw = dict(spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7, sampling_ratio=2)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    first = roi_align.roi_align_backward(grad_out, rois, shape, **kw).view(bits)
    for _ in range(3):
        again = roi_align.roi_align_backward(grad_out, rois, shape, **kw).view(bits)
        assert torch.equal(first, again)


@pytest.mark.cuda
def test_linear_f32_on_bf16_operands(dev):
    """``layers.linear_f32`` on bf16 operands on the card: cuBLAS's bf16
    GEMM with an f32 result outside autograd, the upcast f32 product under
    it; both f32 and within f32 rounding of the exact product."""
    from style_seqcvae_tpu_torch.models.detector.layers import linear_f32

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(600, 2048, generator=gen, device=dev).bfloat16()
    p = {"w": (torch.randn(2048, 405, generator=gen, device=dev) * 0.02).bfloat16(),
         "b": (torch.randn(405, generator=gen, device=dev) * 0.1).bfloat16()}
    want = x.double() @ p["w"].double() + p["b"].double()
    with torch.no_grad():
        got = linear_f32(p, x)
    xg = x.clone().requires_grad_(True)
    got_grad = linear_f32(p, xg)
    got_grad.sum().backward()
    for y in (got, got_grad):
        assert y.dtype == torch.float32
        assert (y.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert xg.grad.dtype == torch.bfloat16 and bool(torch.isfinite(xg.grad.float()).all())


@pytest.mark.cuda
def test_nms_kernel_at_training_candidates(dev):
    """The RPN's training call: 4 images × 12,000 candidates, 0.7, 2,000 kept."""
    gen = torch.Generator(device=dev).manual_seed(12000)
    boxes = _boxes(gen, dev, 4, 12000, extent=1000.0)
    scores, order = torch.sort(torch.rand(4, 12000, generator=gen, device=dev), dim=1,
                               descending=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(4, 12000, 4)).contiguous()
    got = nms.nms(boxes, scores, 0.7, max_out=2000, presorted=True)
    want = nms.nms_plain(boxes, scores, 0.7, max_out=2000, presorted=True)
    torch.cuda.synchronize()
    assert got[0].shape == (4, 2000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_detector_train_step_on_gpu(dev):
    from style_seqcvae_tpu_torch.models.detector.rpn import RPNConfig
    from style_seqcvae_tpu_torch.models.detector.targets import ProposalTargetConfig
    from style_seqcvae_tpu_torch.scripts.train_detector import make_train_step
    from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD

    cfg = DetectorConfig(num_classes=6, num_att_classes=5, depth=50, anchor_scales=(2, 4, 8),
                         rpn=RPNConfig(pre_nms_top_n=3000, post_nms_top_n=300),
                         pt=ProposalTargetConfig(rois_per_image=32, num_classes=6))
    params = init_detector(cfg, seed=0, device=dev)
    opt = DetectorSGD(params, lr=1e-3, steps_per_epoch=10)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"images": torch.randn(2, 192, 256, 3, generator=gen, device=dev) * 50,
             "im_info": torch.tensor([[192.0, 256.0, 1.0]] * 2, device=dev),
             "gt_boxes": torch.tensor([[[10.0, 20, 120, 150, 1], [60, 30, 200, 100, 3]]] * 2,
                                      device=dev),
             "num_gt": torch.tensor([2, 1], device=dev),
             "gt_atts": (torch.rand(2, 2, 5, generator=gen, device=dev) > 0.5).float(),
             "att_counts": torch.arange(1.0, 6.0, device=dev)}
    counts = (roi_align.launches, roi_align.backward_launches, nms.launches)
    for bf16 in (False, True):
        step = make_train_step(cfg, opt, bf16)
        losses = step(params, batch, gen)
        assert all(torch.isfinite(v).item() for v in losses.values()), losses
    assert (roi_align.launches - counts[0], roi_align.backward_launches - counts[1],
            nms.launches - counts[2]) == (2, 2, 2)
    assert all(torch.isfinite(p).all() for p in params["cls_score"].values())
