"""Greedy NMS batched over groups (kernel D).

Counterpart of ``style_seqcvae_tpu/ops/pallas/nms.py::nms_pallas`` (the
``suppression_bitmask`` kernel and its greedy scan). On CUDA tensors
:func:`nms` launches the two hand-written kernels of ``csrc/nms.cu``, the
bitmask and the scan, and counts one launch; on CPU tensors it runs
:func:`nms_plain` (``ops/nms.py::nms``: the pairwise suppression matrix in
torch plus a greedy scan in Python), with the same outputs. The bitmask
alone, :func:`suppression_bitmask`, has its plain version,
:func:`suppression_bitmask_plain`, and so does the scan alone,
:func:`greedy_scan`: :func:`greedy_scan_plain`, which reads the same 64-bit
mask words. :func:`iou_exceeds_plain` mirrors the bitmask kernel's
division-free threshold test, and :func:`boundary_boxes` makes boxes whose
IoUs sit at that test's rounding boundary.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from style_seqcvae_tpu_torch.ops.nms import compact
from style_seqcvae_tpu_torch.ops.nms import greedy_scan as greedy_scan_matrix
from style_seqcvae_tpu_torch.ops.nms import nms as nms_plain
from style_seqcvae_tpu_torch.ops.nms import sort_desc
from style_seqcvae_tpu_torch.ops.nms import suppression_matrix

# calls that launched the CUDA kernels in this process (the plain version
# not counted), in all and by the (groups, boxes) shape of the call
launches = 0
launches_by_shape: Counter = Counter()

_BOX = 64                       # boxes per mask word
_MAX_SMEM_BYTES = 227 * 1024
_MAX_GROUPS = 65535             # the most groups a call takes
_UNPACK_PAIRS = 1 << 26         # (chunk of groups) x N x N bits unpacked at once


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (G, N, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores must be (G, N) = {tuple(boxes.shape[:2])}, "
                         f"got {tuple(scores.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"scores on {scores.device}, boxes on {boxes.device}")


def suppression_bitmask(boxes_sorted: torch.Tensor, threshold: float) -> torch.Tensor:
    """CUDA only: (G, N, 4) contiguous f32 score-sorted boxes → the
    (G, N, ceil(N / 64)) int64 words of the upper-triangle suppression mask
    (bit k of word w of row i marks box 64 w + k > i). Words below each
    row's diagonal word are left unwritten."""
    if (boxes_sorted.dim() != 3 or boxes_sorted.shape[-1] != 4
            or boxes_sorted.dtype != torch.float32 or not boxes_sorted.is_contiguous()
            or boxes_sorted.device.type != "cuda" or boxes_sorted.data_ptr() % 16):
        raise ValueError("boxes must be (G, N, 4) contiguous, 16-byte aligned float32 on "
                         f"a CUDA device, got {tuple(boxes_sorted.shape)} {boxes_sorted.dtype} "
                         f"on {boxes_sorted.device}")
    from style_seqcvae_tpu_torch.ops.kernels import _build

    G, N, _ = boxes_sorted.shape
    words = -(-N // _BOX)
    mask = torch.empty((G, N, words), dtype=torch.int64, device=boxes_sorted.device)
    lib = _build.library()
    with torch.cuda.device(boxes_sorted.device):
        rc = lib.ssc_nms_bitmask(boxes_sorted.data_ptr(), mask.data_ptr(), G, N,
                                 float(threshold), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "nms bitmask")
    return mask


def pack_words(matrix: torch.Tensor) -> torch.Tensor:
    """(G, N, N) bool → (G, N, ceil(N / 64)) int64: bit k of word w of row
    i is ``matrix[g, i, 64 w + k]``, bits at or past N 0."""
    G, N, _ = matrix.shape
    words = -(-N // _BOX)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=matrix.device)
    out = torch.empty((G, N, words * 8), dtype=torch.uint8, device=matrix.device)
    step = max(1, _UNPACK_PAIRS // max(N * N, 1))
    for g0 in range(0, G, step):
        bits = torch.zeros((min(step, G - g0), N, words * _BOX), dtype=torch.int32,
                           device=matrix.device)
        bits[..., :N] = matrix[g0:g0 + step]
        out[g0:g0 + step] = (bits.view(-1, N, words * 8, 8) * weights).sum(-1).to(torch.uint8)
    return out.view(torch.int64)


def suppression_bitmask_plain(boxes_sorted: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain version of :func:`suppression_bitmask` on any device:
    ``ops/nms.py``'s ``suppression_matrix`` in the kernel's words. Its words
    below the diagonal are 0, where the kernel's are unwritten."""
    return pack_words(suppression_matrix(boxes_sorted, threshold))


def fast_test_constants(threshold: float) -> Tuple[np.float32, np.float32]:
    """The f32 threshold t and half the ulp above it, h, as the bitmask
    kernel's host code computes them; h is NaN where the division-free test
    is not sound (t outside [2^-60, 2^20], negative and NaN included)."""
    t = np.float32(threshold)
    if not 2.0 ** -60 <= t <= 2.0 ** 20:
        return t, np.float32(np.nan)
    return t, (np.nextafter(t, np.float32(np.inf)) - t) * np.float32(0.5)


def iou_exceeds_plain(inter: torch.Tensor, union: torch.Tensor, threshold: float
                      ) -> torch.Tensor:
    """Plain mirror of the bitmask kernel's decision, on CPU tensors: f32
    ``inter`` and ``union`` → ``fl(inter / union) > t`` (t the f32
    threshold), decided without a division where that is sound. fl(q) > t
    iff q lies above the midpoint t + h between t and the next f32, that
    is, for union > 0, iff inter - t · union > h · union. e, that difference
    rounded to f32 (the kernel's FMA; here the exact product in float64,
    then rounded), and the exact h · union settle it whenever they differ:
    rounding is monotone. Where they are equal, or the union is not positive
    with h · union a normal f32, it divides as the plain version does. The
    kernel keeps the union in range through the boxes' areas instead."""
    t, h = fast_test_constants(threshold)
    inter, union = inter.float(), union.float()
    e = (inter.double() - float(t) * union.double()).float()
    hu = union * float(h)
    above = e > hu
    unsure = ~(e < hu) & ~above
    unsure |= ~((union >= np.float32(np.finfo(np.float32).tiny) / h)
                & (union <= np.finfo(np.float32).max))
    return torch.where(unsure, inter / union > float(t), above)


def boundary_boxes(G: int, N: int, threshold: float, seed: int = 0) -> torch.Tensor:
    """(G, N, 4) f32 boxes on the CPU in pairs, each pair a row of its own
    (y = 2 p, one pixel high): [0, y, U - 1, y] and [0, y, c - 1, y], so that
    inter = c and union = U exactly and the pair's IoU is c / U. U runs over
    small integers (7 / 10 among them), integers up to 10^6 and multiples of
    2^-4 up to 2^19; c is round(t U) ± 2 on the same grid, so that the IoUs
    fall on both sides of t and on t itself. Pairs of one row block may come
    either way round; an odd last box stands alone."""
    rng = np.random.RandomState(seed)
    t = float(np.float32(threshold))
    P = G * (N // 2)
    small = np.arange(1, 21, dtype=np.float64)
    kind = rng.randint(0, 3, P)
    U = np.where(kind == 0, rng.choice(small, P),
                 np.where(kind == 1, np.round(np.exp(rng.uniform(0, np.log(1e6), P))),
                          np.round(np.exp(rng.uniform(np.log(16), np.log(2 ** 23), P))) / 16))
    U[:min(P, 2)] = 10.0
    grid = np.where(kind == 2, 16.0, 1.0)
    c = (np.round(t * U * grid) + rng.randint(-2, 3, P)) / grid
    c[:min(P, 2)] = [7.0, 3.0][:min(P, 2)]
    c = np.clip(c, 1.0 / grid, U)
    y = 2.0 * (np.arange(P) % max(N // 2, 1))
    big = np.stack([np.zeros(P), y, U - 1, y], -1)
    sml = np.stack([np.zeros(P), y, c - 1, y], -1)
    flip = rng.rand(P) < 0.5
    pairs = np.where(flip[:, None, None], np.stack([sml, big], 1), np.stack([big, sml], 1))
    boxes = np.zeros((G, N, 4), np.float32)
    boxes[:, :2 * (N // 2)] = pairs.reshape(G, 2 * (N // 2), 4)
    if N % 2:
        boxes[:, -1] = [0.0, 2.0 * (N // 2), 9.0, 2.0 * (N // 2)]
    return torch.from_numpy(boxes)


def greedy_scan_plain(mask: torch.Tensor, order: Optional[torch.Tensor], max_out: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`greedy_scan` on CPU tensors: unpacks the
    words' strict upper triangle (bit k of word w of row i marks box
    64 w + k > i), ignoring the words below the diagonal, the bits at or
    below it and the bits at or past N, then runs ``ops/nms.py``'s
    ``greedy_scan`` and ``compact``."""
    G, N, words = mask.shape
    order = (torch.arange(N).expand(G, N) if order is None else order).long()
    if N == 0:
        return compact(torch.zeros((G, 0), dtype=torch.bool), order, max_out)
    # bytes of the little-endian words, so bit 63 (the int64's sign) is bit
    # 7 of the last byte and no shift sees a sign
    shifts = torch.arange(8, dtype=torch.uint8)
    later = torch.ones((N, N), dtype=torch.bool).triu_(1)
    alive = []
    step = max(1, _UNPACK_PAIRS // (N * N))
    for g0 in range(0, G, step):
        octets = mask[g0:g0 + step].contiguous().view(torch.uint8)      # (g, N, 8 · words)
        bits = ((octets[..., None] >> shifts) & 1).flatten(-2)[..., :N].bool()
        alive.append(greedy_scan_matrix(bits & later))
    return compact(torch.cat(alive), order, max_out)


def greedy_scan(mask: torch.Tensor, order: Optional[torch.Tensor], max_out: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mask words (G, N, ceil(N / 64)) int64 of :func:`suppression_bitmask`
    (words below the diagonal are never read) and the sort's permutation
    (G, N) int32 (``None``: the identity) → keep_idx and keep_mask as
    :func:`nms` returns them. CUDA tensors launch the scan kernel (no
    count: :func:`nms` counts its calls); CPU tensors run
    :func:`greedy_scan_plain`."""
    G, N, words = mask.shape
    if mask.dtype != torch.int64 or words != -(-N // _BOX):
        raise ValueError(f"mask must be (G, N, ceil(N / {_BOX})) int64, "
                         f"got {tuple(mask.shape)} {mask.dtype}")
    if order is not None and (order.shape != (G, N) or order.dtype != torch.int32
                              or order.device != mask.device):
        raise ValueError(f"order must be (G, N) = {(G, N)} int32 on {mask.device}")
    if mask.device.type == "cpu":
        return greedy_scan_plain(mask, order, max_out)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    from style_seqcvae_tpu_torch.ops.kernels import _build

    mask = mask.contiguous()
    order = None if order is None else order.contiguous()
    out_len = min(max_out, N) if max_out else N
    keep_idx = torch.empty((G, out_len), dtype=torch.int32, device=mask.device)
    keep_mask = torch.empty((G, N), dtype=torch.bool, device=mask.device)
    lib = _build.library()
    with torch.cuda.device(mask.device):
        rc = lib.ssc_nms_scan(mask.data_ptr(), 0 if order is None else order.data_ptr(),
                              keep_idx.data_ptr(), keep_mask.data_ptr(), G, N, out_len,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "nms scan")
    return keep_idx, keep_mask


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
        max_out: int = 0, presorted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`nms_plain`: boxes (G, N, 4) f32, scores
    (G, N) → (keep_idx (G, N or max_out) int32 padded with -1, keep_mask
    (G, N) bool). ``presorted`` promises descending score order per group."""
    global launches
    _check(boxes, scores)
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, threshold, max_out=max_out, presorted=presorted)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    G, N = scores.shape
    if G > _MAX_GROUPS:
        raise ValueError(f"at most {_MAX_GROUPS} groups per call, got {G}")
    from style_seqcvae_tpu_torch.ops.kernels import _build

    words = -(-N // _BOX)
    if _build.library().ssc_nms_scan_smem_bytes(words) > _MAX_SMEM_BYTES:
        raise ValueError(f"N={N} boxes per group exceed the scan's shared memory")
    if G == 0 or N == 0:            # nothing to launch: empty outputs
        return (torch.empty((G, 0), dtype=torch.int32, device=boxes.device),
                torch.zeros((G, N), dtype=torch.bool, device=boxes.device))
    from style_seqcvae_tpu_torch.ops.kernels import record_inputs

    record_inputs("nms", boxes=boxes, scores=scores, threshold=threshold, max_out=max_out,
                  presorted=presorted)
    if presorted:
        order = None
        sboxes = boxes.contiguous()
    else:
        perm = sort_desc(scores)
        sboxes = torch.gather(boxes, 1, perm[..., None].expand(G, N, 4)).contiguous()
        order = perm.to(torch.int32).contiguous()
    keep = greedy_scan(suppression_bitmask(sboxes, threshold), order, max_out)
    launches += 1
    launches_by_shape[(G, N)] += 1
    return keep
