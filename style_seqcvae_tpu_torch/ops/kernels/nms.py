"""Greedy NMS batched over groups (kernel D).

Counterpart of ``style_seqcvae_tpu/ops/pallas/nms.py::nms_pallas`` (the
``suppression_bitmask`` kernel and its greedy scan). On CUDA tensors
:func:`nms` launches the two hand-written kernels of ``csrc/nms.cu``, the
bitmask and the scan, and counts one launch; on CPU tensors it runs
:func:`nms_plain` (``ops/nms.py::nms``: the pairwise suppression matrix in
torch plus a greedy scan in Python), with the same outputs. The scan alone,
:func:`greedy_scan`, has its own plain version, :func:`greedy_scan_plain`,
which reads the same 64-bit mask words.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from style_seqcvae_tpu_torch.ops.nms import compact
from style_seqcvae_tpu_torch.ops.nms import greedy_scan as greedy_scan_matrix
from style_seqcvae_tpu_torch.ops.nms import nms as nms_plain
from style_seqcvae_tpu_torch.ops.nms import sort_desc

# calls that launched the CUDA kernels in this process (the plain version
# not counted), in all and by the (groups, boxes) shape of the call
launches = 0
launches_by_shape: Counter = Counter()

_BOX = 64                       # boxes per mask word
_MAX_SMEM_BYTES = 227 * 1024
_MAX_GROUPS = 65535             # grid z of the bitmask kernel
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
    (G, N, ceil(N / 64)) int64 words of the upper-triangle suppression mask.
    Words below the diagonal are left unwritten."""
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
