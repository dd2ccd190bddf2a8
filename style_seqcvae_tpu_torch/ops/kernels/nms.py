"""Greedy NMS batched over groups (kernel D).

Counterpart of ``style_seqcvae_tpu/ops/pallas/nms.py::nms_pallas`` (the
``suppression_bitmask`` kernel and its greedy scan). On CUDA tensors
:func:`nms` launches the two hand-written kernels of ``csrc/nms.cu``, the
bitmask and the scan, and counts one launch; on CPU tensors it runs
:func:`nms_plain` (``ops/nms.py::nms``: the pairwise suppression matrix in
torch plus a greedy scan in Python), with the same outputs.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from style_seqcvae_tpu_torch.ops.nms import nms as nms_plain
from style_seqcvae_tpu_torch.ops.nms import sort_desc

# calls that launched the CUDA kernels in this process (the plain version
# not counted), in all and by the (groups, boxes) shape of the call
launches = 0
launches_by_shape: Counter = Counter()

_BOX = 64                       # boxes per mask word
_MAX_SMEM_BYTES = 227 * 1024
_MAX_GROUPS = 65535             # grid z of the bitmask kernel


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


def greedy_scan(mask: torch.Tensor, order: Optional[torch.Tensor], max_out: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA only: the mask of :func:`suppression_bitmask` and the sort's
    permutation (G, N) int32 (``None``: the identity) → keep_idx and
    keep_mask as :func:`nms` returns them."""
    from style_seqcvae_tpu_torch.ops.kernels import _build

    G, N, _ = mask.shape
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
