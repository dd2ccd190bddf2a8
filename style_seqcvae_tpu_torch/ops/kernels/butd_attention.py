"""Bottom-up top-down attention weights: add, tanh, score and masked softmax
in one kernel.

No TPU kernel has this job: the JAX package leaves
``style_seqcvae_tpu/models/attention.py::attention_weights`` to XLA. On
CUDA tensors :func:`butd_attention` launches the hand-written kernel in
``csrc/butd_attention.cu``, which keeps the (rows, N, P) sum of the query
projection and the projected boxes out of device memory; on CPU tensors it
runs :func:`butd_attention_plain`, the same arithmetic as plain PyTorch ops.
The kernel has no backward: a call that needs a gradient runs the plain
version, which autograd differentiates (``models/attention.py::
attention_weights`` routes it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from style_seqcvae_tpu_torch.ops.masked import masked_softmax

# launches of the CUDA kernel in this process (the plain version not counted)
launches = 0


def butd_attention_plain(proj_query: torch.Tensor, pv: torch.Tensor, w_attend: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """proj_query (R, P), pv (B, N, P), w_attend (P,), mask (B, N) →
    weights (R, N): row r attends over the boxes of image r // (R // B),
    ``masked_softmax(w_attend · tanh(proj_query + pv))`` in the inputs'
    dtype, each op rounding to it; differentiable."""
    R, P = proj_query.shape
    B, N, _ = pv.shape
    q = proj_query.reshape(B, R // B, 1, P)
    logits = torch.matmul((q + pv[:, None]).tanh_(), w_attend)        # (B, R // B, N)
    keep = mask.reshape(B, 1, N).expand(logits.shape)
    return masked_softmax(logits, keep, dim=-1).reshape(R, N)


def _check(proj_query: torch.Tensor, pv: torch.Tensor, w_attend: torch.Tensor,
           mask: torch.Tensor) -> None:
    if proj_query.dim() != 2 or pv.dim() != 3 or w_attend.dim() != 1 or mask.dim() != 2:
        raise ValueError(f"need proj_query (R, P), pv (B, N, P), w_attend (P,) and mask "
                         f"(B, N), got {tuple(proj_query.shape)}, {tuple(pv.shape)}, "
                         f"{tuple(w_attend.shape)} and {tuple(mask.shape)}")
    (R, P), (B, N, P_v) = proj_query.shape, pv.shape
    if P_v != P or w_attend.shape[0] != P or tuple(mask.shape) != (B, N):
        raise ValueError(f"widths disagree: proj_query {tuple(proj_query.shape)}, pv "
                         f"{tuple(pv.shape)}, w_attend {tuple(w_attend.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if B == 0 or R % B:
        raise ValueError(f"{R} rows do not split evenly over {B} images")
    dtypes = {proj_query.dtype, pv.dtype, w_attend.dtype}
    if len(dtypes) != 1 or proj_query.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"proj_query, pv and w_attend must all be float32 or all bfloat16, "
                        f"got {proj_query.dtype}, {pv.dtype} and {w_attend.dtype}")
    devices = {proj_query.device, pv.device, w_attend.device, mask.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    for name, t in (("proj_query", proj_query), ("pv", pv), ("w_attend", w_attend)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def plan(B: int, rows_per_image: int, N: int, P: int, dtype: torch.dtype) -> Dict[str, int]:
    """How the kernel splits B images of ``rows_per_image`` rows over N boxes
    of width P on the current CUDA device (16-byte aligned inputs): rows a
    block, blocks, threads a block, dynamic shared memory bytes, box tiles,
    boxes a tile and the bytes of one copy to shared memory."""
    from style_seqcvae_tpu_torch.ops.kernels import _build

    lib = _build.library()
    out = (ctypes.c_longlong * 7)()
    _build.check(lib, lib.ssc_butd_attention_plan(B, rows_per_image, N, P,
                                                  int(dtype == torch.bfloat16), out),
                 "butd_attention plan")
    return dict(zip(("rows_per_block", "blocks", "threads", "smem_bytes", "tiles",
                     "boxes_per_tile", "copy_bytes"), out))


def _launch(proj_query: torch.Tensor, pv: torch.Tensor, w_attend: torch.Tensor,
            mask: torch.Tensor, with_logits: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    if proj_query.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {proj_query.device}")
    # the kernel reads the mask as (B, N) bytes: 1 keeps a box
    mask = (mask if mask.dtype == torch.bool else mask > 0).contiguous()
    (R, P), (B, N, _) = proj_query.shape, pv.shape
    from style_seqcvae_tpu_torch.ops.kernels import _build

    lib = _build.library()
    out = torch.empty((R, N), dtype=proj_query.dtype, device=proj_query.device)
    logits = torch.empty((R, N), dtype=torch.float32, device=proj_query.device) \
        if with_logits else None
    if R == 0 or N == 0:
        return out, logits
    with torch.cuda.device(proj_query.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssc_butd_attention(proj_query.data_ptr(), pv.data_ptr(), w_attend.data_ptr(),
                                    mask.data_ptr(), out.data_ptr(),
                                    logits.data_ptr() if with_logits else None, B, R // B, N, P,
                                    int(proj_query.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, "butd_attention")
    launches += 1
    return out, logits


def butd_attention(proj_query: torch.Tensor, pv: torch.Tensor, w_attend: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`butd_attention_plain`; the mask keeps the
    boxes where it is > 0 (True). The kernel sums,
    takes the tanh and the softmax in f32 and writes the weights in the
    inputs' dtype."""
    _check(proj_query, pv, w_attend, mask)
    if proj_query.device.type == "cpu":
        return butd_attention_plain(proj_query, pv, w_attend, mask)
    return _launch(proj_query, pv, w_attend, mask, with_logits=False)[0]


def butd_attention_logits(proj_query: torch.Tensor, pv: torch.Tensor, w_attend: torch.Tensor,
                          mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights and its f32 logits ``w_attend · tanh(proj_query
    + pv)`` (R, N) before the softmax, on CUDA tensors (tests and
    ``chip_smoke.py``)."""
    _check(proj_query, pv, w_attend, mask)
    return _launch(proj_query, pv, w_attend, mask, with_logits=True)
