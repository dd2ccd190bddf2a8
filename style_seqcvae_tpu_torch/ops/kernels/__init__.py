"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers."""

from __future__ import annotations

import json
import os
from typing import Dict

# a CLI run as a subprocess writes its launch counts to the file this names
LAUNCH_REPORT_ENV = "SSC_LAUNCH_REPORT"
# and saves each kernel's inputs at its first launch to the directory this
# names, so that the process that started it can hold the kernel to its
# plain version on the very inputs the workflow gave it (chip_smoke.py)
KERNEL_INPUTS_ENV = "SSC_KERNEL_INPUTS"
_recorded: set = set()


def launch_counts() -> Dict[str, int]:
    """This process's launches of each kernel so far: A (``vocab_topk_lse``),
    B (``topk_lse``), C (``roi_align``), C's backward, D (``nms``) and the
    BUTD attention (``butd_attention``)."""
    from style_seqcvae_tpu_torch.ops.kernels import (
        butd_attention,
        nms,
        roi_align,
        topk_lse,
        vocab_topk_lse,
    )

    return {"vocab_topk_lse": vocab_topk_lse.launches, "topk_lse": topk_lse.launches,
            "roi_align": roi_align.launches,
            "roi_align_backward": roi_align.backward_launches, "nms": nms.launches,
            "butd_attention": butd_attention.launches}


def report_launches(rc: int) -> int:
    """Write :func:`launch_counts` as JSON to the file that the
    ``SSC_LAUNCH_REPORT`` environment variable names, when it is set, and
    return ``rc``: a CLI's ``__main__`` ends with
    ``raise SystemExit(report_launches(main()))``, so that the process that
    started it reads the launches (``scripts/three_stage.py``)."""
    path = os.environ.get(LAUNCH_REPORT_ENV)
    if path:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)
    return rc


def record_inputs(name: str, **args) -> None:
    """Save ``args`` (tensors copied to the CPU, other values as they are)
    to ``$SSC_KERNEL_INPUTS/<name>.pt`` at kernel ``name``'s first launch in
    this process; a no-op when the variable is unset. A wrapper calls it
    just before it launches its kernel."""
    root = os.environ.get(KERNEL_INPUTS_ENV)
    if not root or name in _recorded:
        return
    _recorded.add(name)
    import torch

    os.makedirs(root, exist_ok=True)
    torch.save({k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}, os.path.join(root, f"{name}.pt"))
