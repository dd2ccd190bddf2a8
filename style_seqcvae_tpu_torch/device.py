"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU. A CUDA device with no GPU present raises: the
    port never carries on silently on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU with the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None
              ) -> Optional[torch.Tensor]:
    """A numpy array or tensor (``None`` passes through) on ``device``, cast
    to ``dtype`` when one is given. Host data bound for a GPU goes through
    pinned memory and is copied without the host waiting for the card (a
    copy from pageable memory waits for it), then cast there."""
    if x is None:
        return None
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype or t.dtype)
