"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W)."""

from __future__ import annotations

# operations a second by the dtype of a product's operands; float32 is the
# CUDA cores' rate with TF32 off
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, n_bytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the dtype's
    peak or bytes over HBM's rate, whichever is longer."""
    return max(ops / PEAK_OPS[dtype], n_bytes / HBM_BYTES_PER_S)
