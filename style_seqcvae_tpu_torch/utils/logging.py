"""Training metrics and timing (counterpart of
``style_seqcvae_tpu/utils/logging.py``).

:class:`MetricsWriter` writes the JSONL records the JAX writer writes
(``{"step": it, name: float, ...}`` a line); in a process group only
rank 0 writes (the metrics it gets are the global ones). The JAX writer also writes
TensorBoard events when flax is installed; the GPU machine has no flax, so
the port writes the JSONL file only. :func:`device_sync` waits for the card
and returns a Python float; :class:`StepTimer` accumulates host wall time
per phase.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict

import torch

from style_seqcvae_tpu_torch.parallel.multihost import process_index


class MetricsWriter:
    def __init__(self, serialization_dir: str, filename: str = "metrics.jsonl"):
        self._path = os.path.join(serialization_dir, filename)
        self._f = None
        if process_index() == 0:
            os.makedirs(serialization_dir, exist_ok=True)
            self._f = open(self._path, "a")

    def scalars(self, step: int, values: Dict[str, Any]) -> None:
        if self._f is None:
            return
        rec = {"step": int(step)}
        for k, v in values.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def device_sync(x) -> float:
    """``x`` (a 0-dim tensor or a number) as a Python float, once the card
    has finished the work queued before it."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.item())
    return float(x)


class StepTimer:
    """Per-phase host wall-clock accumulator (data / step)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, count: int = 1):
        """``count``: the steps this region covers (a K-step chained call
        passes K, so that :meth:`summary` stays per step)."""
        t0 = time.perf_counter()
        yield
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + count

    def summary(self) -> Dict[str, float]:
        return {f"{k}_ms": 1000.0 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}
