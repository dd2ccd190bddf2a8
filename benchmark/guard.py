"""The run's own check that neither JAX nor the JAX package was loaded.

Names are compared by their top-level part (before the first dot), whole:
``style_seqcvae_tpu_torch`` is the port, ``style_seqcvae_tpu`` the JAX
package it was ported from."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "style_seqcvae_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (``sys.modules`` unless ``names`` is given)
    whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
