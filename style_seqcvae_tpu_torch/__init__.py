"""PyTorch/CUDA port of ``style_seqcvae_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; module names mirror it
(``ops/lstm.py`` here is the counterpart of ``ops/lstm.py`` there). The port
imports ``torch`` and numpy only, never JAX and nothing of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (see :func:`resolve_device`).
The kernels (vocabulary selection, RoIAlign, NMS) are hand-written CUDA C++
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(``ops/kernels/_build.py``).
"""

from style_seqcvae_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
