"""The detector's SGD with the reference's per-parameter rules (counterpart
of ``style_seqcvae_tpu/training/detector_optimizer.py``).

Each leaf's label (``faster_rcnn.detector_trainable_labels``) decides its
treatment: ``"never"`` leaves are frozen (no gradient is computed for them:
``requires_grad`` is off); ``"input_conv"`` (the stem conv when the backbone
trains from scratch) has its gradient scaled by 1 / 57.6² before clipping;
the rest train. A step: the optional global-norm clip over the masked
gradients, weight decay added to the gradient (biases only with
``bias_decay``), momentum, and the learning rate times 2 for biases under
``double_bias``, decayed by ``gamma`` every ``lr_decay_step_epochs`` epochs
of ``steps_per_epoch`` steps. The arithmetic is JAX's, in f32, on lists of
tensors (``torch._foreach_*``) so that a step costs a few launches per group
of leaves rather than several per leaf.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from style_seqcvae_tpu_torch.models.detector.faster_rcnn import detector_trainable_labels
from style_seqcvae_tpu_torch.models.detector.resnet import _INPUT_PIXEL_STD
from style_seqcvae_tpu_torch.weights import named_leaves


class DetectorSGD:
    def __init__(self, params, *, lr: float, momentum: float = 0.9,
                 weight_decay: float = 1e-4, double_bias: bool = False,
                 bias_decay: bool = False, steps_per_epoch: int = 1,
                 lr_decay_step_epochs: int = 4, gamma: float = 0.1, clip_norm: float = 0.0,
                 freeze_backbone: bool = True):
        """``params``: the detector's f32 master parameters (a nested dict),
        updated in place; their ``requires_grad`` is set from the labels."""
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.double_bias, self.bias_decay = double_bias, bias_decay
        self.steps_per_epoch, self.lr_decay_step_epochs = steps_per_epoch, lr_decay_step_epochs
        self.gamma, self.clip_norm = gamma, clip_norm
        label_of = dict(named_leaves(detector_trainable_labels(params, freeze_backbone)))
        self.named = named_leaves(params)
        self.labels = {path: label_of[path] for path, _ in self.named}
        self.trace = {path: torch.zeros_like(p) for path, p in self.named}
        self.step = 0
        for path, p in self.named:
            p.requires_grad_(self.labels[path] != "never")

    def lr_at(self, step: int) -> np.float32:
        """The learning rate of step ``step`` (1-based), f32 as JAX's."""
        decay_pow = np.float32((step // self.steps_per_epoch) // self.lr_decay_step_epochs)
        return np.float32(self.lr) * np.power(np.float32(self.gamma), decay_pow)

    @torch.no_grad()
    def apply(self) -> None:
        """One step from the leaves' ``.grad``, which it then clears. A
        trainable leaf without a gradient takes a zero gradient."""
        it = self.step + 1
        lr_t = self.lr_at(it)
        live = []
        for path, p in self.named:
            label = self.labels[path]
            if label == "never":
                continue
            g = torch.zeros_like(p) if p.grad is None else p.grad.to(p.dtype)
            if label == "input_conv":
                g = g * (1.0 / (_INPUT_PIXEL_STD ** 2))
            live.append((path, p, g))
            p.grad = None
        gs = [g for _, _, g in live]
        if self.clip_norm > 0:
            norms = torch._foreach_norm(gs)
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0)
            gs = torch._foreach_mul(gs, scale)
        groups: Dict[tuple, List[int]] = {}
        for i, (path, _, _) in enumerate(live):
            bias = path.rsplit("/", 1)[-1] == "b"
            wd = self.weight_decay if (not bias or self.bias_decay) else 0.0
            lr_mult = 2.0 if (bias and self.double_bias) else 1.0
            groups.setdefault((wd, lr_mult), []).append(i)
        for (wd, lr_mult), idx in groups.items():
            ps = [live[i][1] for i in idx]
            ts = [self.trace[live[i][0]] for i in idx]
            g_eff = [gs[i] for i in idx]
            if wd:
                g_eff = torch._foreach_add(g_eff, ps, alpha=wd)
            torch._foreach_mul_(ts, self.momentum)
            torch._foreach_add_(ts, g_eff)
            step_size = float(np.float32(-lr_t) * np.float32(lr_mult))
            torch._foreach_add_(ps, ts, alpha=step_size)
        self.step = it
