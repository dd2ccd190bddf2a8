"""The captioner's optimizer with the reference's training dynamics
(counterpart of ``style_seqcvae_tpu/training/optimizer.py:38-123``).

The reference trains with ``torch.optim.SGD(lr, momentum, weight_decay)``,
``LambdaLR(1 - it/num_iterations)`` and ``clip_grad_norm_`` over the
gradients that are present (var_updown/scripts/train.py:126-176), and a
two-phase schedule that freezes the decoder LSTM except every Nth step until
iteration ``EPOCH_START_DECODER_TRAINING`` (train.py:154-161). The JAX
package rebuilds that recipe as one optax transformation over a label tree;
``tests/test_training.py::test_sgd_matches_torch_dynamics`` holds it to this
torch recipe, which is what the port runs.

Labels per parameter path (JAX ``make_labels``):

* ``"always"``: trained every step;
* ``"never"``: the tied GloVe embedding, ``requires_grad=False``;
* ``"decoder"``: the decoder LSTM, trained on the schedule's active steps.

A step (1-indexed ``it``): the decoder's ``requires_grad`` follows the
schedule, so an inactive parameter has no ``.grad``, takes no part in the
clip, and SGD skips its weight decay and momentum; then the forward and
backward; then the clip, the SGD step and the scheduler step.

The clip is JAX's (``training/optimizer.py:90-94``): the gradients are
scaled by ``min(1, clip / (gnorm + 1e-6))``, ``gnorm`` the global norm of
``parallel/collectives.py::global_grad_norm``, which counts every element
of a sharded leaf once (``norm_groups``: the group each sharded leaf's
squares are summed over). Weight decay and momentum are elementwise, so a
block of a leaf takes them as the whole leaf would.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from style_seqcvae_tpu_torch.parallel.collectives import global_grad_norm
from style_seqcvae_tpu_torch.weights import named_leaves


def make_labels(params: Any, freeze_embedding: bool) -> Dict[str, str]:
    """Parameter path → ``"always"``, ``"never"`` or ``"decoder"``, by the JAX
    package's rule over the port's parameter tree."""
    labels = {}
    for path, _ in named_leaves(params):
        keys = path.split("/")
        if "embedding" in keys and "output_projection" not in keys:
            labels[path] = "never" if freeze_embedding else "always"
        elif "decoder_lstm" in keys:
            labels[path] = "decoder"
        else:
            labels[path] = "always"
    return labels


def _lr_scheduler(optimizer: torch.optim.Optimizer, num_iterations: int,
                  step: int) -> torch.optim.lr_scheduler.LambdaLR:
    """``LambdaLR(1 - it/N)`` positioned after ``step`` completed steps."""
    for group in optimizer.param_groups:
        group.setdefault("initial_lr", group["lr"])
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda it: 1.0 - it / num_iterations, last_epoch=step - 1)


class SGDFreezeSchedule:
    """``torch.optim.SGD`` with ``LambdaLR``, the global-norm clip and the
    decoder-freeze schedule over a parameter tree whose leaves are tensors
    that the caller keeps training (leaf tensors, updated in place)."""

    def __init__(self, params: Any, labels: Dict[str, str], *, lr: float, momentum: float,
                 weight_decay: float, num_iterations: int, clip_norm: float,
                 decoder_start_iteration: int, decoder_update_every: int,
                 norm_groups: Optional[Dict[str, Any]] = None):
        self.named: List[Tuple[str, torch.Tensor]] = named_leaves(params)
        self.labels = labels
        self.norm_groups = norm_groups or {}
        self.clip_norm = clip_norm
        self.num_iterations = num_iterations
        self.decoder_start_iteration = decoder_start_iteration
        self.decoder_update_every = decoder_update_every
        for path, p in self.named:
            p.requires_grad_(labels[path] != "never")
        self.optimizer = torch.optim.SGD([p for _, p in self.named], lr=lr, momentum=momentum,
                                         weight_decay=weight_decay)
        self.scheduler = _lr_scheduler(self.optimizer, num_iterations, 0)

    def decoder_active(self, iteration: int) -> bool:
        """Whether the decoder LSTM trains at the 1-indexed ``iteration``."""
        return (iteration > self.decoder_start_iteration
                or iteration % self.decoder_update_every == 0)

    def prepare(self, iteration: int) -> None:
        """Before the forward of the 1-indexed ``iteration``: the decoder's
        ``requires_grad`` set by the schedule, every ``.grad`` cleared."""
        active = self.decoder_active(iteration)
        for path, p in self.named:
            if self.labels[path] == "decoder":
                p.requires_grad_(active)
        self.optimizer.zero_grad(set_to_none=True)

    def update(self) -> torch.Tensor:
        """After the backward: clip the present gradients to ``clip_norm``
        (their global norm before the clip is returned), then the SGD and
        LR steps."""
        norm = global_grad_norm(self.named, self.norm_groups)
        scale = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
        for _, p in self.named:
            if p.grad is not None:
                p.grad.mul_(scale.to(p.grad.dtype))
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def momentum(self) -> Dict[str, torch.Tensor]:
        """Parameter path → momentum buffer, zeros where SGD has none yet
        (the JAX optimizer's ``trace``)."""
        out = {}
        for path, p in self.named:
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            out[path] = buf if buf is not None else torch.zeros_like(p)
        return out

    def load(self, momentum: Dict[str, torch.Tensor], step: int) -> None:
        """Restore the momentum buffers (by path) and the LR schedule after
        ``step`` completed steps. A zero buffer acts as a missing one: the
        next active step makes it ``0.9·0 + g = g`` either way."""
        for path, p in self.named:
            if self.labels[path] != "never":
                buf = momentum[path].to(device=p.device, dtype=p.dtype)
                self.optimizer.state[p]["momentum_buffer"] = buf.clone()
        self.scheduler = _lr_scheduler(self.optimizer, self.num_iterations, step)


def make_captioner_optimizer(config, params: Any, tie_embeddings: bool,
                             norm_groups: Optional[Dict[str, Any]] = None
                             ) -> SGDFreezeSchedule:
    """The optimizer of a ``Config``'s OPTIM section over ``params`` (JAX
    ``optimizer.py:112-123``); the tied embedding is frozen."""
    return SGDFreezeSchedule(
        params, make_labels(params, freeze_embedding=tie_embeddings),
        lr=config.OPTIM.LR,
        momentum=config.OPTIM.MOMENTUM,
        weight_decay=config.OPTIM.WEIGHT_DECAY,
        num_iterations=config.OPTIM.NUM_ITERATIONS,
        clip_norm=config.OPTIM.CLIP_GRADIENTS,
        decoder_start_iteration=config.OPTIM.EPOCH_START_DECODER_TRAINING,
        decoder_update_every=config.OPTIM.BEFORE_UPDATE_DECODER_EVERY,
        norm_groups=norm_groups,
    )
