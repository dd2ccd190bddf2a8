"""Carry the JAX package's captioner and detector parameters over to the port.

:func:`save_params_npz` and :func:`load_params_npz` move a parameter tree
through one numpy ``.npz`` (each key the tree path joined by ``/``), the
checkpoint exchange that needs neither JAX nor orbax on the reading side.

The input of the converters is the JAX params pytree with numpy arrays as
leaves (or the nested dicts that :func:`load_params_npz` returns), in its own
nesting: a dict with ``embedding``, ``cell`` (a ``CellParams`` NamedTuple
holding ``LSTMCellParams`` and ``AttentionParams``) and ``output_projection``
or ``output_layer`` dicts. NamedTuple fields are read by name, so the JAX
classes themselves are never imported. Layouts stay as they are: both sides
compute the same thing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.attention import AttentionParams
from style_seqcvae_tpu_torch.models.updown_cell import CellParams
from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams


def save_params_npz(tree: Any, path: str) -> None:
    """Write a parameter tree (dicts and NamedTuples, with arrays or CPU
    tensors as leaves) to one ``.npz``, each leaf under its path joined by
    ``/`` (``cell/attention_lstm/w``)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if hasattr(node, "_asdict"):                        # a NamedTuple
            node = node._asdict()
        if isinstance(node, dict):
            for k, v in node.items():
                if "/" in str(k) or not str(k):
                    raise ValueError(f"parameter key {k!r} cannot be a path segment")
                walk(v, f"{prefix}{k}/")
            return
        if torch.is_tensor(node):
            node = node.detach().cpu().numpy()
        flat[prefix[:-1]] = np.asarray(node)

    walk(tree, "")
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that :func:`save_params_npz` wrote,
    as :func:`from_jax_params` takes it."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _field(node: Any, name: str) -> Any:
    return node[name] if isinstance(node, dict) else getattr(node, name)


def from_jax_params(tree: Dict[str, Any], *,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX captioner params (numpy leaves) → the port's params on ``device``.
    ``dtype`` casts every leaf; ``None`` keeps the leaves' own type."""
    dev = resolve_device(device)

    def t(x) -> torch.Tensor:
        out = torch.from_numpy(np.array(x, copy=True))
        return out.to(device=dev, dtype=dtype or out.dtype)

    def lstm(node) -> LSTMCellParams:
        return LSTMCellParams(w=t(_field(node, "w")), b=t(_field(node, "b")))

    cell = tree["cell"]
    att = _field(cell, "attention")
    params: Dict[str, Any] = {
        "embedding": t(tree["embedding"]),
        "cell": CellParams(
            attention_lstm=lstm(_field(cell, "attention_lstm")),
            attention=AttentionParams(*(t(_field(att, f)) for f in AttentionParams._fields)),
            encoder_lstm=lstm(_field(cell, "encoder_lstm")),
            decoder_lstm=lstm(_field(cell, "decoder_lstm")),
            fc_mean_w=t(_field(cell, "fc_mean_w")),
            fc_mean_b=t(_field(cell, "fc_mean_b")),
            fc_log_var_w=t(_field(cell, "fc_log_var_w")),
            fc_log_var_b=t(_field(cell, "fc_log_var_b")),
        ),
    }
    for head in ("output_projection", "output_layer"):
        if head in tree:
            params[head] = {k: t(v) for k, v in tree[head].items()}
    return params


def from_jax_detector_params(tree: Dict[str, Any], *,
                             device: Optional[Union[str, torch.device]] = None,
                             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX detector params (numpy leaves) → the port's detector params on
    ``device``: ``resnet`` (``conv1``, ``bn1``, ``layer1`` .. ``layer4`` lists
    of bottleneck dicts with an optional ``downsample``), ``rpn`` (``conv``,
    ``cls``, ``bbox``), ``cls_score``, ``bbox_pred`` and ``cls_score_atts``.
    Conv kernels (the 4-D leaves) go from HWIO to OIHW, kept in
    channels_last memory; nothing else changes layout. ``dtype`` casts
    every leaf; ``None`` keeps the leaves' own type."""
    if "resnet" not in tree:
        raise NotImplementedError("only the ResNet backbone is ported (ROADMAP A8.1)")
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        out = torch.from_numpy(np.array(node, copy=True))
        out = out.to(device=dev, dtype=dtype or out.dtype)
        if out.dim() == 4:                                  # HWIO → OIHW
            out = out.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return out

    return convert(tree)


def to_device(params: Any, device: Union[str, torch.device]) -> Any:
    """A copy of ``params`` (dicts and NamedTuples of tensors) on ``device``."""
    if torch.is_tensor(params):
        return params.to(device)
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return type(params)(*[to_device(v, device) for v in params])
