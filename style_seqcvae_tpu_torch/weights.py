"""Carry the JAX package's captioner and detector parameters over to the port.

:func:`save_params_npz` and :func:`load_params_npz` move a parameter tree
through one numpy ``.npz`` (each key the tree path joined by ``/``), the
checkpoint exchange that needs neither JAX nor orbax on the reading side;
:func:`to_jax_params` hands the port's (trained) params back in the JAX
tree's layout.

The input of the converters is the JAX params pytree with numpy arrays as
leaves (or the nested dicts that :func:`load_params_npz` returns), in its own
nesting: a dict with ``embedding``, ``cell`` and ``output_projection`` or
``output_layer`` dicts. ``cell`` is the Style-SeqCVAE family's ``CellParams``
(``attention_lstm``, ``attention``, ``encoder_lstm``, ``decoder_lstm``,
``fc_*``) or the baseline family's ``BaselineCellParams``
(``attention_lstm``, ``attention``, ``language_lstm``); :func:`param_family`
tells them apart by these keys. NamedTuple fields are read by name, so the
JAX classes themselves are never imported. Layouts stay as they are: both
sides compute the same thing.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.attention import AttentionParams
from style_seqcvae_tpu_torch.models.baseline import BaselineCellParams
from style_seqcvae_tpu_torch.models.updown_cell import CellParams
from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """The leaves of a parameter tree (dicts, NamedTuples and lists) with
    their paths joined by ``/`` (``cell/attention_lstm/w``; a list's items
    by their index, ``resnet/layer1/0/conv1``), in the tree's order."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, prefix: str) -> None:
        if hasattr(node, "_asdict"):                        # a NamedTuple
            node = node._asdict()
        elif isinstance(node, (list, tuple)):
            node = {str(i): v for i, v in enumerate(node)}
        if isinstance(node, dict):
            for k, v in node.items():
                if "/" in str(k) or not str(k):
                    raise ValueError(f"parameter key {k!r} cannot be a path segment")
                walk(v, f"{prefix}{k}/")
            return
        out.append((prefix[:-1], node))

    walk(tree, "")
    return out


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``tree`` (dicts, lists and NamedTuples of tensors) with ``fn`` applied
    to every leaf, its structure kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return type(tree)(*[tree_map(fn, v) for v in tree])


def cast_floats(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """``tree`` with every f32 leaf cast to ``dtype`` (``None``: unchanged);
    autograd carries gradients back through the casts."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, tree)


def save_params_npz(tree: Any, path: str) -> None:
    """Write a parameter tree (dicts and NamedTuples, with arrays or CPU
    tensors as leaves) to one ``.npz``, each leaf under its path joined by
    ``/`` (``cell/attention_lstm/w``)."""
    flat = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in named_leaves(tree)}
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that :func:`save_params_npz` wrote,
    as :func:`from_jax_params` and :func:`from_jax_detector_params` take
    it; a dict keyed ``0`` .. ``n-1`` comes back as the list it was."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]

    def lists(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _field(node: Any, name: str) -> Any:
    return node[name] if isinstance(node, dict) else getattr(node, name)


FAMILIES = ("cvae", "baseline")


def param_family(tree: Dict[str, Any]) -> str:
    """``"cvae"`` or ``"baseline"``: the captioner family whose parameter tree
    ``tree`` is (JAX's or the port's), read from the keys of its ``cell``;
    raises ``ValueError`` on a tree of neither."""
    cell = tree.get("cell") if isinstance(tree, dict) else None
    keys = set(cell._fields if hasattr(cell, "_fields") else cell or ())
    if {"encoder_lstm", "decoder_lstm"} <= keys:
        return "cvae"
    if "language_lstm" in keys:
        return "baseline"
    raise ValueError(f"not a captioner parameter tree: its cell holds {sorted(keys)}")


def from_jax_params(tree: Dict[str, Any], *,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None,
                    family: Optional[str] = None) -> Dict[str, Any]:
    """JAX captioner params (numpy leaves) → the port's params on ``device``.
    ``dtype`` casts every leaf; ``None`` keeps the leaves' own type. The
    family comes from the tree (:func:`param_family`); a ``family`` that is
    given must be the tree's, else ``ValueError`` names what was found."""
    dev = resolve_device(device)
    found = param_family(tree)
    if family is not None and family != found:
        if family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
        raise ValueError(f"a {family} model was asked for, but the parameters are the "
                         f"{found} family's")

    def t(x) -> torch.Tensor:
        out = torch.from_numpy(np.array(x, copy=True))
        return out.to(device=dev, dtype=dtype or out.dtype)

    def lstm(node) -> LSTMCellParams:
        return LSTMCellParams(w=t(_field(node, "w")), b=t(_field(node, "b")))

    cell = tree["cell"]
    att = _field(cell, "attention")
    attention = AttentionParams(*(t(_field(att, f)) for f in AttentionParams._fields))
    if found == "baseline":
        cell_params = BaselineCellParams(
            attention_lstm=lstm(_field(cell, "attention_lstm")), attention=attention,
            language_lstm=lstm(_field(cell, "language_lstm")))
    else:
        cell_params = CellParams(
            attention_lstm=lstm(_field(cell, "attention_lstm")),
            attention=attention,
            encoder_lstm=lstm(_field(cell, "encoder_lstm")),
            decoder_lstm=lstm(_field(cell, "decoder_lstm")),
            fc_mean_w=t(_field(cell, "fc_mean_w")),
            fc_mean_b=t(_field(cell, "fc_mean_b")),
            fc_log_var_w=t(_field(cell, "fc_log_var_w")),
            fc_log_var_b=t(_field(cell, "fc_log_var_b")),
        )
    params: Dict[str, Any] = {"embedding": t(tree["embedding"]), "cell": cell_params}
    for head in ("output_projection", "output_layer"):
        if head in tree:
            params[head] = {k: t(v) for k, v in tree[head].items()}
    return params


def to_jax_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's captioner params (either family) → nested dicts of numpy
    arrays in the JAX tree's layout and names (``cell`` a dict of the cell
    NamedTuple's fields),
    the inverse of :func:`from_jax_params`: the JAX package rebuilds its
    tree from them, and :func:`save_params_npz` writes them as it writes
    the JAX tree."""

    def conv(node: Any) -> Any:
        if torch.is_tensor(node):
            return node.detach().cpu().numpy().copy()
        if hasattr(node, "_asdict"):
            node = node._asdict()
        return {k: conv(v) for k, v in node.items()}

    return conv(params)


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


def to_jax_detector_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's detector params → nested dicts and lists of numpy arrays
    in the JAX tree's layout (conv kernels OIHW → HWIO), the inverse of
    :func:`from_jax_detector_params`: :func:`save_params_npz` writes them
    as it writes the JAX tree."""

    def conv(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        out = node.detach().cpu()
        if out.dim() == 4:                                  # OIHW → HWIO
            out = out.permute(2, 3, 1, 0)
        return out.contiguous().numpy().copy()

    return conv(params)


def load_detector_params(path: str, *, depth: int = 101, num_anchors: int = 12,
                         device: Optional[Union[str, torch.device]] = None,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Detector params from a file: a ``.npz`` of the JAX detector tree
    (:func:`save_params_npz` of ``jax.tree_util.tree_map(np.asarray,
    params)``, or of :func:`to_jax_detector_params`), or a reference
    PyTorch checkpoint (``.pth``, jwyang names, through
    ``utils/torch_import.py::import_detector_state_dict`` at ``depth`` and
    ``num_anchors``). A directory (an Orbax checkpoint of the JAX package)
    is refused by name: the card's machine has no orbax."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: Orbax detector checkpoints are not read by "
                         "the port; pass a .npz of the detector tree or a reference .pth")
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            is_npz = all(n.endswith(".npy") for n in z.namelist())
        if is_npz:
            return from_jax_detector_params(load_params_npz(path), device=device, dtype=dtype)
    from style_seqcvae_tpu_torch.utils.torch_import import (
        import_detector_state_dict,
        load_torch_checkpoint,
    )

    return import_detector_state_dict(load_torch_checkpoint(path), depth, num_anchors,
                                      device=device, dtype=dtype)


def to_device(params: Any, device: Union[str, torch.device]) -> Any:
    """A copy of ``params`` (dicts and NamedTuples of tensors) on ``device``."""
    return tree_map(lambda t: t.to(device), params)
