"""Reference PyTorch checkpoints into the port's captioner and detector
params (counterpart of ``style_seqcvae_tpu/utils/torch_import.py``).

:func:`import_captioner_state_dict` maps a var_updown ``UpDownCaptioner``
state dict (module names from var_updown/var_updown/models/
updown_captioner.py and modules/updown_cell.py) onto the port's parameter
tree: each ``nn.LSTMCell`` fused as ``w = [w_ihᵀ; w_hhᵀ]``, ``b = b_ih +
b_hh``; the BUTD projections, ``fc_mean`` and ``fc_log_var`` transposed; the
tied output projection or the untied output layer.
:func:`import_baseline_state_dict` maps an updown-baseline captioner's
(one language LSTM, no ``fc_*``) onto the baseline family's tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.models.detector.resnet import LAYERS
from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams
from style_seqcvae_tpu_torch.weights import from_jax_detector_params

Device = Optional[Union[str, torch.device]]


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference checkpoint's state dict (its ``"model"`` entry when there
    is one), with DataParallel's ``module.`` prefix stripped. Loaded with
    ``weights_only=True``: tensors and plain containers only, no pickled
    code (the JAX importer unpickles everything)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict) and "model" in data:
        data = data["model"]
    return {(k[7:] if k.startswith("module.") else k): v for k, v in data.items()}


def _converters(sd: Mapping, like: torch.Tensor):
    """(tensor, fused LSTM, BUTD attention) readers of ``sd`` onto ``like``'s
    device and dtype."""

    def t(x) -> torch.Tensor:
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return torch.from_numpy(np.array(x, copy=True)).to(device=like.device, dtype=like.dtype)

    def lstm(prefix: str) -> LSTMCellParams:
        return LSTMCellParams(
            w=torch.cat([t(sd[prefix + ".weight_ih"]).T, t(sd[prefix + ".weight_hh"]).T], 0),
            b=t(sd[prefix + ".bias_ih"]) + t(sd[prefix + ".bias_hh"]))

    def attention(params_attention):
        butd = "_updown_cell._butd_attention."
        return params_attention._replace(
            w_query=t(sd[butd + "_query_vector_projection_layer.weight"]).T.contiguous(),
            w_image=t(sd[butd + "_image_features_projection_layer.weight"]).T.contiguous(),
            w_attend=t(sd[butd + "_attention_layer.weight"])[0].contiguous())

    return t, lstm, attention


def import_captioner_state_dict(sd: Mapping, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` (from ``init_captioner``, for the structure, device and
    dtype) filled from the reference state dict ``sd`` (tensors or numpy)."""
    t, lstm, attention = _converters(sd, params["embedding"])
    cell = params["cell"]._replace(
        attention_lstm=lstm("_updown_cell._attention_lstm_cell"),
        encoder_lstm=lstm("_updown_cell._language_lstm_cell_encoder"),
        decoder_lstm=lstm("_updown_cell._language_lstm_cell_decoder"),
        attention=attention(params["cell"].attention),
        fc_mean_w=t(sd["_updown_cell.fc_mean.weight"]).T.contiguous(),
        fc_mean_b=t(sd["_updown_cell.fc_mean.bias"]),
        fc_log_var_w=t(sd["_updown_cell.fc_log_var.weight"]).T.contiguous(),
        fc_log_var_b=t(sd["_updown_cell.fc_log_var.bias"]),
    )
    out = dict(params)
    out["cell"] = cell
    out["embedding"] = t(sd["_embedding_layer.weight"])
    if "output_projection" in params:
        out["output_projection"] = {"w": t(sd["_output_projection.0.weight"]).T.contiguous(),
                                    "b": t(sd["_output_projection.0.bias"])}
    elif "_output_layer.weight" in sd:
        out["output_layer"] = {"w": t(sd["_output_layer.weight"]).T.contiguous(),
                               "b": t(sd["_output_layer.bias"])}
    return out


def import_baseline_state_dict(sd: Mapping, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` (from ``init_baseline``) filled from an updown-baseline
    captioner's state dict ``sd`` (JAX ``utils/torch_import.py:89-112``): the
    attention and language LSTMs, the BUTD attention, the embedding and the
    tied output projection."""
    t, lstm, attention = _converters(sd, params["embedding"])
    out = dict(params)
    out["cell"] = params["cell"]._replace(
        attention_lstm=lstm("_updown_cell._attention_lstm_cell"),
        language_lstm=lstm("_updown_cell._language_lstm_cell"),
        attention=attention(params["cell"].attention))
    out["embedding"] = t(sd["_embedding_layer.weight"])
    if "output_projection" in params:
        out["output_projection"] = {"w": t(sd["_output_projection.0.weight"]).T.contiguous(),
                                    "b": t(sd["_output_projection.0.bias"])}
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _conv(sd: Mapping, name: str) -> np.ndarray:
    return np.transpose(_np(sd[name]), (2, 3, 1, 0))       # OIHW → HWIO, the JAX layout


def _bn(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[prefix + ".weight"]), "offset": _np(sd[prefix + ".bias"]),
            "mean": _np(sd[prefix + ".running_mean"]), "var": _np(sd[prefix + ".running_var"])}


def _bottleneck(sd: Mapping, prefix: str) -> Dict[str, Any]:
    p = {"conv1": _conv(sd, prefix + ".conv1.weight"), "bn1": _bn(sd, prefix + ".bn1"),
         "conv2": _conv(sd, prefix + ".conv2.weight"), "bn2": _bn(sd, prefix + ".bn2"),
         "conv3": _conv(sd, prefix + ".conv3.weight"), "bn3": _bn(sd, prefix + ".bn3")}
    if prefix + ".downsample.0.weight" in sd:
        p["downsample"] = {"conv": _conv(sd, prefix + ".downsample.0.weight"),
                           "bn": _bn(sd, prefix + ".downsample.1")}
    return p


def import_resnet_state_dict(sd: Mapping, depth: int = 101, *, device: Device = None,
                             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A torchvision-named ResNet state dict (``conv1``, ``bn1``,
    ``layerX.Y.*``) → the port's ``resnet`` subtree on ``device``."""
    tree: Dict[str, Any] = {"conv1": _conv(sd, "conv1.weight"), "bn1": _bn(sd, "bn1")}
    for li, n in enumerate(LAYERS[depth], start=1):
        tree[f"layer{li}"] = [_bottleneck(sd, f"layer{li}.{bi}") for bi in range(n)]
    return from_jax_detector_params({"resnet": tree}, device=device, dtype=dtype)["resnet"]


def import_detector_state_dict(sd: Mapping, depth: int = 101, num_anchors: int = 12, *,
                               device: Device = None,
                               dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A jwyang ``resnet(_fasterRCNN)`` state dict → the port's detector
    params on ``device``: ``RCNN_base`` (indices 0 conv1, 1 bn1, 4-6
    layer1-3), ``RCNN_top`` (layer4), the RPN heads and the class, box and
    attribute heads. The reference packs the RPN's class scores as (2, A)
    channels (background first); the port's layout is (A, 2), so the output
    channels are permuted."""
    blocks = LAYERS[depth]
    resnet: Dict[str, Any] = {"conv1": _conv(sd, "RCNN_base.0.weight"),
                              "bn1": _bn(sd, "RCNN_base.1")}
    for li, (seq_idx, n) in enumerate(zip((4, 5, 6), blocks[:3]), start=1):
        resnet[f"layer{li}"] = [_bottleneck(sd, f"RCNN_base.{seq_idx}.{bi}") for bi in range(n)]
    resnet["layer4"] = [_bottleneck(sd, f"RCNN_top.0.{bi}") for bi in range(blocks[3])]

    def linear(prefix):
        return {"w": _np(sd[prefix + ".weight"]).T, "b": _np(sd[prefix + ".bias"])}

    def conv_head(prefix):
        return {"w": _conv(sd, prefix + ".weight"), "b": _np(sd[prefix + ".bias"])}

    cls = conv_head("RCNN_rpn.RPN_cls_score")
    perm = np.arange(2 * num_anchors).reshape(2, num_anchors).T.reshape(-1)
    tree: Dict[str, Any] = {
        "resnet": resnet,
        "rpn": {"conv": conv_head("RCNN_rpn.RPN_Conv"),
                "cls": {"w": cls["w"][..., perm], "b": cls["b"][perm]},
                "bbox": conv_head("RCNN_rpn.RPN_bbox_pred")},
        "cls_score": linear("RCNN_cls_score"),
        "bbox_pred": linear("RCNN_bbox_pred"),
    }
    if "RCNN_cls_score_atts.weight" in sd:
        tree["cls_score_atts"] = linear("RCNN_cls_score_atts")
    return from_jax_detector_params(tree, device=device, dtype=dtype)
