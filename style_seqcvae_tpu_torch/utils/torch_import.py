"""Reference PyTorch checkpoints into the port's captioner params
(counterpart of ``style_seqcvae_tpu/utils/torch_import.py:35-86``).

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

from typing import Any, Dict, Mapping

import numpy as np
import torch

from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams


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
