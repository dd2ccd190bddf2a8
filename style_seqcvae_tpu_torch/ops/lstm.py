"""Fused LSTM cell (counterpart of ``style_seqcvae_tpu/ops/lstm.py``).

The input and hidden weights are one ``(input_size + hidden, 4*hidden)``
matrix with gates in (i, f, g, o) order and the bias pre-summed
(``b_ih + b_hh``), so each step is one matmul. Under tensor parallelism ``w`` is this rank's
block of gate columns (JAX's ``P(None, "model")``) and the bias stays
whole.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from style_seqcvae_tpu_torch.parallel.tensor_parallel import sharded_matmul


class LSTMCellParams(NamedTuple):
    w: torch.Tensor  # (input_size + hidden_size, 4 * hidden_size), or a column block
    b: torch.Tensor  # (4 * hidden_size,)

    @property
    def hidden_size(self) -> int:
        return self.b.shape[0] // 4

    @property
    def input_size(self) -> int:
        return self.w.shape[0] - self.hidden_size


def init_lstm_cell(input_size: int, hidden_size: int, *, generator: torch.Generator,
                   device: torch.device, dtype=torch.float32) -> LSTMCellParams:
    """PyTorch-style U(-1/sqrt(H), 1/sqrt(H)); the bias is the sum of two draws."""
    bound = 1.0 / hidden_size ** 0.5

    def uni(*shape):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return (2.0 * u - 1.0) * bound

    w = uni(input_size + hidden_size, 4 * hidden_size)
    b = uni(2, 4 * hidden_size).sum(0)
    return LSTMCellParams(w=w.to(dtype), b=b.to(dtype))


def gate_math(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, f, g, o) gate nonlinearities and the cell update."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_cell(params: LSTMCellParams, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, model_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x: (..., input_size); h, c: (..., hidden_size). A
    ``w`` that is this rank's block of gate columns multiplies the input
    (its gradient summed over ``model_group``) and the block's gates are
    all-gathered to the whole 4H before the bias and the gate math.

    As JAX's ``lstm_cell`` (``ops/lstm.py:47-66``), the input, the hidden
    state and the weight meet in their promoted dtype (an f32 input, as the
    training step's decoder input under bf16 compute, multiplies the bf16
    weight in f32) and the gates are cast to ``h``'s dtype before the bias."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, h.dtype), params.w.dtype)
    xh = torch.cat([x.to(dtype), h.to(dtype)], dim=-1)
    # one matmul (f32 accumulation inside), gate math in the working dtype
    gates = sharded_matmul(xh, params.w.to(dtype), params.b.shape[0],
                           model_group).to(h.dtype) + params.b
    return gate_math(gates, h, c)
