"""Operations and bytes of the work a cell does, counted from the widths.

The counts are the model's and the call's, the same whatever implements
them: a product of (m, k) by (k, n) is 2·m·k·n operations; elementwise
work is not counted. Bytes count each input read once and each output
written once.
"""

from __future__ import annotations

from typing import Dict

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def cbs_decode_flops(cfg: dict, images: int, boxes: int, n_z: int, states: int,
                     exceptions: int) -> float:
    """Operations of one constrained beam-search decode of ``images`` of
    ``boxes`` boxes × ``n_z`` (beam ``cfg["beam_size"]``, ``states`` FSM states,
    ``exceptions`` exception tokens a state) with the folded step, whose
    step-constant input segments are products made once a decode:

    * once a decode: the token segment of the attention LSTM as a
      (V, E)·(E, 4H) table, and per image the mean feature's segment
      (F, 4H), the sentiment's (1, 4H) and the projected boxes (N·F·P);
    * per row and step: the attention LSTM's h1, h_dec and recurrent
      segments (3H, 4H), the query (H, P), the box scores (N·P) and the
      attended feature (N·F), the decoder LSTM over [attended, h1, h_dec, z]
      and its recurrent h (F + 3H + z, 4H), the head's projection (H, E),
      the vocabulary logits (E, V) and the exception tokens' logits
      (E, exceptions);
    * step 0 runs ``images·n_z`` rows, each later step
      ``images·n_z·states·beam``."""
    V, E, H = cfg["vocab_size"], cfg["embedding_size"], cfg["hidden_size"]
    F, P, Z = cfg["image_feature_size"], cfg["attention_projection_size"], cfg["z_space"]
    N, T, K = boxes, cfg["max_caption_length"], cfg["beam_size"]
    cond = 1 if cfg["sentiment_vae"] == 1 and not cfg["simple_vae"] else 0
    once = 2 * V * E * 4 * H + images * (2 * (F + cond) * 4 * H + 2 * N * F * P)
    row = (2 * 3 * H * 4 * H + 2 * H * P + 2 * N * P + 2 * N * F
           + 2 * (F + 3 * H + Z) * 4 * H + 2 * H * E + 2 * E * V)
    rows0 = images * n_z
    rows = images * n_z * states * K
    return float(once + rows0 * row + (T - 1) * rows * (row + 2 * E * exceptions))


def topk_lse_call(rows: int, vocab: int, width: int, k: int, dtype: str) -> Dict[str, float]:
    """Kernel A's call (``matmul_top_k_with_lse``): x (rows, width) times
    the embedding (vocab, width)ᵀ, then per row the top k and the
    logsumexp. Operations of the product; bytes of x and the embedding read
    once and of the values, indices (4 bytes each) and logsumexp written
    once."""
    n = DTYPE_BYTES[dtype]
    return {"ops": 2.0 * rows * vocab * width,
            "bytes": float(n * (rows + vocab) * width + rows * (8 * k + 4))}
