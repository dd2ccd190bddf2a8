"""The traffic generator: every input of a unit of work, drawn from the
run's seed and the unit's index, so that the same seed gives the same
inputs and the check can draw a unit's inputs again after the window.
A traffic mix is a JSON file of parameters under ``benchmark/traffic/``
that a driver hands to its generator here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of run ``seed``, for
    ``torch.Generator.manual_seed`` and numpy alike."""
    words = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


# streams of sub_seed: the weights, then one per unit (index >= 0; the
# warm-up units count down from -1)
WEIGHTS, UNIT = 0, 1


def unit_path(index: int):
    return (UNIT, index) if index >= 0 else (UNIT + 1, -index)


def cbs_groups(traffic: dict, cfg: dict, seed: int, index: int, device) -> Dict[str, object]:
    """One group of images for constrained captioning: seeded box
    features, a sentiment sign per image, ``constraints`` single-word
    constraints of ``wordforms`` distinct tokens each, and the z-noise.

    Returns feats (B, N, F) f32 and sentiment (B, 1) f32 on ``device``,
    wordforms (B, C, W) int64 on the host, the exception-form FSM tables
    (n_z, B, S[, E]) as numpy (default_dest, exc_token, exc_dest,
    exc_valid), the constraint counts (B,), and the z-noise (n_z, T, B, 1,
    1, z) f32 on ``device``: one draw a z-sample, image and step, which
    every beam of that z-sample takes at that step, so that a caption's
    noise does not depend on the beams it passed through."""
    B, N, F = traffic["images_per_group"], traffic["boxes"], cfg["image_feature_size"]
    C, W, n_z = traffic["constraints_per_image"], traffic["wordforms"], traffic["n_z"]
    S, T, V = 2 ** C, cfg["max_caption_length"], cfg["vocab_size"]
    s = sub_seed(seed, *unit_path(index))
    rng = np.random.default_rng(s)
    gen = torch.Generator(device=device).manual_seed(s)
    feats = torch.randn((B, N, F), generator=gen, device=device)
    noise = torch.randn((n_z, T, B, 1, 1, cfg["z_space"]), generator=gen, device=device)
    sentiment = torch.from_numpy(rng.choice([-1.0, 1.0], (B, 1)).astype(np.float32)).to(device)
    # wordforms: distinct tokens, never the padding or boundary index
    low = max(cfg["pad_index"], cfg["boundary_index"]) + 1
    words = np.stack([rng.choice(V - low, C * W, replace=False) + low
                      for _ in range(B)]).reshape(B, C, W).astype(np.int64)
    return {"feats": feats, "sentiment": sentiment, "wordforms": words,
            "tables": exception_tables(words, S, n_z),
            "num_constraints": np.full((B,), C, np.int64), "noise": noise}


def exception_tables(words: np.ndarray, states: int, n_z: int):
    """The FSM of :func:`cbs_groups` in exception form, the same for each
    z: every state keeps itself by default; state s's exceptions are the
    wordforms of each constraint whose bit is clear, each to s with that
    bit set. (n_z, B, S) default destinations and (n_z, B, S, C·W)
    exception tokens, destinations and validity."""
    B, C, W = words.shape
    E = C * W
    tok = np.zeros((B, states, E), np.int32)
    dest = np.zeros((B, states, E), np.int32)
    valid = np.zeros((B, states, E), bool)
    for s in range(states):
        j = 0
        for c in range(C):
            if s >> c & 1 or (s | 1 << c) >= states:
                continue
            tok[:, s, j:j + W] = words[:, c]
            dest[:, s, j:j + W] = s | 1 << c
            valid[:, s, j:j + W] = True
            j += W
    default = np.broadcast_to(np.arange(states, dtype=np.int32), (B, states))
    return tuple(np.ascontiguousarray(np.broadcast_to(x, (n_z,) + x.shape))
                 for x in (default, tok, dest, valid))

