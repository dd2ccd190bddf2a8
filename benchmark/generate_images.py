"""The images-to-captions traffic: every input of a group drawn from the
run's seed and the group's index (``generate.sub_seed``, ``unit_path``), so
that the check can draw a group's inputs again after the window, and the
attribute → wordform table that the constraints are spelled in, drawn once
a run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.generate import sub_seed, unit_path

# streams of sub_seed beside generate.WEIGHTS (the captioner's) and the units
DETECTOR_WEIGHTS, TABLE = 3, 4


def images_groups(traffic: dict, cfg: dict, seed: int, index: int, device
                  ) -> Dict[str, torch.Tensor]:
    """One group on ``device``: ``images_per_group`` uint8 BGR images (B,
    h, w, 3) of ``image_hw``, each a coarse grid of uniform colours (a cell
    every ``image_cell`` pixels) resized bilinearly with pixel noise of std
    ``pixel_noise`` on top; a sentiment sign per image (B, 1); the Gumbel
    noise of the attribute picks (n_z, B, max_constraints, A), one draw a
    z-sample, image, slot and attribute; and the z-noise (n_z, T, B, 1, 1,
    z), which every beam of a z-sample takes at a step."""
    B, n_z = traffic["images_per_group"], traffic["n_z"]
    h, w = traffic["image_hw"]
    cell = traffic["image_cell"]
    s = sub_seed(seed, *unit_path(index))
    gen = torch.Generator(device=device).manual_seed(s)
    coarse = torch.rand((B, 3, -(-h // cell) + 1, -(-w // cell) + 1), generator=gen,
                        device=device) * 255.0
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    noisy = smooth + torch.randn((B, 3, h, w), generator=gen, device=device) \
        * traffic["pixel_noise"]
    images = noisy.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    sentiment = torch.randint(0, 2, (B, 1), generator=gen, device=device).float() * 2.0 - 1.0
    u = torch.rand((n_z, B, cfg["max_constraints"], cfg["num_att_classes"]), generator=gen,
                   device=device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    noise = torch.randn((n_z, cfg["max_caption_length"], B, 1, 1, cfg["z_space"]),
                        generator=gen, device=device)
    return {"images": images, "sentiment": sentiment, "gumbel": gumbel, "noise": noise}


def wordform_table(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The attribute → wordform table of a run (``AttributeWordformTable``'s
    fields, numpy): each of the A attributes spelled by one or two
    vocabulary tokens, distinct over the table, never the padding or the
    boundary index; every attribute selectable and its own canonical id."""
    A, W, V = cfg["num_att_classes"], cfg["wordforms_per_attribute"], cfg["vocab_size"]
    rng = np.random.default_rng(sub_seed(seed, TABLE))
    low = max(cfg["pad_index"], cfg["boundary_index"]) + 1
    tokens = (rng.choice(V - low, A * W, replace=False) + low).reshape(A, W).astype(np.int32)
    count = rng.integers(1, W + 1, A)
    valid = np.arange(W)[None, :] < count[:, None]
    return {"tokens": np.where(valid, tokens, 0).astype(np.int32), "valid": valid,
            "selectable": np.ones((A,), bool), "canonical": np.arange(A, dtype=np.int32)}
