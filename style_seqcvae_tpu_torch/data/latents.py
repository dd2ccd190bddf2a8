"""Style latent dictionaries for the mode-2 attribute prior (copy of
``style_seqcvae_tpu/data/latents.py:1-134``).

Host-side mirror of var_updown/var_updown/models/updown_captioner.py:76-93
(SentiGloVe-10 / SentiWordNet score dictionaries, tiled to ``z_space``),
:509-532 (``translate_obj_atts2obj_means``: the per-box mean attribute
embedding (B, max_obj, z_space)) and :468-507 (``batch_calc_attrib_mean``).
It runs in the input pipeline and makes the ``obj_att_embeds`` array that
the decode's per-step attention prior reads.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class AttributeEmbedTable(NamedTuple):
    """Per-attribute-class latent vectors for device-side mode-2 priors.

    ``table`` (A, z_space) f32 — latent-dictionary vector of attribute-head
    class ``a`` (first word of its raw name, matching
    ``LatentDictionary.translate_obj_atts`` / reference
    updown_captioner.py:509-532), already scaled by the dictionary
    multiplier; zero row when the word is missing. ``has`` (A,) bool — which
    rows had a dictionary entry (missing attributes are excluded from the
    per-box mean, mirroring the host path's silent KeyError skip)."""
    table: np.ndarray
    has: np.ndarray


class LatentDictionary:
    def __init__(self, mean_choice: Dict[str, np.ndarray], z_space: int,
                 multiplier: float = 1.0):
        self.mean_choice = mean_choice
        self.z_space = z_space
        self.multiplier = multiplier

    @classmethod
    def from_sentiglove(cls, sentiglove_pkl: str, z_space: int,
                        multiplier: float = 1.0) -> "LatentDictionary":
        """sentiglove10.pkl: {word: 10-d vector} → repeat to z_space
        (updown_captioner.py:79-81)."""
        with open(sentiglove_pkl, "rb") as f:
            table = pickle.load(f)
        out = {k: np.repeat(np.asarray(v, np.float32), z_space // len(np.asarray(v)))
               for k, v in table.items()}
        return cls(out, z_space, multiplier)

    @classmethod
    def from_swn_scores(cls, swn_json: str, z_space: int,
                        multiplier: float = 1.0) -> "LatentDictionary":
        """wordform_swd_scores.json: {word: [pos, obj, neg]} → scalar
        pos-neg repeated z_space times (updown_captioner.py:83-86)."""
        with open(swn_json) as f:
            scores = json.load(f)
        out = {k: np.repeat(np.float32(v[0] - v[2]), z_space)
               for k, v in scores.items()}
        return cls(out, z_space, multiplier)

    def translate_obj_atts(self, obj_atts_batch: List[List], max_boxes: int
                           ) -> np.ndarray:
        """Name-form obj_atts → (B, max_boxes, z_space) embedding tensor
        (updown_captioner.py:509-532: per object, mean over its attribute
        vectors looked up by the FIRST word of the attribute name; missing
        entries silently skipped; zero vector when none)."""
        B = len(obj_atts_batch)
        out = np.zeros((B, max_boxes, self.z_space), np.float32)
        for i, im in enumerate(obj_atts_batch):
            for o, obj in enumerate(im[:max_boxes]):
                vecs = []
                for att in obj[1]:
                    name = att if isinstance(att, str) else att[0]
                    try:
                        vecs.append(self.mean_choice[name.split(" ")[0]])
                    except KeyError:
                        pass
                if vecs:
                    out[i, o] = np.mean(vecs, axis=0)
        return out * self.multiplier

    def embed_table(self, att_id2name: List[str]) -> AttributeEmbedTable:
        """Precompute the (A, z_space) per-attribute-class vector table for
        the serving path's on-device mode-2 prior.

        Same lookup as :meth:`translate_obj_atts` (FIRST word of the raw
        attribute name, updown_captioner.py:509-532); the multiplier is
        folded into the rows so the device-side mean over found attributes
        equals ``translate_obj_atts``'s scaled output."""
        A = len(att_id2name)
        table = np.zeros((A, self.z_space), np.float32)
        has = np.zeros((A,), bool)
        for a, name in enumerate(att_id2name):
            vec = self.mean_choice.get(name.split(" ")[0])
            if vec is not None:
                table[a] = np.asarray(vec, np.float32) * self.multiplier
                has[a] = True
        return AttributeEmbedTable(table, has)

    def batch_calc_attrib_mean(self, batch_image_attribs: List[Optional[list]]
                               ) -> np.ndarray:
        """Image-level weighted attribute mean (updown_captioner.py:468-507),
        using the LAST word of each attribute name and max-merged weights.
        Faithful to the reference's weight_sum quirk (only the final
        object's last weight is accumulated, :497)."""
        B = len(batch_image_attribs)
        out = np.zeros((B, self.z_space), np.float32)
        for i, item in enumerate(batch_image_attribs):
            weight_sum = 0.0
            mean = np.zeros(self.z_space, np.float32)
            att_words: List[str] = []
            att_weights: List[float] = []
            if item:
                a_weight = 0.0
                for o in item:
                    for a in o[1]:
                        cleaned = a[0].split(" ")[-1] or a[0].split(" ")[-2]
                        if cleaned not in att_words:
                            att_words.append(cleaned)
                            att_weights.append(a[1])
                        else:
                            idx = att_words.index(cleaned)
                            att_weights[idx] = max(att_weights[idx], a[1])
                for w, a_weight in zip(att_words, att_weights):
                    if w in self.mean_choice:
                        mean += self.mean_choice[w] * a_weight
                weight_sum += a_weight if att_weights else 0.0
            if weight_sum > 0:
                mean /= weight_sum
            out[i] = mean
        return out
