"""Serving: raw images → N diverse constrained captions on the card
(counterpart of ``style_seqcvae_tpu/serving.py``).

A request runs

    detector forward (kernels C and D) → box decode + per-class NMS + global
    cap → per-z random attribute constraints → exception-form FSM tables →
    (z × batch × states × beam) CBS decode (kernel A) → best-beam pick

with no host round trip between the stages: the detector's selection, the
constraint choice (``decoding/device_fsm.py``) and the tables stay on the
card, and the constraint counts reach the beam pick as a device tensor.
JAX compiles the chain into one XLA program and decodes through its raw
route; the port runs it eagerly and decodes through ``DecodeHarness``'s
``"prehead"`` selection (kernel A), which is token-identical in f32, or
through the raw route where the output head is not tied to the embedding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.data.latents import AttributeEmbedTable
from style_seqcvae_tpu_torch.decoding.cbs_fast import FSMTables
from style_seqcvae_tpu_torch.decoding.device_fsm import (
    AttributeWordformTable,
    select_attribute_constraints,
    table_to_device,
    tables_for_samples,
)
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.device import as_tensor, resolve_device
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig
from style_seqcvae_tpu_torch.models.detector.defaults import InferenceConfig
from style_seqcvae_tpu_torch.models.detector.extract import extract_device_features
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig


def attribute_embeds_device(att_scores: torch.Tensor, valid: torch.Tensor,
                            embed_table: AttributeEmbedTable, att_thresh: float) -> torch.Tensor:
    """The mode-2 prior's per-box attribute embeddings on the device (the
    mirror of ``LatentDictionary.translate_obj_atts``): att_scores (..., M,
    A) sigmoid scores, valid (..., M) → (..., M, z) float32, each box the
    mean of the table rows of its attributes scoring above ``att_thresh``
    that have a dictionary entry, zero when none."""
    dev = att_scores.device
    table = torch.as_tensor(np.asarray(embed_table.table, np.float32), device=dev)
    has = torch.as_tensor(np.asarray(embed_table.has, bool), device=dev)
    m = (att_scores > att_thresh) & has & valid[..., None]
    cnt = m.sum(dim=-1, keepdim=True)
    total = torch.matmul(m.float(), table)
    return total / cnt.clamp(min=1).float()


def make_serve_fn(det_cfg: DetectorConfig, cap_cfg: CaptionerConfig,
                  wordform_table: AttributeWordformTable, *,
                  n_z: int = 20,
                  beam_size: int = 5,
                  max_boxes: int = 100,
                  det_thresh: float = 0.05,
                  det_nms_thresh: float = 0.3,
                  att_thresh: float = 0.3,
                  max_constraints: int = 3,
                  per_z_fsm: bool = True,
                  rpn_pre_nms_top_n: int = 6000,
                  rpn_post_nms_top_n: int = 300,
                  rpn_nms_thresh: float = 0.7,
                  bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
                  bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                  att_embed_table: Optional[AttributeEmbedTable] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[Union[str, torch.device]] = None):
    """Build the serving function for ``device`` (the GPU unless ``"cpu"``).

    Returns ``serve(det_params, cap_params, images (B, H, W, 3),
    im_info (B, 3), sentiment (B, 1), *, generator=None, gumbel=None,
    noise=None) -> (captions (Z, B, T), log_probs (Z, B), num_constraints
    (B,))``, tensors on the device. Its three stages are its attributes
    ``serve.detect``, ``serve.constrain`` and ``serve.caption``. ``dtype`` is the features' type; the
    decode runs in ``cap_params``' own. The draws come from ``generator``
    (on the device) unless given: ``gumbel`` the attribute picks' noise
    (n_fsm, B, max_constraints, A), n_fsm = n_z with ``per_z_fsm`` (each z
    re-rolls the pick) else 1; ``noise`` the decode's z-noise (n_z, T, B,
    2**max_constraints, beam_size, z)."""
    dev = resolve_device(device)
    if cap_cfg.sentiment_vae == 2 and att_embed_table is None:
        raise ValueError(
            "cap_cfg.sentiment_vae == 2 (latent-dictionary attribute prior) needs "
            "att_embed_table (LatentDictionary.embed_table of the attribute-head names): "
            "without it the decode would run with a zero-mean prior")
    cfg = cap_cfg._replace(beam_size=beam_size)
    table = table_to_device(wordform_table, dev)
    test = InferenceConfig(rpn_pre_nms_top_n=rpn_pre_nms_top_n,
                           rpn_post_nms_top_n=rpn_post_nms_top_n,
                           rpn_nms_thresh=rpn_nms_thresh, nms_thresh=det_nms_thresh,
                           score_thresh=det_thresh, max_per_image=max_boxes,
                           bbox_normalize_means=tuple(bbox_normalize_means),
                           bbox_normalize_stds=tuple(bbox_normalize_stds))
    n_fsm = n_z if per_z_fsm else 1
    # kernel A needs the tied head; an untied one decodes through JAX's raw route
    selection = "prehead" if cfg.tie_embeddings else "raw"

    @torch.inference_mode()
    def detect(det_params: Dict[str, Any], images, im_info) -> Dict[str, torch.Tensor]:
        """The detector forward and the device selection (kernels C, D)."""
        sel = extract_device_features(det_params, det_cfg, images, im_info,
                                      max_boxes=max_boxes, test=test, device=dev, dtype=dtype)
        if "att_scores" not in sel:
            raise ValueError("serving needs a detector with an attribute head "
                             "(num_att_classes > 0): the constraints come from the "
                             "per-RoI attribute scores")
        return sel

    @torch.inference_mode()
    def constrain(sel: Dict[str, torch.Tensor], gumbel) -> Tuple[torch.Tensor, torch.Tensor,
                                                                 FSMTables]:
        """(att_ids (n_fsm, B, k), num_constraints (B,), tables (n_z, B, S,
        E)) from ``detect``'s selection; ``gumbel`` a noise tensor or a
        generator."""
        att_ids, num_given = select_attribute_constraints(
            sel["class_ids"], sel["valid"], sel["att_scores"], table,
            gumbel if isinstance(gumbel, torch.Generator) else as_tensor(gumbel, dev),
            n_fsm=n_fsm, att_thresh=att_thresh, max_constraints=max_constraints)
        return att_ids, num_given, tables_for_samples(att_ids, table, n_z, max_constraints)

    @torch.inference_mode()
    def caption(cap_params: Dict[str, Any], sel: Dict[str, torch.Tensor], sentiment,
                tables: FSMTables, num_given: torch.Tensor, noise
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The CBS decode of ``detect``'s features under ``constrain``'s
        tables (kernel A), then the best beam: (captions (Z, B, T),
        log-probs (Z, B))."""
        obj_att_embeds = None
        if cfg.sentiment_vae == 2:
            obj_att_embeds = attribute_embeds_device(sel["att_scores"], sel["valid"],
                                                     att_embed_table, att_thresh)
        harness = DecodeHarness(cap_params, cfg, device=dev)
        return harness.decode_cbs(sel["features"], as_tensor(sentiment, dev), obj_att_embeds,
                                  tables, num_given, noise, n_z, selection=selection)

    def serve(det_params: Dict[str, Any], cap_params: Dict[str, Any], images, im_info,
              sentiment, *, generator: Optional[torch.Generator] = None,
              gumbel=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if (gumbel is None or noise is None) and generator is None:
            raise ValueError("pass a generator, or both gumbel and noise")
        sel = detect(det_params, images, im_info)
        _, num_given, tables = constrain(sel, generator if gumbel is None else gumbel)
        best, best_lp = caption(cap_params, sel, sentiment, tables, num_given,
                                generator if noise is None else noise)
        return best, best_lp, num_given

    serve.detect, serve.constrain, serve.caption = detect, constrain, caption
    return serve
