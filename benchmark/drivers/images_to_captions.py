"""Driver of the images-to-captions cells: groups of raw images through the
port's serving chain as ``scripts/serve.py`` runs it in batch mode: each
image through ``data/detection.py::prepare_image`` onto the group's canvas
(the fill of ``run_group``), then ``serving.make_serve_fn``'s stages
``detect``, ``constrain`` and ``caption``, one group after another.

A unit is one group: its images, sentiment signs, Gumbel draws and z-noise
made on the card from the seed (``generate_images.images_groups``), the
images prepared onto the canvas, the detector, the constraints and the CBS
decode, and the best captions with their log-probs copied to the host,
where a user gets them. What the check needs of a group stays on the
card (the detections, their features and scores, the proposals, the
picks: ~16 MB a group of 32), since a copy to the host would add its time
to the window.

The check draws groups from the seed among those the window finished and
holds the program against the plain references (``reference/detector.py``,
``reference/captioner.py``) in f32: the reference prepares its own
canvases and runs on them; the program's continuous outputs are compared
on the program's own discrete choices (its proposals and the detections it
kept), and the proposals themselves by what ties cannot break (greedy
NMS's invariant, their count, and the reference's score of each).
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, flops_detector, generate, generate_images
from benchmark.drivers.cbs_decode import program_config, program_params, sample_units
from benchmark.reference import captioner as cref
from benchmark.reference import detector as dref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the control: the plain reference one precision below the cell's
CONTROL = {"bfloat16": "fp8"}
# images a block of the reference's backbone; of its dense search (the
# control's), whose (rows, S, K, S, V) candidates take ~1 GB in f32 at 40 rows
BACKBONE_BLOCK = 8
SEARCH_BLOCK = 2
# proposals and detections match at this IoU or above
MATCH_IOU = 0.95
# a kept proposal came from the anchor whose box, as its own side decodes
# every anchor, lies nearest to it; anchors within this many pixels more
# tie, and the best of them counts (the reference's boxes cannot tell:
# bf16 moves a box's sides by up to a fifth of its size from the
# reference's box of the same anchor, past its neighbours a stride away)
MATCH_SLACK = 0.5
# a proposal misses when the reference scores it below its
# rpn_pre_nms_top_n-th best score by more than this: bf16 rounds every
# score above 1 - 2^-9 to 1, so its ranks tie over that much
RANK_MARGIN = 0.01
# a pair of kept proposals overlaps past the RPN's NMS threshold by more
# than the rounding of an IoU computed in another order
OVERLAP_SLACK = 1e-5
KEPT = ("features", "scores", "class_ids", "valid", "att_scores", "boxes", "roi_index",
        "rois", "roi_valid")


def program_detector(w: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """The benchmark's flat detector weights as the port's parameter tree:
    the same values, convolutions in channels_last memory."""
    def conv(name):
        return w[name].contiguous(memory_format=torch.channels_last)

    def bn(name):
        return {k: w[f"{name}.{k}"] for k in ("scale", "offset", "mean", "var")}

    resnet = {"conv1": conv("conv1.w"), "bn1": bn("bn1")}
    for name, *_ in dref.block_names(cfg["depth"]):
        layer = name.split(".")[0]
        p = {"conv1": conv(f"{name}.conv1.w"), "bn1": bn(f"{name}.bn1"),
             "conv2": conv(f"{name}.conv2.w"), "bn2": bn(f"{name}.bn2"),
             "conv3": conv(f"{name}.conv3.w"), "bn3": bn(f"{name}.bn3")}
        if f"{name}.downsample.w" in w:
            p["downsample"] = {"conv": conv(f"{name}.downsample.w"),
                               "bn": bn(f"{name}.downsample.bn")}
        resnet.setdefault(layer, []).append(p)
    out = {"resnet": resnet,
           "rpn": {k: {"w": conv(f"rpn.{k}.w"), "b": w[f"rpn.{k}.b"]}
                   for k in ("conv", "cls", "bbox")}}
    for k in ("cls_score", "bbox_pred", "cls_score_atts"):
        out[k] = {"w": w[f"{k}.w"], "b": w[f"{k}.b"]}
    return out


def detector_config(cfg: dict):
    from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig

    return DetectorConfig(num_classes=cfg["num_classes"], num_att_classes=cfg["num_att_classes"],
                          depth=cfg["depth"], pooling_size=cfg["pooling_size"],
                          feat_stride=cfg["feat_stride"],
                          anchor_scales=tuple(cfg["anchor_scales"]),
                          anchor_ratios=tuple(cfg["anchor_ratios"]))


class Driver:
    unit_items = "captions"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from style_seqcvae_tpu_torch.data.detection import prepare_image
        from style_seqcvae_tpu_torch.decoding.device_fsm import AttributeWordformTable
        from style_seqcvae_tpu_torch.ops.kernels import nms, roi_align, vocab_topk_lse
        from style_seqcvae_tpu_torch.serving import make_serve_fn

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = traffic["dtype"]
        self._prepare = prepare_image
        self._kernels = roi_align, nms, vocab_topk_lse
        dt = DTYPES[self.dtype]
        self.det_params = program_detector(dref.make_weights(
            cfg, generate.sub_seed(seed, generate_images.DETECTOR_WEIGHTS), device, dt), cfg)
        self.cap_params = program_params(cref.make_weights(
            cfg, generate.sub_seed(seed, generate.WEIGHTS), device, dt))
        self.table = generate_images.wordform_table(cfg, seed)
        self.serve = make_serve_fn(
            detector_config(cfg), program_config(cfg), AttributeWordformTable(**self.table),
            n_z=traffic["n_z"], beam_size=cfg["beam_size"], max_boxes=cfg["max_boxes"],
            det_thresh=cfg["score_thresh"], det_nms_thresh=cfg["nms_thresh"],
            att_thresh=cfg["att_thresh"], max_constraints=cfg["max_constraints"],
            per_z_fsm=True, rpn_pre_nms_top_n=cfg["rpn_pre_nms_top_n"],
            rpn_post_nms_top_n=cfg["rpn_post_nms_top_n"], rpn_nms_thresh=cfg["rpn_nms_thresh"],
            bbox_normalize_stds=tuple(dref.BOX_STDS), dtype=dt, device=device)
        self.records: Dict[int, dict] = {}
        self.units = 0
        self._c0, self._d0, self._a0 = 0, Counter(), 0

    def _canvases(self, images: torch.Tensor):
        """The group's canvases and im_info as serve.py makes them: each
        image through ``prepare_image``, then onto a zero canvas at the top
        left with its (height, width, scale) row (``run_group``)."""
        c = self.cfg
        H, W = self.traffic["canvas_hw"]
        canvas = torch.zeros((images.shape[0], H, W, 3), device=self.device)
        info = []
        for i, img in enumerate(images):
            prepped, scale = self._prepare(img, c["image_target_size"], c["image_max_size"])
            h, w = prepped.shape[:2]
            canvas[i, :h, :w] = prepped
            info.append((float(h), float(w), scale))
        return canvas, torch.tensor(info, device=self.device)

    def _serve(self, index: int) -> dict:
        x = generate_images.images_groups(self.traffic, self.cfg, self.seed, index, self.device)
        canvas, im_info = self._canvases(x["images"])
        sel = self.serve.detect(self.det_params, canvas, im_info)
        att_ids, num_given, tables = self.serve.constrain(sel, x["gumbel"])
        # the decode cells' span around the decode, which their readers count in
        with torch.profiler.record_function("bench.decode"):
            best, lp = self.serve.caption(self.cap_params, sel, x["sentiment"], tables,
                                          num_given, x["noise"])
        rec = {"best": best.cpu(), "lp": lp.cpu().float()}
        rec.update({k: sel[k] for k in KEPT}, att_ids=att_ids)
        return rec

    def warm(self) -> None:
        """The cell's own shapes, once, on inputs the window never sees
        (and whose record is not kept)."""
        self._serve(-1)

    def start(self) -> None:
        self._c0 = self._kernels[0].launches
        self._d0 = Counter(self._kernels[1].launches_by_shape)
        self._a0 = self._kernels[2].launches
        self.units = 0

    def unit(self, index: int) -> int:
        self.records[index] = self._serve(index)
        self.units += 1
        return self.traffic["images_per_group"] * self.traffic["n_z"]

    def counters(self) -> dict:
        """What the per-layer readers take besides the trace: the groups and
        decode steps in the window, their operations in the cell's dtype
        (the whole chain's, and the decode's as the decode cells count
        them), and the launches of kernels C, D and A with one call's
        operations and bytes (D's by call shape)."""
        t, c = self.traffic, self.cfg
        B, (H, W) = t["images_per_group"], t["canvas_hw"]
        fh, fw = c4_size(c, H, W)
        R = B * c["rpn_post_nms_top_n"]
        roi_align, nms, topk = self._kernels
        E_exc = c["max_constraints"] * c["wordforms_per_attribute"]
        rows = B * t["n_z"] * 2 ** c["max_constraints"] * c["beam_size"]
        d = Counter(nms.launches_by_shape)
        d.subtract(self._d0)
        calls = []
        for (G, N), n in d.items():
            if n > 0:
                out = c["rpn_post_nms_top_n"] if N == c["rpn_pre_nms_top_n"] else N
                calls.append({"launches": n, **flops_detector.nms_call(G, N, out)})
        return {"groups": self.units,
                "decode_steps": self.units * c["max_caption_length"],
                "pipeline_ops": {self.dtype: flops_detector.pipeline_flops(c, t) * self.units},
                "model_ops": {self.dtype: flops_detector.decode_flops(c, t) * self.units},
                "kernel_calls": {
                    "vocab_topk_lse": {"launches": topk.launches - self._a0,
                                       **flops.topk_lse_call(rows, c["vocab_size"],
                                                             c["embedding_size"],
                                                             c["per_node_beam_size"] + E_exc,
                                                             self.dtype),
                                       "dtype": self.dtype},
                    "roi_align": {"launches": roi_align.launches - self._c0,
                                  **flops_detector.roi_align_call(
                                      B, fh, fw, 1024, R, c["pooling_size"], 2, self.dtype)},
                    "nms": calls}}

    def release(self) -> None:
        # the detector's weights stay: the check decodes the program's
        # anchors with them (:meth:`program_anchor_boxes`)
        del self.cap_params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, done: int) -> Dict[str, float]:
        """The numbers the traffic's ``limits`` hold the program to, on a
        sample of the finished groups drawn from the seed."""
        got = self.readings(done, ["program"], list(self.traffic["limits"]))["program"]
        return {k: got[k] for k in self.traffic["limits"]}

    def readings(self, done: int, sides: List[str], measures: List[str]
                 ) -> Dict[str, Dict[str, float]]:
        """For each side (``"program"``: the window's groups; a precision
        name: the plain reference at that precision, run whole in the
        program's place), over the sampled groups, every number below,
        whichever ``measures`` are asked for:

        * ``canvas_gap``: the widest |side − reference| of the canvases
          and their im_info rows (the program's prepared again by the same
          code on the same images; the reference's by :func:`dref.prepare`);
        * ``feat_gap``: the widest |side − reference| of the kept
          detections' 2,048-d features, over the reference's largest
          |feature| of those detections in the image (the reference on its
          own canvas, its head on the side's own proposals);
        * ``score_gap``: the widest gap of a kept detection's class
          probability or of any of its attribute scores;
        * ``proposal_overlap``: the share of pairs of an image's kept
          proposals whose IoU passes the RPN's NMS threshold (by more than
          ``OVERLAP_SLACK``), which greedy NMS never keeps;
        * ``proposal_short``: the share of images with fewer kept proposals
          than the reference's own NMS keeps, up to ``rpn_post_nms_top_n``;
        * ``proposal_rank_miss``: the share of kept proposals inside the
          image whose anchor, by the side's own decoding of every anchor,
          the reference scores below its ``rpn_pre_nms_top_n``-th best by
          more than ``RANK_MARGIN`` (:func:`rank_misses`);
        * ``proposal_miss``: the share of the reference's own proposals
          that no proposal of the side's matches at IoU >= ``MATCH_IOU``;
        * ``detection_miss``: the share of the reference's own detections,
          made on the side's proposals, that no detection of the side's of
          the same class matches at IoU >= ``MATCH_IOU``;
        * ``constraint_mismatch``: the share of (z-sample, image) whose
          picks differ from the reference's pick on the side's own
          detections and attribute scores, with the same Gumbel draw;
        * ``lp_gap``: the widest gap between the side's log-prob of its
          best caption and the reference's (f32) by teacher forcing on the
          side's own features."""
        t, cfg, dev = self.traffic, self.cfg, self.device
        picks = sample_units(self.seed, done, t["check_units"])
        w_det, w_cap = self.reference_weights()
        keys = ("canvas", "feat", "score", "overlap", "short", "rank", "prop", "det", "cons",
                "lp")
        parts = {s: {k: [] for k in keys} for s in sides}
        with torch.inference_mode(), dref.exact_f32():
            for i in picks:
                x = generate_images.images_groups(t, cfg, self.seed, i, dev)
                ref = self.reference_group(w_det, x)
                for side in sides:
                    rec = self.program_record(i, x) if side == "program" else \
                        self.control_record(w_det, w_cap, x, side)
                    for k, v in self.compare(w_det, w_cap, ref, x, rec).items():
                        parts[side][k].append(v)
        out = {}
        for s, p in parts.items():
            share = {k: np.sum(p[k], axis=0) for k in ("overlap", "short", "rank", "prop",
                                                        "det", "cons")}
            share = {k: float(v[0] / max(v[1], 1)) for k, v in share.items()}
            out[s] = {"canvas_gap": max(p["canvas"]), "feat_gap": max(p["feat"]),
                      "score_gap": max(p["score"]), "proposal_overlap": share["overlap"],
                      "proposal_short": share["short"], "proposal_rank_miss": share["rank"],
                      "proposal_miss": share["prop"], "detection_miss": share["det"],
                      "constraint_mismatch": share["cons"], "lp_gap": max(p["lp"])}
        return out

    def reference_weights(self):
        """The f32 copies of the weights the program got in its dtype:
        (detector's, captioner's), on the device."""
        cfg, dev, dt = self.cfg, self.device, DTYPES[self.dtype]
        w_det = dref.make_weights(cfg, generate.sub_seed(self.seed,
                                                         generate_images.DETECTOR_WEIGHTS),
                                  dev, dt)
        w_cap = cref.make_weights(cfg, generate.sub_seed(self.seed, generate.WEIGHTS), dev, dt)
        return ({k: v.float() for k, v in w_det.items()},
                {k: v.float() for k, v in w_cap.items()})

    def reference_group(self, w_det, x) -> Dict[str, object]:
        """The reference (f32) on a group's inputs ``x``: its own canvases
        and im_info, the C4 map, its proposals with their count, and every
        anchor's box and foreground log-odds."""
        cfg, t = self.cfg, self.traffic
        canvas, im_info = dref.prepare(x["images"], cfg["image_target_size"],
                                       cfg["image_max_size"], tuple(t["canvas_hw"]))
        c4 = torch.cat([dref.backbone(w_det, cfg, canvas[b:b + BACKBONE_BLOCK])
                        for b in range(0, canvas.shape[0], BACKBONE_BLOCK)])
        props, n_props = dref.rpn(w_det, cfg, c4, im_info)
        return {"canvas": canvas, "im_info": im_info, "c4": c4, "props": props,
                "n_props": n_props, "anchors": dref.rpn_candidates(w_det, cfg, c4, im_info)}

    def program_record(self, index: int, x) -> dict:
        """Group ``index``'s record on the device, with the canvases and
        im_info that the program's preparation makes of its images ``x``
        again, and every anchor's box as its RPN decodes them there (the
        same code on the same inputs)."""
        rec = dict(self.records[index])
        rec["canvas"], rec["im_info"] = self._canvases(x["images"])
        rec["anchor_boxes"] = self.program_anchor_boxes(rec["canvas"], rec["im_info"])
        return rec

    def program_anchor_boxes(self, canvas: torch.Tensor, im_info: torch.Tensor
                             ) -> torch.Tensor:
        """Every anchor's box (B, N, 4), decoded and clipped as the
        program's RPN does on ``canvas``: its backbone, heads and decode
        with its weights, so that each kept proposal names its anchor."""
        from style_seqcvae_tpu_torch.models.detector import faster_rcnn, rpn

        p, dcfg = self.det_params, detector_config(self.cfg)
        feat = faster_rcnn._backbone(p, dcfg, canvas.to(p["rpn"]["conv"]["w"].dtype))
        B, h, w = feat.shape[:3]
        anchors = rpn.anchors_for(h, w, dcfg.feat_stride, dcfg.anchor_scales,
                                  dcfg.anchor_ratios, feat.device)
        _, deltas = rpn.rpn_heads(p["rpn"], feat)
        N = anchors.shape[0]
        boxes = rpn.bbox_transform_inv(anchors.expand(B, N, 4), deltas.reshape(B, N, 4))
        return rpn.clip_boxes(boxes, im_info[:, 0, None, None],
                              im_info[:, 1, None, None]).float()

    def compare(self, w_det, w_cap, ref, x, rec) -> Dict[str, object]:
        """One group's gaps and counts of one side's record against the
        reference (f32): its own canvas and RPN (``ref``), its head on the
        side's own proposals and detections."""
        cfg, t = self.cfg, self.traffic
        c4, im_info = ref["c4"], ref["im_info"]
        B = c4.shape[0]
        canvas = max((rec["canvas"] - ref["canvas"]).abs().max().item(),
                     (rec["im_info"] - im_info).abs().max().item())
        feat = score = 0.0
        overlap, short, rank, prop, det = [0, 0], [0, 0], [0, 0], [0, 0], [0, 0]
        post, pre = cfg["rpn_post_nms_top_n"], cfg["rpn_pre_nms_top_n"]
        for b in range(B):
            rois = rec["rois"][b, :, 1:5].float()
            live = rec["roi_valid"][b]
            mine = rois[live]
            head = dref.roi_head(w_det, cfg, c4, b, rois)
            kept = rec["valid"][b]
            roi, cls = rec["roi_index"][b][kept], rec["class_ids"][b][kept]
            if kept.any():
                want = head["features"][roi]
                got = rec["features"][b][kept].float()
                feat = max(feat, ((got - want).abs().max() / want.abs().max()).item())
                gap_p = (rec["scores"][b][kept].float() - head["cls_prob"][roi, cls]).abs().max()
                gap_a = (rec["att_scores"][b][kept].float() - head["att_scores"][roi]).abs().max()
                score = max(score, gap_p.item(), gap_a.item())
            n = mine.shape[0]
            pair = dref.iou(mine.double(), mine.double()) > cfg["rpn_nms_thresh"] + OVERLAP_SLACK
            overlap[0] += int(pair.triu(1).sum())
            overlap[1] += n * (n - 1) // 2
            short[0] += int(n < min(post, int(ref["n_props"][b])))
            short[1] += 1
            inside = inner(mine, im_info[b])
            rank[0] += rank_misses(mine[inside], rec["anchor_boxes"][b],
                                   ref["anchors"]["scores"][b], pre)
            rank[1] += int(inside.sum())
            ref_props = ref["props"][b, :int(ref["n_props"][b])]
            prop[0] += missed(ref_props, mine, None, None)
            prop[1] += ref_props.shape[0]
            sel = dref.select_detections(cfg, head["cls_prob"],
                                         dref.decode(cfg, rois, head["bbox_pred"], im_info[b]))
            det[0] += missed(sel["box"], rec["boxes"][b][kept].float(), sel["class"], cls)
            det[1] += sel["box"].shape[0]
        host = {k: rec[k].cpu().numpy() for k in ("class_ids", "valid", "att_scores",
                                                  "att_ids")}
        gumbel = x["gumbel"].cpu().numpy()
        differ = 0
        for b in range(B):
            want = dref.pick_constraints(host["class_ids"][b], host["valid"][b],
                                         host["att_scores"][b].astype(np.float32),
                                         self.table["selectable"], gumbel[:, b],
                                         cfg["att_thresh"], cfg["max_constraints"])
            differ += int((want != host["att_ids"][:, b]).any(axis=1).sum())
        feats = rec["features"].float()
        caps = rec["best"].to(c4.device).transpose(0, 1)                 # (B, n_z, T)
        forced = torch.cat([cref.score_captions(
            w_cap, cfg, feats[b:b + 4], x["sentiment"][b:b + 4], caps[b:b + 4],
            x["noise"][:, :, b:b + 4, 0, 0]) for b in range(0, B, 4)]).transpose(0, 1).cpu()
        return {"canvas": canvas, "feat": feat, "score": score, "overlap": overlap,
                "short": short, "rank": rank, "prop": prop, "det": det,
                "cons": [differ, B * t["n_z"]],
                "lp": (rec["lp"].cpu() - forced).abs().max().item()}

    def control_record(self, w_det, w_cap, x, precision: str) -> dict:
        """The plain reference at ``precision``, run whole in the program's
        place, as a record of the program's form: its canvases, backbone,
        RPN and proposals, its head on them, its detections (the first row
        all ones where none survives), its picks with the group's Gumbel
        draw, and its own dense CBS decode at that precision on its
        features."""
        cfg, t, dev = self.cfg, self.traffic, x["images"].device
        canvas, im_info = dref.prepare(x["images"], cfg["image_target_size"],
                                       cfg["image_max_size"], tuple(t["canvas_hw"]), precision)
        B, M, n_z = canvas.shape[0], cfg["max_boxes"], t["n_z"]
        c4 = torch.cat([dref.backbone(w_det, cfg, canvas[b:b + BACKBONE_BLOCK], precision)
                        for b in range(0, B, BACKBONE_BLOCK)])
        props, n_props = dref.rpn(w_det, cfg, c4, im_info, precision)
        anchor_boxes = dref.rpn_candidates(w_det, cfg, c4, im_info, precision)["boxes"]
        A = cfg["num_att_classes"]
        post = cfg["rpn_post_nms_top_n"]
        rec = {"canvas": canvas, "im_info": im_info, "anchor_boxes": anchor_boxes,
               "features": torch.zeros((B, M, 2048), device=dev),
               "scores": torch.zeros((B, M), device=dev),
               "class_ids": torch.zeros((B, M), dtype=torch.long, device=dev),
               "valid": torch.zeros((B, M), dtype=torch.bool, device=dev),
               "att_scores": torch.zeros((B, M, A), device=dev),
               "boxes": torch.zeros((B, M, 4), device=dev),
               "roi_index": torch.zeros((B, M), dtype=torch.long, device=dev),
               "rois": torch.cat([torch.zeros_like(props[..., :1]), props], dim=-1),
               "roi_valid": torch.arange(post, device=dev)[None] < n_props[:, None]}
        for b in range(B):
            head = dref.roi_head(w_det, cfg, c4, b, props[b], precision)
            sel = dref.select_detections(cfg, head["cls_prob"],
                                         dref.decode(cfg, props[b], head["bbox_pred"],
                                                     im_info[b]))
            n = sel["roi"].shape[0]
            rec["features"][b, :n] = head["features"][sel["roi"]]
            rec["scores"][b, :n] = sel["score"]
            rec["class_ids"][b, :n] = sel["class"]
            rec["valid"][b, :n] = True
            rec["att_scores"][b, :n] = head["att_scores"][sel["roi"]]
            rec["boxes"][b, :n] = sel["box"]
            rec["roi_index"][b, :n] = sel["roi"]
            if n == 0:
                rec["features"][b, 0] = 1.0
        host = {k: rec[k].cpu().numpy() for k in ("class_ids", "valid", "att_scores")}
        gumbel = x["gumbel"].cpu().numpy()
        att_ids = np.stack([dref.pick_constraints(
            host["class_ids"][b], host["valid"][b], host["att_scores"][b],
            self.table["selectable"], gumbel[:, b], cfg["att_thresh"], cfg["max_constraints"])
            for b in range(B)], axis=1)                                 # (n_z, B, k)
        rec["att_ids"] = torch.from_numpy(att_ids)
        given = torch.from_numpy((att_ids[0] >= 0).sum(-1)).to(dev)     # (B,)
        tokens = torch.from_numpy(self.table["tokens"]).long()
        valid = torch.from_numpy(self.table["valid"])
        S = 2 ** cfg["max_constraints"]
        best, lp = [], []
        for b0 in range(0, B, SEARCH_BLOCK):
            bs = slice(b0, b0 + SEARCH_BLOCK)
            nb = rec["features"][bs].shape[0]
            # every (image, z) a row of its own, with its own FSM
            rows = torch.from_numpy(att_ids[:, bs].transpose(1, 0, 2).reshape(nb * n_z, -1))
            fsm = dref.dense_fsm(rows, tokens, valid, S, cfg["vocab_size"]).to(dev)
            feats = rec["features"][bs].repeat_interleave(n_z, dim=0)
            sent = x["sentiment"][bs].repeat_interleave(n_z, dim=0)
            noise = x["noise"][:, :, bs].permute(2, 0, 1, 3, 4, 5).reshape(
                nb * n_z, cfg["max_caption_length"], 1, 1, cfg["z_space"])
            seqs, seq_lp = cref.constrained_beam_search(
                w_cap, cfg, feats, sent, fsm, noise.transpose(0, 1)[None], precision)
            bb, bl = dref.best_beam(seqs[:, 0], seq_lp[:, 0],
                                    given[bs].repeat_interleave(n_z),
                                    cfg["min_constraints_to_satisfy"])
            best.append(bb.reshape(nb, n_z, -1).transpose(0, 1).cpu())
            lp.append(bl.reshape(nb, n_z).transpose(0, 1).cpu())
        rec["best"], rec["lp"] = torch.cat(best, dim=1), torch.cat(lp, dim=1)
        return rec


def c4_size(cfg: dict, height: int, width: int):
    """The C4 map's size on a (height, width) canvas."""
    _, h, w = flops_detector.backbone_flops(cfg["depth"], height, width)
    return h, w


def inner(boxes: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Which of ``boxes`` (n, 4) lie inside the image of im_info row
    ``info`` on all four sides: a side that clipping moved to the image's
    edge keeps no trace of the anchor it came from, and many anchors clip
    to nearly one box there."""
    h, w = info[0] - 1.0, info[1] - 1.0
    return ((boxes[:, 0] > 0) & (boxes[:, 1] > 0) & (boxes[:, 2] < w) & (boxes[:, 3] < h))


def rank_misses(mine: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor, top: int
                ) -> int:
    """How many proposals of ``mine`` (n, 4) score below the ``top``-th
    best of ``scores`` (N,) by more than ``RANK_MARGIN``, each taking the
    score of the anchor whose box in ``boxes`` (N, 4), the side's own
    decoding of every anchor, lies nearest to it in its farthest
    coordinate (the best of those within ``MATCH_SLACK`` of the nearest)."""
    if mine.shape[0] == 0:
        return 0
    cut = torch.topk(scores, min(top, scores.shape[0])).values[-1]
    dist = (mine[:, None, :] - boxes[None, :, :]).abs().amax(dim=-1)       # (n, N)
    near = dist <= dist.amin(dim=1, keepdim=True) + MATCH_SLACK
    best = torch.where(near, scores[None], -1.0).amax(dim=1)
    return int((best < cut - RANK_MARGIN).sum())


def missed(want_boxes: torch.Tensor, got_boxes: torch.Tensor, want_cls, got_cls) -> int:
    """How many of ``want_boxes`` (n, 4) no box of ``got_boxes`` (m, 4)
    matches at IoU >= ``MATCH_IOU`` (of the same class where classes are
    given)."""
    if want_boxes.shape[0] == 0:
        return 0
    if got_boxes.shape[0] == 0:
        return int(want_boxes.shape[0])
    ov = dref.iou(want_boxes, got_boxes) >= MATCH_IOU
    if want_cls is not None:
        ov &= want_cls[:, None] == got_cls[None, :]
    return int((~ov.any(dim=1)).sum())
