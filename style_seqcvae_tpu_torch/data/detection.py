"""Detection data: COCO records, image loading and the detector's input
canvases (counterpart of ``style_seqcvae_tpu/data/detection.py``).

* :class:`CocoDetectionDataset`: the record path of JAX ``:31-168``
  (instances JSONs, one or a union; the Senticap test exclusion; the
  COCO-Attributes lists; crowd filtering and box clipping).
* :func:`load_image_bgr` and :func:`decode_image_bgr`: image files and bytes
  to float32 BGR HWC on a device (``data/image_decode.py``).
* :func:`prepare_image`: JAX ``prepare_image_np`` (``:179-201``) on tensors,
  on the image's device, in the span ``ssc.prepare``.
* :func:`flip_record`: JAX ``:204-214``, the image flipped on its own device.
* :func:`canvas_for` and :func:`make_batch`: JAX ``:217-259``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.data.image_decode import decode_image_bgr
from style_seqcvae_tpu_torch.data.readers import CocoAttributesReader, SenticapReader
from style_seqcvae_tpu_torch.utils.tracing import PREPARE, span

PIXEL_MEANS_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


class CocoDetectionDataset:
    def __init__(self, instances_jsonpath, image_root: str = "",
                 senticap_jsonpath: str = "", attribs_dir_path: str = "",
                 exclude_senticap_test: bool = True, n_attribs: int = 0):
        """``instances_jsonpath``: one path or a list of paths, unioned as
        JAX does: images de-duplicate by id and the first JSON that holds an
        image keeps all of its annotations; category tables must agree on
        every shared id. Images in the Senticap test split are dropped when
        ``exclude_senticap_test`` and ``senticap_jsonpath`` are given; with
        ``attribs_dir_path`` each annotation id gets its COCO-Attributes
        index list."""
        paths = ([instances_jsonpath] if isinstance(instances_jsonpath, str)
                 else list(instances_jsonpath))
        cats: Dict[int, str] = {}
        images: Dict[int, dict] = {}
        annotations: Dict[Tuple[int, int], dict] = {}
        for path in paths:
            with open(path) as f:
                data = json.load(f)
            for c in data["categories"]:
                if c["id"] in cats and cats[c["id"]] != c["name"]:
                    raise ValueError(
                        f"category id {c['id']} is '{cats[c['id']]}' in one instances json "
                        f"but '{c['name']}' in {path}: the union datasets must share a "
                        "class table")
                cats[c["id"]] = c["name"]
            new_ids = set()
            for im in data["images"]:
                if im["id"] not in images:
                    images[im["id"]] = im
                    new_ids.add(im["id"])
            dropped = orphaned = 0
            for ann in data["annotations"]:
                if ann["image_id"] in new_ids:
                    annotations.setdefault((ann["image_id"], ann["id"]), ann)
                elif ann["image_id"] in images:
                    dropped += 1      # the image came from an earlier json
                else:
                    orphaned += 1     # no json holds the image's record
            if dropped:
                warnings.warn(
                    f"{dropped} annotation(s) in {path} reference images already provided "
                    "by an earlier instances json and were skipped (first-json-wins union)",
                    stacklevel=2)
            if orphaned:
                warnings.warn(
                    f"{orphaned} annotation(s) in {path} reference image ids with no image "
                    "record in any provided instances json: dangling annotations skipped",
                    stacklevel=2)

        cat_ids = sorted(cats)
        self.classes = ["__background__"] + [cats[c] for c in cat_ids]
        self.cat_id_to_class = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.num_classes = len(self.classes)

        excluded = set()
        if exclude_senticap_test and senticap_jsonpath:
            excluded = SenticapReader(senticap_jsonpath, test_split=True)._image_ids

        self._images = {iid: im for iid, im in images.items() if iid not in excluded}
        self._anns: Dict[int, List[dict]] = {}
        for ann in annotations.values():
            if ann.get("iscrowd", 0):
                continue
            if ann["image_id"] in self._images:
                self._anns.setdefault(ann["image_id"], []).append(ann)

        self.image_ids = [iid for iid in sorted(self._images) if iid in self._anns]
        self.image_root = image_root

        # per-annotation attribute index lists (annotation id == obj_inst)
        self.ann_atts: Dict[int, List[int]] = {}
        self.n_attribs = n_attribs
        self.att_counts: Optional[np.ndarray] = None
        if attribs_dir_path:
            reader = CocoAttributesReader(attribs_dir_path)
            self.n_attribs = reader.n_attribs
            self.att_counts = reader.att_counts
            for obj_inst, attrib_inst in reader.obj_inst2attrib_inst.items():
                vec = reader.attrib_inst2attrib_vector.get(attrib_inst)
                if vec is not None:
                    idx = np.nonzero(vec)[0]
                    if len(idx):
                        self.ann_atts[obj_inst] = idx.tolist()

    def __len__(self) -> int:
        return len(self.image_ids)

    def record(self, index: int) -> Dict[str, Any]:
        image_id = self.image_ids[index]
        im = self._images[image_id]
        boxes, classes, atts = [], [], []
        W, H = im.get("width", 0), im.get("height", 0)
        for ann in self._anns.get(image_id, []):
            x, y, w, h = ann["bbox"]
            # clipped as the reference's coco.py:203-210
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(W - 1.0, x1 + max(0.0, w - 1))
            y2 = min(H - 1.0, y1 + max(0.0, h - 1))
            if ann.get("area", w * h) > 0 and x2 >= x1 and y2 >= y1:
                boxes.append([x1, y1, x2, y2])
                classes.append(self.cat_id_to_class[ann["category_id"]])
                atts.append(self.ann_atts.get(ann["id"], []))
        return {
            "image_id": image_id,
            "file_name": os.path.join(self.image_root, im.get("file_name", "")),
            "width": W, "height": H,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "atts": atts,
        }


def load_image_bgr(path: str, device: Optional[Union[str, torch.device]] = None
                   ) -> torch.Tensor:
    """An image file as (H, W, 3) float32 BGR on ``device`` (the GPU unless
    ``"cpu"``): PIL's ``convert("RGB")`` pixels, channels reversed (the
    cv2.imread convention of the reference). Raises
    ``image_decode.ImageError`` for a refused format or a corrupt file."""
    with open(path, "rb") as f:
        return decode_image_bgr(f.read(), device)


def prepared_size(h: int, w: int, target_size: int, max_size: int) -> Tuple[int, int, float]:
    """(height, width, scale) of an h × w image after :func:`prepare_image`:
    the shorter side to ``target_size`` unless the longer would exceed
    ``max_size``."""
    scale = float(target_size) / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    return int(round(h * scale)), int(round(w * scale)), scale


def prepare_image(img: torch.Tensor, target_size: int, max_size: int
                  ) -> Tuple[torch.Tensor, float]:
    """Mean subtraction and the bilinear resize of JAX ``prepare_image_np``
    on the image's device: the shorter side to ``target_size`` unless the
    longer would exceed ``max_size``. img (H, W, 3) float32 BGR → (canvas
    (h', w', 3) float32, scale). The tap indices and weights are JAX's
    (float64 on the host) and the taps are summed in float64 in JAX's
    order, as numpy promotes them there. Runs in the span ``ssc.prepare``
    (``utils/tracing.py``)."""
    with span(PREPARE):
        dev = img.device
        h, w = img.shape[:2]
        new_h, new_w, scale = prepared_size(h, w, target_size, max_size)

        def taps(n_out: int, n_in: int):
            pos = (np.arange(n_out) + 0.5) / scale - 0.5
            i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
            i1 = np.clip(i0 + 1, 0, n_in - 1)
            wt = np.clip(pos - i0, 0, 1)
            return (torch.from_numpy(i0).to(dev), torch.from_numpy(i1).to(dev),
                    torch.from_numpy(wt).to(dev))

        y0, y1, wy = taps(new_h, h)
        x0, x1, wx = taps(new_w, w)
        wy, wx = wy[:, None, None], wx[None, :, None]
        src = (img.float() - torch.from_numpy(PIXEL_MEANS_BGR).to(dev)).double()
        top, bottom = src.index_select(0, y0), src.index_select(0, y1)
        out = ((top.index_select(1, x0) * (1 - wy) * (1 - wx))
               + (top.index_select(1, x1) * (1 - wy) * wx)
               + (bottom.index_select(1, x0) * wy * (1 - wx))
               + (bottom.index_select(1, x1) * wy * wx))
        return out.float(), scale


def flip_record(record: Dict[str, Any], img: torch.Tensor
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Horizontal flip of an (H, W, 3) image and of its record's boxes
    (x1, x2 mirrored at the image's width), the training augmentation."""
    W = img.shape[1]
    boxes = record["boxes"].copy()
    x1 = boxes[:, 0].copy()
    boxes[:, 0] = W - boxes[:, 2] - 1
    boxes[:, 2] = W - x1 - 1
    out = dict(record)
    out["boxes"] = boxes
    return out, torch.flip(img, dims=[1])


def canvas_for(record: Dict[str, Any], canvas_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Aspect-aware canvas: a portrait image gets the transposed canvas, so
    that padding stays small (the fixed-shape analogue of the reference's
    aspect-ratio-grouped batching)."""
    h, w = record.get("height", 0), record.get("width", 0)
    ch, cw = canvas_hw
    if h > w and ch < cw:
        return (cw, ch)
    if w >= h and ch > cw:
        return (cw, ch)
    return tuple(canvas_hw)


def make_batch(records: Sequence[Dict[str, Any]], images: Sequence[torch.Tensor],
               scales: Sequence[float], canvas_hw: Tuple[int, int], max_gt: int,
               n_attribs: int) -> Dict[str, torch.Tensor]:
    """A fixed-shape batch on the images' device: images (B, H, W, 3) on
    the canvas (cropped where larger), im_info (B, 3) rows (height, width,
    scale), gt_boxes (B, max_gt, 5) at the image's scale with the class
    last, gt_atts (B, max_gt, max(n_attribs, 1)) multi-hot and num_gt (B,)."""
    B = len(records)
    H, W = canvas_hw
    dev = images[0].device
    out_im = torch.zeros((B, H, W, 3), dtype=torch.float32, device=dev)
    im_info = np.zeros((B, 3), np.float32)
    gt_boxes = np.zeros((B, max_gt, 5), np.float32)
    gt_atts = np.zeros((B, max_gt, max(n_attribs, 1)), np.float32)
    num_gt = np.zeros((B,), np.int32)
    for i, (rec, img, scale) in enumerate(zip(records, images, scales)):
        h, w = min(img.shape[0], H), min(img.shape[1], W)
        out_im[i, :h, :w] = img[:h, :w]
        im_info[i] = [h, w, scale]
        n = min(len(rec["boxes"]), max_gt)
        if n:
            gt_boxes[i, :n, :4] = rec["boxes"][:n] * scale
            gt_boxes[i, :n, 4] = rec["classes"][:n]
            for g in range(n):
                for a in rec["atts"][g]:
                    if a < n_attribs:
                        gt_atts[i, g, a] = 1.0
        num_gt[i] = n
    return {"images": out_im, "im_info": torch.from_numpy(im_info).to(dev),
            "gt_boxes": torch.from_numpy(gt_boxes).to(dev),
            "gt_atts": torch.from_numpy(gt_atts).to(dev),
            "num_gt": torch.from_numpy(num_gt).to(dev)}
