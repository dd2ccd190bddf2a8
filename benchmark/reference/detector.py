"""Plain reference of the Faster R-CNN ResNet-101 C4 detector with the
per-RoI attribute head, and of the serving chain's constraint pick.

Written from the published description (Ren et al., NeurIPS 2015; He et
al., CVPR 2016; the C4 variant of jwyang's faster-rcnn.pytorch that
github.com/visinf/style-seqcvae ``frcnn/`` extends with the attribute head,
``frcnn/lib/model/faster_rcnn/faster_rcnn.py:163-165``, ``resnet.py:245-248``;
test settings from ``frcnn/lib/model/utils/config.py``), not from the
program: nothing of the program is imported. Every product runs in
float32 with TF32 off (:func:`conv`, and ``captioner.matmul``), or at a
lower precision for the check's control (``"fp8"``: both operands rounded
to float8_e4m3 under a per-tensor scale).

* The test-time image preparation (:func:`prepare`): the pixel means
  subtracted, then one bilinear resize by the scale that takes the shorter
  side to 600 unless the longer would pass 1,000 (``cv2.resize`` with
  ``fx = fy = scale``, ``INTER_LINEAR``), at the top left of a zero canvas.
* ResNet-101 to the C4 map: a 7×7 stride-2 conv, frozen BatchNorm
  (``(x - mean) / sqrt(var + 1e-5) · scale + offset``), ReLU, a 3×3
  stride-2 max-pool (ceil mode, no padding), then layers 1 to 3 of
  bottlenecks whose stride sits on the 1×1 conv1 (the caffe ResNet).
* The RPN: a 3×3 conv to 512 with ReLU, then 1×1 class (2 a anchor) and
  box (4 a anchor) heads over 12 anchors (scales 4, 8, 16, 32; ratios 0.5,
  1, 2; the classic ``generate_anchors`` around a 16-pixel base), each
  head's channels ordered (anchor, value) and the anchors (row, column,
  anchor).
* The proposal layer: box deltas applied to the anchors, clipped to the
  image, the best 6,000 by foreground score, greedy NMS at 0.7
  (:func:`greedy_nms`), the first 300 kept.
* RoIAlign at 7 × 7, 2 × 2 samples a bin, from bilinear sampling with the
  classic kernel's boundary rules (:func:`roi_align`).
* layer4 (stride on its first 1×1 conv) and the mean over its 4 × 4 map
  to 2,048; the class softmax (81), the class-specific box deltas (4 × 81)
  and the attribute sigmoids (196).
* Box decoding with the deltas' normalisation (0.1, 0.1, 0.2, 0.2), the
  per-class greedy NMS at 0.3 of the boxes scoring above 0.05, and the 100
  best detections (:func:`select_detections`).
* The constraint pick (:func:`pick_constraints`): one attribute for each
  detected class in order of its best detection, from the attributes
  above 0.3 of its boxes, by the largest Gumbel draw, up to 3.

Departures from the published code, each where the program departs too:
proposals are not filtered by size; the detections keep exactly the 100
best (no ties past the cap).

The weights are the benchmark's own (:func:`make_weights`): one flat dict
of tensors drawn on the device from a seed, convolutions OIHW. The driver
hands the same values to the program in its parameter tree (the bf16
cast) and the f32 copy of that cast to the reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.captioner import FP8_MAX, matmul

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
PLANES = (64, 128, 256, 512)
BOX_STDS = (0.1, 0.1, 0.2, 0.2)
# caffe-convention inputs are mean-subtracted pixels, std ~ 60: the stem's
# draw folds that scale in, so that activations start at unit order
INPUT_PIXEL_STD = 57.6
# the published PIXEL_MEANS, BGR
PIXEL_MEANS = (102.9801, 115.9465, 122.7717)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in f32 after the rounding ``precision`` names."""
    if precision == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    if precision == "bf16":
        return x.bfloat16().float()
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, precision: str = "f32"
         ) -> torch.Tensor:
    """NCHW ``x`` by OIHW ``w``: an odd k × k kernel padded by (k - 1) / 2,
    both operands rounded as ``precision`` says."""
    return F.conv2d(rounded(x, precision), rounded(w, precision), stride=stride,
                    padding=(w.shape[-1] - 1) // 2)


def linear(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, precision: str):
    return matmul(x, w[f"{name}.w"], precision) + w[f"{name}.b"]


# --- the weights -------------------------------------------------------------

def resize_weights(n_out: int, n_in: int, scale: float, device) -> torch.Tensor:
    """One axis of ``cv2.resize``'s bilinear rule at ``scale`` as an
    (n_out, n_in) float64 matrix: output pixel i samples the input at
    (i + 0.5) / scale - 0.5, clamped below at 0, between its floor and the
    next pixel (the last pixel alone past the end)."""
    pos = ((torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5).clamp(min=0.0)
    lo = pos.floor().clamp(max=n_in - 1)
    frac = torch.where(lo >= n_in - 1, 0.0, pos - lo)
    hi = (lo + 1).clamp(max=n_in - 1)
    out = torch.zeros((n_out, n_in), dtype=torch.float64)
    rows = torch.arange(n_out)
    out.index_put_((rows, lo.long()), 1.0 - frac, accumulate=True)
    out.index_put_((rows, hi.long()), frac, accumulate=True)
    return out.to(device)


def prepare(images: torch.Tensor, target_size: int, max_size: int, canvas_hw,
            precision: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (B, h, w, 3) BGR, any dtype, of one size → (canvases (B, H, W,
    3) f32 with each prepared image at the top left, zero elsewhere, and
    im_info (B, 3) rows (height, width, scale)): the means subtracted, the
    scale that takes the shorter side to ``target_size`` unless the longer
    would then round past ``max_size``, the resize to round(h · scale) ×
    round(w · scale) as two products by :func:`resize_weights` in float64,
    then rounded as ``precision`` says."""
    B, h, w, _ = images.shape
    scale = float(target_size) / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    dev = images.device
    src = images.double() - torch.tensor(PIXEL_MEANS, dtype=torch.float64, device=dev)
    out = torch.einsum("yh,bhwc,xw->byxc", resize_weights(nh, h, scale, dev), src,
                       resize_weights(nw, w, scale, dev))
    H, W = canvas_hw
    canvas = torch.zeros((B, H, W, 3), device=dev)
    canvas[:, :nh, :nw] = rounded(out.float(), precision)
    info = torch.tensor([[float(nh), float(nw), scale]] * B, device=dev)
    return canvas, info


def block_names(depth: int) -> List[Tuple[str, int, int, int]]:
    """(prefix, input channels, planes, stride) of every bottleneck, layer1
    to layer4."""
    out, ch = [], 64
    for li, (n, planes) in enumerate(zip(BLOCKS[depth], PLANES), start=1):
        for bi in range(n):
            out.append((f"layer{li}.{bi}", ch, planes, 2 if li > 1 and bi == 0 else 1))
            ch = planes * 4
    return out


def weight_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape; a BatchNorm ``<bn>`` has ``<bn>.scale``,
    ``.offset``, ``.mean`` and ``.var``."""
    A, C, K = cfg["num_anchors"], cfg["num_classes"], cfg["num_att_classes"]
    shapes: Dict[str, Tuple[int, ...]] = {"conv1.w": (64, 3, 7, 7)}

    def bn(name, ch):
        for k in ("scale", "offset", "mean", "var"):
            shapes[f"{name}.{k}"] = (ch,)

    bn("bn1", 64)
    for name, ch, planes, stride in block_names(cfg["depth"]):
        shapes[f"{name}.conv1.w"] = (planes, ch, 1, 1)
        bn(f"{name}.bn1", planes)
        shapes[f"{name}.conv2.w"] = (planes, planes, 3, 3)
        bn(f"{name}.bn2", planes)
        shapes[f"{name}.conv3.w"] = (planes * 4, planes, 1, 1)
        bn(f"{name}.bn3", planes * 4)
        if stride != 1 or ch != planes * 4:
            shapes[f"{name}.downsample.w"] = (planes * 4, ch, 1, 1)
            bn(f"{name}.downsample.bn", planes * 4)
    shapes.update({"rpn.conv.w": (512, 1024, 3, 3), "rpn.conv.b": (512,),
                   "rpn.cls.w": (2 * A, 512, 1, 1), "rpn.cls.b": (2 * A,),
                   "rpn.bbox.w": (4 * A, 512, 1, 1), "rpn.bbox.b": (4 * A,),
                   "cls_score.w": (2048, C), "cls_score.b": (C,),
                   "bbox_pred.w": (2048, 4 * C), "bbox_pred.b": (4 * C,),
                   "cls_score_atts.w": (2048, K), "cls_score_atts.b": (K,)})
    return shapes


def make_weights(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every leaf drawn on ``device`` from ``seed`` in the order of
    :func:`weight_shapes`, then cast to ``dtype``. The draws are those of
    the configuration's ``assumed`` ``weights`` (``cfg["draws"]``):

    * convolutions He-normal (std sqrt(2 / fan_in)), the stem's over the
      input pixels' std;
    * BatchNorm scale uniform in [0.9, 1.1], times ``bn3_scale`` on each
      bottleneck's last BN (the residual branch adds a little to its
      input, so activations keep unit order through the 33 blocks);
      offset and mean normal with std 0.05; var uniform in [0.8, 1.2];
    * the RPN's class head normal with std ``rpn_cls_std`` / sqrt(512),
      its box head ``rpn_bbox_std`` / sqrt(512), the 3×3 conv He-normal,
      biases zero;
    * the class head normal with std ``cls_std`` / sqrt(2048) and zero
      bias; the box head ``bbox_std`` / sqrt(2048); the attribute head
      ``att_std`` / sqrt(2048) with every bias ``att_bias``."""
    d = cfg["draws"]
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    for name, shape in weight_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[1]
        if name == "conv1.w":
            w = normal(shape, math.sqrt(2.0 / math.prod(shape[1:])) / INPUT_PIXEL_STD)
        elif name.startswith("rpn.") or name.startswith(("cls_score", "bbox_pred")):
            head = name.rsplit(".", 1)[0]
            fan_in = shape[0] if len(shape) == 2 else math.prod(shape[1:])
            std = {"rpn.conv": math.sqrt(2.0), "rpn.cls": d["rpn_cls_std"],
                   "rpn.bbox": d["rpn_bbox_std"], "cls_score": d["cls_std"],
                   "bbox_pred": d["bbox_std"], "cls_score_atts": d["att_std"]}[head]
            if leaf == "w":
                w = normal(shape, std / math.sqrt(fan_in))
            else:
                w = torch.full(shape, float(d["att_bias"]) if head == "cls_score_atts"
                               else 0.0, device=device)
        elif leaf == "w":
            w = normal(shape, math.sqrt(2.0 / math.prod(shape[1:])))
        elif leaf == "scale":
            w = uniform(shape, 0.9, 1.1) * (d["bn3_scale"] if name.endswith("bn3.scale") else 1.0)
        elif leaf in ("offset", "mean"):
            w = normal(shape, 0.05)
        else:
            w = uniform(shape, 0.8, 1.2)
        out[name] = w.to(dtype)
    return out


# --- the backbone and the heads ---------------------------------------------

def batch_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    def c(v):
        return w[f"{name}.{v}"].reshape(-1, 1, 1)

    return (x - c("mean")) / torch.sqrt(c("var") + 1e-5) * c("scale") + c("offset")


def bottleneck(x, w, name, stride, precision):
    out = F.relu(batch_norm(conv(x, w[f"{name}.conv1.w"], stride, precision), w, f"{name}.bn1"))
    out = F.relu(batch_norm(conv(out, w[f"{name}.conv2.w"], 1, precision), w, f"{name}.bn2"))
    out = batch_norm(conv(out, w[f"{name}.conv3.w"], 1, precision), w, f"{name}.bn3")
    if f"{name}.downsample.w" in w:
        x = batch_norm(conv(x, w[f"{name}.downsample.w"], stride, precision), w,
                       f"{name}.downsample.bn")
    return F.relu(out + x)


def layer(x, w, cfg, li: int, precision: str):
    for name, _, _, stride in block_names(cfg["depth"]):
        if name.startswith(f"layer{li}."):
            x = bottleneck(x, w, name, stride, precision)
    return x


def backbone(w, cfg, images: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """images (B, H, W, 3) mean-subtracted BGR → C4 (B, 1024, H/16, W/16)."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.relu(batch_norm(F.conv2d(rounded(x, precision), rounded(w["conv1.w"], precision),
                                   stride=2, padding=3), w, "bn1"))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0, ceil_mode=True)
    for li in (1, 2, 3):
        x = layer(x, w, cfg, li, precision)
    return x


def generate_anchors(base: int, ratios, scales) -> torch.Tensor:
    """The classic anchors (ratio-major, then scale) around the window
    (0, 0, base - 1, base - 1): widths rounded for each ratio at the base
    area, then scaled. (A, 4) float64."""
    w = h = float(base)
    cx = cy = 0.5 * (base - 1)
    out = []
    for r in ratios:
        ws = round(math.sqrt(w * h / r))
        hs = round(ws * r)
        for s in scales:
            aw, ah = ws * s, hs * s
            out.append([cx - 0.5 * (aw - 1), cy - 0.5 * (ah - 1),
                        cx + 0.5 * (aw - 1), cy + 0.5 * (ah - 1)])
    return torch.tensor(out, dtype=torch.float64)


def grid_anchors(cfg, h: int, w: int, device) -> torch.Tensor:
    """Every anchor of an h × w map, (h·w·A, 4) f32 in (row, column,
    anchor) order."""
    stride = cfg["feat_stride"]
    base = generate_anchors(stride, cfg["anchor_ratios"], cfg["anchor_scales"])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64) * stride,
                            torch.arange(w, dtype=torch.float64) * stride, indexing="ij")
    shift = torch.stack([xs, ys, xs, ys], dim=-1).reshape(-1, 1, 4)
    return (base[None] + shift).reshape(-1, 4).float().to(device)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """boxes (..., 4) and deltas (..., 4) (dx, dy, dw, dh) → (..., 4), with
    +1 widths."""
    wd = boxes[..., 2] - boxes[..., 0] + 1.0
    ht = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * wd
    cy = boxes[..., 1] + 0.5 * ht
    px = deltas[..., 0] * wd + cx
    py = deltas[..., 1] * ht + cy
    pw = torch.exp(deltas[..., 2]) * wd
    ph = torch.exp(deltas[..., 3]) * ht
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def clip(boxes: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Clip (..., 4) to [0, width - 1] × [0, height - 1]; ``height`` and
    ``width`` are tensors that broadcast against (...)."""
    x = torch.minimum(boxes[..., 0::2].clamp(min=0.0), (width - 1.0)[..., None])
    y = torch.minimum(boxes[..., 1::2].clamp(min=0.0), (height - 1.0)[..., None])
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) × (..., M, 4) → (..., N, M), +1 widths."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def greedy_nms(boxes: torch.Tensor, live: torch.Tensor, threshold: float) -> torch.Tensor:
    """Greedy NMS of groups of score-sorted boxes: boxes (G, N, 4), live
    (G, N) the boxes that take part → (G, N) bool, kept. Box i, when kept,
    removes every later box whose IoU with it exceeds ``threshold``."""
    G, N, _ = boxes.shape
    kept = live.clone()
    if N == 0:
        return kept
    later = torch.ones((N, N), dtype=torch.bool, device=boxes.device).triu_(1)
    step = max(1, (1 << 25) // (N * N))
    over = torch.cat([(iou(boxes[g:g + step], boxes[g:g + step]) > threshold) & later
                      for g in range(0, G, step)])
    for i in range(N):
        kept &= ~(over[:, i] & kept[:, i:i + 1])
    return kept


def rpn_candidates(w, cfg, c4: torch.Tensor, im_info: torch.Tensor, precision: str = "f32"
                   ) -> Dict[str, torch.Tensor]:
    """C4 (B, 1024, h, w) → every anchor's box, deltas applied and clipped
    to the image, (B, N, 4), and its foreground score (B, N)."""
    B, _, h, wd = c4.shape
    x = F.relu(conv(c4, w["rpn.conv.w"], 1, precision) + w["rpn.conv.b"].reshape(-1, 1, 1))
    cls = conv(x, w["rpn.cls.w"], 1, precision) + w["rpn.cls.b"].reshape(-1, 1, 1)
    bbox = conv(x, w["rpn.bbox.w"], 1, precision) + w["rpn.bbox.b"].reshape(-1, 1, 1)
    deltas = bbox.permute(0, 2, 3, 1).reshape(B, -1, 4)
    boxes = apply_deltas(grid_anchors(cfg, h, wd, c4.device)[None], deltas)
    return {"boxes": clip(boxes, im_info[:, 0, None], im_info[:, 1, None]),
            "scores": torch.softmax(cls.permute(0, 2, 3, 1).reshape(B, -1, 2), dim=-1)[..., 1]}


def rpn(w, cfg, c4: torch.Tensor, im_info: torch.Tensor, precision: str = "f32"
        ) -> torch.Tensor:
    """C4 (B, 1024, h, w) → proposals (B, post, 4), zero rows past those
    kept, and their count (B,): of :func:`rpn_candidates`, the
    ``rpn_pre_nms_top_n`` best by foreground score, greedy NMS at
    ``rpn_nms_thresh``, the first ``rpn_post_nms_top_n`` kept."""
    B = c4.shape[0]
    cand = rpn_candidates(w, cfg, c4, im_info, precision)
    boxes, scores = cand["boxes"], cand["scores"]
    k = min(cfg["rpn_pre_nms_top_n"], boxes.shape[1])
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    boxes = torch.gather(boxes, 1, order[..., None].expand(B, k, 4))
    kept = greedy_nms(boxes, torch.ones((B, k), dtype=torch.bool, device=c4.device),
                      cfg["rpn_nms_thresh"])
    post = cfg["rpn_post_nms_top_n"]
    rank = torch.cumsum(kept.long(), dim=1) - 1
    take = kept & (rank < post)
    out = torch.zeros((B, post, 4), device=c4.device)
    for b in range(B):
        n = int(take[b].sum())
        out[b, :n] = boxes[b, take[b]]
    return out, take.sum(dim=1)


def bilinear_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, pooled: int,
                     sampling: int) -> torch.Tensor:
    """One axis of RoIAlign: RoIs spanning [lo, hi] (R,) on the map's
    scale → (R, pooled, size) weights, the mean over the bin's ``sampling``
    points of each point's bilinear weights on the map's rows. A point
    outside [-1, size] adds nothing; one below 0 reads row 0; from row
    size - 1 on it reads that row alone (the classic kernel)."""
    R = lo.shape[0]
    bin_ = torch.clamp(hi - lo, min=1.0) / pooled
    p = torch.arange(pooled, device=lo.device, dtype=torch.float32)
    s = (torch.arange(sampling, device=lo.device, dtype=torch.float32) + 0.5) / sampling
    y = lo[:, None, None] + (p[None, :, None] + s[None, None, :]) * bin_[:, None, None]
    empty = (y < -1.0) | (y > size)
    y = y.clamp(min=0.0)
    low = torch.floor(y).clamp(max=size - 1)
    top = low >= size - 1
    y = torch.where(top, low, y)
    high = torch.where(top, low, low + 1)
    frac = y - low
    out = torch.zeros((R, pooled, sampling, size), device=lo.device)
    keep = (~empty).float()
    out.scatter_add_(-1, low.long()[..., None], ((1.0 - frac) * keep)[..., None])
    out.scatter_add_(-1, high.long()[..., None], (frac * keep)[..., None])
    return out.mean(dim=2)


def roi_align(c4: torch.Tensor, b: int, boxes: torch.Tensor, cfg: dict) -> torch.Tensor:
    """RoIAlign of ``boxes`` (R, 4) on image ``b``'s map c4 (B, C, h, w) →
    (R, C, P, P): row and column weights (:func:`bilinear_weights`) applied
    as two products, which is the bilinear sampling written out (a
    sample's weight is its row weight times its column weight, and its
    bin's mean is the product of the axes' means)."""
    scale, P, S = 1.0 / cfg["feat_stride"], cfg["pooling_size"], 2
    _, C, h, wd = c4.shape
    x = boxes * scale
    wy = bilinear_weights(x[:, 1], x[:, 3], h, P, S)                  # (R, P, h)
    wx = bilinear_weights(x[:, 0], x[:, 2], wd, P, S)                 # (R, P, w)
    rows = torch.einsum("rph,chw->rpcw", wy, c4[b])
    return torch.einsum("rpcw,rqw->rcpq", rows, wx)


def roi_head(w, cfg, c4: torch.Tensor, b: int, boxes: torch.Tensor, precision: str = "f32"
             ) -> Dict[str, torch.Tensor]:
    """The head on image ``b``'s RoIs ``boxes`` (R, 4): pooled features (R,
    2048), class probabilities (R, C), box deltas (R, 4C), attribute
    scores (R, A)."""
    pooled = layer(roi_align(c4, b, boxes, cfg), w, cfg, 4, precision).mean(dim=(2, 3))
    return {"features": pooled,
            "cls_prob": torch.softmax(linear(pooled, w, "cls_score", precision), dim=-1),
            "bbox_pred": linear(pooled, w, "bbox_pred", precision),
            "att_scores": torch.sigmoid(linear(pooled, w, "cls_score_atts", precision))}


def decode(cfg, rois: torch.Tensor, bbox_pred: torch.Tensor, info: torch.Tensor
           ) -> torch.Tensor:
    """rois (R, 4) on the canvas, deltas (R, 4C) → class boxes (R, C, 4) at
    the original image's scale, clipped to the image."""
    R = rois.shape[0]
    deltas = bbox_pred.reshape(R, -1, 4) * torch.tensor(BOX_STDS, device=rois.device)
    boxes = clip(apply_deltas(rois[:, None, :], deltas), info[0], info[1])
    return boxes / info[2]


def select_detections(cfg, cls_prob: torch.Tensor, boxes: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """One image: class probabilities (R, C) and class boxes (R, C, 4) of
    its RoIs → per class the boxes above ``score_thresh`` through greedy NMS
    at ``nms_thresh``, then the ``max_boxes`` best of all classes by score:
    roi (n,), class (n,), score (n,), box (n, 4), best first. Every RoI
    takes part, a zero row of the proposals too, as in the program (at the
    cell's sizes the proposal layer keeps its 300 rows full)."""
    R, C = cls_prob.shape
    scores = cls_prob[:, 1:].T                                         # (C - 1, R)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    sorted_scores = torch.gather(scores, 1, order)
    cls_boxes = boxes[:, 1:].transpose(0, 1)                           # (C - 1, R, 4)
    sorted_boxes = torch.gather(cls_boxes, 1, order[..., None].expand(-1, -1, 4))
    live = sorted_scores > cfg["score_thresh"]
    kept = greedy_nms(sorted_boxes, live, cfg["nms_thresh"])
    cls_idx, pos = torch.nonzero(kept, as_tuple=True)
    s = sorted_scores[cls_idx, pos]
    best = torch.sort(s, descending=True, stable=True).indices[:cfg["max_boxes"]]
    cls_idx, pos = cls_idx[best], pos[best]
    return {"roi": order[cls_idx, pos], "class": cls_idx + 1, "score": s[best],
            "box": sorted_boxes[cls_idx, pos]}


def pick_constraints(class_ids: np.ndarray, valid: np.ndarray, att_scores: np.ndarray,
                     selectable: np.ndarray, gumbel: np.ndarray, att_thresh: float,
                     max_constraints: int) -> np.ndarray:
    """The constraint pick of the serving chain, one image and FSM sample at
    a time: detections (M,) in descending score order with their attribute
    scores (M, A); ``gumbel`` (n_fsm, k, A). Each detected class, in the
    order of its best detection, is an object whose attributes are those
    above ``att_thresh`` of any of its boxes that the table can constrain
    (``selectable``); the first ``max_constraints`` objects with any take
    one each, the one with the largest Gumbel draw. Returns (n_fsm, k)
    attribute ids, -1 for a slot left empty."""
    objects, seen = [], set()
    for m in range(len(class_ids)):
        c = int(class_ids[m])
        if not valid[m] or c in seen:
            continue
        seen.add(c)
        boxes = valid & (class_ids == c)
        atts = ((att_scores[boxes] > att_thresh).any(axis=0)) & selectable
        if atts.any():
            objects.append(np.flatnonzero(atts))
    picks = np.full(gumbel.shape[:2], -1, np.int64)
    for slot, atts in enumerate(objects[:max_constraints]):
        picks[:, slot] = atts[np.argmax(gumbel[:, slot, atts], axis=-1)]
    return picks


def dense_fsm(picks: torch.Tensor, tokens: torch.Tensor, token_valid: torch.Tensor,
              states: int, vocab: int) -> torch.Tensor:
    """(R, k) picked attributes (-1: none) and the attribute table's tokens
    (A, W) with their validity → (R, S, S, V) bool on the picks' device
    (built on the host): every token keeps its
    state, except that a token of a picked attribute whose slot's bit is
    clear moves to the state with that bit set (to each such state, when
    two slots picked the same attribute)."""
    R, k = picks.shape
    fsm = torch.zeros((R, states, states, vocab), dtype=torch.bool)
    s = torch.arange(states)
    fsm[:, s, s, :] = True
    host = picks.tolist()
    tokens, token_valid = tokens.cpu(), token_valid.cpu()
    for r in range(R):
        for slot, a in enumerate(host[r]):
            if a < 0:
                continue
            toks = tokens[a][token_valid[a]].tolist()
            for src in range(states):
                if src >> slot & 1 or (src | 1 << slot) >= states:
                    continue
                for t in toks:
                    fsm[r, src, src, t] = False
                    fsm[r, src, src | 1 << slot, t] = True
    return fsm.to(picks.device)


def best_beam(seqs: torch.Tensor, lp: torch.Tensor, given: torch.Tensor,
              min_to_satisfy: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top beam of the most likely state that meets enough constraints
    (popcount >= min(given, min_to_satisfy), and no bit past ``given``):
    seqs (R, S, K, T), lp (R, S, K), given (R,) → ((R, T), (R,))."""
    S = seqs.shape[1]
    s = torch.arange(S, device=lp.device)
    pop = torch.tensor([bin(i).count("1") for i in range(S)], device=lp.device)
    ok = (pop[None] >= given.clamp(max=min_to_satisfy)[:, None]) & (s[None] < (1 << given)[:, None])
    top = torch.where(ok, lp[..., 0], torch.tensor(float("-inf"), device=lp.device))
    best_lp, state = top.max(dim=1)
    return seqs[torch.arange(seqs.shape[0], device=lp.device), state, 0], best_lp
