"""Operations and bytes of the images-to-captions cell's detector and of
its two kernels, counted from the widths, as ``flops.py`` counts the
decode's: a product (or a convolution) of m·k by k·n is 2·m·k·n
operations, elementwise work is not counted; bytes count each input read
once and each output written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.flops import DTYPE_BYTES, cbs_decode_flops
from benchmark.reference.detector import BLOCKS, PLANES


def _layer_flops(n: int, planes: int, cin: int, h: int, w: int, stride: int):
    """One ResNet layer of ``n`` bottlenecks (stride on the first 1×1) on
    an h × w input: (operations, channels out, h out, w out)."""
    ops = 0
    for bi in range(n):
        s = stride if bi == 0 else 1
        ho, wo = -(-h // s), -(-w // s)
        ops += 2 * ho * wo * (cin * planes + planes * planes * 9 + planes * planes * 4)
        if bi == 0:
            ops += 2 * ho * wo * cin * planes * 4          # the downsample 1×1
        cin, h, w = planes * 4, ho, wo
    return ops, cin, h, w


def backbone_flops(depth: int, height: int, width: int) -> Tuple[float, int, int]:
    """conv1 .. layer3 of one (height, width) canvas: (operations, C4
    height, C4 width). conv1 is 7×7 at stride 2 (padding 3); the max-pool
    3×3 at stride 2 in ceil mode."""
    h, w = (height - 1) // 2 + 1, (width - 1) // 2 + 1
    ops = 2 * h * w * 3 * 64 * 49
    h, w = -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1
    cin = 64
    for li, (n, planes) in enumerate(zip(BLOCKS[depth][:3], PLANES[:3])):
        o, cin, h, w = _layer_flops(n, planes, cin, h, w, 1 if li == 0 else 2)
        ops += o
    return float(ops), h, w


def detector_flops(cfg: dict, height: int, width: int, rois: int) -> Dict[str, float]:
    """One image's operations by part: the backbone on the canvas, the RPN
    (the 3×3 conv to 512 and the two 1×1 heads over the C4 map), and the
    RoI head on ``rois`` RoIs (layer4 on the pooled 7×7, the class, box and
    attribute heads on 2,048)."""
    ops, h, w = backbone_flops(cfg["depth"], height, width)
    A, C, K = cfg["num_anchors"], cfg["num_classes"], cfg["num_att_classes"]
    rpn = 2 * h * w * (1024 * 512 * 9 + 512 * 6 * A)
    P = cfg["pooling_size"]
    layer4, *_ = _layer_flops(BLOCKS[cfg["depth"]][3], PLANES[3], 1024, P, P, 2)
    head = rois * (layer4 + 2 * 2048 * (C + 4 * C + K))
    return {"backbone": ops, "rpn": float(rpn), "roi_head": float(head)}


def decode_flops(cfg: dict, traffic: dict) -> float:
    """One group's CBS decode (``flops.cbs_decode_flops``) of its box
    features: every constraint slot filled, each with its most wordforms."""
    C = cfg["max_constraints"]
    return cbs_decode_flops(cfg, traffic["images_per_group"], cfg["max_boxes"], traffic["n_z"],
                            2 ** C, C * cfg["wordforms_per_attribute"])


def pipeline_flops(cfg: dict, traffic: dict) -> float:
    """One group's operations: the detector on each canvas and the decode
    (:func:`decode_flops`)."""
    B, (H, W) = traffic["images_per_group"], traffic["canvas_hw"]
    det = sum(detector_flops(cfg, H, W, cfg["rpn_post_nms_top_n"]).values())
    return B * det + decode_flops(cfg, traffic)


def roi_align_call(batch: int, height: int, width: int, channels: int, rois: int,
                   pooled: int, sampling: int, dtype: str) -> Dict[str, float]:
    """Kernel C's call (``ops/kernels/roi_align.py``): an NHWC map (batch,
    height, width, channels) read once and (rois, pooled, pooled, channels)
    written once; operations a multiply and an add for each of a sample's
    four corners, channel and sample (CUDA cores: its peak is f32's)."""
    n = DTYPE_BYTES[dtype]
    return {"ops": 2.0 * rois * pooled * pooled * sampling * sampling * 4 * channels,
            "bytes": float(n * channels * (batch * height * width + rois * pooled * pooled)),
            "dtype": "float32"}


def nms_call(groups: int, boxes: int, out_len: int) -> Dict[str, float]:
    """Kernel D's call (``ops/kernels/nms.py``) on (groups, boxes): 15
    operations a box pair over the upper triangle (the bitmask's IoU test,
    on CUDA cores: f32's peak); bytes of the scan, which reads each row's
    mask words from its diagonal word on (8 bytes each) and the boxes (16
    bytes each), and writes the kept indices (4 bytes each) and the keep
    flags (1 byte each)."""
    words = -(-boxes // 64)
    row_words = sum(words - i // 64 for i in range(boxes))
    return {"ops": 15.0 * groups * boxes * (boxes - 1) / 2,
            "bytes": float(groups * (8 * row_words + 16 * boxes + 4 * out_len + boxes)),
            "dtype": "float32"}
