"""Detection visualization on the host (counterpart of the JAX package's
``utils/visualize.py``): draw a detector's boxes onto an image with their
class name and score, skipping detections under a score threshold.

JAX draws with PIL (``ImageDraw.rectangle`` and ``ImageDraw.text`` with
PIL's default font); the port draws the same pixels with numpy and the
glyph atlas of ``utils/glyphs.py``, and imports no PIL. Each rule below was
found against Pillow 12.1.0 and is held by ``tests/test_torch_visualize.py``
pixel for pixel:

* A box ``[x1, y1, x2, y2]`` with ``x2 < x1`` or ``y2 < y1`` raises
  ``ValueError`` (PIL's check, on the float coordinates). The coordinates
  are then cut toward zero (C's ``(int)`` cast: 10.7 → 10, -3.5 → -3).
* The outline at width 2 is two rows at each of y1, y1 + 1, y2 - 1 and y2
  from x1 to x2, and the columns x1, x1 + 1, x2 - 1 and x2 from y1 + 2
  toward y2 - 1, that end excluded (PIL's line steps ``|dy|`` pixels, so a
  box under 3 pixels tall draws a column stub below it).
* The label strip ``[tx, ty, tx + tw + 4, ty + 12]`` is a filled rectangle:
  rows ty through ty + 12, each from tx to tx + tw + 4, both ends included.
  Rows and columns are clipped at the image's edges.
* The text goes at ``(tx + 2, ty)``. PIL's origin is the coordinate cut
  toward zero plus a shift of 0 or ±1 that FreeType's layout takes from the
  fraction: the fraction in f32, times 64, added in f32 to the line's pen
  start (64 × the line's left overhang for x, 64 × its height above the
  baseline for y), rounded half away from zero and then to whole pixels
  (x: (v + 32) >> 6, y: -((32 - v) >> 6)). The glyphs are laid at whole
  advances, each mask joined into the line's coverage by ``s + t·(255 -
  s)/255`` rounded as PIL's ``DIV255``; a line moved left by the shift
  loses what falls left of its box, as PIL clips it.
* White is blended over the image by coverage m with PIL's integer blend,
  ``DIV255(in·(255 - m) + 255·m)``.

Drawing stays on the host, never on the device path: a box is a few
hundred pixels, and the image's decode is what runs on the card
(``scripts/eval_detections.py --vis-dir``).
"""

from __future__ import annotations

import math
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from style_seqcvae_tpu_torch.utils.glyphs import ASCENT, GLYPHS

# distinct, dark-on-light-safe outline colors cycled per class
_COLORS = [
    (204, 0, 0), (0, 153, 0), (0, 82, 204), (230, 153, 0),
    (153, 0, 153), (0, 153, 153), (102, 51, 0), (230, 0, 115),
]
_WHITE = (255, 255, 255)
_OUTLINE = 2                    # rectangle(..., width=2)
_STRIP = 12                     # label strip height above the box


def check_label(class_name: str) -> None:
    """Raise ``ValueError`` when a label of ``class_name`` has a character
    outside the glyph atlas (printable ASCII). JAX would draw it with
    Aileron's own glyph; the port has none to draw."""
    for ch in class_name:
        if ch not in GLYPHS:
            raise ValueError(f"class name {class_name!r} has the character {ch!r} "
                             f"(U+{ord(ch):04X}), which the glyph atlas does not hold: "
                             "labels are drawn in printable ASCII only")


def _div255(a):
    a = a + 128
    return ((a >> 8) + a) >> 8


def _box(xy: Sequence[float]) -> Tuple[int, int, int, int]:
    x0, y0, x1, y1 = xy
    if not all(math.isfinite(v) for v in xy):
        raise ValueError(f"box coordinates must be finite, got {tuple(xy)}")
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    return int(x0), int(y0), int(x1), int(y1)


def _hline(img: np.ndarray, x0: int, y: int, x1: int, color: np.ndarray) -> None:
    H, W = img.shape[:2]
    if 0 <= y < H and x0 < W and x1 >= 0:
        img[y, max(x0, 0):min(x1, W - 1) + 1] = color


def _vline(img: np.ndarray, x: int, y0: int, y1: int, color: np.ndarray) -> None:
    """PIL's vertical line from (x, y0) toward (x, y1): |y1 - y0| pixels
    starting at y0, the end excluded."""
    H, W = img.shape[:2]
    if not 0 <= x < W or y0 == y1:
        return
    lo, hi = (y0, y1 - 1) if y1 > y0 else (y1 + 1, y0)
    lo, hi = max(lo, 0), min(hi, H - 1)
    if lo <= hi:
        img[lo:hi + 1, x] = color


def _outline(img: np.ndarray, xy: Sequence[float], color: np.ndarray) -> None:
    x0, y0, x1, y1 = _box(xy)
    for i in range(_OUTLINE):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + _OUTLINE, y1 - _OUTLINE + 1, color)
        _vline(img, x0 + i, y0 + _OUTLINE, y1 - _OUTLINE + 1, color)


def _fill(img: np.ndarray, xy: Sequence[float], color: np.ndarray) -> None:
    x0, y0, x1, y1 = _box(xy)
    H, W = img.shape[:2]
    y0, y1 = max(y0, 0), min(y1, H - 1)
    if y0 <= y1 and x0 < W and x1 >= 0:
        img[y0:y1 + 1, max(x0, 0):min(x1, W - 1) + 1] = color


def _snap(frac: float, pen: int) -> int:
    """FreeType's pen position in 26.6 units for a start fraction ``frac``
    added to the line's pen start ``pen`` (a multiple of 64), both in f32,
    rounded half away from zero."""
    v = float(np.float32(pen) + np.float32(frac) * np.float32(64))
    return int(math.copysign(math.floor(abs(v) + 0.5), v))


def text_width(label: str) -> int:
    """``ImageDraw.textlength`` of ``label`` in PIL's default font: the sum
    of the atlas's whole-pixel advances (the font has no pair kerning)."""
    return sum(GLYPHS[ch].advance for ch in label)


def _text(img: np.ndarray, xy: Tuple[float, float], label: str) -> None:
    """``ImageDraw.text(xy, label, fill=white)`` in PIL's default font."""
    x, y = xy
    glyphs = [GLYPHS[ch] for ch in label]
    pens = [0]
    for g in glyphs[:-1]:
        pens.append(pens[-1] + g.advance)
    # the line's box in pen coordinates: every glyph's mask box joined
    left = min(p + g.x for p, g in zip(pens, glyphs))
    top = min(g.y for g in glyphs)
    right = max(p + g.x + g.mask.shape[1] for p, g in zip(pens, glyphs))
    bottom = max(g.y + g.mask.shape[0] for g in glyphs)
    fx, fy = np.float32(math.modf(x)[0]), np.float32(math.modf(y)[0])
    pen_x, pen_y = -left * 64, (ASCENT - top) * 64
    shift_x = (_snap(fx, pen_x) - pen_x + 32) >> 6
    shift_y = -((pen_y - _snap(fy, pen_y) + 32) >> 6)
    # PIL's mask grows by ceil(fraction) to take a shift right or down
    w, h = right - left + math.ceil(fx), bottom - top + math.ceil(fy)
    cover = np.zeros((h, w), np.int32)
    for p, g in zip(pens, glyphs):
        gx, gy = p + g.x - left + shift_x, g.y - top + shift_y
        gh, gw = g.mask.shape
        a0, a1, b0, b1 = max(gx, 0), min(gx + gw, w), max(gy, 0), min(gy + gh, h)
        if a0 < a1 and b0 < b1:
            s = g.mask[b0 - gy:b1 - gy, a0 - gx:a1 - gx].astype(np.int32)
            t = cover[b0:b1, a0:a1]
            t[...] = s + _div255(t * (255 - s))
    # the mask lands at the origin cut toward zero plus the line's box offset
    X, Y = int(x) + left, int(y) + top
    H, W = img.shape[:2]
    a0, a1, b0, b1 = max(X, 0), min(X + w, W), max(Y, 0), min(Y + h, H)
    if a0 < a1 and b0 < b1:
        m = cover[b0 - Y:b1 - Y, a0 - X:a1 - X, None]
        under = img[b0:b1, a0:a1].astype(np.int32)
        img[b0:b1, a0:a1] = _div255(under * (255 - m) + np.asarray(_WHITE, np.int32) * m)


def vis_detections(image: np.ndarray, class_name: str, dets: np.ndarray,
                   thresh: float = 0.8, max_boxes: int = 10,
                   color: Optional[tuple] = None) -> np.ndarray:
    """Draw one class's detections on ``image``.

    image (H, W, 3) uint8 (RGB); dets (N, 5) [x1, y1, x2, y2, score].
    Only boxes with score > ``thresh`` are drawn, at most ``max_boxes`` per
    call (the first ``max_boxes`` rows, drawn or not). Returns a NEW
    annotated (H, W, 3) uint8 array; the input is not modified. Raises
    ``ValueError`` for a label character outside printable ASCII, a box
    with x2 < x1 or y2 < y1, or a coordinate that is not finite."""
    img = np.array(np.asarray(image).astype(np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"the image must be (H, W, 3), got {img.shape}")
    check_label(class_name)
    dets = np.asarray(dets)
    # stable per-class color: builtin hash() is salted per process
    c = np.asarray(color or _COLORS[zlib.crc32(class_name.encode()) % len(_COLORS)], np.uint8)
    for i in range(min(max_boxes, dets.shape[0])):
        score = float(dets[i, 4]) if dets.shape[1] > 4 else 1.0
        if not score > thresh:
            continue
        x1, y1, x2, y2 = (float(v) for v in dets[i, :4])
        _outline(img, (x1, y1, x2, y2), c)
        label = f"{class_name}: {score:.3f}"
        # text background strip above the box (inside if at the top edge)
        tx, ty = x1, max(y1 - _STRIP, 0)
        _fill(img, (tx, ty, tx + text_width(label) + 4, ty + _STRIP), c)
        _text(img, (tx + 2, ty), label)
    return img


def vis_image_detections(image: np.ndarray,
                         boxes: np.ndarray,
                         scores: np.ndarray,
                         labels: Sequence[int],
                         class_names: Sequence[str],
                         thresh: float = 0.5) -> np.ndarray:
    """Multi-class convenience wrapper: one call for a whole image.

    boxes (N, 4), scores (N,), labels (N,) int class ids indexing
    ``class_names`` (an id past its end is drawn as ``str(id)``); each class
    in ascending id order through :func:`vis_detections`."""
    out = np.asarray(image, np.uint8)
    labels = np.asarray(labels)
    for cls in np.unique(labels):
        sel = labels == cls
        dets = np.concatenate(
            [np.asarray(boxes)[sel], np.asarray(scores)[sel, None]], axis=1)
        name = class_names[int(cls)] if int(cls) < len(class_names) else str(int(cls))
        out = vis_detections(out, name, dets, thresh=thresh)
    return out
