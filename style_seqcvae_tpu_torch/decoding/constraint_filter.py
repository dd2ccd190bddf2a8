"""Constraint filtering for CBS decoding (copy of
``style_seqcvae_tpu/decoding/constraint_filter.py:1-119``).

Mirror of updown-baseline/updown/utils/constraints.py:56-209
(``ConstraintFilter``): blacklist removal, class-hierarchy NMS (for boxes
with IoU >= 0.85 the finer class suppresses the coarser: "dog" beats
"mammal"), top-k by detection score, name replacements, dedup. The Open
Images class hierarchy JSON is walked as a small tree of nodes, whose
"height" is the longest downward path.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

BLACKLIST: List[str] = [
    "auto part", "bathroom accessory", "bicycle wheel", "boy", "building", "clothing",
    "door handle", "fashion accessory", "footwear", "girl", "hiking equipment", "human arm",
    "human beard", "human body", "human ear", "human eye", "human face", "human foot",
    "human hair", "human hand", "human head", "human leg", "human mouth", "human nose",
    "land vehicle", "mammal", "man", "person", "personal care", "plant", "plumbing fixture",
    "seat belt", "skull", "sports equipment", "tire", "tree", "vehicle registration plate",
    "wheel", "woman",
]

REPLACEMENTS: Dict[str, str] = {
    "band-aid": "bandaid",
    "wood-burning stove": "wood burning stove",
    "kitchen & dining room table": "table",
    "salt and pepper shakers": "salt and pepper",
    "power plugs and sockets": "power plugs",
    "luggage and bags": "luggage",
}


class _Node:
    __slots__ = ("label", "children", "height")

    def __init__(self, label: str):
        self.label = label
        self.children: List["_Node"] = []
        self.height = 0


class ConstraintFilter:
    def __init__(self, hierarchy_jsonpath: str, nms_threshold: float = 0.85,
                 max_given_constraints: int = 3):
        with open(hierarchy_jsonpath) as f:
            hierarchy = json.load(f)
        self._nodes: List[_Node] = []
        self._root = self._read(hierarchy)
        self._compute_heights(self._root)
        self._nms_threshold = nms_threshold
        self._max_given_constraints = max_given_constraints

    def _read(self, d: dict) -> _Node:
        node = _Node(str(d.get("LabelName", "")))
        self._nodes.append(node)
        for child in d.get("Subcategory", []):
            node.children.append(self._read(child))
        return node

    def _compute_heights(self, node: _Node) -> int:
        node.height = (1 + max(self._compute_heights(c) for c in node.children)
                       if node.children else 0)
        return node.height

    def _height_of(self, class_name: str) -> int:
        """First node whose (lowercased) label is a substring of the class
        name — matching the reference's ``node.LabelName.lower() in c``
        findall predicate (constraints.py:163)."""
        for node in self._nodes:
            if node.label.lower() in class_name:
                return node.height
        return 0

    def __call__(self, boxes: np.ndarray, class_names: List[str],
                 scores: np.ndarray) -> List[str]:
        keep = [i for i in range(len(class_names))
                if scores[i] > 0 and class_names[i] not in BLACKLIST]
        boxes = boxes[keep]
        class_names = [class_names[i] for i in keep]
        scores = scores[keep]

        keep = self._nms(boxes, class_names)
        boxes = boxes[keep]
        class_names = [class_names[i] for i in keep]
        scores = scores[keep]

        ranked = sorted(zip(class_names, scores), key=lambda t: -t[1])
        ranked = ranked[: self._max_given_constraints]
        class_names = [REPLACEMENTS.get(t[0], t[0]) for t in ranked]
        return list(set(class_names))

    def _nms(self, boxes: np.ndarray, class_names: List[str]) -> List[int]:
        if len(class_names) == 0:
            return []
        heights = np.array([self._height_of(c) for c in class_names])
        score_order = heights.argsort()
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        keep_box_indices = []
        while score_order.size > 0:
            current = score_order[0]
            keep_box_indices.append(int(current))
            xx1 = np.maximum(x1[current], x1[score_order[1:]])
            yy1 = np.maximum(y1[current], y1[score_order[1:]])
            xx2 = np.minimum(x2[current], x2[score_order[1:]])
            yy2 = np.minimum(y2[current], y2[score_order[1:]])
            inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
            union = areas[current] + areas[score_order[1:]] - inter
            keep_cond = np.logical_or(
                heights[score_order[1:]] >= heights[current],
                inter / union <= self._nms_threshold)
            score_order = score_order[1:][np.where(keep_cond)[0]]
        return keep_box_indices
