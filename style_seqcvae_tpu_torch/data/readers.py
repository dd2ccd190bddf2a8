"""Caption, attribute and constraint-box readers (copy of
``style_seqcvae_tpu/data/readers.py:1-288``).

Behavioral mirrors of updown-baseline/updown/data/readers.py:

* :class:`CocoCaptionsReader` (:142-169), :class:`SenticapReader`
  (:172-216, incl. the sentiment 0 -> -1 remap), :class:`ExpertReader`
  (:219-256),
* :class:`ConstraintBoxesReader` (:259-290),
* :class:`CocoAttributesReader` (:294-535): the index over the
  COCO-Attributes pickles with weight threshold 0.3, min-appearance 20, at
  most 99 attributes an image, name-keyed output and duplicate merging,
* :func:`obj_atts_id2string`.

The image-features reader is :mod:`style_seqcvae_tpu_torch.utils.features_io`.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from style_seqcvae_tpu_torch.data.tokenizer import tokenize_caption


def load_obj(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


class CocoCaptionsReader:
    def __init__(self, captions_jsonpath: str):
        with open(captions_jsonpath) as f:
            captions_json = json.load(f)
        self._captions: List[Tuple[int, List[str]]] = [
            (item["image_id"], tokenize_caption(item["caption"]))
            for item in captions_json["annotations"]
        ]

    def __len__(self):
        return len(self._captions)

    def __getitem__(self, index):
        return self._captions[index]


class SenticapReader:
    def __init__(self, senticap_jsonpath: str, train_split=False, val_split=False,
                 test_split=False, sentiment: Optional[str] = None):
        with open(senticap_jsonpath) as f:
            senticap_json = json.load(f)["images"]
        self._captions: List[Tuple[int, List[str], int]] = []
        self._image_ids: Set[int] = set()
        self.sentiment = sentiment
        for item in senticap_json:
            senti_coco_id = int(item["filename"].split(".")[0].split("_")[2])
            split = item["split"]
            if ((train_split and split == "train")
                    or (val_split and split == "val")
                    or (test_split and split == "test")):
                cap_added = False
                for c in item["sentences"]:
                    senti = c["sentiment"]
                    if (not sentiment or (sentiment == "pos" and senti == 1)
                            or (sentiment == "neg" and senti == 0)):
                        cap_added = True
                        senti_out = -1 if senti == 0 else senti
                        self._captions.append(
                            (senti_coco_id, tokenize_caption(c["raw"]), senti_out))
                if cap_added:
                    self._image_ids.add(senti_coco_id)

    def __len__(self):
        return len(self._captions)

    def __getitem__(self, index):
        return self._captions[index]


class ExpertReader:
    def __init__(self, expert_jsonpath: str):
        with open(expert_jsonpath) as f:
            expert_json = json.load(f)
        self._captions: List[Tuple[int, List[str], int]] = []
        self._image_ids: Set[int] = set()
        for item in expert_json:
            image_id = int(item["image_id"])
            sentiment = item.get("sentiment", 0)
            self._image_ids.add(image_id)
            self._captions.append((image_id, tokenize_caption(item["caption"]), sentiment))

    def __len__(self):
        return len(self._captions)

    def __getitem__(self, index):
        return self._captions[index]


class ConstraintBoxesReader:
    def __init__(self, boxes_jsonpath: str):
        with open(boxes_jsonpath) as f:
            _boxes = json.load(f)
        self._image_id_to_boxes: Dict[int, List[dict]] = {}
        for ann in _boxes["annotations"]:
            self._image_id_to_boxes.setdefault(ann["image_id"], []).append(ann)
        self._class_names = {c["id"]: c["name"] for c in _boxes["categories"]}

    def __len__(self):
        return len(self._image_id_to_boxes)

    def __getitem__(self, image_id: int):
        bbox_anns = self._image_id_to_boxes.get(int(image_id), [])
        boxes = np.array([ann["bbox"] for ann in bbox_anns])
        scores = np.array([ann.get("score", 1) for ann in bbox_anns])
        class_names = [self._class_names[ann["category_id"]] for ann in bbox_anns]
        return {"boxes": boxes, "class_names": class_names, "scores": scores}


class CocoAttributesReader:
    """Index over the COCO-Attributes pickles with count-based pruning and
    per-image top-99 truncation (readers.py:294-535)."""

    def __init__(self, attribs_dir_path: str, attrib_selection: Optional[Dict[str, bool]] = None):
        self.attrib_weight_threshold = 0.3
        self.attrib_min_appearance = 20
        self.attribs_n_max_per_image = 99
        if attrib_selection is None:
            from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection

        result = self.read_attributes(attribs_dir_path, attrib_selection)
        (self.image_ids, self.image2obj_insts, self.obj_inst2attrib_inst,
         self.attrib_inst2attrib_vector, self.ignore_attrib_indices,
         self.attrib_names, self.attrib_image_count,
         self.attrib2attrib_inst_count) = result

        self.n_attribs = len(self.attrib_names)
        self.att_counts = np.zeros(self.n_attribs)
        for k, v in self.attrib2attrib_inst_count.items():
            self.att_counts[k] = v

        self.obj_inst2obj_id = load_obj(os.path.join(attribs_dir_path, "obj_inst2obj_id.pkl"))
        self.obj_id2obj_name = load_obj(os.path.join(attribs_dir_path, "obj_id2obj_name.pkl"))

        self.avail_obj_ids: Set[int] = set()
        self.avail_obj_names: Set[str] = set()
        for obj_inst, attrib_inst in self.obj_inst2attrib_inst.items():
            try:
                if self.attrib_inst2attrib_vector[attrib_inst].sum() > 0:
                    oid = self.obj_inst2obj_id[obj_inst]
                    self.avail_obj_ids.add(oid)
                    self.avail_obj_names.add(self.obj_id2obj_name[oid])
            except (KeyError, AttributeError):
                pass

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, image_id: int):
        result = []
        for obj_inst in self.image2obj_insts[image_id]:
            if obj_inst in self.obj_inst2attrib_inst:
                attrib_inst = self.obj_inst2attrib_inst[obj_inst]
                try:
                    vec = self.attrib_inst2attrib_vector[attrib_inst]
                    if vec.sum() > 0:
                        result.append([
                            self.obj_id2obj_name[self.obj_inst2obj_id[obj_inst]],
                            [[self.attrib_names[x], vec[x]] for x in np.nonzero(vec)[0]],
                        ])
                except KeyError:
                    pass
        return self.filter_duplicates(result)

    @staticmethod
    def filter_duplicates(result):
        """Merge objects with the same name, max-merging attribute weights
        (readers.py:370-386)."""
        filtered: Dict[str, list] = {}
        for obj in result:
            if obj[0] not in filtered:
                filtered[obj[0]] = obj[1]
            else:
                names = [a[0] for a in filtered[obj[0]]]
                for attrib in obj[1]:
                    try:
                        idx = names.index(attrib[0])
                        filtered[obj[0]][idx][1] = max(filtered[obj[0]][idx][1], attrib[1])
                    except ValueError:
                        filtered[obj[0]].append(attrib)
        return [[k, v] for k, v in filtered.items()]

    def read_attributes(self, attribs_dir_path: str, attrib_selection: Dict[str, bool],
                        ignore_attrib_indices=None):
        """Full index construction (readers.py:389-535)."""
        p = lambda name: os.path.join(attribs_dir_path, name)
        attrib_inst2attrib_vector = load_obj(p("attrib_inst2attrib_vector.pkl"))
        attrib_inst2obj_inst = load_obj(p("attrib_inst2obj_inst.pkl"))
        obj_inst2attrib_inst = load_obj(p("obj_inst2attrib_inst.pkl"))
        obj_inst2image = load_obj(p("obj_inst2image.pkl"))
        image2obj_insts = load_obj(p("image2obj_insts.pkl"))
        attrib2string = load_obj(p("attrib2string.pkl"))

        attrib_names = [attrib2string[k] for k in sorted(attrib2string.keys())]
        sel = np.array([int(v) for v in attrib_selection.values()])
        ignore_sel = np.argwhere(sel == 0)
        attrib_names = np.delete(attrib_names, ignore_sel).tolist()

        attrib2attrib_inst_count: Dict[int, int] = {}
        attrib_image_count: Dict[int, int] = {}
        attrib2images: Dict[int, Set[int]] = {}
        for att_id, atts in list(attrib_inst2attrib_vector.items()):
            instance_id = attrib_inst2obj_inst[att_id]
            try:
                coco_id = obj_inst2image[instance_id]
            except KeyError:
                del attrib_inst2attrib_vector[att_id]
                continue
            atts = np.delete(atts, ignore_sel)
            idxs_larger = [i[0] for i in np.argwhere(atts >= self.attrib_weight_threshold)]
            atts = np.where(atts < self.attrib_weight_threshold, 0.0, atts)
            attrib_inst2attrib_vector[att_id] = atts
            for idx in idxs_larger:
                attrib2attrib_inst_count[idx] = attrib2attrib_inst_count.get(idx, 0) + 1
                attrib2images.setdefault(idx, set()).add(coco_id)

        for att_id, image_ids in attrib2images.items():
            attrib_image_count[att_id] = len(image_ids)

        if ignore_attrib_indices is None:
            ignore_attrib_indices = [[att_id] for att_id, count in attrib_image_count.items()
                                     if count < self.attrib_min_appearance]
        attrib_names = np.delete(attrib_names, ignore_attrib_indices).tolist()

        # per-image top-99 truncation by rarity (readers.py:465-498)
        for image_id, obj_insts in image2obj_insts.items():
            attrib_insts = [obj_inst2attrib_inst[o] for o in obj_insts
                            if o in obj_inst2attrib_inst]
            attrib_insts = [a for a in attrib_insts if a in attrib_inst2attrib_vector]
            if not attrib_insts:
                continue
            atts = np.sum([attrib_inst2attrib_vector[a] for a in attrib_insts], axis=0)
            idxs_larger = [i[0] for i in np.argwhere(atts > 0)]
            n_attribs = min(len(idxs_larger), self.attribs_n_max_per_image)
            atts_count = np.full(atts.shape, 99999.0)
            for idx in idxs_larger:
                atts_count[idx] = attrib_image_count.get(idx, 99999)
            final_idxs = np.argsort(atts_count)[:n_attribs]
            for attrib_inst in attrib_insts:
                atts_new = np.zeros(atts.shape)
                for idx in final_idxs:
                    atts_new[idx] = attrib_inst2attrib_vector[attrib_inst][idx]
                attrib_inst2attrib_vector[attrib_inst] = atts_new

        # rebuild counts with pruned attributes removed (readers.py:501-525)
        attrib2attrib_inst_count = {}
        attrib2images = {}
        for att_id, atts in attrib_inst2attrib_vector.items():
            instance_id = attrib_inst2obj_inst[att_id]
            coco_id = obj_inst2image[instance_id]
            atts = np.delete(atts, ignore_attrib_indices)
            attrib_inst2attrib_vector[att_id] = atts
            for idx in (i[0] for i in np.argwhere(atts > 0)):
                attrib2attrib_inst_count[idx] = attrib2attrib_inst_count.get(idx, 0) + 1
                attrib2images.setdefault(idx, set()).add(coco_id)

        attrib_image_count = {a: len(s) for a, s in attrib2images.items()}
        image_ids = set(i for s in attrib2images.values() for i in s)
        return (list(image_ids), image2obj_insts, obj_inst2attrib_inst,
                attrib_inst2attrib_vector, ignore_attrib_indices, attrib_names,
                attrib_image_count, attrib2attrib_inst_count)


def obj_atts_id2string(obj_voc: Sequence[str], atts_voc: Sequence[str], obj_atts,
                       avail_obj_names: Set[str], att_pred_thresh: float,
                       use_obj_att_preds: bool):
    """Map packed id-form obj_atts to name form (datasets.py:640-668)."""
    out = []
    for obj in obj_atts:
        obj_new = [obj_voc[obj[0]], []]
        if (not use_obj_att_preds) or (obj_voc[obj[0]] in avail_obj_names):
            for att in obj[1]:
                if att[1] >= att_pred_thresh:
                    obj_new[1].append(atts_voc[att[0]])
        out.append(obj_new)
    return out
