"""Training and evaluation datasets of the captioner (copy of
``style_seqcvae_tpu/data/datasets.py:1-675``).

Behavioral mirrors of updown-baseline/updown/data/datasets.py:

* :class:`TrainingDataset` (:18-202): COCO + Senticap composition with 20×
  Senticap oversampling when mixed (:50-51), Senticap-test leakage removal
  (:72-76), attribute-presence and feature-presence filtering (:78-92),
  tokenize/truncate/pad to ``max_caption_length`` with ``@@UNKNOWN@@``
  (:153-161); ``feature_table`` and ``obj_att_embed_table`` for the train
  step's device corpus.
* :class:`EvaluationDataset` (:205-368): image-id driven, Senticap test ids
  under ``DO_LOAD_SENTICAP``, hard-coded object-name fixups (:252-263),
  sentiment from config.
* :class:`EvaluationDatasetWithConstraints` (:368-637): CBS candidate
  selection (cbs_simple picks one random attribute per detected object up
  to MAX_GIVEN_CONSTRAINTS, or the sentiment word: :491-525; grounded mode
  mixes objects and attributes: :527-577), one FSM per z-sample under
  ``STATE_MACHINE_PER_Z_SAMPLE`` (:582-602), and a collate that trims each
  FSM to its used states and also emits the packed and exception-table
  forms the decode reads.

Batches are fixed-shape numpy (image features padded to
``DATA.MAX_BOXES``). Candidates are drawn from the ``random`` module unless
an ``rng`` is given, so a run seeded as the JAX CLI seeds it draws the same
ones.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np

from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection
from style_seqcvae_tpu_torch.data.readers import (
    CocoAttributesReader,
    CocoCaptionsReader,
    ConstraintBoxesReader,
    ExpertReader,
    SenticapReader,
    obj_atts_id2string,
)
from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary
from style_seqcvae_tpu_torch.decoding.cbs_fast import fsm_to_tables
from style_seqcvae_tpu_torch.decoding.constraint_filter import ConstraintFilter
from style_seqcvae_tpu_torch.decoding.fsm import FiniteStateMachineBuilder, pack_fsm
from style_seqcvae_tpu_torch.utils.features_io import FeaturesReader

# Hard-coded object-name fixups applied by the reference for COCO ids whose
# detector names differ from attribute/wordform names (datasets.py:252-263).
OBJ_NAME_FIXUPS = {
    64: "plant", 72: "television", 76: "computer keyboard", 77: "mobile phone",
    78: "microwave oven", 35: "ski", 47: "mug", 60: "doughnut",
    75: "remote control", 34: "flying disc", 21: "cattle", 89: "hair dryer",
}


def collate_image_features(feature_list: List[np.ndarray], max_boxes: int) -> np.ndarray:
    """Zero-pad each (n_i, F) to (max_boxes, F); fixed shape for XLA
    (reference pads to batch max at datasets.py:623-632)."""
    F = feature_list[0].shape[-1]
    out = np.zeros((len(feature_list), max_boxes, F), np.float32)
    for i, feats in enumerate(feature_list):
        n = min(feats.shape[0], max_boxes)
        out[i, :n] = feats[:n]
    return out


def _collate_obj_atts(batch_list: List[Dict[str, Any]]):
    """Per-item obj_atts presence can differ within a batch (e.g. train and
    val h5 readers where only one file carries the packed streams) — an
    item without them means "no attribute detections" (empty list), and the
    batch key is None only when NO item has them. Deciding from item 0
    alone either crashed downstream iteration on a None or silently zeroed
    the mode-2 prior for the whole batch."""
    oa = [x["obj_atts"] for x in batch_list]
    if all(o is None for o in oa):
        return None
    return [o if o is not None else [] for o in oa]

def _obj_id2name_from_reader(reader) -> list:
    """Default object-id -> name table from the COCO-Attributes pickles'
    obj_id2obj_name map (the reference gets names from the imdb class list;
    the CLIs have no imdb, and without this mode-2's obj_atts_id2string
    would index an empty list)."""
    m = reader.obj_id2obj_name
    out = [""] * (max(m) + 1 if m else 0)
    for i, n in m.items():
        out[int(i)] = n
    return out


class TrainingDataset:
    """Caption items for training (JAX ``data/datasets.py:89-348``): the COCO
    captions, with Senticap's train and val splits added 20 times over when
    both are loaded, or Senticap alone; the expert captions; Senticap's test
    images removed; optionally only images with attributes; captions whose
    image has no feature row dropped and counted."""

    def __init__(
        self,
        vocabulary: Vocabulary,
        captions_jsonpath: str = "",
        senticap_jsonpath: str = "",
        expert_jsonpath: str = "",
        do_load_coco: bool = True,
        do_load_senticap: bool = False,
        image_features_h5path: str = "",
        image_features_h5path_valid: str = "",
        attribs_dir_path: str = "",
        use_obj_att_preds: bool = False,
        att_pred_thresh: float = 0.3,
        remove_samples_without_attribs: bool = False,
        max_caption_length: int = 20,
        max_boxes: int = 100,
        in_memory: bool = False,
        sentiment: Optional[str] = None,
        obj_id2name: Optional[List[str]] = None,
    ):
        self._vocabulary = vocabulary
        self._max_caption_length = max_caption_length
        self._max_boxes = max_boxes
        self.sentiment = sentiment
        self.use_obj_att_preds = use_obj_att_preds
        self.att_pred_thresh = att_pred_thresh
        self.obj_id2name = obj_id2name or []
        # Device-resident corpus mode (train.py --device-corpus): __getitem__
        # skips the per-item feature read entirely — the whole feature table
        # ships to HBM once via feature_table() and the train step gathers
        # rows by index on device, so per-step host work is tokens-only.
        self.skip_feature_read = False

        self._features = (FeaturesReader(image_features_h5path, in_memory,
                                         use_obj_att_preds)
                          if image_features_h5path else None)
        self._features_valid = (FeaturesReader(image_features_h5path_valid, in_memory,
                                               use_obj_att_preds)
                               if image_features_h5path_valid else None)

        self._captions: List = []
        if do_load_coco and captions_jsonpath:
            self._captions = list(CocoCaptionsReader(captions_jsonpath)._captions)
            if do_load_senticap and senticap_jsonpath:
                senti = SenticapReader(senticap_jsonpath, train_split=True,
                                       val_split=True, sentiment=None)
                for _ in range(20):  # 20× oversampling (datasets.py:50-51)
                    self._captions.extend(senti._captions)
        elif do_load_senticap and senticap_jsonpath:
            self._captions = list(SenticapReader(senticap_jsonpath, train_split=True,
                                                 val_split=True, sentiment=None)._captions)

        if expert_jsonpath:
            expert = ExpertReader(expert_jsonpath)
            self._captions.extend(expert._captions)

        if senticap_jsonpath:
            # remove Senticap-TEST images from training (datasets.py:72-76)
            test_ids = SenticapReader(senticap_jsonpath, test_split=True)._image_ids
            self._captions = [x for x in self._captions if x[0] not in test_ids]

        self.coco_attributes_reader: Optional[CocoAttributesReader] = None
        if attribs_dir_path:
            self.coco_attributes_reader = CocoAttributesReader(attribs_dir_path)
            if not self.obj_id2name:
                self.obj_id2name = _obj_id2name_from_reader(
                    self.coco_attributes_reader)
            if remove_samples_without_attribs:
                with_atts = set(self.coco_attributes_reader.image_ids)
                self._captions = [x for x in self._captions if x[0] in with_atts]
        if self._features is not None:
            # drop captions whose image has no feature row IN EITHER file
            # (previously only under the attribs branch): the reference
            # reader silently DEFAULTS missing ids (readers.py:128-137);
            # here the skip is explicit and counted — e.g. Senticap
            # val-split images that were never run through feat_extract
            avail = set(self._features.image_ids)
            if self._features_valid is not None:
                avail |= set(self._features_valid.image_ids)
            before = len(self._captions)
            self._captions = [x for x in self._captions if x[0] in avail]
            if len(self._captions) != before:
                print(f"dropped {before - len(self._captions)} caption(s) "
                      "whose image has no feature row (reference "
                      "readers.py:128-137 would silently default them)")

    @classmethod
    def from_config(cls, config, vocabulary, in_memory=False, obj_id2name=None):
        _C = config
        return cls(
            vocabulary=vocabulary,
            image_features_h5path=_C.DATA.TRAIN_FEATURES,
            image_features_h5path_valid=_C.DATA.INFER_FEATURES,
            captions_jsonpath=_C.DATA.TRAIN_CAPTIONS,
            senticap_jsonpath=_C.DATA.SENTICAP_CAPTIONS,
            expert_jsonpath=_C.DATA.EXPERT_CAPTIONS,
            do_load_coco=_C.DATA.DO_LOAD_COCO,
            do_load_senticap=_C.DATA.DO_LOAD_SENTICAP,
            attribs_dir_path=_C.DATA.COCO_ATTRIBS_OBJS,
            use_obj_att_preds=_C.DATA.USE_OBJ_ATT_PREDS,
            att_pred_thresh=_C.DATA.ATT_PRED_THRESH,
            remove_samples_without_attribs=_C.DATA.REMOVE_SAMPLES_WITHOUT_ATTRIBS,
            max_caption_length=_C.DATA.MAX_CAPTION_LENGTH,
            max_boxes=_C.DATA.MAX_BOXES,
            in_memory=in_memory,
            sentiment=_C.DATA.SENTICAP_SENTIMENT,
            obj_id2name=obj_id2name,
        )

    def __len__(self):
        return len(self._captions)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        entry = self._captions[index]
        if len(entry) == 3:
            image_id, caption, sentiment = entry
            if sentiment == 0:
                sentiment = -1
        else:
            image_id, caption = entry
            sentiment = 0

        image_features, obj_atts = None, None
        if self._features is not None and not self.skip_feature_read:
            try:
                image_features, obj_atts = self._features[image_id]
            except KeyError:
                image_features, obj_atts = self._features_valid[image_id]

        if self.coco_attributes_reader is not None and obj_atts is not None:
            obj_atts = obj_atts_id2string(
                self.obj_id2name, self.coco_attributes_reader.attrib_names,
                obj_atts, self.coco_attributes_reader.avail_obj_names,
                self.att_pred_thresh, self.use_obj_att_preds)

        image_attributes = None
        if self.coco_attributes_reader is not None:
            try:
                image_attributes = self.coco_attributes_reader[image_id]
            except KeyError:
                image_attributes = None

        tokens = [self._vocabulary.get_token_index(c) for c in caption]
        tokens = tokens[: self._max_caption_length]
        tokens.extend([self._vocabulary.unk_index]
                      * (self._max_caption_length - len(tokens)))

        return {"image_id": image_id, "image_features": image_features,
                "caption_tokens": tokens, "image_attributes": image_attributes,
                "sentiment": sentiment, "obj_atts": obj_atts}

    def collate_fn(self, batch_list: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {
            "image_id": np.asarray([x["image_id"] for x in batch_list], np.int64),
            "caption_tokens": np.asarray([x["caption_tokens"] for x in batch_list],
                                         np.int32),
            "sentiment": np.asarray([[x["sentiment"]] for x in batch_list],
                                    np.float32),
            "image_attributes": [x["image_attributes"] for x in batch_list],
        }
        if batch_list[0]["image_features"] is not None:
            batch["image_features"] = collate_image_features(
                [x["image_features"] for x in batch_list], self._max_boxes)
        batch["obj_atts"] = _collate_obj_atts(batch_list)
        return batch

    def feature_table(self):
        """The full feature corpus as one dense array, for the train step's
        device corpus (train CLI ``--device-corpus``): the table goes to the
        card once and each step gathers its rows by index, in place of
        shipping batch · boxes · F floats through the host every step.

        Returns ``(table, row_of)``: ``table`` is (num_images, max_boxes,
        feat_dim) float32 zero-padded over boxes, ``row_of`` maps image_id
        → table row."""
        if self._features is None:
            raise ValueError("dataset has no features reader")
        readers = [self._features]
        if self._features_valid is not None:
            readers.append(self._features_valid)
        ids, feats0 = [], None
        for r in readers:
            ids.extend(r.image_ids)
        row_of = {iid: i for i, iid in enumerate(dict.fromkeys(ids))}
        for r in readers:
            feats0, _ = r[r.image_ids[0]]
            break
        table = np.zeros((len(row_of), self._max_boxes, feats0.shape[-1]),
                         np.float32)
        written = set()
        for r in readers:
            for iid in r.image_ids:
                if iid in written:
                    # ids in BOTH files keep the train reader's features —
                    # __getitem__'s precedence (valid only on KeyError)
                    continue
                written.add(iid)
                f, _ = r[iid]
                n = min(f.shape[0], self._max_boxes)
                table[row_of[iid], :n] = f[:n]
        return table, row_of

    def obj_att_embed_table(self, latent_dict, row_of) -> np.ndarray:
        """(num_images, max_boxes, z_space) mode-2 prior-embedding table in
        :meth:`feature_table` row order, so that the device corpus gathers
        both tables by the same ``feat_idx``. The host-side equivalent of
        the reference's per-batch ``translate_obj_atts2obj_means``
        (updown_captioner.py:509-532), computed once for the corpus."""
        out = np.zeros((len(row_of), self._max_boxes, latent_dict.z_space),
                       np.float32)
        for iid, row in row_of.items():
            try:
                _, obj_atts = self._features[iid]
            except KeyError:
                _, obj_atts = self._features_valid[iid]
            if self.coco_attributes_reader is not None and obj_atts is not None:
                obj_atts = obj_atts_id2string(
                    self.obj_id2name, self.coco_attributes_reader.attrib_names,
                    obj_atts, self.coco_attributes_reader.avail_obj_names,
                    self.att_pred_thresh, self.use_obj_att_preds)
            out[row] = latent_dict.translate_obj_atts(
                [obj_atts or []], self._max_boxes)[0]
        return out

    def batches(self, batch_size: int, rng: Optional[random.Random] = None,
                process_shard: Optional[tuple] = None):
        """Infinite shuffled batch generator (updown/utils/common.py:7-27
        ``cycle`` semantics); partial trailing batches are dropped (one
        batch shape throughout).

        ``process_shard=(index, count)``: every process shuffles the same
        global order (same seeded ``rng``) and takes a disjoint stride of
        it, so ``count`` processes each yielding ``batch_size`` rows jointly
        cover one ``batch_size·count`` global batch with no duplicates."""
        shard_index, shard_count = process_shard or (0, 1)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"bad process_shard ({shard_index}, {shard_count})")
        if batch_size * shard_count > len(self):
            # range() below would be empty and the while-True would spin
            # forever without yielding — indistinguishable from a hang
            raise ValueError(
                f"batch_size {batch_size} x {shard_count} process(es) "
                f"exceeds dataset size {len(self)}; no full batch can ever "
                "be formed")
        rng = rng or random.Random(0)
        while True:
            order = list(range(len(self)))
            rng.shuffle(order)
            order = order[shard_index::shard_count]
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start:start + batch_size]
                yield self.collate_fn([self[i] for i in idx])


class EvaluationDataset:
    def __init__(
        self,
        train_image_features_h5path: str = "",
        val_image_features_h5path: str = "",
        val_captions_jsonpath: str = "",
        do_load_coco: bool = False,
        do_load_senticap: bool = False,
        senticap_jsonpath: str = "",
        attribs_dir_path: str = "",
        use_obj_att_preds: bool = False,
        att_pred_thresh: float = 0.3,
        remove_samples_without_attribs: bool = False,
        max_boxes: int = 100,
        in_memory: bool = False,
        sentiment: Optional[str] = None,
        obj_id2name: Optional[List[str]] = None,
    ):
        self._max_boxes = max_boxes
        self.use_obj_att_preds = use_obj_att_preds
        self.att_pred_thresh = att_pred_thresh
        self.obj_id2name = obj_id2name or []
        self.sentiment = sentiment

        self._train_features = (FeaturesReader(train_image_features_h5path, in_memory,
                                               use_obj_att_preds)
                                if train_image_features_h5path else None)
        self._val_features = (FeaturesReader(val_image_features_h5path, in_memory,
                                             use_obj_att_preds)
                             if val_image_features_h5path else None)

        ids: List[int] = []
        if do_load_senticap:
            if self._train_features:
                ids += self._train_features.image_ids
            if self._val_features:
                ids += self._val_features.image_ids
            ids = sorted(ids)
        elif self._val_features:
            ids = sorted(self._val_features.image_ids)
        if do_load_coco and val_captions_jsonpath:
            reader = CocoCaptionsReader(val_captions_jsonpath)
            ids = list(set(x[0] for x in reader._captions))
        if do_load_senticap and senticap_jsonpath:
            senti = SenticapReader(senticap_jsonpath, test_split=True,
                                   sentiment=sentiment)
            ids = list(senti._image_ids)
        self._image_ids = ids

        self.coco_attributes_reader: Optional[CocoAttributesReader] = None
        if attribs_dir_path:
            self.coco_attributes_reader = CocoAttributesReader(attribs_dir_path)
            if not self.obj_id2name:
                self.obj_id2name = _obj_id2name_from_reader(
                    self.coco_attributes_reader)
            if remove_samples_without_attribs:
                with_atts = set(self.coco_attributes_reader.image_ids)
                self._image_ids = [x for x in self._image_ids if x in with_atts]
            for k, v in OBJ_NAME_FIXUPS.items():
                self.coco_attributes_reader.obj_id2obj_name[k] = v

        avail = set()
        if self._train_features:
            avail |= set(self._train_features.image_ids)
        if self._val_features:
            avail |= set(self._val_features.image_ids)
        if avail:
            self._image_ids = [x for x in self._image_ids if x in avail]

    @classmethod
    def from_config(cls, config, in_memory=False, obj_id2name=None, **kwargs):
        _C = config
        return cls(
            train_image_features_h5path=_C.DATA.TRAIN_FEATURES,
            val_image_features_h5path=_C.DATA.INFER_FEATURES,
            val_captions_jsonpath=_C.DATA.INFER_CAPTIONS,
            do_load_coco=_C.DATA.DO_LOAD_COCO,
            do_load_senticap=_C.DATA.DO_LOAD_SENTICAP,
            senticap_jsonpath=_C.DATA.SENTICAP_CAPTIONS,
            attribs_dir_path=_C.DATA.COCO_ATTRIBS_OBJS,
            use_obj_att_preds=_C.DATA.USE_OBJ_ATT_PREDS,
            att_pred_thresh=_C.DATA.ATT_PRED_THRESH,
            remove_samples_without_attribs=_C.DATA.REMOVE_SAMPLES_WITHOUT_ATTRIBS,
            max_boxes=_C.DATA.MAX_BOXES,
            in_memory=in_memory,
            sentiment=_C.DATA.SENTICAP_SENTIMENT,
            obj_id2name=obj_id2name,
            **kwargs,
        )

    def __len__(self):
        return len(self._image_ids)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        image_id = self._image_ids[index]
        try:
            image_features, obj_atts = self._train_features[image_id]
        except (KeyError, TypeError):
            image_features, obj_atts = self._val_features[image_id]

        if self.coco_attributes_reader is not None and obj_atts is not None:
            obj_atts = obj_atts_id2string(
                self.obj_id2name, self.coco_attributes_reader.attrib_names,
                obj_atts, self.coco_attributes_reader.avail_obj_names,
                self.att_pred_thresh, self.use_obj_att_preds)

        image_attributes = None
        if self.coco_attributes_reader is not None:
            try:
                image_attributes = self.coco_attributes_reader[image_id]
            except KeyError:
                image_attributes = None

        sentiment = {"pos": 1, "neg": -1}.get(self.sentiment or "", 0)
        return {"image_id": image_id, "image_features": image_features,
                "image_attributes": image_attributes, "sentiment": sentiment,
                "obj_atts": obj_atts}

    def collate_fn(self, batch_list: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {
            "image_id": np.asarray([x["image_id"] for x in batch_list], np.int64),
            "image_features": collate_image_features(
                [x["image_features"] for x in batch_list], self._max_boxes),
            "image_attributes": [x["image_attributes"] for x in batch_list],
            "sentiment": np.asarray([[x["sentiment"]] for x in batch_list], np.float32),
            "candidates": None, "constraint2states": None,
        }
        batch["obj_atts"] = _collate_obj_atts(batch_list)
        return batch


class EvaluationDatasetWithConstraints(EvaluationDataset):
    def __init__(self, vocabulary: Vocabulary, *,
                 boxes_jsonpath: str = "",
                 wordforms_tsvpath: str = "",
                 wordforms_attribs_tsvpath: str = "",
                 hierarchy_jsonpath: str = "",
                 nms_threshold: float = 0.85,
                 max_given_objects: int = 2,
                 max_given_constraints: int = 3,
                 max_words_per_constraint: int = 3,
                 state_machine_per_z_sample: bool = False,
                 n_z_samples: int = 1,
                 cbs_simple: bool = True,
                 rng: Optional[random.Random] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self._vocabulary = vocabulary
        self._max_given_objects = max_given_objects
        self._max_given_constraints = max_given_constraints
        self.state_machine_per_z_sample = state_machine_per_z_sample
        self.n_z_samples = max(n_z_samples, 1)
        self.cbs_simple = cbs_simple
        self._rng = rng or random

        self._boxes_reader = (ConstraintBoxesReader(boxes_jsonpath)
                              if boxes_jsonpath else None)
        if self._boxes_reader and self.coco_attributes_reader:
            for k, v in OBJ_NAME_FIXUPS.items():
                self._boxes_reader._class_names[k] = v

        self._fsm_builder = FiniteStateMachineBuilder(
            vocabulary, wordforms_tsvpath, wordforms_attribs_tsvpath,
            max_given_constraints, max_words_per_constraint,
            use_coco_attributes=self.coco_attributes_reader is not None,
            attrib_selection=attrib_selection)

        if hierarchy_jsonpath:
            self._constraint_filter = ConstraintFilter(
                hierarchy_jsonpath, nms_threshold, max_given_objects)
        else:
            self._constraint_filter = None

    @classmethod
    def from_config(cls, config, vocabulary, in_memory=False, obj_id2name=None):
        _C = config
        return cls(
            vocabulary=vocabulary,
            train_image_features_h5path=_C.DATA.TRAIN_FEATURES,
            val_image_features_h5path=_C.DATA.INFER_FEATURES,
            val_captions_jsonpath=_C.DATA.INFER_CAPTIONS,
            do_load_coco=_C.DATA.DO_LOAD_COCO,
            do_load_senticap=_C.DATA.DO_LOAD_SENTICAP,
            senticap_jsonpath=_C.DATA.SENTICAP_CAPTIONS,
            attribs_dir_path=_C.DATA.COCO_ATTRIBS_OBJS,
            use_obj_att_preds=_C.DATA.USE_OBJ_ATT_PREDS,
            att_pred_thresh=_C.DATA.ATT_PRED_THRESH,
            remove_samples_without_attribs=_C.DATA.REMOVE_SAMPLES_WITHOUT_ATTRIBS,
            max_boxes=_C.DATA.MAX_BOXES,
            in_memory=in_memory,
            sentiment=_C.DATA.SENTICAP_SENTIMENT,
            obj_id2name=obj_id2name,
            boxes_jsonpath=_C.DATA.CBS.INFER_BOXES,
            wordforms_tsvpath=_C.DATA.CBS.WORDFORMS,
            wordforms_attribs_tsvpath=_C.DATA.CBS.WORDFORMS_ATTRIBS,
            hierarchy_jsonpath=_C.DATA.CBS.CLASS_HIERARCHY,
            nms_threshold=_C.DATA.CBS.NMS_THRESHOLD,
            max_given_objects=_C.DATA.CBS.MAX_GIVEN_OBJECTS,
            max_given_constraints=_C.DATA.CBS.MAX_GIVEN_CONSTRAINTS,
            max_words_per_constraint=_C.DATA.CBS.MAX_WORDS_PER_CONSTRAINT,
            state_machine_per_z_sample=_C.MODEL.STATE_MACHINE_PER_Z_SAMPLE,
            n_z_samples=_C.MODEL.N_Z_SAMPLES,
            cbs_simple=_C.MODEL.CBS_SIMPLE,
        )

    def generate_cbs_state_machine(self, item: Dict[str, Any]):
        """Candidate selection + FSM build (datasets.py:470-580)."""
        candidates_obj: List[str] = []
        if self._boxes_reader is not None:
            constraint_boxes = self._boxes_reader[item["image_id"]]
            areas: Dict[str, float] = {}
            for bbox, classname in zip(constraint_boxes["boxes"],
                                       constraint_boxes["class_names"]):
                areas[classname] = areas.get(classname, 0.0) + bbox[2] * bbox[3]
            candidates_obj = [k for k, v in sorted(areas.items(),
                                                   key=lambda kv: kv[1], reverse=True)]

        image_attributes = item["image_attributes"]
        if image_attributes:
            image_attributes.sort(key=lambda x: len(x[1]))

        if self.cbs_simple:
            if self.coco_attributes_reader is not None:
                # one random attribute per detected object (datasets.py:498-518)
                objs: Dict[str, set] = {o[0]: set() for o in (item["obj_atts"] or [])}
                for obj in (item["obj_atts"] or []):
                    for a in obj[1]:
                        att_cleaned = a.split(" ")[-1] or a.split(" ")[-2]
                        objs[obj[0]].add(att_cleaned)
                candidates = []
                for obj, atts in objs.items():
                    if atts:
                        candidates.append(self._rng.sample(sorted(atts), 1)[0])
                candidates = candidates[: self._max_given_constraints]
            else:
                # the sentiment word as every constraint (datasets.py:521-523)
                candidates = [self.sentiment] * self._max_given_constraints
            fsm_input = candidates
        else:
            # grounded mode (datasets.py:527-577)
            candidates = []
            objects_with_attributes = [o[0] for o in (image_attributes or [])]
            objects_without_attributes = [[o, []] for o in candidates_obj
                                          if o not in objects_with_attributes]
            n_atts_per_obj = 2 if len(objects_with_attributes) <= 2 else 1
            attribs_already_added: List[str] = []
            n_objects_added = 0
            for o in (image_attributes or [])[:3]:
                new_cand_attribs = []
                atts = [a[0] for a in o[1]]
                k = 0
                while k < n_atts_per_obj:
                    if len(atts) == 0:
                        break
                    sample = self._rng.choice(atts)
                    sample_cleaned = sample.split(" ")[-1] or sample.split(" ")[-2]
                    atts.remove(sample)
                    if sample not in attribs_already_added:
                        new_cand_attribs.append(sample_cleaned)
                        attribs_already_added.append(sample)
                        k += 1
                candidates.append([o[0], new_cand_attribs])
                n_objects_added += 1
            n_avail = min(self._max_given_objects - n_objects_added,
                          self._max_given_constraints - n_objects_added
                          - len(attribs_already_added))
            # NO clamp at 0: a NEGATIVE slot count uses Python negative-
            # slice semantics (keep all but the last |n| entries) exactly
            # like the reference (datasets.py:568-570) — clamping changed
            # the grounded-mode candidate list whenever more objects were
            # added than MAX_GIVEN_OBJECTS
            candidates.extend(objects_without_attributes[:n_avail])
            fsm_input = []
            for o in candidates:
                fsm_input.extend(o[1])
            fsm_input = fsm_input[: self._max_given_constraints]

        fsm, nstates, constraint2states = self._fsm_builder.build(fsm_input)
        return fsm, nstates, constraint2states, candidates, fsm_input

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = super().__getitem__(index)
        fsm, nstates, num_constraints = [], [], []
        candidates, constraint2states = [], []
        for _ in range(self.n_z_samples):
            result = self.generate_cbs_state_machine(item)
            fsm.append(result[0])
            nstates.append(result[1])
            constraint2states.append(result[2])
            candidates.append(result[3])
            num_constraints.append(len(result[4]))
            if not self.state_machine_per_z_sample:
                break
        return {"fsm": fsm, "num_states": nstates,
                "num_constraints": num_constraints, "candidates": candidates,
                "constraint2states": constraint2states, **item}

    def collate_fn(self, batch_list):
        """bs=1 collate (the reference forces it, inference.py:89-95): trims
        each z-sample's FSM to its used states and also emits the packed and
        exception-table device forms."""
        batch = super().collate_fn(batch_list)
        assert len(batch_list) == 1, "CBS evaluation uses batch size 1"
        item = batch_list[0]
        fsm_trimmed, packed, tables = [], [], []
        for k in range(len(item["fsm"])):
            max_state = max(item["num_states"][k], 8)
            f = item["fsm"][k][:max_state, :max_state, :]
            fsm_trimmed.append(f[None])
            packed.append(pack_fsm(f))
            tables.append(fsm_to_tables(f))
        batch.update({
            "fsm": fsm_trimmed,
            "fsm_packed": packed,
            "fsm_tables": tables,
            "num_constraints": np.asarray(item["num_constraints"], np.int64),
            "candidates": item["candidates"],
            "constraint2states": item["constraint2states"],
        })
        return batch
