"""Named spans of the port's decode and serving chain, recorded into
``torch.profiler``'s own trace.

:func:`span` opens a ``torch.profiler.record_function`` range while a
profiler records (``torch.profiler.profile``, ``emit_nvtx``) and otherwise
returns one shared no-op context: an unconditional ``record_function``
costs ~15 µs a span on a host with no profiler, the check ~0.6 µs. The
ranges live in the profiler's memory until it stops and land in its trace
beside the kernels, on the same clock; a kernel belongs to the spans its
launch fell in. Parents follow from nesting on one thread:

==========================  ==========================  =====================================
span                        parent                      covers
==========================  ==========================  =====================================
``ssc.decode_cbs``          (the caller's)              ``DecodeHarness.decode_cbs``, one
                                                        device's whole decode
``ssc.cbs.setup``           ``ssc.decode_cbs``          tables and noise to the card, the
                                                        step's constant tables; in the search,
                                                        its first step and constant masks
``ssc.step``                ``ssc.cbs.setup`` (first    one optimized model step (also under
                            step), else                 beam search and the samplers, whose
                            ``ssc.decode_cbs``          callers are its parents)
``ssc.step.attention``      ``ssc.step``                the BUTD attention over (rows, N, P)
``ssc.cbs.select``          ``ssc.decode_cbs``          a step's vocabulary selection through
                                                        end freezing
``ssc.cbs.search``          ``ssc.decode_cbs``          a step's candidates, top-k, gathers
                                                        and beam picks
``ssc.cbs.finish``          ``ssc.decode_cbs``          sequences from back-pointers, the
                                                        best beam, the z-major views
``ssc.prepare``             (the caller's)              ``data/detection.py::prepare_image``:
                                                        one image's mean subtraction and
                                                        resize
``ssc.detect``              (the caller's)              ``serve.detect``: the detector forward
                                                        and the device selection
``ssc.detect.backbone``     ``ssc.detect``              the ResNet or VGG16 trunk to the C4 map
``ssc.detect.rpn``          ``ssc.detect``              the RPN's heads, the proposal layer and
                                                        its NMS (kernel D)
``ssc.detect.roi_head``     ``ssc.detect``              RoI pooling (kernel C), the head
                                                        (layer4 or fc6 / fc7) and the class,
                                                        box and attribute heads
``ssc.detect.select``       ``ssc.detect``              box decoding, the per-class NMS
                                                        (kernel D), the top detections and
                                                        their gathers
``ssc.constrain``           (the caller's)              ``serve.constrain``: the attribute
                                                        constraints and the FSM tables
==========================  ==========================  =====================================

``serve.caption`` opens no span of its own: its work is the
``ssc.decode_cbs`` tree. The detector's spans are opened wherever
``detector_forward_test`` and ``extract_device_features`` run (the extract
CLI too).

The benchmark's readers look for these names: the decode's in
``benchmark/spans.py`` (:data:`NAMES`), the serving chain's in
``benchmark/pipeline_spans.py`` (:data:`SERVE_NAMES`).
"""

from __future__ import annotations

import contextlib

import torch

DECODE_CBS = "ssc.decode_cbs"
CBS_SETUP = "ssc.cbs.setup"
STEP = "ssc.step"
STEP_ATTENTION = "ssc.step.attention"
CBS_SELECT = "ssc.cbs.select"
CBS_SEARCH = "ssc.cbs.search"
CBS_FINISH = "ssc.cbs.finish"

NAMES = (DECODE_CBS, CBS_SETUP, STEP, STEP_ATTENTION, CBS_SELECT, CBS_SEARCH, CBS_FINISH)

PREPARE = "ssc.prepare"
DETECT = "ssc.detect"
DETECT_BACKBONE = "ssc.detect.backbone"
DETECT_RPN = "ssc.detect.rpn"
DETECT_ROI_HEAD = "ssc.detect.roi_head"
DETECT_SELECT = "ssc.detect.select"
CONSTRAIN = "ssc.constrain"

SERVE_NAMES = (PREPARE, DETECT, DETECT_BACKBONE, DETECT_RPN, DETECT_ROI_HEAD, DETECT_SELECT,
               CONSTRAIN)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
