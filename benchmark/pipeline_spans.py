"""The program's spans of the serving chain in a traced window, for the
per-layer readers ``metrics/device_ms_per_group.*.py``.

The port opens them (``style_seqcvae_tpu_torch/utils/tracing.py``,
``SERVE_NAMES``) while a profiler records; the decode's own spans are
``spans.py``'s. The names are written out here and not imported, so that
the readers also run on a program that has no such spans, and then find
nothing. A kernel belongs to a span when its launch on the host fell inside
one of that span's ranges (``spans.within``).
"""

from __future__ import annotations

from typing import Optional

from benchmark import spans

PREPARE = "ssc.prepare"
DETECT = "ssc.detect"
BACKBONE = "ssc.detect.backbone"
RPN = "ssc.detect.rpn"
ROI_HEAD = "ssc.detect.roi_head"
SELECT = "ssc.detect.select"
CONSTRAIN = "ssc.constrain"
NAMES = (PREPARE, DETECT, BACKBONE, RPN, ROI_HEAD, SELECT, CONSTRAIN)
# the spans that split a group's work between them: the serving chain's
# stages and the decode
STAGES = (PREPARE, DETECT, CONSTRAIN, spans.DECODE)


def kernel_time_in(trace, names) -> float:
    """Device seconds of the kernels whose launch fell inside a range of
    any of ``names``."""
    found = [(rs, [s for s, _ in rs]) for rs in (spans.ranges(trace, n) for n in names)]
    kernels = [op for op in trace.device_ops if op[3] == "kernel"]
    return sum(e - s for (_, s, e, _), t in zip(kernels, trace.kernel_launch)
               if any(spans.within(t, rs, starts) for rs, starts in found))


def device_ms_per_group(run, name: str) -> Optional[float]:
    """Device time (ms) of the kernels launched inside ``name``'s ranges,
    over the groups of the window; None without a trace, kernels, groups or
    such a range."""
    trace = run.trace
    groups = run.counters.get("groups")
    if trace is None or not trace.kernel_launch or not groups or not spans.ranges(trace, name):
        return None
    return 1e3 * kernel_time_in(trace, [name]) / groups
