"""The program's own spans in a traced window, for the per-layer readers
``metrics/device_ms_per_step.*.py``, ``host_ms_per_step.decode.py`` and
``syncs_per_decode.py``.

The port opens ``record_function`` ranges inside its CBS decode
(``style_seqcvae_tpu_torch/utils/tracing.py``) while a profiler records,
so they sit in the window's trace beside the kernels, on its clock, among
``Trace.host`` (the window thread's host events). The names are written
out here and not imported: the readers also run on a program that has no
spans, and then find nothing. A kernel belongs to a span when its launch
on the host fell inside one of that span's ranges; a decode step is an
``ssc.step`` range that starts inside an ``ssc.decode_cbs`` range.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

DECODE = "ssc.decode_cbs"
SETUP = "ssc.cbs.setup"
STEP = "ssc.step"
ATTENTION = "ssc.step.attention"
SELECT = "ssc.cbs.select"
SEARCH = "ssc.cbs.search"
FINISH = "ssc.cbs.finish"
NAMES = (DECODE, SETUP, STEP, ATTENTION, SELECT, SEARCH, FINISH)

# CUDA runtime calls that return only when the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def blocking(name: str) -> bool:
    """The synchronising calls above, and the copies that are not
    ``Async`` (``cudaMemcpy``, ``cudaMemcpy2D``, ...)."""
    return name in SYNCS or (name.startswith("cudaMemcpy") and "Async" not in name)


def ranges(trace, name: str) -> List[Tuple[float, float]]:
    """The (start, end) ranges of the host span ``name``, by start. Ranges
    of one name never overlap: no span of the port nests in itself."""
    return [(s, e) for s, e, n in trace.host if n == name]


def within(t: float, rs: List[Tuple[float, float]], starts: List[float]) -> bool:
    """Whether ``t`` lies in one of the ranges ``rs`` (``starts``: their
    starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= rs[i][1]


def decode_steps(trace) -> int:
    decodes = ranges(trace, DECODE)
    starts = [s for s, _ in decodes]
    return sum(within(s, decodes, starts) for s, _ in ranges(trace, STEP))


def device_ms_per_step(run, name: str) -> Optional[float]:
    """Device time (ms) of the kernels launched inside ``name``'s ranges,
    over the decode steps."""
    trace = run.trace
    if trace is None or not trace.kernel_launch:
        return None
    steps = decode_steps(trace)
    if not steps:
        return None
    rs = ranges(trace, name)
    starts = [s for s, _ in rs]
    kernels = [op for op in trace.device_ops if op[3] == "kernel"]
    took = sum(e - s for (_, s, e, _), t in zip(kernels, trace.kernel_launch)
               if within(t, rs, starts))
    return 1e3 * took / steps


def decode_blocking(trace) -> List[Tuple[float, float]]:
    """The blocking runtime calls that start inside ``ssc.decode_cbs``
    ranges, each cut to its range."""
    decodes = ranges(trace, DECODE)
    starts = [s for s, _ in decodes]
    out = []
    for s, e, n in trace.host:
        if blocking(n) and within(s, decodes, starts):
            out.append((s, min(e, decodes[bisect.bisect_right(starts, s) - 1][1])))
    return out
