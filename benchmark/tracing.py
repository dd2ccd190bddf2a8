"""The traced window: ``torch.profiler`` over the measured loop, its trace
exported as Chrome JSON to the run's temporary directory, read back and
deleted. The benchmark's own spans are ``record_function`` ranges named
``bench.<name>``; they show as host annotations in the trace.

:class:`Trace` holds what the per-layer readers need: the device's
operations (kernels, copies, fills) with their times, each kernel's launch
time on the host, the benchmark's spans, and the host's events of the
thread that ran the window (to say what the host did while the device
idled).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


class Trace:
    """Times in seconds on the trace's own clock."""

    def __init__(self, events: List[dict]):
        self.device_ops: List[Tuple[str, float, float, str]] = []   # name, start, end, cat
        self.kernel_launch: List[float] = []                         # per kernel, host time
        self.kernel_names: List[str] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        launches: Dict[int, float] = {}
        host: List[Tuple[float, float, str, object]] = []
        kernels: List[Tuple[str, float, int]] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat", ""), float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ev["name"], ts, ts + dur, cat))
                if cat == "kernel":
                    kernels.append((ev["name"], ts, args.get("correlation", -1)))
            elif cat in HOST_CATS:
                if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                    launches[args["correlation"]] = ts
                if cat == "user_annotation" and ev["name"].startswith("bench."):
                    self.spans[ev["name"]].append((ts, ts + dur))
                host.append((ts, ts + dur, ev["name"], ev.get("tid")))
        for name, ts, corr in kernels:
            self.kernel_names.append(name)
            self.kernel_launch.append(launches.get(corr, float("nan")))
        window = self.spans.get(WINDOW_SPAN)
        tid = None
        if window:
            w0, w1 = window[0]
            tid = next((t for s, e, n, t in host if n == WINDOW_SPAN and s == w0), None)
        self.window = window[0] if window else None
        self.host = sorted((s, e, n) for s, e, n, t in host if t == tid)
        for v in self.spans.values():
            v.sort()

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operation intervals, merged, cut to
        the window span when the trace has one."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        out: List[List[float]] = []
        for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device_ops):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e, c in self.device_ops if c == "kernel" and match(n))

    def kernels_in(self, span: str) -> int:
        """Kernels whose launch on the host fell inside a ``span`` range."""
        ranges = self.spans.get(span, [])
        starts = [s for s, _ in ranges]
        n = 0
        for t in self.kernel_launch:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                n += 1
        return n

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device_ops:
            tot[name] += e - s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time of the device inside the window, summed by the host
        event that was running at the middle of each gap (the innermost
        one on the window's thread), longest first."""
        if self.window is None:
            return []
        w0, w1 = self.window
        gaps, prev = [], w0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, min(s, w1)))
            prev = max(prev, e)
            if prev >= w1:
                break
        if prev < w1:
            gaps.append((prev, w1))
        tot: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            while j < len(self.host) and self.host[j][0] <= mid:
                ev = self.host[j]
                while stack and stack[-1][1] < ev[0]:
                    stack.pop()
                stack.append(ev)
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            tot[stack[-1][2] if stack else "(no host event)"] += g1 - g0
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def traced(fn: Callable[[], object]) -> Tuple[object, Optional[Trace]]:
    """Run ``fn`` under ``torch.profiler`` (host and CUDA) and return its
    result and the :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return result, Trace(events)
