"""Kernel D (``ops/kernels/nms.py``): for each call shape in the window,
its launches times the bound of one call (``flops_detector.nms_call`` at
the peaks of ``peaks.py``: 15 operations a box pair at f32's rate, or the
scan's bytes), summed, over the device time of its bitmask and scan
kernels in the trace."""

from benchmark.peaks import bound_s


def read(run):
    calls = run.counters.get("kernel_calls", {}).get("nms")
    if run.trace is None or not calls:
        return None
    took = run.trace.device_time(lambda name: "nms_bitmask_kernel" in name
                                 or "nms_scan_kernel" in name)
    if took <= 0:
        return None
    least = sum(c["launches"] * bound_s(c["ops"], c["bytes"], c["dtype"]) for c in calls)
    return 100.0 * least / took
