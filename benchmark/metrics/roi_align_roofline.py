"""Kernel C (``ops/kernels/roi_align.py``): its launches in the window
times the bound of one call (``flops_detector.roi_align_call`` at the peaks
of ``peaks.py``: the map read once and the pooled RoIs written once), over
the device time of its forward kernels in the trace."""

from benchmark.peaks import bound_s


def read(run):
    call = run.counters.get("kernel_calls", {}).get("roi_align")
    if run.trace is None or not call or not call["launches"]:
        return None
    took = run.trace.device_time(lambda name: "roi_align_kernel" in name)
    if took <= 0:
        return None
    return 100.0 * call["launches"] * bound_s(call["ops"], call["bytes"], call["dtype"]) / took
