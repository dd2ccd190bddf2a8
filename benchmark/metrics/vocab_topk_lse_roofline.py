"""Kernel A (``ops/kernels/vocab_topk_lse.py``): its launches in the window
times the bound of one call (``flops.topk_lse_call`` at the peaks of
``peaks.py``), over the device time of its kernels in the trace (every
kernel whose name holds ``vocab_topk_lse``: the product with its partial
top-k, and the merge)."""

from benchmark.peaks import bound_s


def read(run):
    call = run.counters.get("kernel_calls", {}).get("vocab_topk_lse")
    if run.trace is None or not call or not call["launches"]:
        return None
    took = run.trace.device_time(lambda name: "vocab_topk_lse" in name)
    if took <= 0:
        return None
    return 100.0 * call["launches"] * bound_s(call["ops"], call["bytes"], call["dtype"]) / took
