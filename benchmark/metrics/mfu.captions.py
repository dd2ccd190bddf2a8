"""The model's operations over the traced window (``flops.py``, counted from
the widths) at the peak of each product's dtype, as a share of the
window: the least time the card could take over the time it took."""

from benchmark.peaks import PEAK_OPS


def read(run):
    ops = run.counters.get("model_ops")
    if not ops or run.unit_items != "captions":
        return None
    least = sum(n / PEAK_OPS[dtype] for dtype, n in ops.items())
    return 100.0 * least / run.window_s
