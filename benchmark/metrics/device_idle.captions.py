"""Share of the traced window in which no operation ran on the device,
from the union of the trace's kernel, copy and fill intervals."""


def read(run):
    if run.trace is None or run.trace.window is None or run.unit_items != "captions":
        return None
    if not run.trace.device_ops:
        return None
    w0, w1 = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_s() / (w1 - w0))
