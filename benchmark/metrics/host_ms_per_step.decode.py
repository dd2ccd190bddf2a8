"""The host's own time (ms) a decode step: the length of the program's
``ssc.decode_cbs`` spans less the time spent inside blocking CUDA runtime
calls that start in them (``spans.blocking``), over the decode steps. What
a step would cost the host on an infinitely fast card."""

from benchmark import spans


def read(run):
    trace = run.trace
    if trace is None or not trace.kernel_launch:
        return None
    steps = spans.decode_steps(trace)
    if not steps:
        return None
    total = sum(e - s for s, e in spans.ranges(trace, spans.DECODE))
    waited = sum(e - s for s, e in spans.decode_blocking(trace))
    return 1e3 * (total - waited) / steps
