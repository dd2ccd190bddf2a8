"""Blocking CUDA runtime calls (``spans.blocking``: stream, device and event
synchronisation, copies that are not ``Async``) that start inside the
program's ``ssc.decode_cbs`` spans, per span: the times a decode waits for
the card."""

from benchmark import spans


def read(run):
    trace = run.trace
    if trace is None or not trace.kernel_launch:
        return None
    decodes = spans.ranges(trace, spans.DECODE)
    if not decodes:
        return None
    return len(spans.decode_blocking(trace)) / len(decodes)
