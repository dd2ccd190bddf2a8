"""Device kernels launched inside the benchmark's ``bench.decode`` spans
(around ``DecodeHarness.decode_cbs``), per decode step, from the trace:
an exact count."""


def read(run):
    steps = run.counters.get("decode_steps")
    if run.trace is None or not steps or not run.trace.kernel_names:
        return None
    return run.trace.kernels_in("bench.decode") / steps
