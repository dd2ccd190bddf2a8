"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.step.attention`` spans (the BUTD attention over (rows, N, P)), per
decode step (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step(run, spans.ATTENTION)
