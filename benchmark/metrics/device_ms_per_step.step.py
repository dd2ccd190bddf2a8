"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.step`` spans (one model step: both LSTMs, the attention, z, the
head), per decode step (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step(run, spans.STEP)
