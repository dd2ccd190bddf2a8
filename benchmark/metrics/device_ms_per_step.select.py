"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.cbs.select`` spans (kernel A or the other selections, the exception
filter and end freezing), per decode step (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step(run, spans.SELECT)
