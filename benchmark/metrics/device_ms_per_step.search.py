"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.cbs.search`` spans (candidates over (S_to, S_from), the top-k
passes, the gathers and the beam picks), per decode step (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step(run, spans.SEARCH)
