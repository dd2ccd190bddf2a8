"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.decode_cbs`` spans (the CBS decode of a group's box features: the
step, kernels A and E, the search), per group of images
(``pipeline_spans.py``)."""

from benchmark import pipeline_spans, spans


def read(run):
    return pipeline_spans.device_ms_per_group(run, spans.DECODE)
