"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.detect.select`` spans (the box decoding, the per-class NMS, kernel D,
the top detections and their gathers), per group of images
(``pipeline_spans.py``)."""

from benchmark import pipeline_spans


def read(run):
    return pipeline_spans.device_ms_per_group(run, pipeline_spans.SELECT)
