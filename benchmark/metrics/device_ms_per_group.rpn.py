"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.detect.rpn`` spans (the RPN's 3x3 conv and heads, the proposal layer
and its NMS, kernel D), per group of images (``pipeline_spans.py``)."""

from benchmark import pipeline_spans


def read(run):
    return pipeline_spans.device_ms_per_group(run, pipeline_spans.RPN)
