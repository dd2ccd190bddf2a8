"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.detect.roi_head`` spans (RoIAlign, kernel C; layer4; the class, box
and attribute heads), per group of images (``pipeline_spans.py``)."""

from benchmark import pipeline_spans


def read(run):
    return pipeline_spans.device_ms_per_group(run, pipeline_spans.ROI_HEAD)
