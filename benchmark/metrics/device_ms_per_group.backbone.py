"""Device time (ms) of the kernels whose launch fell inside the program's
``ssc.detect.backbone`` spans (the ResNet-101 trunk to the C4 map: conv1 ..
layer3, cuDNN convolutions, frozen BatchNorm and ReLU), per group of images
(``pipeline_spans.py``)."""

from benchmark import pipeline_spans


def read(run):
    return pipeline_spans.device_ms_per_group(run, pipeline_spans.BACKBONE)
