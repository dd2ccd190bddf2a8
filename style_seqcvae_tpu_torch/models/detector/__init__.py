"""Faster R-CNN detector of the port: inference forward and feature
extraction."""
