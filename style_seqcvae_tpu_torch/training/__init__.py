"""Captioner training: optimizer, train steps, checkpoints."""
