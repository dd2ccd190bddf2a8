"""Command-line entry points of the port (``python -m style_seqcvae_tpu_torch.scripts.<name>``)."""
