"""The benchmark of the PyTorch and CUDA port (``style_seqcvae_tpu_torch``);
see README.md beside this file."""
