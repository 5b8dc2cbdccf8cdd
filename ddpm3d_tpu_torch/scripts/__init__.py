"""Command-line entry points (``python -m ddpm3d_tpu_torch.scripts.test``)."""
