"""The plain reference of the benchmark: PyTorch and NumPy only, nothing of
the program (``ddpm3d_tpu_torch``), of JAX or of the JAX package."""
