"""ddpm3d_tpu_torch — the PyTorch/CUDA port of ddpm3d_tpu for NVIDIA Hopper.

A package of its own beside the JAX package ``ddpm3d_tpu``, which stays the
reference. It imports torch, numpy and the standard library only. Public
tensors keep the JAX package's channels-last layout ``[B, D, H, W, C]`` and
parameter names follow the reference torch state dict, so a ``.pt``
exported by ``tools/export_torch_ckpt.py`` loads with ``strict=True``.

Every stride-1 3x3x3 convolution and every GroupNorm of the denoising path
runs a hand-written kernel on the card (``csrc/``, built on first use);
on the CPU the same modules run the kernels' plain PyTorch versions.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card) unless
    the caller names another. Raises rather than moving to the CPU when no
    card is there."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
