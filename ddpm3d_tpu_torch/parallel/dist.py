"""torch.distributed bootstrap and collectives for the patch split.

Counterpart of ``ddpm3d_tpu/parallel/mesh.py`` for the port: where the JAX
package shards one patch batch over a device mesh's ``data`` axis, the port
runs one process per GPU (``torchrun --nproc_per_node N``), each sampling a
contiguous slice of the patches, and gathers the slices. Only the ``data``
axis is ported; the ``spatial`` axis (one patch's H over several chips) is
not (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist


def maybe_initialize_distributed(device="cuda") -> Tuple[int, int]:
    """Join the process group that ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``; a no-op without them or when a group
    exists. Returns :func:`world`.

    A CUDA run uses NCCL and binds the process to card ``LOCAL_RANK`` before
    the caller resolves its device; it raises when this PyTorch has no NCCL
    rather than run the collectives elsewhere. A CPU run uses gloo."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return world()
    if torch.device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "a multi-GPU run needs torch.distributed with NCCL, which "
                "this PyTorch lacks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return world()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def destroy() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k >= n: the patch count every rank's equal slice
    adds up to, so the gather is never ragged."""
    return ((n + k - 1) // k) * k


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0
    in rank order, on every rank; ``x`` itself without a process group.
    With NCCL ``x`` lies on this process's card."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    parts = [torch.empty_like(x) for _ in range(world()[1])]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
