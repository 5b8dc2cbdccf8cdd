"""torch.distributed bootstrap and collectives: the patch split and
data-parallel training.

Counterpart of ``ddpm3d_tpu/parallel/mesh.py`` for the port: where the JAX
package shards a batch over a device mesh's ``data`` axis, the port runs one
process per GPU (``torchrun --nproc_per_node N``). Serving samples a
contiguous slice of the patches on each rank and gathers the slices;
training takes each rank's equal slice of the global batch
(:func:`rank_rows`, JAX's ``shard_batch``) and all-reduces the gradients
through :func:`data_parallel` (DistributedDataParallel, which broadcasts
rank 0's parameters at construction: JAX's ``replicate``). The serving
path's ``spatial`` axis (one patch's H over several GPUs) is
:mod:`.mesh`'s: there the patches split over the data groups and each
rank of a group samples its H slice (:mod:`.spatial`).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .. import resolve_device


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
        resolve_device(device)  # raises without a card
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


def barrier() -> None:
    """Wait for every rank; a no-op without a process group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def rank_batch(batch_size: int, world_size: int) -> int:
    """Rows per rank of a global batch of ``batch_size``; raises unless the
    ranks can hold equal rows (an all-reduced mean of per-rank means is the
    global mean only then)."""
    if batch_size % world_size:
        raise ValueError(
            f"the global batch {batch_size} does not split over "
            f"{world_size} ranks; give a multiple of the world size")
    return batch_size // world_size


def rank_rows(x: torch.Tensor, rank: int, world_size: int) -> torch.Tensor:
    """Rank ``rank``'s equal, contiguous slice of a global batch along dim
    0 (rank order, as :func:`all_gather_rows` puts them back)."""
    n = rank_batch(x.shape[0], world_size)
    return x[rank * n:(rank + 1) * n]


def data_parallel(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` under DistributedDataParallel when a process group is up
    (the gradient all-reduce; rank 0's parameters are broadcast here), else
    ``model`` itself (also when it is already wrapped). The group's
    backend must be NCCL for a model on the card and gloo on the CPU."""
    if (not (dist.is_available() and dist.is_initialized())
            or isinstance(model, DistributedDataParallel)):
        return model
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(
            f"data-parallel training on {device.type} needs a {want} "
            f"process group, not {dist.get_backend()}")
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        gradient_as_bucket_view=True)


def unwrap(model: nn.Module) -> nn.Module:
    """The module under a :func:`data_parallel` wrapper (or ``model``)."""
    return model.module if isinstance(model, DistributedDataParallel) else model
