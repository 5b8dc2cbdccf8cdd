"""The (data, spatial) mesh of the serving path.

Counterpart of ``ddpm3d_tpu/parallel/mesh.py`` for the port. One process
runs per GPU (``torchrun``); the world of W ranks is a mesh of ``n_data`` x
``n_spatial`` with ``spatial`` innermost, as the JAX mesh
(``arr.reshape(n_data, n_spatial)``): ranks ``d * n_spatial .. d *
n_spatial + n_spatial - 1`` form data group d and share its patches, each
holding an equal slice of every patch's H axis (JAX's ``data_sharding(
spatial_dim=2)``). Where XLA's SPMD partitioner inserts the conv halo
exchanges and the cross-chip reductions, the port's model calls those of
its :class:`.spatial.SpatialGroup` (``ConvSites.set_spatial``).

The spatial axis serves only, as the JAX package's (its trainer shards the
batch alone): training and the standalone encoder refuse a group of
several ranks; the UNets, SuperResModel and the Seg models serve under it.
Pooling and upsampling stay local, so H must split into equal shards of a
whole number of the model's deepest rows: :func:`check_spatial_split`
raises otherwise (JAX's GSPMD pads an uneven shard instead).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .dist import rank_rows, world
from .spatial import H_DIM, SpatialGroup

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: the axis sizes, its data group's
    index ``data_index`` and its :class:`.spatial.SpatialGroup` (whose
    ``index`` is this rank's place on the spatial axis), on ``device``."""

    n_data: int
    n_spatial: int
    data_index: int
    spatial: SpatialGroup
    device: torch.device

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    @property
    def spatial_index(self) -> int:
        return self.spatial.index

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's ``mesh.shape``."""
        return {DATA_AXIS: self.n_data, SPATIAL_AXIS: self.n_spatial}


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              device=None) -> Mesh:
    """The (data, spatial) mesh over every rank of the process group (one
    rank without one). ``n_data`` defaults to W / ``n_spatial``; W must be
    ``n_data * n_spatial`` (every rank has a place). With ``n_spatial`` > 1
    every rank makes every data group's process group (``new_group``), and
    the group's backend must be NCCL for ``device`` cuda, gloo for the CPU.

    ``device`` is ``cuda`` unless the caller passes ``"cpu"``; without a
    card that raises. Raises when W is not ``n_data * n_spatial`` and when
    ``n_spatial`` > 1 has no process group to run on."""
    device = resolve_device(device)
    if n_spatial < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh axes must be >= 1, got ({n_data}, {n_spatial})")
    if n_spatial > 1 and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a spatial axis of {n_spatial} needs a process group of "
            "several ranks: run under torchrun (or init_process_group)")
    rank, world_size = world()
    if n_data is None:
        if world_size % n_spatial:
            raise ValueError(f"{world_size} ranks do not split into spatial "
                             f"groups of {n_spatial}")
        n_data = world_size // n_spatial
    if n_data * n_spatial != world_size:
        raise ValueError(f"a ({n_data}, {n_spatial}) mesh needs "
                         f"{n_data * n_spatial} ranks, the group has "
                         f"{world_size}")
    groups = [list(range(d * n_spatial, (d + 1) * n_spatial))
              for d in range(n_data)]
    handles = [None] * n_data
    if n_spatial > 1:
        want = "nccl" if device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(f"a spatial axis on {device.type} needs a "
                               f"{want} process group, not "
                               f"{dist.get_backend()}")
        # every rank makes every group, in the same order
        handles = [dist.new_group(ranks) for ranks in groups]
    d, s = divmod(rank, n_spatial)
    return Mesh(n_data, n_spatial, d, SpatialGroup(groups[d], s, handles[d]),
                device)


def allowed_spatial(h: int, multiple: int) -> List[int]:
    """The spatial axis sizes that split ``h`` rows into equal shards of a
    whole number of ``multiple`` rows each."""
    return [n for n in range(1, h + 1) if h % (n * multiple) == 0]


def check_spatial_split(h: int, n_spatial: int, multiple: int) -> None:
    """Raise unless ``n_spatial`` shards of ``h`` rows are each a multiple
    of ``multiple`` (the model's 2 ** number of H downsamplings: pooling and
    upsampling stay local), naming the sizes that are."""
    if h % (n_spatial * multiple):
        raise ValueError(
            f"H = {h} does not split over a spatial axis of {n_spatial} into "
            f"shards of a multiple of {multiple} rows; allowed sizes: "
            f"{allowed_spatial(h, multiple)}")


def spatial_rows(mesh: Mesh, x, dim: int = H_DIM):
    """This rank's equal slice of ``x`` (tensor or array) along ``dim``:
    rows ``[s * n / S, (s + 1) * n / S)`` for spatial index s of S."""
    n_s = mesh.n_spatial
    if n_s == 1:
        return x
    n = x.shape[dim]
    if n % n_s:
        raise ValueError(f"{n} rows along dim {dim} do not split over "
                         f"{n_s} spatial ranks")
    h = n // n_s
    index = (slice(None),) * dim + (slice(mesh.spatial_index * h,
                                          (mesh.spatial_index + 1) * h),)
    return x[index]


def shard_batch(mesh: Mesh, x, spatial_dim: Optional[int] = None):
    """This rank's part of a global batch ``x`` (tensor or array): its data
    group's equal slice of dim 0 (:func:`.dist.rank_rows`) and, with
    ``spatial_dim``, its slice of that axis (:func:`spatial_rows`)."""
    rows = rank_rows(x, mesh.data_index, mesh.n_data)
    return rows if spatial_dim is None else spatial_rows(mesh, rows,
                                                         spatial_dim)
