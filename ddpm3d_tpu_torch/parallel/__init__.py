"""Multi-GPU serving and training: the torch.distributed bootstrap, the
patch gather, the batch split, the DDP wrapper and the (data, spatial)
mesh with its spatial group's collectives."""

from .dist import (
    all_gather_rows,
    barrier,
    data_parallel,
    destroy,
    maybe_initialize_distributed,
    pad_to_multiple,
    rank_batch,
    rank_rows,
    unwrap,
    world,
)
from .mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    allowed_spatial,
    check_spatial_split,
    make_mesh,
    shard_batch,
    spatial_rows,
)
from .spatial import SpatialGroup
