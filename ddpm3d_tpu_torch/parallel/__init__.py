"""Multi-GPU serving and training: the torch.distributed bootstrap, the
patch gather, the batch split and the DDP wrapper."""

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
