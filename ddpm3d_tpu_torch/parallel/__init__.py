"""Multi-GPU serving: the torch.distributed bootstrap and the patch gather."""

from .dist import (
    all_gather_rows,
    destroy,
    maybe_initialize_distributed,
    pad_to_multiple,
    world,
)
