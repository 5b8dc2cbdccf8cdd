"""Config flags, weight conversion, blob IO, checkpoints and logging."""

from . import blobio, checkpoint, config, logger
