"""Minimal run logger: lines to stdout and to ``<dir>/log.txt``.

The JAX package's logger formats (csv, tensorboard-style key/values) wait
for the training slice; inference only logs lines and needs its output
directory, which this keeps.
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import tempfile
from typing import Optional


class Logger:
    def __init__(self, dir: str):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.path = osp.join(dir, "log.txt")

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.path, "a") as f:
            f.write(msg + "\n")


def configure(dir: Optional[str] = None) -> Logger:
    """A logger writing under ``dir`` (else $DDPM_LOGDIR / $OPENAI_LOGDIR,
    else a fresh timestamped directory under the temp dir)."""
    if not dir:
        dir = os.getenv("DDPM_LOGDIR") or os.getenv("OPENAI_LOGDIR")
    if not dir:
        dir = osp.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("ddpm3d-%Y-%m-%d-%H-%M-%S-%f"),
        )
    logger = Logger(dir)
    logger.log(f"Logging to {dir}")
    return logger
