"""Training checkpoints under the reference's file names.

Own copy of the naming and resume helpers of ``ddpm3d_tpu/utils/
checkpoint.py``, writing the reference's own ``.pt`` format:
``model{step:06d}.pt`` and ``ema_{rate}_{step:06d}.pt`` are f32 state dicts
under the reference keys (:func:`..utils.convert.load_checkpoint`, the
serving CLI and the JAX package's ``utils/torch_import`` read them), and
``opt{step:06d}.pt`` is the optimizer's ``state_dict()``. A bare state dict
(a distilled student's) goes through :func:`save_state_dict`. Under a
process group the callers write on rank 0 only. Every read, write and
lookup goes through :mod:`.blobio`, so a run directory may be a local
path, ``file://``, ``mem://`` or ``gs://`` (or any registered scheme).
"""

from __future__ import annotations

import io
import re
from typing import Any, Dict, List, Optional

import torch

from . import blobio


def parse_resume_step_from_filename(filename: str) -> int:
    """path/to/modelNNNNNN.pt -> NNNNNN (0 when the name has no step)."""
    split = filename.split("model")
    if len(split) < 2:
        return 0
    try:
        return int(split[-1].split(".")[0])
    except ValueError:
        return 0


def find_ema_checkpoint(
    main_checkpoint: Optional[str], step: int, rate
) -> Optional[str]:
    """``ema_{rate}_{step:06d}.pt`` beside the main checkpoint, if there."""
    if main_checkpoint is None:
        return None
    path = blobio.join(blobio.dirname(main_checkpoint),
                       f"ema_{rate}_{step:06d}.pt")
    return path if blobio.exists(path) else None


def find_opt_checkpoint(main_checkpoint: str, step: int) -> Optional[str]:
    """``opt{step:06d}.pt`` beside the main checkpoint, if there."""
    path = blobio.join(blobio.dirname(main_checkpoint), f"opt{step:06d}.pt")
    return path if blobio.exists(path) else None


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``model{step}.pt`` with the largest step in ``directory``."""
    if not directory or not blobio.isdir(directory):
        return None
    best, best_step = None, -1
    for name in blobio.listdir(directory):
        m = re.fullmatch(r"model(\d+)\.pt", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = blobio.join(directory, name)
    return best


def _save(obj: Any, path: str) -> None:
    """torch.save into memory, then one blob write (a local write renames a
    temporary file into place, so a reader never sees half a checkpoint)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    blobio.write_bytes(path, buf.getvalue())


def load(path: str, map_location="cpu") -> Any:
    """``torch.load`` (tensors and plain containers only) of a blob."""
    return torch.load(io.BytesIO(blobio.read_bytes(path)),
                      map_location=map_location, weights_only=True)


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write ``state_dict`` (moved to the CPU) to ``path``; returns it."""
    _save({k: v.detach().cpu() if torch.is_tensor(v) else v
           for k, v in state_dict.items()}, path)
    return path


def save_train_checkpoint(
    directory: str,
    step: int,
    model_state: Dict[str, torch.Tensor],
    ema_states: Dict[str, Dict[str, torch.Tensor]],
    opt_state: Dict[str, Any],
) -> List[str]:
    """Write the model, one EMA file per rate string and the optimizer
    state for ``step``; tensors are moved to the CPU first. Returns the
    paths."""
    written = [save_state_dict(blobio.join(directory, f"model{step:06d}.pt"),
                               model_state)]
    for rate, sd in ema_states.items():
        written.append(save_state_dict(
            blobio.join(directory, f"ema_{rate}_{step:06d}.pt"), sd))
    written.append(blobio.join(directory, f"opt{step:06d}.pt"))
    _save(opt_state, written[-1])
    return written
