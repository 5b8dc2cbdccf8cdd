"""Weights carried across from the JAX package.

Own copy of the flax-path -> torch-key map and layout transposes of
``ddpm3d_tpu/utils/torch_export.py`` (the reference torch state-dict
naming), for the model families the port builds:

  time_embed_{0,2}        -> time_embed.{0,2}
  label_emb.embedding     -> label_emb.weight
  in{i}_{j}.<inner'>      -> input_blocks.i.j.<inner>
  mid_{j}.<inner'>        -> middle_block.j.<inner>
  out{i}_{j}.<inner'>     -> output_blocks.i.j.<inner>
  head_norm / head_conv   -> out.0 / out.2
  conv (*k, in, out) -> (out, in, *k); dense (in, out) -> (out, in);
  GroupNorm scale/bias -> weight/bias.

:func:`jax_params_to_state_dict` turns a JAX ``params`` tree of numpy
arrays into the port's state dict; :func:`load_checkpoint` reads the ``.pt``
state dicts that ``tools/export_torch_ckpt.py`` writes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_NORM_MODULES = {"in_norm", "out_norm", "norm", "head_norm"}
_INNER = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip": "skip_connection",
    "op": "op",
    "conv": "conv",
}
_STAGES = (
    (re.compile(r"^in(\d+)_(\d+)$"), "input_blocks"),
    (re.compile(r"^out(\d+)_(\d+)$"), "output_blocks"),
    (re.compile(r"^mid_(\d+)$"), "middle_block"),
)
_TE_RE = re.compile(r"^time_embed_(\d+)$")


def _leaf(module: str, leaf: str) -> str:
    if module in _NORM_MODULES:
        return {"scale": "weight", "bias": "bias"}[leaf]
    if leaf in ("kernel", "embedding"):
        return "weight"
    return leaf


def _value(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim >= 3:  # conv (*k, in, out) -> (out, in, *k)
            return value.transpose(
                (value.ndim - 1, value.ndim - 2) + tuple(range(value.ndim - 2)))
        if value.ndim == 2:  # dense (in, out) -> (out, in)
            return value.T
    return value


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """A flax param path (module names then the leaf) -> the torch key."""
    head, leaf = path[0], path[-1]
    m = _TE_RE.match(head)
    if m:
        return f"time_embed.{m.group(1)}.{_leaf(head, leaf)}"
    if head == "label_emb":
        return "label_emb.weight"
    if head == "head_norm":
        return f"out.0.{_leaf(head, leaf)}"
    if head == "head_conv":
        return f"out.2.{_leaf(head, leaf)}"
    for regex, name in _STAGES:
        m = regex.match(head)
        if not m:
            continue
        stage = ".".join((name,) + m.groups())
        if len(path) == 2:  # a bare conv stage (input_blocks.0.0)
            return f"{stage}.{_leaf(head, leaf)}"
        inner = path[1]
        if inner not in _INNER:
            raise KeyError(f"no port-side module for flax path {path}")
        return f"{stage}.{_INNER[inner]}.{_leaf(inner, leaf)}"
    raise KeyError(f"unrecognized flax param path: {path}")


_TORCH_STAGES = {"input_blocks": "in", "output_blocks": "out"}
_INNER_FLAX = {v: k for k, v in _INNER.items()}


def torch_module_to_flax_path(name: str) -> str:
    """A module's torch name -> its flax module path (the inverse of
    :func:`flax_path_to_torch_key` without the leaf), e.g.
    ``input_blocks.1.0.in_layers.2`` -> ``in1_0/in_conv``, ``out.2`` ->
    ``head_conv``: the conv site names the int8 scales files key on (under
    the SuperResModel's ``unet/``)."""
    if name in ("out.0", "out.2"):
        return {"out.0": "head_norm", "out.2": "head_conv"}[name]
    parts = name.split(".")
    if parts[0] in _TORCH_STAGES and len(parts) >= 3:
        head, rest = f"{_TORCH_STAGES[parts[0]]}{parts[1]}_{parts[2]}", parts[3:]
    elif parts[0] == "middle_block" and len(parts) >= 2:
        head, rest = f"mid_{parts[1]}", parts[2:]
    else:
        raise KeyError(f"no flax module for torch module {name!r}")
    if not rest:
        return head
    inner = ".".join(rest)
    if inner not in _INNER_FLAX:
        raise KeyError(f"no flax module for torch module {name!r}")
    return f"{head}/{_INNER_FLAX[inner]}"


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``params`` tree (numpy leaves; with or without the ``params``
    level and the SuperResModel ``unet`` wrapper) -> the port's state dict
    of f32 tensors."""
    tree = params.get("params", params)
    if set(tree.keys()) == {"unet"}:
        tree = tree["unet"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        key = flax_path_to_torch_key(path)
        if key in out:
            raise KeyError(f"duplicate torch key {key} from {path}")
        arr = _value(path[-1], np.asarray(node, np.float32))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, ())
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pt`` state dict (tensors only) onto the CPU."""
    if path.endswith(".msgpack"):
        raise SystemExit(
            f"{path}: the port reads .pt state dicts; convert a JAX "
            "checkpoint with tools/export_torch_ckpt.py"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state dict, got {type(sd)}")
    return dict(sd)
