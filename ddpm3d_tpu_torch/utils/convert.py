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
  attention norm / qkv / proj -> norm / qkv / proj_out
  conv (*k, in, out) -> (out, in, *k); dense (in, out) -> (out, in);
  GroupNorm scale/bias -> weight/bias.

The classifier's heads, which the JAX exporter does not map (it raises on
them), take the names of the published guided-diffusion
``EncoderUNetModel.out`` (the reference's source is not in this repository
to check them against):

  head_pool/pos           -> out.2.positional_embedding, transposed to
                             the reference's (C, T + 1)
  head_pool/qkv / proj    -> out.2.qkv_proj / out.2.c_proj
  sp_fc1 / sp_fc2         -> out.0 / out.2 (spatial)
  sp_fc1 / sp_norm / sp_fc2 -> out.0 / out.1 / out.3 (spatial_v2)

:func:`jax_params_to_state_dict` turns a JAX ``params`` tree of numpy
arrays into the port's state dict; :func:`load_checkpoint` reads the ``.pt``
state dicts that ``tools/export_torch_ckpt.py`` writes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_NORM_MODULES = {"in_norm", "out_norm", "norm", "head_norm", "sp_norm"}
_INNER = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip": "skip_connection",
    "op": "op",
    "conv": "conv",
    "norm": "norm",
    "qkv": "qkv",
    "proj": "proj_out",
}
_POOL = {"pos": "positional_embedding", "qkv": "qkv_proj", "proj": "c_proj"}
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
    if leaf == "pos":  # (T + 1, C) -> (C, T + 1)
        return value.T
    if leaf == "kernel":
        if value.ndim >= 3:  # conv (*k, in, out) -> (out, in, *k)
            return value.transpose(
                (value.ndim - 1, value.ndim - 2) + tuple(range(value.ndim - 2)))
        if value.ndim == 2:  # dense (in, out) -> (out, in)
            return value.T
    return value


def flax_path_to_torch_key(path: Tuple[str, ...],
                           spatial_v2: bool = False) -> str:
    """A flax param path (module names then the leaf) -> the torch key;
    ``spatial_v2``: the tree holds ``sp_norm`` (its last dense is out.3)."""
    head, leaf = path[0], path[-1]
    if head == "head_pool":
        if len(path) == 2:
            return f"out.2.{_POOL[leaf]}"
        return f"out.2.{_POOL[path[1]]}.{_leaf(path[1], leaf)}"
    if head in ("sp_fc1", "sp_norm", "sp_fc2"):
        index = {"sp_fc1": 0, "sp_norm": 1,
                 "sp_fc2": 3 if spatial_v2 else 2}[head]
        return f"out.{index}.{_leaf(head, leaf)}"
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
    level and the SuperResModel ``unet`` wrapper) of a UNet, SuperResModel
    or EncoderUNetModel -> the port's state dict of f32 tensors."""
    tree = params.get("params", params)
    if set(tree.keys()) == {"unet"}:
        tree = tree["unet"]
    out: Dict[str, torch.Tensor] = {}
    spatial_v2 = "sp_norm" in tree

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        key = flax_path_to_torch_key(path, spatial_v2)
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
