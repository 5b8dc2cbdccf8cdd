"""The program's ``SuperResModel`` (``ddpm3d_tpu_torch.models.factory.
sr_create_model``) at a configuration's flags, built as the program builds
it (its own initialisation on the host) and moved to the run's device; the
harness then loads every parameter from the seed."""

from __future__ import annotations

from typing import Optional

import torch


def int8_config(cfg: dict, control: Optional[str] = None):
    """The program's int8 serving config of ``cfg`` (None for bf16);
    ``control`` "int8_dynamic" serves every int8-able site with dynamic
    scales instead (the program's own lower-precision path)."""
    from ddpm3d_tpu_torch.ops.quant import Int8Config

    if control == "int8_dynamic":
        return Int8Config(scales="")
    if control is not None:
        raise ValueError(f"no program control {control!r}")
    q = cfg.get("int8")
    if not q:
        return None
    return Int8Config(exclude=tuple(q["exclude"]), scales=q["scales_path"],
                      time_scales=q["time_scales"])


def build(cfg: dict, device, control: Optional[str] = None) -> torch.nn.Module:
    """The model on ``device`` in eval mode, at the program's own init."""
    from ddpm3d_tpu_torch.models import factory

    model = factory.sr_create_model(
        cfg["large_size"], cfg["small_size"], cfg["num_channels"],
        cfg["num_res_blocks"], learn_sigma=cfg["learn_sigma"],
        class_cond=cfg["class_cond"], use_checkpoint=cfg["use_checkpoint"],
        attention_resolutions=cfg["attention_resolutions"],
        num_heads=cfg["num_heads"], num_head_channels=cfg["num_head_channels"],
        num_heads_upsample=cfg["num_heads_upsample"],
        use_scale_shift_norm=cfg["use_scale_shift_norm"],
        dropout=cfg["dropout"], resblock_updown=cfg["resblock_updown"],
        use_fp16=cfg["use_fp16"], fused=cfg["fused"],
        int8=int8_config(cfg, control))
    return model.eval().to(device)
