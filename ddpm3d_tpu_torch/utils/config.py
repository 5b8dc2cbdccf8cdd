"""Defaults dicts and argparse helpers (port of ``ddpm3d_tpu/utils/config.py``):
layered defaults projected onto the factory signature, one typed
``--flag`` per key, so launch commands carry over verbatim."""

from __future__ import annotations

import argparse
import inspect
from typing import Any, Dict


def diffusion_defaults() -> Dict[str, Any]:
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        predict_v=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def model_and_diffusion_defaults() -> Dict[str, Any]:
    res = dict(
        image_size=64,
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        num_head_channels=-1,
        attention_resolutions="16,8",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=False,
        use_fp16=False,
        use_new_attention_order=False,
    )
    res.update(diffusion_defaults())
    return res


def sr_model_and_diffusion_defaults() -> Dict[str, Any]:
    """The conditional denoiser's defaults, filtered to the factory's
    signature."""
    from ..models import factory

    res = model_and_diffusion_defaults()
    res["large_size"] = 256
    res["small_size"] = 64
    arg_names = inspect.getfullargspec(factory.sr_create_model_and_diffusion)[0]
    return {k: v for k, v in res.items() if k in arg_names}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_dict_to_argparser(parser: argparse.ArgumentParser, default_dict: Dict):
    """One typed --flag per defaults key."""
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys) -> Dict[str, Any]:
    return {k: getattr(args, k) for k in keys}
