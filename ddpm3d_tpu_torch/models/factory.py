"""Model and diffusion factories for the denoising path.

Port of ``ddpm3d_tpu/models/factory.py:sr_create_model_and_diffusion``,
``sr_create_model`` and ``create_gaussian_diffusion``: the CLI's flat flag
namespace becomes a :class:`~.unet.SuperResModel` and a respaced schedule.
The 96^3 production config lands on channel_mult (1, 1, 2, 3, 4).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..diffusion import (
    DiffusionConfig,
    LossType,
    MeanType,
    Schedule,
    VarType,
    get_named_beta_schedule,
    make_spaced_schedule,
    space_timesteps,
)
from .plan import attention_ds_from_resolutions
from .unet import NUM_CLASSES, SuperResModel


def sr_create_model(
    large_size,
    small_size,
    num_channels,
    num_res_blocks,
    learn_sigma,
    class_cond,
    use_checkpoint,
    attention_resolutions,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    use_scale_shift_norm,
    dropout,
    resblock_updown,
    use_fp16,
) -> SuperResModel:
    """SuperResModel_noatt with in_channels=1 doubled by the conditioner;
    ``use_fp16`` means a bf16 torso with f32 params. ``small_size`` and
    ``use_checkpoint`` (training) are accepted for CLI parity."""
    _ = small_size, use_checkpoint
    if large_size in (512, 256):
        channel_mult = (1, 1, 2, 2, 4, 4)
    elif large_size == 64:
        channel_mult = (1, 2, 3, 4)
    else:  # the 96^3 production config
        channel_mult = (1, 1, 2, 3, 4)
    return SuperResModel(
        in_channels=1,
        model_channels=num_channels,
        out_channels=(1 if not learn_sigma else 2),
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds_from_resolutions(
            large_size, attention_resolutions),
        dropout=dropout,
        channel_mult=channel_mult,
        dims=3,
        num_classes=(NUM_CLASSES if class_cond else None),
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        middle_attention=False,
        dtype=torch.bfloat16 if use_fp16 else torch.float32,
    )


def create_gaussian_diffusion(
    *,
    steps=1000,
    learn_sigma=False,
    sigma_small=False,
    noise_schedule="linear",
    use_kl=False,
    predict_xstart=False,
    predict_v=False,
    rescale_timesteps=False,
    rescale_learned_sigmas=False,
    timestep_respacing="",
) -> Tuple[Schedule, DiffusionConfig]:
    """Respaced schedule and the process config; ``predict_v`` wins over
    ``predict_xstart``."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if not timestep_respacing:
        timestep_respacing = [steps]
    sched = make_spaced_schedule(
        betas, sorted(space_timesteps(steps, timestep_respacing))
    )
    if predict_v:
        mean_type = MeanType.VELOCITY
    else:
        mean_type = MeanType.START_X if predict_xstart else MeanType.EPSILON
    if learn_sigma:
        var_type = VarType.LEARNED_RANGE
    else:
        var_type = VarType.FIXED_SMALL if sigma_small else VarType.FIXED_LARGE
    cfg = DiffusionConfig(
        mean_type=mean_type,
        var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
        original_num_steps=steps,
    )
    return sched, cfg


def sr_create_model_and_diffusion(
    large_size,
    small_size,
    class_cond,
    learn_sigma,
    num_channels,
    num_res_blocks,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    attention_resolutions,
    dropout,
    diffusion_steps,
    noise_schedule,
    timestep_respacing,
    use_kl,
    predict_xstart,
    rescale_timesteps,
    rescale_learned_sigmas,
    use_checkpoint,
    use_scale_shift_norm,
    resblock_updown,
    use_fp16,
    predict_v=False,
):
    """-> (model, schedule, config) from the CLI's flags."""
    model = sr_create_model(
        large_size,
        small_size,
        num_channels,
        num_res_blocks,
        learn_sigma=learn_sigma,
        class_cond=class_cond,
        use_checkpoint=use_checkpoint,
        attention_resolutions=attention_resolutions,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        dropout=dropout,
        resblock_updown=resblock_updown,
        use_fp16=use_fp16,
    )
    sched, cfg = create_gaussian_diffusion(
        steps=diffusion_steps,
        learn_sigma=learn_sigma,
        noise_schedule=noise_schedule,
        use_kl=use_kl,
        predict_xstart=predict_xstart,
        predict_v=predict_v,
        rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing,
    )
    return model, sched, cfg
