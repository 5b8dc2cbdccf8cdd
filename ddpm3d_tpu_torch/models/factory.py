"""Model and diffusion factories.

Port of ``ddpm3d_tpu/models/factory.py``: the CLIs' flat flag namespace
becomes a model (the conditional 3-D :class:`~.unet.SuperResModel`, the
image :class:`~.unet.UNetModel`, the classifier
:class:`~.unet.EncoderUNetModel`) and a respaced schedule. The 96^3
production config lands on channel_mult (1, 1, 2, 3, 4).
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
from .unet import NUM_CLASSES, EncoderUNetModel, SuperResModel, UNetModel


def _parse_channel_mult(channel_mult, image_size) -> Tuple[float, ...]:
    """The image size's channel multipliers, or the ``"1,2,2"`` given."""
    if channel_mult == "" or channel_mult is None:
        table = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}
        if image_size not in table:
            raise ValueError(f"unsupported image size: {image_size}")
        return table[image_size]
    if isinstance(channel_mult, str):
        return tuple(int(m) for m in channel_mult.split(","))
    return tuple(channel_mult)


def _dtype(use_fp16: bool) -> torch.dtype:
    """``use_fp16`` means a bf16 torso with f32 params."""
    return torch.bfloat16 if use_fp16 else torch.float32


def create_model(
    image_size,
    num_channels,
    num_res_blocks,
    channel_mult="",
    learn_sigma=False,
    class_cond=False,
    use_checkpoint=False,
    attention_resolutions="16",
    num_heads=1,
    num_head_channels=-1,
    num_heads_upsample=-1,
    use_scale_shift_norm=False,
    dropout=0.0,
    resblock_updown=False,
    use_fp16=False,
    use_new_attention_order=False,
    dims=2,
    in_channels=3,
) -> UNetModel:
    """The unconditional or class-conditional UNet with middle attention,
    2-D over RGB by default."""
    return UNetModel(
        in_channels=in_channels,
        model_channels=num_channels,
        out_channels=(in_channels if not learn_sigma else in_channels * 2),
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds_from_resolutions(
            image_size, attention_resolutions),
        dropout=dropout,
        channel_mult=_parse_channel_mult(channel_mult, image_size),
        dims=dims,
        num_classes=(NUM_CLASSES if class_cond else None),
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
        middle_attention=True,
        use_checkpoint=use_checkpoint,
        dtype=_dtype(use_fp16),
    )


def create_classifier(
    image_size,
    classifier_use_fp16,
    classifier_width,
    classifier_depth,
    classifier_attention_resolutions,
    classifier_use_scale_shift_norm,
    classifier_resblock_updown,
    classifier_pool,
    dims=2,
    in_channels=3,
    out_channels=NUM_CLASSES,
) -> EncoderUNetModel:
    """The classifier of guidance: an encoder with 64-channel heads, built
    for ``image_size`` on every axis (which sizes the attention pool)."""
    channel_mult = _parse_channel_mult("", image_size)
    return EncoderUNetModel(
        in_channels=in_channels,
        model_channels=classifier_width,
        out_channels=out_channels,
        num_res_blocks=classifier_depth,
        attention_resolutions=attention_ds_from_resolutions(
            image_size, classifier_attention_resolutions),
        channel_mult=channel_mult,
        dims=dims,
        num_head_channels=64,
        use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown,
        pool=classifier_pool,
        dtype=_dtype(classifier_use_fp16),
        image_size=image_size,
    )


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
    fused=False,
    int8=None,
) -> SuperResModel:
    """SuperResModel_noatt with in_channels=1 doubled by the conditioner;
    ``use_fp16`` means a bf16 torso with f32 params; ``use_checkpoint``
    recomputes the high-resolution ResBlocks in the backward; ``fused``
    serves the ResBlocks without up/down through the fused conv kernel
    (inference only; off under ``use_checkpoint``); ``int8`` (an
    :class:`..ops.quant.Int8Config`) serves the conv sites it quantizes in
    int8 (inference only; not with ``fused``). ``small_size`` is accepted
    for CLI parity."""
    _ = small_size
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
        use_checkpoint=use_checkpoint,
        dtype=_dtype(use_fp16),
        fused=fused,
        int8=int8,
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
    fused=False,
    int8=None,
):
    """-> (model, schedule, config) from the CLI's flags; ``fused`` and
    ``int8`` as in :func:`sr_create_model`."""
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
        fused=fused,
        int8=int8,
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


def create_model_and_diffusion(
    image_size,
    class_cond,
    learn_sigma,
    num_channels,
    num_res_blocks,
    channel_mult,
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
    use_new_attention_order,
    predict_v=False,
):
    """-> (:func:`create_model`'s UNet, schedule, config) from the flags of
    ``utils.config.model_and_diffusion_defaults``."""
    model = create_model(
        image_size,
        num_channels,
        num_res_blocks,
        channel_mult=channel_mult,
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
        use_new_attention_order=use_new_attention_order,
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


def create_classifier_and_diffusion(
    image_size,
    classifier_use_fp16,
    classifier_width,
    classifier_depth,
    classifier_attention_resolutions,
    classifier_use_scale_shift_norm,
    classifier_resblock_updown,
    classifier_pool,
    learn_sigma,
    diffusion_steps,
    noise_schedule,
    timestep_respacing,
    use_kl,
    predict_xstart,
    rescale_timesteps,
    rescale_learned_sigmas,
    predict_v=False,
):
    """-> (:func:`create_classifier`'s encoder, schedule, config) from the
    flags of ``utils.config.classifier_and_diffusion_defaults``."""
    classifier = create_classifier(
        image_size,
        classifier_use_fp16,
        classifier_width,
        classifier_depth,
        classifier_attention_resolutions,
        classifier_use_scale_shift_norm,
        classifier_resblock_updown,
        classifier_pool,
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
    return classifier, sched, cfg
