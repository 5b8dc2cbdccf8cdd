"""Diffusion schedules, process math and the DDPM ancestral sampler."""

from .process import (
    DiffusionConfig,
    LossType,
    MeanType,
    VarType,
    p_mean_variance,
)
from .sampling import p_sample, p_sample_loop
from .schedules import (
    Schedule,
    get_named_beta_schedule,
    make_schedule,
    make_spaced_schedule,
    space_timesteps,
)
