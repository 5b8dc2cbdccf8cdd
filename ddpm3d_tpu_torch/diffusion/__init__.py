"""Diffusion schedules, process math, training losses, classifier guidance,
eps-scale calibration and the DDPM ancestral, DDIM and DPM-Solver++
samplers."""

from .calibration import eps_corrected_model_fn, estimate_eps_scale
from .dpm_solver import dpm_solver_pp_sample_loop
from .losses import (
    calc_bpd_loop,
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
    prior_bpd,
    training_losses,
    vb_terms_bpd,
)
from .process import (
    DiffusionConfig,
    LossType,
    MeanType,
    VarType,
    condition_mean,
    condition_score,
    extract,
    model_timesteps,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_v,
    predict_xstart_from_eps,
    predict_xstart_from_v,
    predict_xstart_from_xprev,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
)
from .sampling import (
    ddim_reverse_sample,
    ddim_sample,
    ddim_sample_loop,
    p_sample,
    p_sample_loop,
    p_sample_loop_progressive,
)
from .schedules import (
    Schedule,
    betas_for_alpha_bar,
    cosine_beta_schedule,
    get_named_beta_schedule,
    linear_beta_schedule,
    make_schedule,
    make_spaced_schedule,
    space_timesteps,
)
