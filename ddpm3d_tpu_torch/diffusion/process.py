"""Diffusion process math: forward q, posterior, reverse p.

Port of ``ddpm3d_tpu/diffusion/process.py``: functions over a
:class:`~.schedules.Schedule` (on the tensors' device) and a static
:class:`DiffusionConfig`. Tensors are channels-last ``[B, ..., C]``; the
model is called with the original chain's timesteps.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional

import torch

from .schedules import Schedule


class MeanType(enum.Enum):
    """What the model's mean head predicts."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"
    VELOCITY = "velocity"


class VarType(enum.Enum):
    """How the reverse variance is determined."""

    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    """Training loss selection (training waits for a later slice)."""

    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    mean_type: MeanType = MeanType.EPSILON
    var_type: VarType = VarType.FIXED_LARGE
    loss_type: LossType = LossType.MSE
    rescale_timesteps: bool = False
    # length of the original chain (not the respaced one)
    original_num_steps: int = 1000


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, broadcast over trailing dims."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def model_timesteps(
    sched: Schedule, cfg: DiffusionConfig, t: torch.Tensor
) -> torch.Tensor:
    """Internal (respaced) steps -> what the model is fed: ``timestep_map``
    then optional 0..1000 rescaling."""
    new_t = sched.timestep_map[t]
    if cfg.rescale_timesteps:
        return new_t.float() * (1000.0 / cfg.original_num_steps)
    return new_t


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    """Moments of the posterior q(x_{t-1} | x_t, x_0)."""
    nd = x_t.dim()
    posterior_mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    posterior_variance = extract(sched.posterior_variance, t, nd)
    posterior_log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    nd = x_t.dim()
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    nd = x_t.dim()
    coef1 = extract(sched.posterior_mean_coef1, t, nd)
    coef2 = extract(sched.posterior_mean_coef2, t, nd)
    return xprev / coef1 - (coef2 / coef1) * x_t


def predict_xstart_from_v(sched: Schedule, x_t, t, v):
    """x0 = sqrt(acp) * x_t - sqrt(1 - acp) * v."""
    nd = x_t.dim()
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


ModelFn = Callable[..., torch.Tensor]


def p_mean_variance(
    model_fn: ModelFn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Reverse-step distribution p(x_{t-1} | x_t) and x0-hat, for every mean
    and variance mode. Returns mean / variance / log_variance /
    pred_xstart (shaped like x) and the raw ``model_output``."""
    model_kwargs = model_kwargs or {}
    C = x.shape[-1]
    nd = x.dim()
    model_output = model_fn(x, model_timesteps(sched, cfg, t), **model_kwargs)

    if cfg.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        if model_output.shape != x.shape[:-1] + (2 * C,):
            raise ValueError(
                f"expected learned-variance output {x.shape[:-1] + (2 * C,)}, "
                f"got {tuple(model_output.shape)}"
            )
        model_output, model_var_values = torch.split(model_output, C, dim=-1)
        if cfg.var_type == VarType.LEARNED:
            model_log_variance = model_var_values.float()
            model_variance = torch.exp(model_log_variance)
        else:
            # interpolate the log-variance between the posterior's (min) and
            # beta (max) with the model's [-1, 1] output
            min_log = extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = extract(sched.log_betas, t, nd)
            frac = (model_var_values.float() + 1.0) / 2.0
            model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
    else:
        if cfg.var_type == VarType.FIXED_LARGE:
            model_variance = extract(sched.fixed_large_variance, t, nd)
            model_log_variance = extract(sched.fixed_large_log_variance, t, nd)
        else:  # FIXED_SMALL
            model_variance = extract(sched.posterior_variance, t, nd)
            model_log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
        model_variance = model_variance.expand(x.shape)
        model_log_variance = model_log_variance.expand(x.shape)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    out_f32 = model_output.float()
    if cfg.mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, out_f32))
        model_mean = out_f32
    elif cfg.mean_type in (MeanType.START_X, MeanType.EPSILON, MeanType.VELOCITY):
        if cfg.mean_type == MeanType.START_X:
            pred_xstart = process_xstart(out_f32)
        elif cfg.mean_type == MeanType.VELOCITY:
            pred_xstart = process_xstart(predict_xstart_from_v(sched, x, t, out_f32))
        else:
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, out_f32))
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    else:
        raise NotImplementedError(cfg.mean_type)

    return {
        "mean": model_mean,
        "variance": model_variance,
        "log_variance": model_log_variance.expand(x.shape),
        "pred_xstart": pred_xstart,
        "model_output": model_output,
    }
