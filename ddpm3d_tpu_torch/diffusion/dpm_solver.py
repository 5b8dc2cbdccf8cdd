"""DPM-Solver++(2M): a second-order multistep ODE sampler.

Port of ``ddpm3d_tpu/diffusion/dpm_solver.py`` (Lu et al., 2022,
"DPM-Solver++: Fast Solver for Guided Sampling of Diffusion Probabilistic
Models"). It integrates the probability-flow ODE in log-SNR time in the
data-prediction (x0) form, which composes with ``clip_denoised`` as the
ancestral and DDIM chains do. K model calls for a K-step (respaced) chain;
deterministic given x_T. Order 1 is the eta = 0 DDIM update.

The JAX scan over the chain becomes a Python loop of model calls; alpha,
sigma and lambda are f32 tensors computed from the schedule's f32
``alphas_cumprod``, as the JAX package computes them with x64 off.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..utils import tracing
from . import process
from .process import DiffusionConfig
from .schedules import Schedule


def _alpha_sigma_lambda(acp: torch.Tensor):
    alpha = torch.sqrt(acp)
    sigma = torch.sqrt(1.0 - acp)
    lam = torch.log(alpha) - torch.log(sigma)
    return alpha, sigma, lam


def dpm_solver_pp_sample_loop(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    noise: torch.Tensor,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    order: int = 2,
    device=None,
) -> torch.Tensor:
    """Sample with DPM-Solver++({1,2}M) from x_T = ``noise`` over the
    schedule's K timesteps (use a spaced schedule to pick K).

    Step i walks the chain index K-1 -> 0 and integrates from lambda[idx] to
    lambda[idx-1]; the first step is first order, and the last (idx = 0)
    returns its x0 prediction exactly, the reference chains' endpoint. The
    chain runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``),
    where ``noise`` and the schedule are moved."""
    if order not in (1, 2):
        raise ValueError("orders 1 (DDIM-equivalent) and 2M are supported")
    device = resolve_device(device)
    sched = sched.to(device)
    x = noise.to(device=device, dtype=torch.float32)
    B = x.shape[0]
    K = sched.num_timesteps
    alphas, sigmas, lams = _alpha_sigma_lambda(sched.alphas_cumprod)

    d_prev = h_prev = None
    for i in range(K):
        with tracing.span("ddpm.sampler.step"):
            idx = K - 1 - i
            t = torch.full((B,), idx, dtype=torch.long, device=device)
            d = process.p_mean_variance(
                model_fn, sched, cfg, x, t,
                clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                model_kwargs=model_kwargs,
            )["pred_xstart"]
            if idx == 0:  # the ODE ends at t = 0: x = x0
                return d
            h = lams[idx - 1] - lams[idx]
            d_used = d
            if order == 2 and d_prev is not None:
                r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
                r = torch.where(r == 0, torch.ones_like(r), r)
                d_used = ((1.0 + 1.0 / (2.0 * r)) * d
                          - (1.0 / (2.0 * r)) * d_prev)
            ratio = sigmas[idx - 1] / sigmas[idx]
            coef = alphas[idx - 1] * -torch.expm1(-h)
            x = ratio * x + coef * d_used
            d_prev, h_prev = d, h
    raise ValueError("the schedule has no timesteps")
