"""Likelihood terms and training losses.

Port of ``ddpm3d_tpu/diffusion/losses.py``: KL, the tanh normal CDF, the
discretized Gaussian log-likelihood, the per-step VLB term, the training
losses of every loss, mean and variance mode, and the full bits-per-dim
loop. Tensors are channels-last ``[B, ..., C]``; the noise is given by the
caller or drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from . import process
from .process import DiffusionConfig, LossType, MeanType, VarType
from .schedules import Schedule

_LN2 = math.log(2.0)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.dim())))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)) in nats; scalars and
    tensors broadcast."""
    logvar1, logvar2 = (
        v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float32)
        for v in (logvar1, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """tanh approximation of the standard normal CDF."""
    return 0.5 * (
        1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to 1/255 bins; x in [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta),
    )


def vb_terms_bpd(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Per-example VLB term in bits: the KL, or the decoder NLL at t = 0."""
    true_mean, _, true_log_var = process.q_posterior_mean_variance(
        sched, x_start, x_t, t)
    out = process.p_mean_variance(
        model_fn, sched, cfg, x_t, t,
        clip_denoised=clip_denoised, model_kwargs=model_kwargs,
    )
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    kl = mean_flat(kl) / _LN2
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out["pred_xstart"]}


def training_losses(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    t: torch.Tensor,
    model_kwargs: Optional[Dict[str, Any]] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Per-example training losses for a batch of timesteps ``t``.

    ``noise`` defaults to a standard normal draw from ``generator``. With a
    learned variance under an MSE loss, the VLB term sees a detached mean,
    so variance learning cannot move the eps prediction (the reference's
    ``frozen_out``)."""
    model_kwargs = model_kwargs or {}
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator,
                            dtype=x_start.dtype, device=x_start.device)
    x_t = process.q_sample(sched, x_start, t, noise)

    terms: Dict[str, torch.Tensor] = {}
    if cfg.loss_type in (LossType.KL, LossType.RESCALED_KL):
        terms["loss"] = vb_terms_bpd(
            model_fn, sched, cfg, x_start, x_t, t,
            clip_denoised=False, model_kwargs=model_kwargs,
        )["output"]
        if cfg.loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * sched.num_timesteps
    elif cfg.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
        model_output = model_fn(
            x_t, process.model_timesteps(sched, cfg, t), **model_kwargs)
        if cfg.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            C = x_t.shape[-1]
            if model_output.shape != x_t.shape[:-1] + (2 * C,):
                raise ValueError(
                    f"expected learned-variance output "
                    f"{x_t.shape[:-1] + (2 * C,)}, got "
                    f"{tuple(model_output.shape)}")
            model_output, model_var_values = torch.split(model_output, C, -1)
            frozen_out = torch.cat(
                [model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = vb_terms_bpd(
                lambda *a, **k: frozen_out,
                sched, cfg, x_start, x_t, t, clip_denoised=False,
            )["output"]
            if cfg.loss_type == LossType.RESCALED_MSE:
                # keep the VLB term from dominating the MSE
                terms["vb"] = terms["vb"] * (sched.num_timesteps / 1000.0)

        if cfg.mean_type == MeanType.PREVIOUS_X:
            target = process.q_posterior_mean_variance(sched, x_start, x_t, t)[0]
        elif cfg.mean_type == MeanType.START_X:
            target = x_start
        elif cfg.mean_type == MeanType.VELOCITY:
            target = process.predict_v(sched, x_start, t, noise)
        else:
            target = noise
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(
                f"model output {tuple(model_output.shape)} does not match "
                f"x_start {tuple(x_start.shape)}")
        terms["mse"] = mean_flat((target.float() - model_output.float()) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    else:
        raise NotImplementedError(cfg.loss_type)
    return terms


def prior_bpd(sched: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """Prior KL term KL(q(x_T | x_0) || N(0, 1)) in bits per dim."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1,
                   dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_variance = process.q_mean_variance(sched, x_start, t)
    kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)
    return mean_flat(kl_prior) / _LN2


def calc_bpd_loop(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    clip_denoised: bool = True,
    model_kwargs: Optional[Dict[str, Any]] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Full VLB evaluation over every timestep, t = T-1 .. 0. ``noise``
    [T, *x_start.shape] gives each step's draw in that order (else drawn
    from ``generator``). Returns [B, T] stacks in the same order, plus the
    prior and total bits per dim."""
    B, T = x_start.shape[0], sched.num_timesteps
    vb, xstart_mse, mse = [], [], []
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=x_start.device)
        eps = noise[i] if noise is not None else torch.randn(
            x_start.shape, generator=generator, dtype=x_start.dtype,
            device=x_start.device)
        x_t = process.q_sample(sched, x_start, t, eps)
        out = vb_terms_bpd(
            model_fn, sched, cfg, x_start, x_t, t,
            clip_denoised=clip_denoised, model_kwargs=model_kwargs,
        )
        pred_eps = process.predict_eps_from_xstart(
            sched, x_t, t, out["pred_xstart"])
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        mse.append(mean_flat((pred_eps - eps) ** 2))
    vb = torch.stack(vb, dim=1)
    prior = prior_bpd(sched, x_start)
    return {
        "total_bpd": vb.sum(dim=1) + prior,
        "prior_bpd": prior,
        "vb": vb,
        "xstart_mse": torch.stack(xstart_mse, dim=1),
        "mse": torch.stack(mse, dim=1),
    }
