"""Epsilon-scale calibration: measure and correct a model's systematic eps
bias, so that deterministic and few-step samplers work.

Port of ``ddpm3d_tpu/diffusion/calibration.py``. A trained denoiser may
carry a small multiplicative eps bias lambda(t) that the full ancestral
chain tolerates but DDIM, respaced DDPM and DPM-Solver++ integrate into
collapse. It is a per-timestep scalar, measured teacher-forced on clean
volumes and removed at sampling time:

    lambda(t) = <eps_hat, eps> / <eps, eps>     (summed over the draws)
    eps_corrected(x, t) = eps_hat(x, t) / lambda(t)

The eps draws come from a ``torch.Generator`` (the JAX package folds a
key), or are given explicitly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import process
from .process import DiffusionConfig
from .schedules import Schedule


def estimate_eps_scale(
    model_fn: Callable,
    sched: Schedule,
    cfg: DiffusionConfig,
    x0: torch.Tensor,
    model_kwargs: Optional[Dict[str, Any]] = None,
    t_points: Optional[Sequence[int]] = None,
    draws: int = 4,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Teacher-forced lambda(t) fit on clean data ``x0`` [B, ...].

    At each of ``t_points`` (default: 17 points evenly over the chain)
    ``draws`` eps draws of x0's shape are taken from ``generator`` on x0's
    device, or from ``eps`` [len(t_points), draws, *x0.shape]. Returns a
    dense [T] float32 table, linear between the points. Fit it on training
    or validation volumes, not on the volume being denoised."""
    T = sched.num_timesteps
    if t_points is None:
        t_points = sorted({int(t) for t in np.linspace(0, T - 1, 17)})
    t_points = [int(t) for t in t_points]
    if eps is not None and tuple(eps.shape) != (
            (len(t_points), draws) + tuple(x0.shape)):
        raise ValueError(
            f"eps {tuple(eps.shape)} != {(len(t_points), draws)} + x0 "
            f"{tuple(x0.shape)}")
    sched = sched.to(x0.device)
    B, nd = x0.shape[0], x0.dim()
    lams = []
    with torch.no_grad():
        for j, t_s in enumerate(t_points):
            t = torch.full((B,), t_s, dtype=torch.long, device=x0.device)
            num = den = 0.0
            for d in range(draws):
                e = (eps[j, d].to(x0.device) if eps is not None else
                     torch.randn(x0.shape, generator=generator,
                                 device=x0.device))
                x_t = process.q_sample(sched, x0, t, e)
                out = process.p_mean_variance(
                    model_fn, sched, cfg, x_t, t, clip_denoised=False,
                    model_kwargs=model_kwargs)
                eps_hat = (
                    process.extract(sched.sqrt_recip_alphas_cumprod, t, nd)
                    * x_t - out["pred_xstart"]
                ) / process.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)
                num += float(torch.sum(eps_hat * e))
                den += float(torch.sum(e * e))
            lams.append(num / max(den, 1e-12))
    return np.interp(np.arange(T), np.asarray(t_points, np.float64),
                     np.asarray(lams, np.float64)).astype(np.float32)


def eps_corrected_model_fn(
    model_fn: Callable,
    lam_table: np.ndarray,
    learn_sigma: bool = True,
    rescale_timesteps: bool = False,
    original_num_steps: int = 1000,
) -> Callable:
    """Wrap ``model_fn`` so that its eps output is divided by lambda(t).

    ``lam_table`` indexes the ORIGINAL timesteps (the model's t), so the
    wrapper composes with respaced schedules, which map t before calling
    the model. With ``rescale_timesteps`` the model receives t scaled to
    0..1000 (:func:`.process.model_timesteps`); the wrapper undoes that
    before indexing. With ``learn_sigma`` the variance half of the output
    passes through untouched."""
    lam = torch.as_tensor(np.asarray(lam_table, np.float32))

    def wrapped(x, t, **kw):
        out = model_fn(x, t, **kw)
        if rescale_timesteps:
            t_idx = torch.round(t * (original_num_steps / 1000.0)).long()
        else:
            t_idx = t.long()
        table = lam.to(out.device)
        scale = table[t_idx.clamp(0, table.shape[0] - 1)].reshape(
            (-1,) + (1,) * (out.dim() - 1))
        if learn_sigma:
            C = out.shape[-1] // 2
            return torch.cat([out[..., :C] / scale, out[..., C:]], dim=-1)
        return out / scale

    return wrapped
