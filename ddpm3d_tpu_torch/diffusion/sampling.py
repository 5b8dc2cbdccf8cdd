"""DDPM ancestral sampling.

Port of ``ddpm3d_tpu/diffusion/sampling.py:p_sample`` / ``p_sample_loop``.
The chain is a Python loop of model calls (eager PyTorch; the kernels do the
work). Noise is either given (``noise`` = x_T, ``noise_stream`` = one draw
per step ordered t = T-1 .. 0) or drawn from ``torch.Generator``s keyed on
(seed, sample id, t), so each sample's noise does not depend on how samples
are batched — the property of the JAX package's ``_step_noise``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import process
from .process import DiffusionConfig
from .schedules import Schedule

# the t key of x_T: above any timestep index (as in the JAX pipeline)
XT_STEP = 2 ** 31 - 1


def _seed_for(seed: int, sample_id: int, t: int) -> int:
    state = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, sample_id, t]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def step_noise(
    seed: int,
    sample_ids: Sequence[int],
    t: int,
    shape,
    device: torch.device,
) -> torch.Tensor:
    """Standard normal noise [len(sample_ids), *shape] in f32; sample i's
    draw depends only on (seed, sample_ids[i], t)."""
    out = []
    for sid in sample_ids:
        g = torch.Generator(device=device)
        g.manual_seed(_seed_for(seed, int(sid), int(t)))
        out.append(torch.randn(tuple(shape), generator=g, device=device))
    return torch.stack(out)


def p_sample(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} with the given step noise."""
    out = process.p_mean_variance(
        model_fn, sched, cfg, x, t,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    nonzero_mask = (t != 0).float().reshape((-1,) + (1,) * (x.dim() - 1))
    sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def p_sample_loop(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    shape=None,
    noise: Optional[torch.Tensor] = None,
    noise_stream: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    sample_ids: Optional[Sequence[int]] = None,
    device=None,
    step_cb: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Run the full reverse chain t = T-1 .. 0 and return x_0.

    The chain runs on ``device``: ``cuda`` unless the caller passes
    ``"cpu"``; with no card and no such request it raises. ``noise`` is x_T
    (else drawn, keyed on ``XT_STEP``); ``noise_stream`` [T, *x.shape]
    supplies each step's noise in chain order (else drawn per (seed, sample
    id, t)); both are moved to ``device``, as is the schedule.
    ``sample_ids`` default to 0..B-1. ``step_cb(t, x_{t})`` sees every
    step's output."""
    device = resolve_device(device)
    if noise is None:
        if shape is None:
            raise ValueError("provide shape or noise")
        ids = list(range(shape[0])) if sample_ids is None else list(sample_ids)
        noise = step_noise(seed, ids, XT_STEP, tuple(shape[1:]), device)
    img = noise.to(device=device, dtype=torch.float32)
    B = img.shape[0]
    ids = list(range(B)) if sample_ids is None else list(sample_ids)
    if len(ids) != B:
        raise ValueError("one sample id per batch element")
    sched = sched.to(device)
    T = sched.num_timesteps
    if noise_stream is not None and noise_stream.shape[0] != T:
        raise ValueError(
            f"noise_stream has {noise_stream.shape[0]} steps, chain has {T}")
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=device)
        if noise_stream is not None:
            eps = noise_stream[i].to(device=device, dtype=torch.float32)
        else:
            eps = step_noise(seed, ids, t_scalar, img.shape[1:], device)
        img = p_sample(
            model_fn, sched, cfg, img, t, eps,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            model_kwargs=model_kwargs,
        )["sample"]
        if step_cb is not None:
            step_cb(t_scalar, img)
    return img
