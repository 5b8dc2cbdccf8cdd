"""DDPM ancestral and DDIM sampling.

Port of ``ddpm3d_tpu/diffusion/sampling.py``: ``p_sample`` /
``p_sample_loop`` (whole chains or segments t_hi-1 .. t_lo, optionally
with every step's output), ``p_sample_loop_progressive``, ``ddim_sample``
/ ``ddim_reverse_sample`` / ``ddim_sample_loop``. The chain is a Python
loop of model calls (eager PyTorch; the kernels do the work). Noise is
either given (``noise`` = x_T, ``noise_stream`` = one draw per step
ordered t = T-1 .. 0) or drawn from
``torch.Generator``s keyed on (seed, sample id, t), so each sample's noise
does not depend on how samples are batched — the property of the JAX
package's ``_step_noise``. DDIM draws its step noise the same way whatever
``eta`` is (at ``eta = 0`` it is multiplied by 0), so a given noise stream
lines up with the same steps on both samplers.

Classifier guidance: ``cond_fn(x, t, **model_kwargs)`` returns grad_x log
p(y | x) (times the guidance scale) at the model's timesteps; DDPM shifts
the mean by it (:func:`.process.condition_mean`), DDIM the eps
(:func:`.process.condition_score`). ``cond_fn`` takes its own gradient: a
chain under ``torch.no_grad()`` runs it under ``torch.enable_grad()`` on a
detached x (never under ``torch.inference_mode()``, whose tensors cannot
enter autograd).
"""

from __future__ import annotations

import functools
from typing import (Any, Callable, Dict, Iterator, Optional, Sequence,
                    Tuple)

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
    draw depends only on (seed, sample_ids[i], t) and the device type.

    So a seeded run is the same whatever the batch composition, the
    chunking and the number of GPUs, on one device type. It is not the same
    on the CPU and the card: the generator is MT19937 on the CPU and Philox
    on CUDA (an intended divergence, ROADMAP Queue 3; drawing on the host
    and copying would add host time to every patch-step). Neither matches
    the JAX package's ``fold_in`` draws either: tests that compare the two
    packages feed explicit noise."""
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
    cond_fn=None,
) -> Dict[str, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} with the given step noise; with
    ``cond_fn``, its mean guided (:func:`.process.condition_mean`)."""
    out = process.p_mean_variance(
        model_fn, sched, cfg, x, t,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    if cond_fn is not None:
        out["mean"] = process.condition_mean(
            cond_fn, sched, cfg, out, x, t, model_kwargs=model_kwargs)
    nonzero_mask = (t != 0).float().reshape((-1,) + (1,) * (x.dim() - 1))
    sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_sample(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    eta: float = 0.0,
    cond_fn=None,
) -> Dict[str, torch.Tensor]:
    """One DDIM step x_t -> x_{t-1} with the given step noise (scaled by
    ``eta``'s sigma; none at t = 0); with ``cond_fn``, its eps guided
    (:func:`.process.condition_score`)."""
    out = process.p_mean_variance(
        model_fn, sched, cfg, x, t,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    if cond_fn is not None:
        out = process.condition_score(
            cond_fn, sched, cfg, out, x, t, model_kwargs=model_kwargs)
    nd = x.dim()
    eps = process.predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
    alpha_bar = process.extract(sched.alphas_cumprod, t, nd)
    alpha_bar_prev = process.extract(sched.alphas_cumprod_prev, t, nd)
    sigma = (
        eta
        * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar))
        * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev)
    )
    mean_pred = (
        out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
        + torch.sqrt(1.0 - alpha_bar_prev - sigma ** 2) * eps
    )
    nonzero_mask = (t != 0).float().reshape((-1,) + (1,) * (nd - 1))
    sample = mean_pred + nonzero_mask * sigma * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_reverse_sample(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Deterministic DDIM reverse-ODE step x_t -> x_{t+1}."""
    out = process.p_mean_variance(
        model_fn, sched, cfg, x, t,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    nd = x.dim()
    eps = (
        process.extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x
        - out["pred_xstart"]
    ) / process.extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)
    alpha_bar_next = process.extract(sched.alphas_cumprod_next, t, nd)
    mean_pred = (
        out["pred_xstart"] * torch.sqrt(alpha_bar_next)
        + torch.sqrt(1.0 - alpha_bar_next) * eps
    )
    return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}


def _chain_start(shape, noise, noise_stream, seed, sample_ids, device,
                 sched: Schedule, t_hi: Optional[int], t_lo: int):
    """x_{t_hi} on the device (``noise``, else drawn keyed on ``XT_STEP``),
    the sample ids, the schedule on the device and the chain's t's."""
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
    hi = T if t_hi is None else int(t_hi)
    if not 0 <= t_lo <= T or hi > T:
        raise ValueError(f"segment [{hi}, {t_lo}) outside the {T}-step chain")
    ts = range(hi - 1, t_lo - 1, -1)
    if noise_stream is not None and noise_stream.shape[0] != len(ts):
        raise ValueError(
            f"noise_stream has {noise_stream.shape[0]} steps, the chain "
            f"segment has {len(ts)}")
    return img, ids, sched, ts


def _steps(model_fn, sched, cfg, img, ids, ts, noise_stream, seed, step_fn,
           step_kwargs, before_step=None
           ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """The reverse steps ``ts`` from ``img``: yields ``(t, step_fn's
    output)`` for each (see :func:`p_sample_loop`)."""
    B = img.shape[0]
    for i, t_scalar in enumerate(ts):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=img.device)
        if noise_stream is not None:
            eps = noise_stream[i].to(device=img.device, dtype=torch.float32)
        else:
            eps = step_noise(seed, ids, t_scalar, img.shape[1:], img.device)
        if before_step is not None:
            before_step(t_scalar)
        out = step_fn(model_fn, sched, cfg, img, t, eps, **step_kwargs)
        img = out["sample"]
        yield t_scalar, out


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
    before_step: Optional[Callable[[int], None]] = None,
    use_ddim: bool = False,
    eta: float = 0.0,
    cond_fn=None,
    return_intermediates: bool = False,
    t_hi: Optional[int] = None,
    t_lo: int = 0,
):
    """Run the reverse chain t = T-1 .. 0 and return x_0: DDPM ancestral
    steps, or DDIM steps with ``use_ddim`` (and ``eta``), guided by
    ``cond_fn`` when given.

    The chain runs on ``device``: ``cuda`` unless the caller passes
    ``"cpu"``; with no card and no such request it raises. ``noise`` is x_T
    (else drawn, keyed on ``XT_STEP``); ``noise_stream`` [n_steps, *x.shape]
    supplies each step's noise in chain order (else drawn per (seed, sample
    id, t)); both are moved to ``device``, as is the schedule.
    ``sample_ids`` default to 0..B-1. ``before_step(t)`` is called with the
    chain index before each step (the int8 sites' time bin), ``step_cb(t,
    x_{t})`` sees every step's output.

    ``t_hi`` / ``t_lo`` run only the segment t_hi-1 .. t_lo (``noise`` is
    then x_{t_hi}, ``noise_stream`` has t_hi - t_lo entries); the step
    noise is keyed on t, so segments compose to the whole chain bit for
    bit. A segment outside the chain raises (JAX clamps its gathers).
    ``return_intermediates`` returns ``(x_{t_lo}, [n_steps, *x.shape]
    every step's output)``."""
    step_fn = functools.partial(ddim_sample, eta=eta) if use_ddim else p_sample
    img, ids, sched, ts = _chain_start(shape, noise, noise_stream, seed,
                                       sample_ids, device, sched, t_hi, t_lo)
    ys = []
    for t_scalar, out in _steps(
            model_fn, sched, cfg, img, ids, ts, noise_stream, seed, step_fn,
            dict(clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                 model_kwargs=model_kwargs, cond_fn=cond_fn),
            before_step):
        img = out["sample"]
        if return_intermediates:
            ys.append(img)
        if step_cb is not None:
            step_cb(t_scalar, img)
    if not return_intermediates:
        return img
    return img, (torch.stack(ys) if ys
                 else img.new_empty((0,) + tuple(img.shape)))


def p_sample_loop_progressive(
    model_fn,
    sched: Schedule,
    cfg: DiffusionConfig,
    shape=None,
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    sample_ids: Optional[Sequence[int]] = None,
    device=None,
    noise_stream: Optional[torch.Tensor] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each DDPM ancestral step's output dict (``sample``,
    ``pred_xstart``), t = T-1 .. 0: the reference's progressive API for
    step-wise inspection. Noise, device and ids as in
    :func:`p_sample_loop`."""
    img, ids, sched, ts = _chain_start(shape, noise, noise_stream, seed,
                                       sample_ids, device, sched, None, 0)
    for _, out in _steps(
            model_fn, sched, cfg, img, ids, ts, noise_stream, seed, p_sample,
            dict(clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                 model_kwargs=model_kwargs, cond_fn=cond_fn)):
        yield out


def ddim_sample_loop(model_fn, sched: Schedule, cfg: DiffusionConfig,
                     eta: float = 0.0, **kwargs):
    """The DDIM chain: :func:`p_sample_loop` with ``use_ddim`` (its
    ``t_hi``, ``t_lo`` and ``return_intermediates`` too)."""
    return p_sample_loop(model_fn, sched, cfg, use_ddim=True, eta=eta,
                         **kwargs)
