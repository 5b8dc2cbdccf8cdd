"""Progressive distillation: halve the sampling chain, teacher -> student.

Port of ``ddpm3d_tpu/training/distill.py`` (Salimans & Ho, "Progressive
Distillation for Fast Sampling of Diffusion Models", ICLR 2022). A student
whose N/2-step deterministic (DDIM) chain reproduces its teacher's N-step
chain is trained from the teacher; repeating halves the chain down to a few
steps.

Discrete time over the ``Schedule`` tables: the teacher chain keeps the
sorted original steps K (|K| = 2N), the student the odd positions K[1::2],
so student step i has the teacher's acp at 2i+1 and its DDIM predecessor
the teacher's at 2i-1 (1.0 at i = 0). The target is the x0 that makes ONE
student DDIM step from x_t land on the teacher's two-step result z'':

    x0~ = (z'' - (sig''/sig) x_t) / (alpha'' - (sig''/sig) alpha)

converted to the model's output parameterization (v / eps / x0). Every
phase trains the same architecture on original-chain timesteps (through
``timestep_map``), so a distilled ``.pt`` serves through the serving CLI's
``--timesteps_file`` with the phase's kept steps.

PyTorch idiom: the teacher and the student are modules (the teacher run
without gradients, the student without dropout, as the JAX package applies
both with ``train=False``); ``i`` and the noise are explicit or drawn from
``torch.Generator``s; the update half is the training step's
:func:`.train_loop.apply_update` (grad norm, the non-finite skip, AdamW,
EMA). Under a process group the student is data parallel exactly like
:class:`.train_loop.TrainLoop`: each rank trains on its rows of the global
batch, and ``i`` and the noise are the global batch's draws.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..diffusion import losses as dlosses
from ..diffusion import process
from ..diffusion.process import DiffusionConfig, MeanType, VarType
from ..diffusion.sampling import ddim_sample
from ..diffusion.schedules import Schedule, make_spaced_schedule
from ..parallel import data_parallel, rank_rows, unwrap, world
from ..utils import logger
from .train_loop import TrainState, apply_update, make_optimizer


def halve_timesteps(use_timesteps: Sequence[int]) -> list:
    """Student kept-step set: the odd positions of the sorted teacher set
    (the highest step stays, so both chains start from the same x_T)."""
    ts = sorted(use_timesteps)
    if len(ts) % 2:
        raise ValueError(f"teacher chain length {len(ts)} must be even")
    return ts[1::2]


def distill_schedules(
    betas: np.ndarray, teacher_use_timesteps: Sequence[int]
) -> Tuple[Schedule, Schedule, list]:
    """(teacher_sched, student_sched, student_use_timesteps)."""
    t_ts = sorted(teacher_use_timesteps)
    s_ts = halve_timesteps(t_ts)
    return (make_spaced_schedule(betas, t_ts),
            make_spaced_schedule(betas, s_ts), s_ts)


@torch.no_grad()
def distill_targets(
    teacher,
    teacher_sched: Schedule,
    student_sched: Schedule,
    cfg: DiffusionConfig,
    x_t: torch.Tensor,
    i: torch.Tensor,
    model_kwargs: Optional[Dict[str, Any]] = None,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """The teacher's two DDIM steps (eta 0) from x_t at STUDENT step ``i``
    [B] (teacher steps 2i+1, then 2i) -> the x0-space target."""
    nd = x_t.dim()
    j = 2 * i + 1
    zeros = torch.zeros_like(x_t)  # the step noise, scaled by sigma = 0
    out1 = ddim_sample(teacher, teacher_sched, cfg, x_t, j, zeros,
                       clip_denoised=clip_denoised, model_kwargs=model_kwargs,
                       eta=0.0)
    z2 = ddim_sample(teacher, teacher_sched, cfg, out1["sample"], j - 1,
                     zeros, clip_denoised=clip_denoised,
                     model_kwargs=model_kwargs, eta=0.0)["sample"]
    alpha = process.extract(student_sched.sqrt_alphas_cumprod, i, nd)
    sigma = process.extract(student_sched.sqrt_one_minus_alphas_cumprod, i, nd)
    acp_prev = process.extract(student_sched.alphas_cumprod_prev, i, nd)
    alpha_p = torch.sqrt(acp_prev)
    sigma_p = torch.sqrt(1.0 - acp_prev)
    ratio = sigma_p / sigma
    # alpha_p - ratio * alpha > 0: acp_prev > acp along any chain
    return (z2 - ratio * x_t) / (alpha_p - ratio * alpha)


def target_to_model_space(sched: Schedule, mean_type: MeanType, x_t, i,
                          x0_target):
    """An x0-space target in the model's output parameterization (v-space
    MSE is the (SNR+1)-weighted x0 MSE, eps-space the SNR-weighted)."""
    nd = x_t.dim()
    alpha = process.extract(sched.sqrt_alphas_cumprod, i, nd)
    sigma = process.extract(sched.sqrt_one_minus_alphas_cumprod, i, nd)
    if mean_type == MeanType.VELOCITY:
        return (alpha * x_t - x0_target) / sigma
    if mean_type == MeanType.EPSILON:
        return (x_t - alpha * x0_target) / sigma
    if mean_type == MeanType.START_X:
        return x0_target
    raise NotImplementedError(f"distillation with {mean_type}")


def distill_losses(
    student,
    teacher,
    teacher_sched: Schedule,
    student_sched: Schedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    i: torch.Tensor,
    model_kwargs: Optional[Dict[str, Any]] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    vb_weight: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Per-example distillation loss at student steps ``i`` [B]; ``noise``
    defaults to a draw from ``generator``.

    With a learned variance the MSE takes the mean channels only (the
    distilled chain samples deterministically); ``vb_weight > 0`` also
    trains the variance channels on the student schedule's VLB with the
    mean detached."""
    model_kwargs = model_kwargs or {}
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator,
                            dtype=x_start.dtype, device=x_start.device)
    x_t = process.q_sample(student_sched, x_start, i, noise)
    x0_target = distill_targets(
        teacher, teacher_sched, student_sched, cfg, x_t, i,
        model_kwargs=model_kwargs, clip_denoised=clip_denoised)
    target = target_to_model_space(student_sched, cfg.mean_type, x_t, i,
                                   x0_target)
    s_out = student(x_t, process.model_timesteps(student_sched, cfg, i),
                    **model_kwargs)
    terms: Dict[str, torch.Tensor] = {}
    if cfg.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        s_mean, s_var = torch.split(s_out, x_t.shape[-1], dim=-1)
        if vb_weight > 0.0:
            frozen = torch.cat([s_mean.detach(), s_var], dim=-1)
            terms["vb"] = vb_weight * dlosses.vb_terms_bpd(
                lambda *a, **k: frozen, student_sched, cfg,
                x_start, x_t, i, clip_denoised=False)["output"]
        s_out = s_mean
    terms["mse"] = dlosses.mean_flat((target.float() - s_out.float()) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    return terms


def distill_step(
    state: TrainState,
    teacher,
    teacher_sched: Schedule,
    student_sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    cond: Dict[str, torch.Tensor],
    i: torch.Tensor,
    noise: torch.Tensor,
    *,
    lr: float,
    ema_rate: float = 0.0,
    clip_denoised: bool = True,
    vb_weight: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """One optimizer step of the student (``state.model``, under DDP when
    data parallel) on this rank's rows with the given ``i`` and noise: the
    mean loss's gradients, then :func:`.train_loop.apply_update` at the
    fixed rate ``lr`` (grad norm over all gradients; on a non-finite norm
    the student, optimizer state and EMA stay as they were; the EMA in
    ``state.ema_params`` only with ``ema_rate``). Returns the metrics on the
    device: this rank's mean ``loss``, ``mse`` (and ``vb``), the global
    ``grad_norm`` and ``skipped_nonfinite``."""
    state.model.zero_grad(set_to_none=True)
    terms = distill_losses(
        state.model, teacher, teacher_sched, student_sched, cfg, x, i,
        model_kwargs=cond, noise=noise, clip_denoised=clip_denoised,
        vb_weight=vb_weight)
    loss = torch.mean(terms["loss"])
    loss.backward()
    terms = {k: v.detach() for k, v in terms.items()}
    update = apply_update(state, i, terms, torch.ones_like(terms["loss"]),
                          lr, 0, (ema_rate,) if ema_rate else ())
    metrics = {"loss": loss.detach(), "mse": torch.mean(terms["mse"]),
               "grad_norm": update["grad_norm"],
               "skipped_nonfinite": update["skipped_nonfinite"]}
    if "vb" in terms:
        metrics["vb"] = torch.mean(terms["vb"])
    return metrics


def distill_phase(
    teacher: nn.Module,
    student: nn.Module,
    betas: np.ndarray,
    teacher_use_timesteps: Sequence[int],
    cfg: DiffusionConfig,
    data,
    *,
    steps: int,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    ema_rate: float = 0.0,
    clip_denoised: bool = True,
    vb_weight: float = 0.0,
    seed: int = 0,
    log_every: int = 50,
    device=None,
):
    """One halving: ``student`` (the same architecture; its weights are set
    to the teacher's first) learns the teacher's chain / 2. ``data`` yields
    ``(batch, cond_dict)`` of this rank's rows, like the training loader.
    The teacher's weights are not changed; it and the student move to
    ``device`` (``cuda`` unless the caller asks for the CPU).

    Returns ``(weights, student_use_timesteps)``: a state dict on the CPU of
    the student, or of its EMA when ``ema_rate``."""
    device = resolve_device(device)
    rank, world_size = world()
    t_sched, s_sched, s_ts = distill_schedules(betas, teacher_use_timesteps)
    t_sched, s_sched = t_sched.to(device), s_sched.to(device)
    n_steps = s_sched.num_timesteps
    teacher.to(device).eval().requires_grad_(False)
    module = unwrap(student).to(device).eval().requires_grad_(True)
    module.load_state_dict(teacher.state_dict())
    wrapped = data_parallel(student, device)
    params = list(module.parameters())
    state = TrainState(
        step=0, model=wrapped,
        optimizer=make_optimizer(params, lr, weight_decay),
        ema_params=[[p.detach().clone() for p in params]] if ema_rate else [])
    i_gen = torch.Generator().manual_seed(seed)
    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)

    for step in range(steps):
        batch, cond = next(data)
        x = torch.as_tensor(batch).to(device, torch.float32)
        c = {k: torch.as_tensor(v).to(device, torch.float32)
             for k, v in cond.items()}
        rows = x.shape[0]
        glob = rows * world_size  # the global batch's draws, this rank's rows
        i = rank_rows(torch.randint(0, n_steps, (glob,), generator=i_gen),
                      rank, world_size).to(device)
        noise = rank_rows(torch.randn((glob,) + tuple(x.shape[1:]),
                                      generator=noise_gen, device=device),
                          rank, world_size)
        metrics = distill_step(
            state, teacher, t_sched, s_sched, cfg, x, c, i, noise, lr=lr,
            ema_rate=ema_rate, clip_denoised=clip_denoised,
            vb_weight=vb_weight)
        if step % log_every == 0 or step == steps - 1:
            host = {k: float(v) for k, v in metrics.items()}
            local = [k for k in ("loss", "mse", "vb") if k in host]
            host.update(logger.gather_weighted_means(
                {k: host[k] for k in local}, {k: rows for k in local}))
            logger.logkv("distill/steps_to", n_steps)
            for k, v in host.items():
                logger.logkv_mean(f"distill/{k}", v)
            logger.logkv("distill/step", step)
            logger.dumpkvs()
    names = [n for n, _ in module.named_parameters()]
    final = state.ema_params[0] if ema_rate else params
    return ({n: p.detach().to("cpu", copy=True)
             for n, p in zip(names, final)}, s_ts)


def progressive_distill(
    model: nn.Module,
    betas: np.ndarray,
    cfg: DiffusionConfig,
    data,
    *,
    target_steps: int,
    steps_per_phase: int,
    start_use_timesteps: Optional[Sequence[int]] = None,
    lr: float = 1e-4,
    device=None,
    **phase_kwargs,
):
    """Halve the chain until it is at most ``target_steps`` long, yielding
    ``(weights, use_timesteps)`` after each phase. ``model`` holds the first
    teacher's weights and is every phase's teacher: before the next phase
    it is loaded with this phase's result (the student, or its EMA). The
    whole halving ladder is validated before any training."""
    use_ts = (list(range(len(betas))) if start_use_timesteps is None
              else sorted(start_use_timesteps))
    n = len(use_ts)
    while n > target_steps:
        if n % 2:
            raise ValueError(
                f"halving ladder hits odd chain length {n} before reaching "
                f"{target_steps}; start from an even/power-of-two chain "
                f"(e.g. --start_respacing 512 or 256 for a 1000-step teacher)"
            )
        n //= 2
    device = resolve_device(device)
    # one student module (and one DDP wrapper) for every phase
    student = data_parallel(
        copy.deepcopy(model).to(device).requires_grad_(True), device)
    while len(use_ts) > target_steps:
        logger.log(
            f"distilling {len(use_ts)} -> {len(use_ts) // 2} steps "
            f"({steps_per_phase} optimizer steps)"
        )
        weights, use_ts = distill_phase(
            model, student, betas, use_ts, cfg, data, steps=steps_per_phase,
            lr=lr, device=device, **phase_kwargs)
        yield weights, use_ts
        model.load_state_dict(weights, strict=True)
