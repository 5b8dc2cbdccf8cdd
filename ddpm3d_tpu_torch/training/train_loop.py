"""Training: the step, its update half and the host loop.

Port of ``ddpm3d_tpu/training/train_loop.py``. The step is split as in the
JAX package:
  * :func:`loss_for` / :func:`compute_grads` — the loss and its gradients,
    with explicit ``t``, ``weights`` and (optionally) ``noise``; microbatches
    accumulate and are averaged;
  * :func:`apply_update` — the unscale under fp16 loss scaling, global grad
    and param norms, the skip on a non-finite gradient (params, optimizer
    state and EMA unchanged), AdamW with the linear anneal, multi-rate EMA,
    the loss-second-moment update and the loss-scale growth and backoff.

Mixed precision as in the JAX package: f32 master parameters, a bf16 torso
(the model casts the f32 weights to the activation dtype, so gradients
arrive in f32 through the cast), f32 GroupNorm and head, and no loss
scaling unless ``use_fp16_scaling``. Random draws come from
``torch.Generator``s seeded from ``seed`` (t on the host, noise on the
device); dropout draws from the default generators, seeded from ``seed``
too, because ``torch.utils.checkpoint`` replays only those. Metrics stay on
the device and drain at log and save boundaries. Checkpoints are ``.pt``
files under the reference's names (:mod:`..utils.checkpoint`).

Data parallel under a process group (``torchrun``): ``batch_size`` is the
global batch, as in the JAX package; each of W ranks takes its
``batch_size / W`` rows (W must divide the batch) and DistributedDataParallel
all-reduces the mean gradient, once per step. Every rank draws the global
batch's t and noise from the shared generators and keeps its rows, so a
seeded run draws the same whatever W is; the per-example terms and t are
gathered in rank order for the loss-second-moment update and the logs, so
every rank keeps the same state. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..diffusion.losses import training_losses
from ..diffusion.process import DiffusionConfig
from ..diffusion.schedules import Schedule
from ..parallel import (
    all_gather_rows,
    barrier,
    data_parallel,
    rank_batch,
    rank_rows,
    unwrap,
    world,
)
from ..utils import checkpoint as ckpt
from ..utils import logger
from .resample import (
    LossSecondMomentState,
    init_loss_second_moment,
    sample_loss_second_moment,
    sample_uniform,
    update_loss_second_moment,
)

INITIAL_LOG_LOSS_SCALE = 20.0


@dataclasses.dataclass
class TrainState:
    """What one update reads and writes. ``ema_params`` holds one list per
    EMA rate, aligned with ``model.parameters()``."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: List[List[torch.Tensor]]
    sampler_state: Optional[LossSecondMomentState] = None
    lg_loss_scale: Optional[float] = None


def make_optimizer(
    params, lr: float, weight_decay: float
) -> torch.optim.AdamW:
    """AdamW, b1 0.9, b2 0.999, eps 1e-8, decay on every parameter (as
    ``optax.adamw`` with no mask). The learning rate of each update comes
    from :func:`annealed_lr`."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def annealed_lr(lr: float, lr_anneal_steps: int, count: int) -> float:
    """The rate of update number ``count`` (0-based, applied updates only):
    linear anneal to zero over ``lr_anneal_steps``, constant if 0."""
    if not lr_anneal_steps:
        return lr
    return lr * max(0.0, 1.0 - count / lr_anneal_steps)


def applied_updates(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (skipped steps do not count)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                return int(float(st["step"]))
    return 0


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in f32, on their device."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def loss_for(
    model: nn.Module,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    cond: Dict[str, torch.Tensor],
    t: torch.Tensor,
    weights: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    loss_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Backward of ``mean(loss * weights) * loss_scale`` into the params'
    ``.grad`` (accumulating); returns the detached per-example terms."""
    terms = training_losses(
        model, sched, cfg, x, t, model_kwargs=cond, noise=noise,
        generator=generator)
    (torch.mean(terms["loss"] * weights) * loss_scale).backward()
    return {k: v.detach() for k, v in terms.items()}


def compute_grads(
    model: nn.Module,
    sched: Schedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    cond: Dict[str, torch.Tensor],
    t: torch.Tensor,
    weights: torch.Tensor,
    microbatch: int = 0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    loss_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Gradients of the batch loss in ``.grad`` (zeroed first). With
    ``0 < microbatch < B`` the batch runs in B / microbatch pieces whose
    gradients are summed and averaged. Under DistributedDataParallel every
    piece but the last runs in ``no_sync``: one all-reduce per call.
    Returns the per-example terms [B]."""
    model.zero_grad(set_to_none=True)
    B = x.shape[0]
    m = microbatch if 0 < microbatch < B else B
    if B % m:
        raise ValueError(f"batch {B} not divisible by microbatch {m}")
    no_sync = getattr(model, "no_sync", contextlib.nullcontext)
    parts = []
    for i in range(0, B, m):
        sl = slice(i, i + m)
        with contextlib.nullcontext() if i + m >= B else no_sync():
            parts.append(loss_for(
                model, sched, cfg, x[sl], {k: v[sl] for k, v in cond.items()},
                t[sl], weights[sl],
                noise=None if noise is None else noise[sl],
                generator=generator, loss_scale=loss_scale))
    if len(parts) > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(len(parts))
    return {k: torch.cat([d[k] for d in parts]) for k in parts[0]}


@torch.no_grad()
def apply_update(
    state: TrainState,
    t: torch.Tensor,
    terms: Dict[str, torch.Tensor],
    weights: torch.Tensor,
    lr: float,
    lr_anneal_steps: int,
    ema_rates: Sequence[float],
    fp16_scale_growth: float = 1e-3,
) -> Dict[str, Any]:
    """The update half of a step, from the gradients in ``.grad``. Returns
    the step's metrics (tensors on the device)."""
    params = [p for p in state.model.parameters()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if state.lg_loss_scale is not None:
        torch._foreach_div_(grads, 2.0 ** state.lg_loss_scale)
    grad_norm = global_norm(grads)
    param_norm = global_norm(params)
    finite = bool(torch.isfinite(grad_norm))
    if finite:
        for group in state.optimizer.param_groups:
            group["lr"] = annealed_lr(lr, lr_anneal_steps,
                                      applied_updates(state.optimizer))
        state.optimizer.step()
        for rate, ema in zip(ema_rates, state.ema_params):
            torch._foreach_mul_(ema, rate)
            torch._foreach_add_(ema, params, alpha=1.0 - rate)
    state.model.zero_grad(set_to_none=True)
    if state.sampler_state is not None:
        state.sampler_state = update_loss_second_moment(
            state.sampler_state, t.cpu(), terms["loss"].cpu())
    metrics: Dict[str, Any] = {
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "skipped_nonfinite": 0.0 if finite else 1.0,
        "t": t,
    }
    if state.lg_loss_scale is not None:
        # slow growth, backoff by 1 on overflow
        state.lg_loss_scale += fp16_scale_growth if finite else -1.0
        metrics["lg_loss_scale"] = state.lg_loss_scale
    for k, v in terms.items():
        metrics[k] = v * weights
    state.step += 1
    return metrics


def log_loss_dict(num_timesteps: int, ts, losses: Dict[str, Any]) -> None:
    """Mean and per-quartile (of t) loss logging."""
    for key, values in losses.items():
        values = np.asarray(values)
        logger.logkv_mean(key, float(values.mean()))
        for sub_t, sub_loss in zip(np.asarray(ts), values):
            quartile = int(4 * sub_t / num_timesteps)
            logger.logkv_mean(f"{key}_q{quartile}", float(sub_loss))


class TrainLoop:
    """Host-side training loop: sample t, run the step, log, save,
    resume. Runs on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises when there is no card); data parallel when a process group
    is up (the module docstring), where ``data`` yields this rank's
    ``batch_size / W`` rows."""

    def __init__(
        self,
        *,
        model: nn.Module,
        sched: Schedule,
        cfg: DiffusionConfig,
        data,
        batch_size: int,
        microbatch: int,
        lr: float,
        ema_rate,
        log_interval: int,
        save_interval: int,
        resume_checkpoint: str = "",
        fp16_scale_growth: float = 1e-3,
        use_fp16_scaling: bool = False,
        schedule_sampler: str = "uniform",
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        seed: int = 0,
        auto_resume: bool = False,
        device=None,
    ):
        if schedule_sampler not in ("uniform", "loss-second-moment"):
            raise NotImplementedError(f"unknown schedule sampler: {schedule_sampler}")
        self.device = resolve_device(device)
        self.rank, self.world_size = world()
        rank_batch(batch_size, self.world_size)  # W must divide the batch
        self.sched = sched.to(self.device)
        self.cfg = cfg
        self.data = data
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        self.lr = lr
        self.ema_rate = (
            [ema_rate] if isinstance(ema_rate, float)
            else [float(x) for x in str(ema_rate).split(",")]
        )
        self.log_interval = log_interval
        self.save_interval = save_interval
        if auto_resume and not resume_checkpoint:
            found = ckpt.latest_checkpoint(logger.get_dir() or "")
            if found:
                logger.log(f"auto-resuming from {found}")
                resume_checkpoint = found
        self.resume_checkpoint = resume_checkpoint
        self.fp16_scale_growth = fp16_scale_growth
        self.lr_anneal_steps = lr_anneal_steps
        self.resume_step = 0

        torch.manual_seed(seed)  # dropout (see the module docstring)
        self.t_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(seed + 1)

        model.to(self.device).train()
        names = [n for n, _ in model.named_parameters()]
        if self.resume_checkpoint:
            self.resume_step = ckpt.parse_resume_step_from_filename(
                self.resume_checkpoint)
            logger.log(f"loading model from checkpoint: {self.resume_checkpoint}...")
            model.load_state_dict(self._load(self.resume_checkpoint), strict=True)
        # every rank loaded the same weights; the wrapper broadcasts rank 0's
        wrapped = data_parallel(model, self.device)
        params = list(model.parameters())
        optimizer = make_optimizer(params, lr, weight_decay)
        ema_params = []
        for rate in self.ema_rate:
            ema = [p.detach().clone() for p in params]
            path = (ckpt.find_ema_checkpoint(
                self.resume_checkpoint, self.resume_step, rate)
                if self.resume_checkpoint else None)
            if path:
                logger.log(f"loading EMA from checkpoint: {path}...")
                sd = self._load(path)
                if sorted(sd) != sorted(names):
                    raise KeyError(f"{path}: EMA keys do not match the model")
                for e, n in zip(ema, names):
                    e.copy_(sd[n])
            ema_params.append(ema)
        if self.resume_checkpoint:
            path = ckpt.find_opt_checkpoint(self.resume_checkpoint, self.resume_step)
            if path:
                logger.log(f"loading optimizer state from checkpoint: {path}")
                optimizer.load_state_dict(self._load(path))
        self.state = TrainState(
            step=self.resume_step,
            model=wrapped,
            optimizer=optimizer,
            ema_params=ema_params,
            sampler_state=(init_loss_second_moment(sched.num_timesteps)
                           if schedule_sampler == "loss-second-moment" else None),
            lg_loss_scale=INITIAL_LOG_LOSS_SCALE if use_fp16_scaling else None,
        )
        self.step = 0
        self._pending_metrics: List = []
        logger.log(f"parameters:{{{sum(p.numel() for p in params)}}}")

    def _load(self, path: str):
        return torch.load(path, map_location=self.device, weights_only=True)

    @property
    def model(self) -> nn.Module:
        """The model itself (under the DDP wrapper of ``state.model``)."""
        return unwrap(self.state.model)

    def sample_t(self, batch_size: int):
        """(t, weights) on the device from the configured sampler."""
        if self.state.sampler_state is not None:
            t, w = sample_loss_second_moment(
                self.state.sampler_state, batch_size, self.t_gen)
        else:
            t, w = sample_uniform(self.sched.num_timesteps, batch_size, self.t_gen)
        return t.to(self.device), w.to(self.device)

    def run_loop(self):
        while (not self.lr_anneal_steps
               or self.step + self.resume_step < self.lr_anneal_steps):
            batch, cond = next(self.data)
            self.run_step(batch, cond)
            if self.step % self.log_interval == 0:
                self._drain_metrics()
                logger.dumpkvs()
            if self.step % self.save_interval == 0:
                self._drain_metrics()
                self.save()
                if os.environ.get("DIFFUSION_TRAINING_TEST", "") and self.step > 0:
                    return
            self.step += 1
        self._drain_metrics()
        if (self.step - 1) % self.save_interval != 0:
            self.save()

    def run_step(self, batch, cond, t=None, weights=None, noise=None):
        """One training step on this rank's rows of a host (numpy) or device
        batch. ``t``, ``weights`` and ``noise`` (this rank's rows) may be
        given; else the global batch's are drawn and this rank's kept."""
        x = torch.as_tensor(batch).to(self.device, torch.float32)
        c = {k: torch.as_tensor(v).to(self.device, torch.float32)
             for k, v in cond.items()}
        W = self.world_size
        rows = lambda a: rank_rows(a, self.rank, W)
        if t is None:
            t, weights = map(rows, self.sample_t(x.shape[0] * W))
        if noise is None:
            noise = rows(torch.randn(
                (x.shape[0] * W,) + tuple(x.shape[1:]),
                generator=self.noise_gen, device=self.device))
        scale = (1.0 if self.state.lg_loss_scale is None
                 else 2.0 ** self.state.lg_loss_scale)
        terms = compute_grads(
            self.state.model, self.sched, self.cfg, x, c, t, weights,
            microbatch=self.microbatch, noise=noise, loss_scale=scale)
        # the global batch's rows, in rank order, on every rank
        metrics = apply_update(
            self.state, all_gather_rows(t),
            {k: all_gather_rows(v) for k, v in terms.items()},
            all_gather_rows(weights), self.lr, self.lr_anneal_steps,
            self.ema_rate, self.fp16_scale_growth)
        self._pending_metrics.append((self.step, metrics))
        return metrics

    def _drain_metrics(self):
        for step_i, metrics in self._pending_metrics:
            self._log_metrics(dict(metrics), step_i)
        self._pending_metrics.clear()

    def _log_metrics(self, metrics, step_i):
        host = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                for k, v in metrics.items()}
        ts = host.pop("t")
        logger.logkv_mean("grad_norm", float(host.pop("grad_norm")))
        logger.logkv_mean("param_norm", float(host.pop("param_norm")))
        if "lg_loss_scale" in host:
            logger.logkv("lg_loss_scale", float(host.pop("lg_loss_scale")))
        if host.pop("skipped_nonfinite"):
            logger.log(f"Found non-finite grads; skipped optimizer step {step_i}")
        log_loss_dict(self.sched.num_timesteps, ts, host)
        logger.logkv("step", step_i + self.resume_step)
        logger.logkv("samples", (step_i + self.resume_step + 1) * self.batch_size)

    def ema_state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        names = [n for n, _ in self.model.named_parameters()]
        return {str(rate): dict(zip(names, ema))
                for rate, ema in zip(self.ema_rate, self.state.ema_params)}

    def save(self) -> List[str]:
        """Rank 0 writes the step's files (returns their paths; [] on the
        other ranks); then every rank waits for it, so that none runs ahead
        into the next all-reduce during a save."""
        step = self.step + self.resume_step
        logger.log(f"saving model at step {step}...")
        paths = []
        if self.rank == 0:
            paths = ckpt.save_train_checkpoint(
                logger.get_dir(), step, self.model.state_dict(),
                self.ema_state_dicts(), self.state.optimizer.state_dict())
        barrier()
        return paths
