"""Beta schedules and diffusion coefficient tables.

Port of ``ddpm3d_tpu/diffusion/schedules.py``: every table is computed on
the host in float64 numpy and stored as float32 tensors, in the same order
of casts, so the tables equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    """Linear schedule from Ho et al., scaled so any T behaves like T=1000."""
    scale = 1000.0 / num_timesteps
    return np.linspace(
        scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64
    )


def cosine_beta_schedule(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (improved DDPM)."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return betas_for_alpha_bar(num_timesteps, alpha_bar, max_beta=max_beta)


def betas_for_alpha_bar(num_timesteps, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into per-step betas."""
    t = np.arange(num_timesteps, dtype=np.float64)
    a1 = np.array([alpha_bar(ti / num_timesteps) for ti in t])
    a2 = np.array([alpha_bar((ti + 1) / num_timesteps) for ti in t])
    return np.minimum(1.0 - a2 / a1, max_beta)


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_beta_schedule(num_timesteps)
    if name == "cosine":
        return cosine_beta_schedule(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-timestep coefficient tables (float32 tensors of length T).

    ``timestep_map`` maps internal (possibly respaced) steps back to the
    original chain's indices for the model's timestep input."""

    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to(self, device) -> "Schedule":
        """The same tables on ``device``."""
        return Schedule(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def make_schedule(
    betas: np.ndarray, timestep_map: Optional[Sequence[int]] = None
) -> Schedule:
    """Build all coefficient tables from a 1-D beta array (float64 math)."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be 1-D and in (0, 1]")
    num_timesteps = betas.shape[0]

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = (
        betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    )
    # the t=0 entry is exactly 0: clip it before the log
    if num_timesteps > 1:
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )
        fixed_large_variance = np.append(posterior_variance[1], betas[1:])
    else:
        # single-step chain: fall back to beta itself
        posterior_log_variance_clipped = np.log(np.maximum(betas, 1e-20))
        fixed_large_variance = betas.copy()
    fixed_large_log_variance = np.log(fixed_large_variance)

    if timestep_map is None:
        timestep_map = np.arange(num_timesteps, dtype=np.int32)
    timestep_map = np.asarray(timestep_map, dtype=np.int64)
    if timestep_map.shape != (num_timesteps,):
        raise ValueError("timestep_map must have one entry per step")

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    # beta can reach exactly 1.0 at the end of short linear chains, making
    # acp = 0 and 1/acp = inf, as in the reference tables
    with np.errstate(divide="ignore"):
        sqrt_recip = np.sqrt(1.0 / alphas_cumprod)
        sqrt_recipm1 = np.sqrt(1.0 / alphas_cumprod - 1.0)
    return Schedule(
        betas=f32(betas),
        log_betas=f32(np.log(betas)),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(sqrt_recip),
        sqrt_recipm1_alphas_cumprod=f32(sqrt_recipm1),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        fixed_large_variance=f32(fixed_large_variance),
        fixed_large_log_variance=f32(fixed_large_log_variance),
        timestep_map=torch.from_numpy(timestep_map),
    )


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Select a subset of an original chain's timesteps: a comma-separated
    per-section count string, a list of counts, or ``"ddimN"`` striding
    (reference respace.py:7-60 semantics, fractional stride + round())."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def make_spaced_schedule(betas: np.ndarray, use_timesteps) -> Schedule:
    """Respaced schedule: for each kept step i the new beta is
    ``1 - acp[i] / acp[last kept]``; ``timestep_map`` records i."""
    betas = np.asarray(betas, dtype=np.float64)
    use_timesteps = set(use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, acp in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1.0 - acp / last_alpha_cumprod)
            last_alpha_cumprod = acp
            timestep_map.append(i)
    return make_schedule(np.array(new_betas), timestep_map=timestep_map)
