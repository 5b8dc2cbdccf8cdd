"""Timestep samplers over explicit state.

Port of ``ddpm3d_tpu/training/resample.py``: uniform sampling with unit
weights, and loss-second-moment importance sampling with a 10-deep loss
history per timestep, ``sqrt(E[L^2])`` weights, a 0.001 uniform floor and
unbiased ``1 / (T p)`` loss weights. Draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class LossSecondMomentState:
    """Shift-register loss history per timestep."""

    loss_history: torch.Tensor  # [T, history_per_term] f32
    loss_counts: torch.Tensor   # [T] int64

    @property
    def num_timesteps(self) -> int:
        return int(self.loss_history.shape[0])

    @property
    def history_per_term(self) -> int:
        return int(self.loss_history.shape[1])


def init_loss_second_moment(
    num_timesteps: int, history_per_term: int = 10
) -> LossSecondMomentState:
    return LossSecondMomentState(
        loss_history=torch.zeros((num_timesteps, history_per_term),
                                 dtype=torch.float32),
        loss_counts=torch.zeros((num_timesteps,), dtype=torch.int64),
    )


def lsm_weights(state: LossSecondMomentState,
                uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling probabilities [T]; uniform until every timestep has a full
    history."""
    T = state.num_timesteps
    if not bool((state.loss_counts == state.history_per_term).all()):
        return torch.full((T,), 1.0 / T, dtype=torch.float32)
    w = torch.sqrt(torch.mean(state.loss_history ** 2, dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-20)
    return w * (1.0 - uniform_prob) + uniform_prob / T


def sample_uniform(
    num_timesteps: int, batch_size: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """t uniform in [0, T) with unit importance weights."""
    t = torch.randint(0, num_timesteps, (batch_size,), generator=generator)
    return t, torch.ones((batch_size,), dtype=torch.float32)


def sample_loss_second_moment(
    state: LossSecondMomentState,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    uniform_prob: float = 0.001,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample t from the loss-history weights; the weights are
    ``1 / (T p[t])``."""
    p = lsm_weights(state, uniform_prob)
    t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
    return t, 1.0 / (state.num_timesteps * p[t])


def update_loss_second_moment(
    state: LossSecondMomentState, ts, losses
) -> LossSecondMomentState:
    """Sequential shift-register update, one (t, loss) pair at a time in
    batch order, duplicates included: a full row drops its oldest entry,
    else the loss goes to the next free slot."""
    hist = state.loss_history.clone()
    counts = state.loss_counts.clone()
    H = state.history_per_term
    for t, loss in zip(torch.as_tensor(ts).tolist(),
                       torch.as_tensor(losses, dtype=torch.float32).tolist()):
        c = int(counts[t])
        if c == H:
            hist[t] = torch.cat([hist[t, 1:], torch.tensor([loss])])
        else:
            hist[t, c] = loss
            counts[t] = c + 1
    return LossSecondMomentState(hist, counts)
