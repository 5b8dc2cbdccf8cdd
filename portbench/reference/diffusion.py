"""Plain reference of the serving chain: the linear beta schedule, its
respacing, the DDPM ancestral step with a learned-range variance and an
epsilon mean, and the step noise keyed on (seed, patch, step) as the port
states it draws it on the card. Tables in float64 numpy, stored as f32.
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

# the key of x_T's draw, above any step index
XT_STEP = 2 ** 31 - 1


def linear_betas(steps: int) -> np.ndarray:
    scale = 1000.0 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def space_timesteps(steps: int, sections: str) -> list:
    """The kept steps of an even respacing ``"25"`` (one section; the
    reference's fractional stride rounded)."""
    counts = [int(s) for s in sections.split(",")]
    size_per, extra = divmod(steps, len(counts))
    kept, start = [], 0
    for i, count in enumerate(counts):
        size = size_per + (1 if i < extra else 0)
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            kept.append(start + round(cur))
            cur += stride
        start += size
    return sorted(set(kept))


def chain_tables(steps: int, respacing: str) -> Dict[str, torch.Tensor]:
    """The respaced chain's coefficient tables (f32) and its timestep map."""
    betas = linear_betas(steps)
    kept = space_timesteps(steps, respacing) if respacing else list(range(steps))
    acp_full = np.cumprod(1.0 - betas)
    last, new_betas = 1.0, []
    for i in kept:
        new_betas.append(1.0 - acp_full[i] / last)
        last = acp_full[i]
    b = np.array(new_betas)
    acp = np.cumprod(1.0 - b)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = b * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    with np.errstate(divide="ignore"):
        return {
            "log_betas": f32(np.log(b)),
            "post_log_var": f32(np.log(np.append(post_var[1], post_var[1:]))),
            "sqrt_recip_acp": f32(np.sqrt(1.0 / acp)),
            "sqrt_recipm1_acp": f32(np.sqrt(1.0 / acp - 1.0)),
            "coef1": f32(b * np.sqrt(acp_prev) / (1.0 - acp)),
            "coef2": f32((1.0 - acp_prev) * np.sqrt(1.0 - b) / (1.0 - acp)),
            "timestep_map": torch.tensor(kept, dtype=torch.long),
        }


def _seed_for(seed: int, sample_id: int, t: int) -> int:
    state = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, sample_id, t]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def step_noise(seed: int, ids: Sequence[int], t: int, shape,
               device) -> torch.Tensor:
    """Standard normal f32 [len(ids), *shape], sample i's draw from a
    generator on ``device`` seeded by (seed, ids[i], t)."""
    out = []
    for sid in ids:
        g = torch.Generator(device=device)
        g.manual_seed(_seed_for(seed, int(sid), int(t)))
        out.append(torch.randn(tuple(shape), generator=g, device=device))
    return torch.stack(out)


def ancestral_step(tab: Dict[str, torch.Tensor], out: torch.Tensor,
                   x: torch.Tensor, i: int, noise: torch.Tensor,
                   clip: bool = True) -> torch.Tensor:
    """x_{i-1} from x_i and the model's f32 output [..., 2 C] (epsilon,
    then the learned-range variance value)."""
    C = x.shape[-1]
    eps, v = out[..., :C], out[..., C:]
    frac = (v + 1.0) / 2.0
    log_var = frac * tab["log_betas"][i] + (1.0 - frac) * tab["post_log_var"][i]
    x0 = tab["sqrt_recip_acp"][i] * x - tab["sqrt_recipm1_acp"][i] * eps
    if clip:
        x0 = torch.clamp(x0, -1.0, 1.0)
    mean = tab["coef1"][i] * x0 + tab["coef2"][i] * x
    if i == 0:
        return mean
    return mean + torch.exp(0.5 * log_var) * noise


def sample_chain(model: Callable, tab: Dict[str, torch.Tensor],
                 x_T: torch.Tensor, low: torch.Tensor, seed: int,
                 ids: Sequence[int], clip: bool = True,
                 before_step: Callable[[int], None] = None,
                 on_step: Callable = None, step: Callable = ancestral_step,
                 noisy: bool = True) -> torch.Tensor:
    """The whole respaced chain from x_T [B, D, H, W, 1] with conditioner
    ``low`` [B, D, H, W, 1]; ``model(x, t_model, low)`` -> f32 output.
    ``on_step(i, x_i, output)`` sees each step's input and model output;
    ``step(tab, out, x, i, noise, clip)`` is the sampler's step (``noisy``
    False: it takes no noise)."""
    dev = x_T.device
    tab = {k: v.to(dev) for k, v in tab.items()}
    x = x_T.float()
    for i in range(len(tab["timestep_map"]) - 1, -1, -1):
        noise = step_noise(seed, ids, i, x.shape[1:], dev) if noisy else None
        if before_step is not None:
            before_step(i)
        out = model(x, tab["timestep_map"][i].expand(x.shape[0]), low)
        if on_step is not None:
            on_step(i, x, out)
        x = step(tab, out, x, i, noise, clip)
    return x
