"""The serving traffic of a cell, from its parameters and the run's seed.

One generator for every serving mix. A mix states the whole-body volume
(Z, X, Y), the patch edge, the XY patches a row, the batch of one call,
the sampler, its respacing and how many x_T draws to keep ready. From the
seed it makes:

- a synthetic low-dose volume: a body ellipsoid with a few hot lesions,
  smooth structure and noise, scaled into [-1, 1) as the model takes it;
- the conditioner patches, cut on the fixed serving grid (XY starts spread
  evenly from 0 to the edge, Z from 0 to the end): 3 x 3 x 2 = 18 patches
  of a 200 x 200 x 130 volume, served in order and cycled;
- a pool of x_T draws, one per call, cycled; and each call's seed of the
  step noise, so that no two calls of a run draw alike.

Everything is made at set-up on the run's device in a few large calls
(a generator on the card) and handed to the entry as host arrays, which is
what it takes. The same seed gives the same traffic on the same device
type.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def xy_starts(n: int, patch: int, count: int) -> List[int]:
    if count == 1 or n <= patch:
        return [0]
    return [round(i * (n - patch) / (count - 1)) for i in range(count)]


def z_starts(n: int, patch: int) -> List[int]:
    if n <= patch:
        return [0]
    count = -(-n // patch)
    return [round(i * (n - patch) / (count - 1)) for i in range(count)]


def _generator(ss: np.random.SeedSequence, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return g


def synthetic_volume(shape: Tuple[int, int, int], g: torch.Generator,
                     device) -> torch.Tensor:
    """(Z, X, Y) f32 in about [-1, 1), on ``device``."""
    Z, X, Y = shape

    def u(lo, hi, n=1):
        return torch.rand(n, generator=g, device=device) * (hi - lo) + lo

    z, x, y = torch.meshgrid(torch.linspace(-1, 1, Z, device=device),
                             torch.linspace(-1, 1, X, device=device),
                             torch.linspace(-1, 1, Y, device=device),
                             indexing="ij")
    body = ((x / 0.8) ** 2 + (y / 0.6) ** 2 + (z / 1.1) ** 2 < 1.0).float()
    vol = 0.3 * body
    for _ in range(6):
        c, r, a = u(-0.6, 0.6, 3), u(0.04, 0.15), u(0.3, 1.0)
        d2 = (z - c[0]) ** 2 + (x - c[1]) ** 2 + (y - c[2]) ** 2
        vol = vol + a * torch.exp(-d2 / (2 * r * r))
    vol = vol + 0.1 * torch.sin(7.0 * x + u(0, 6)) * torch.cos(5.0 * y) * body
    vol = vol + 0.05 * torch.randn(shape, generator=g, device=device)
    vol = vol.clamp_min(0.0)
    return vol / vol.max().clamp_min(1e-6) * 2.0 - 1.0


class ServeTraffic:
    """The calls of one serving run: ``call(k)`` -> (conditioner patches
    [n, Z, X, Y] f32, x_T [n, Z, X, Y] f32, step-noise seed), host arrays
    (the entry takes numpy) made on ``device`` in a few large calls."""

    def __init__(self, params: dict, seed: int, device="cpu"):
        self.p = params
        self.seed = seed
        vol_ss, xt_ss, call_ss = np.random.SeedSequence(seed).spawn(3)
        shape = tuple(params["volume"])
        e = params["patch"]
        with torch.no_grad():
            vol = synthetic_volume(shape, _generator(vol_ss, device), device)
            xs = xy_starts(shape[1], e, params["xy_patches"])
            ys = xy_starts(shape[2], e, params["xy_patches"])
            zs = z_starts(shape[0], e)
            self.patches = torch.stack(
                [vol[z:z + e, x:x + e, y:y + e]
                 for x in xs for y in ys for z in zs]).cpu().numpy()
            b = params["batch"]
            self.x_T = torch.randn((params["x_t_pool"], b, e, e, e),
                                   generator=_generator(xt_ss, device),
                                   device=device).cpu().numpy()
        self.call_seeds = np.random.default_rng(call_ss).integers(
            0, 2 ** 62, size=4096)

    @property
    def batch(self) -> int:
        return self.p["batch"]

    def call(self, k: int):
        b, P = self.batch, len(self.patches)
        idx = [(k * b + i) % P for i in range(b)]
        return (self.patches[idx], self.x_T[k % len(self.x_T)],
                int(self.call_seeds[k % len(self.call_seeds)]))
