"""End-to-end learning check: train a small conditional denoiser on
synthetic volumes, then denoise a held-out volume and verify that the
output is closer to the clean target than the noisy input (PSNR gain).

Port of ``tools/e2e_learning_check.py``, at its defaults: a 32-channel
``(1, 2)`` ``SuperResModel`` (one res block, learned range, scale-shift
norm, resblock up/down, bf16 torso), 32^3, 400 steps of batch 4 on 32
``make_pair`` volumes, a 64-step cosine schedule, ``lr`` 2e-4 and one EMA
rate ``min(0.99, 1 - 10 / steps)``. It samples the held-out volume
(``make_pair(default_rng(123))``) by DDIM over ``--sample_respace``, raw
and EMA, and takes the mean of four full DDPM chains; it passes when the
loss fell and one of the three PSNRs beats the noisy input's.

Training runs the port's ``compute_grads`` / ``apply_update``
(:class:`Trainer`: uniform t, AdamW without decay or anneal, as the JAX
package's ``make_train_step``). ``--device`` replaces ``--platform`` (the
card unless ``cpu``); ``--seed`` seeds the torch draws (t, the loss noise,
x_T and the step noise); the data draws are the JAX tool's numpy ones.

    python -m ddpm3d_tpu_torch.tools.e2e_learning_check [--steps N] [--size S]

Exits 0 and prints a JSON summary when the check passes, 1 otherwise.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..diffusion import (
    DiffusionConfig,
    LossType,
    MeanType,
    VarType,
    ddim_sample_loop,
    make_schedule,
    make_spaced_schedule,
    p_sample_loop,
    space_timesteps,
)
from ..diffusion.schedules import cosine_beta_schedule
from ..models import SuperResModel
from ..training.resample import sample_uniform
from ..training.train_loop import (
    TrainState,
    apply_update,
    compute_grads,
    make_optimizer,
)
from ..utils.metrics import psnr, ssim


def make_pair(rng: np.random.Generator, shape, noise_sigma: float = 0.35):
    """A synthetic (noisy, clean) volume pair: five Gaussian blobs scaled to
    [0, 1], plus Gaussian noise (the JAX tool's draws)."""
    Z, H, W = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, Z), np.linspace(-1, 1, H), np.linspace(-1, 1, W),
        indexing="ij",
    )
    clean = np.zeros(shape, np.float32)
    for _ in range(5):
        cz, cy, cx = rng.uniform(-0.6, 0.6, 3)
        s = rng.uniform(0.15, 0.5)
        a = rng.uniform(0.4, 1.0)
        clean += a * np.exp(
            -(((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        ).astype(np.float32)
    clean = clean / max(clean.max(), 1e-6)  # [0, 1]
    noisy = clean + rng.normal(0, noise_sigma, shape).astype(np.float32)
    return noisy, clean


def scale(v):
    """[0, 1] -> [-1, 1]."""
    return v * 2.0 - 1.0


def to_volumes(a, device) -> torch.Tensor:
    """numpy [N, Z, H, W] -> f32 [N, Z, H, W, 1] on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(a, np.float32))[..., None].to(device)


def denoised(out: torch.Tensor) -> np.ndarray:
    """A chain's [B, Z, H, W, 1] output mapped back to [0, 1] on the host."""
    return np.clip((out[..., 0].float().cpu().numpy() + 1.0) / 2.0, 0, 1)


class Trainer:
    """The JAX tools' train step on the port's ``compute_grads`` and
    ``apply_update``: t uniform from a CPU generator, the loss noise from
    one on the device (both seeded from ``seed``), AdamW at ``lr`` without
    decay or anneal, one EMA rate. The model trains in place on
    ``device``."""

    def __init__(self, model, sched, cfg: DiffusionConfig, lr: float,
                 ema_rate: float, seed: int, device):
        self.device = resolve_device(device)
        model.to(self.device).train()
        params = list(model.parameters())
        self.state = TrainState(
            step=0, model=model,
            optimizer=make_optimizer(params, lr, 0.0),
            ema_params=[[p.detach().clone() for p in params]])
        self.sched = sched.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.ema_rate = ema_rate
        self.t_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    def step(self, x: torch.Tensor,
             cond: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on the device batch ``x`` [B, ...]; its metrics."""
        t, w = sample_uniform(self.sched.num_timesteps, x.shape[0], self.t_gen)
        t, w = t.to(self.device), w.to(self.device)
        noise = torch.randn(x.shape, generator=self.noise_gen,
                            device=self.device)
        terms = compute_grads(self.state.model, self.sched, self.cfg, x, cond,
                              t, w, noise=noise)
        return apply_update(self.state, t, terms, w, self.lr, 0,
                            (self.ema_rate,))

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA weights under the model's names, on the CPU."""
        names = [n for n, _ in self.state.model.named_parameters()]
        return {n: e.detach().cpu().clone()
                for n, e in zip(names, self.state.ema_params[0])}

    def ema_model(self) -> torch.nn.Module:
        """A copy of the model holding the EMA weights, in eval mode."""
        m = copy.deepcopy(self.state.model)
        m.load_state_dict(self.ema_state_dict(), strict=True)
        return m.eval().requires_grad_(False)


def model_fn_of(model):
    return lambda x, t, **kw: model(x, t, **kw).float()


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--diffusion_steps", type=int, default=64)
    ap.add_argument("--sample_respace", type=str, default="ddim16")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds t, the loss noise, x_T and the step noise")
    return ap


def main(argv=None) -> int:
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    S = args.size
    shape = (S, S, S)

    model = SuperResModel(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(), channel_mult=(1, 2), dims=3,
        use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False, dtype=torch.bfloat16,
    )
    T = args.diffusion_steps
    betas = cosine_beta_schedule(T)
    sched = make_schedule(betas)
    cfg = DiffusionConfig(
        MeanType.EPSILON, VarType.LEARNED_RANGE, LossType.MSE,
        original_num_steps=T,
    )
    # EMA rate sized to the run: 0.999 over a few hundred steps would still
    # be ~2/3 initialization weights
    ema_rate = min(0.99, 1.0 - 10.0 / args.steps)
    trainer = Trainer(model, sched, cfg, args.lr, ema_rate, args.seed, device)

    # fixed training set of paired patches, scaled to roughly [-1, 1], on
    # the device once
    train_pairs = [make_pair(rng, shape) for _ in range(32)]
    noisy_all = to_volumes(scale(np.stack([p[0] for p in train_pairs])),
                           device)
    clean_all = to_volumes(scale(np.stack([p[1] for p in train_pairs])),
                           device)
    t0 = time.time()
    first_loss = last_loss = None
    for step in range(args.steps):
        idx = torch.from_numpy(
            rng.integers(0, len(train_pairs), size=args.batch)).to(device)
        metrics = trainer.step(clean_all[idx], {"low_res": noisy_all[idx]})
        if step == 0 or step == args.steps - 1 or step % 100 == 0:
            loss = float(metrics["loss"].mean())
            if first_loss is None:
                first_loss = loss
            last_loss = loss
            print(f"step {step}: loss {loss:.4f}", flush=True)
    train_time = time.time() - t0

    # held-out volume, respaced DDIM sampling (raw + EMA params)
    noisy, clean = make_pair(np.random.default_rng(123), shape)
    sp = make_spaced_schedule(betas,
                              sorted(space_timesteps(T, args.sample_respace)))
    low = to_volumes(scale(noisy)[None], device)
    p_noisy = psnr(clean, noisy, data_range=1.0)
    s_noisy = ssim(clean, noisy, data_range=1.0)
    result = {
        "first_loss": round(first_loss, 4),
        "last_loss": round(last_loss, 4),
        "psnr_noisy_db": round(p_noisy, 2),
        "ssim_noisy": round(s_noisy, 4),
        "ema_rate": ema_rate,
        "train_steps": args.steps,
        "train_time_s": round(train_time, 1),
    }
    ema = trainer.ema_model()
    with torch.no_grad():
        for name, m in [("raw", trainer.state.model.eval()), ("ema", ema)]:
            out = ddim_sample_loop(
                model_fn_of(m), sp, cfg, shape=(1, S, S, S, 1),
                model_kwargs={"low_res": low}, eta=0.0, seed=args.seed,
                sample_ids=[7], device=device)
            den = denoised(out)[0]
            result[f"psnr_{name}_db"] = round(
                psnr(clean, den, data_range=1.0), 2)
            result[f"ssim_{name}"] = round(ssim(clean, den, data_range=1.0), 4)
        # posterior-mean estimate: average four full-DDPM draws (the MMSE
        # estimator; single draws carry the generative variance, which is
        # what the paper's uncertainty maps quantify), one chain of batch 4
        # whose samples' noise is keyed on their ids
        out = p_sample_loop(
            model_fn_of(ema), sched, cfg, shape=(4, S, S, S, 1),
            model_kwargs={"low_res": low.expand(4, -1, -1, -1, -1)},
            seed=args.seed, sample_ids=[100, 101, 102, 103], device=device)
    avg = np.mean(denoised(out), axis=0)
    result["psnr_avg4_db"] = round(psnr(clean, avg, data_range=1.0), 2)
    result["ssim_avg4"] = round(ssim(clean, avg, data_range=1.0), 4)
    print(json.dumps(result))
    ok = (
        last_loss < first_loss
        and max(
            result["psnr_raw_db"], result["psnr_ema_db"], result["psnr_avg4_db"]
        ) > p_noisy
    )
    print("E2E LEARNING CHECK:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
