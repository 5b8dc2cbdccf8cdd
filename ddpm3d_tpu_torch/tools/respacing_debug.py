"""Diagnose respaced-sampling quality on the respacing study's checkpoint.

Port of ``tools/respacing_debug.py``. Loads the EMA ``.pt`` that
``respacing_study`` saved (its default model: 32 channels, (1, 2), one
res block) and runs:
  1. teacher-forced eps error vs t  — is the model accurate at every t?
  2. x0-prediction PSNR and mean log-variance vs t
  3. DDPM and DDIM at the full 1000 steps, and ``ddpm250`` / ``ddim250``
     — separates "DDIM broken" from "respacing broken"
  4. truncated ancestral chains from ``q_sample(x0_clean, t0 - 1)`` through
     ``p_sample_loop(..., t_hi=t0)``: does the chain hold up when it does
     not begin at pure noise?

The draws come from ``torch.Generator``s seeded as the JAX tool keys its
(eps of (t, k): 1000 t + k; x_T: 77 on the CPU, moved; the truncated start:
5; the DDPM step noise keyed on (``--seed``, 7, t)). ``--device`` is the
card unless ``cpu``; ``--ckpt`` defaults under the temp dir, where the
study writes.

    python -m ddpm3d_tpu_torch.tools.respacing_debug [--ckpt FILE] [--size S]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..diffusion import (
    DiffusionConfig,
    LossType,
    MeanType,
    VarType,
    make_schedule,
    make_spaced_schedule,
    p_sample_loop,
    space_timesteps,
)
from ..diffusion import process
from ..diffusion.schedules import linear_beta_schedule
from ..models import SuperResModel
from ..utils.convert import load_checkpoint
from ..utils.metrics import psnr, ssim
from .e2e_learning_check import denoised, make_pair, scale, to_volumes

T = 1000
T_POINTS = (5, 25, 50, 100, 200, 300, 400, 500, 600, 700, 800, 900, 950, 990)
CHAINS = (("ddpm_full", "full", False), ("ddim_full", "full", True),
          ("ddpm250", "250", False), ("ddim250", "ddim250", True))
TRUNCATED = (100, 250, 500, 1000)


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", type=str, default=os.path.join(
        tempfile.gettempdir(), "respacing_ckpt.pt"))
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the DDPM chains' step noise")
    return ap


def main(argv=None) -> dict:
    """Prints the three tables; returns them: ``teacher`` (one row per t),
    ``chains`` and ``truncated`` ({name: {psnr, ssim}})."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    S = args.size
    model = SuperResModel(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(), channel_mult=(1, 2), dims=3,
        use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False, dtype=torch.bfloat16,
    )
    model.load_state_dict(load_checkpoint(args.ckpt), strict=True)
    model.to(device).eval().requires_grad_(False)
    betas = linear_beta_schedule(T)
    sched = make_schedule(betas).to(device)
    cfg = DiffusionConfig(
        MeanType.EPSILON, VarType.LEARNED_RANGE, LossType.MSE,
        original_num_steps=T,
    )

    noisy, clean = make_pair(np.random.default_rng(123), (S, S, S))
    low = to_volumes(scale(noisy)[None], device)
    x0 = to_volumes(scale(clean)[None], device)
    kw = {"low_res": low}

    def model_fn(x, t, **k):
        return model(x, t, **k).float()

    def normal(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(x0.shape, generator=g, device=device)

    def score(out):
        out = denoised(out)[0]
        return {"psnr": psnr(clean, out, data_range=1.0),
                "ssim": ssim(clean, out, data_range=1.0)}

    result = {"teacher": [], "chains": {}, "truncated": {}}
    with torch.no_grad():
        # 1 + 2: teacher-forced accuracy vs t
        print("== teacher-forced accuracy vs t ==")
        print("   t   relMSE(eps)   PSNR(x0_hat)   mean logvar")
        for t_s in T_POINTS:
            rels, psnrs, lvs = [], [], []
            for k in range(3):
                eps = normal(1000 * t_s + k)
                t = torch.full((1,), t_s, dtype=torch.long, device=device)
                x_t = process.q_sample(sched, x0, t, eps)
                out = process.p_mean_variance(
                    model_fn, sched, cfg, x_t, t, clip_denoised=True,
                    model_kwargs=kw)
                eps_hat = (
                    process.extract(sched.sqrt_recip_alphas_cumprod, t, 5)
                    * x_t - out["pred_xstart"]
                ) / process.extract(sched.sqrt_recipm1_alphas_cumprod, t, 5)
                rels.append(float(torch.mean((eps_hat - eps) ** 2)
                                  / torch.mean(eps ** 2)))
                psnrs.append(psnr(clean, denoised(out["pred_xstart"])[0],
                                  data_range=1.0))
                lvs.append(float(out["log_variance"].mean()))
            row = {"t": t_s, "rel_mse_eps": float(np.mean(rels)),
                   "psnr_x0_db": float(np.mean(psnrs)),
                   "mean_logvar": float(np.mean(lvs))}
            result["teacher"].append(row)
            print(f"  {t_s:4d}   {row['rel_mse_eps']:10.4f}   "
                  f"{row['psnr_x0_db']:9.2f}      {row['mean_logvar']:8.3f}",
                  flush=True)

        # 3: full-length DDPM and DDIM, and 250 steps of each
        xT = torch.randn(x0.shape, generator=torch.Generator().manual_seed(
            77)).to(device)
        print("\n== chains ==")
        for name, respace, ddim in CHAINS:
            sp = (sched if respace == "full" else make_spaced_schedule(
                betas, sorted(space_timesteps(T, respace))))
            out = p_sample_loop(model_fn, sp, cfg, noise=xT, model_kwargs=kw,
                                seed=args.seed, sample_ids=[7],
                                device=device, use_ddim=ddim, eta=0.0)
            result["chains"][name] = score(out)
            print(f"  {name:10s} PSNR {result['chains'][name]['psnr']:6.2f}"
                  f"  SSIM {result['chains'][name]['ssim']:.4f}", flush=True)

        # 4: truncated ancestral chains from a q-sampled start
        print("\n== truncated ancestral chains "
              "(start from q_sample(x0, t0-1)) ==")
        for t_hi in TRUNCATED:
            t = torch.full((1,), t_hi - 1, dtype=torch.long, device=device)
            x_t = process.q_sample(sched, x0, t, normal(5))
            out = p_sample_loop(model_fn, sched, cfg, noise=x_t,
                                model_kwargs=kw, seed=args.seed,
                                sample_ids=[7], device=device, t_hi=t_hi)
            r = result["truncated"][str(t_hi)] = score(out)
            print(f"  t0={t_hi:4d}: PSNR {r['psnr']:6.2f} "
                  f"SSIM {r['ssim']:.4f}", flush=True)
    return result


if __name__ == "__main__":
    main()
