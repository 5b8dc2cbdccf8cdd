"""Whole-volume denoising CLI of the PyTorch port.

    python -m ddpm3d_tpu_torch.scripts.test --base_samples vol.tif \\
        --model_path model.pt [--device cuda] <model and diffusion flags>

The flags and defaults of the JAX package's ``scripts/test.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). The
checkpoint is a ``.pt`` state dict (``tools/export_torch_ckpt.py`` converts
a JAX checkpoint). Samplers and modes this slice does not have yet refuse
to start and name the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import tiff_io
from ..data.patches import patch_grid, test_xy_starts, test_z_starts
from ..inference import denoise_volume, load_volume_for_denoising, save_outputs
from ..models.factory import sr_create_model_and_diffusion
from ..utils import logger as logger_mod
from ..utils.config import (
    add_dict_to_argparser,
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ..utils.convert import load_checkpoint

# flag -> why this slice refuses it
_NOT_PORTED = {
    "use_ddim": "DDIM sampling is not ported yet (ROADMAP.md Queue 1 item 5)",
    "use_dpm_solver": "DPM-Solver is not ported yet (ROADMAP.md Queue 1 item 7)",
    "int8": "int8 serving is not ported yet (ROADMAP.md Queue 1 item 8)",
    "int8_scales": "int8 serving is not ported yet (ROADMAP.md Queue 1 item 8)",
    "timesteps_file": "explicit distilled chains wait for distillation "
                      "(ROADMAP.md Queue 1 item 10)",
}


def _refuse_unported(args) -> None:
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {why}")


def torch_noise_provider(seed: int, patch_size: int, num_steps: int):
    """The reference's draw order from a torch CPU generator seeded with
    ``seed``: per patch, x_T then one randn per reverse step. Returns the
    ``(lo, hi) -> (x_T, stream)`` provider that denoise_volume consumes in
    patch order."""
    gen = torch.Generator().manual_seed(seed)
    consumed = {"next": 0}
    shape = (1, 1, patch_size, patch_size, patch_size)

    def provider(lo, hi):
        if lo != consumed["next"]:
            raise RuntimeError("noise stream consumed out of order")
        x_ts, streams = [], []
        for _ in range(lo, hi):
            x_ts.append(torch.randn(shape, generator=gen).numpy()[0, 0])
            streams.append(np.stack([
                torch.randn(shape, generator=gen).numpy()[0, 0]
                for _ in range(num_steps)
            ]))
        consumed["next"] = hi
        return (np.stack(x_ts).astype(np.float32),
                np.stack(streams).astype(np.float32))

    return provider


def main(argv=None):
    args = create_argparser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    logger = logger_mod.configure(args.save_dir or None)
    log = logger.log

    log("creating model...")
    model, sched, cfg = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys())
    )
    if args.model_path:
        log(f"loading checkpoint {args.model_path}...")
        model.load_state_dict(load_checkpoint(args.model_path), strict=True)
    else:
        log("WARNING: no --model_path given; using random init")
    model.to(device).eval()

    # several volumes in one process: each re-derives its noise from --seed
    # and the patch index exactly as a fresh process would
    vol_paths = [p for p in args.base_samples.split(",") if p]
    for vi, vol_path in enumerate(vol_paths):
        log("loading data...")
        vol = load_volume_for_denoising(vol_path, log=log)
        log("Using original data without normalization - "
            f"min: {vol.min():.4f}, max: {vol.max():.4f}, std: {vol.std():.4f}")
        log(f"Fixed seed set to {args.seed}")

        noise_stream = None
        if args.torch_noise_seed >= 0:
            Z, H, W = vol.shape
            ps = args.large_size
            n_patches = len(patch_grid(
                test_xy_starts(H, ps, 3), test_xy_starts(W, ps, 3),
                test_z_starts(Z, ps)))
            noise_stream = torch_noise_provider(
                args.torch_noise_seed, ps, sched.num_timesteps)
            log(f"torch-matched noise stream: seed {args.torch_noise_seed}, "
                f"{n_patches} patches x {sched.num_timesteps} steps "
                "(batch-lazy)")

        log("creating samples...")
        result, stats = denoise_volume(
            model, sched, cfg, vol,
            seed=args.seed,
            noise_stream=noise_stream,
            patch_size=args.large_size,
            clip_denoised=args.clip_denoised,
            batch_size=args.batch_size,
            blend=args.blend,
            normalize_div4=args.normalize_div4,
            num_samples=args.num_samples,
            log=log,
            device=device,
        )
        save_outputs(logger.dir, vol_path, result, log=log)
        if "uncertainty_hwz" in stats:
            unc_path = os.path.join(
                logger.dir,
                f"uncertainty_{os.path.basename(vol_path).rsplit('.', 1)[0]}.tif",
            )
            tiff_io.imwrite(
                unc_path,
                stats["uncertainty_hwz"].transpose(2, 0, 1).astype(np.float32))
            log(f"Saved uncertainty map: {unc_path}")
        if len(vol_paths) > 1:
            log(f"multi-volume [{vi + 1}/{len(vol_paths)}] "
                f"{os.path.basename(vol_path)}: sampling "
                f"{stats['sample_wall_s']:.1f}s wall")
    log("Full image denoising complete")


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        save_dir="",
        clip_denoised=True,
        batch_size=1,
        num_samples=1,
        use_ddim=False,
        eta=0.0,
        use_dpm_solver=False,
        dpm_order=2,
        # accepted for launch-command parity; the port runs each chain in
        # one loop, which equals the JAX package's segmented runs
        segment_steps=100,
        timestep_respacing="",
        base_samples="",
        model_path="",
        seed=10,
        # >= 0: the reference's torch-global-RNG noise stream
        torch_noise_seed=-1,
        blend="hann",
        normalize_div4=False,
        timesteps_file="",
        int8=False,
        int8_scales="",
        # the JAX package's platform selector; the port uses --device
        platform="",
        device="cuda",
    )
    defaults.update(sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
