"""Whole-volume denoising CLI of the PyTorch port.

    python -m ddpm3d_tpu_torch.scripts.test --base_samples vol.tif \\
        --model_path model.pt [--device cuda] <model and diffusion flags>
    torchrun --nproc_per_node N -m ddpm3d_tpu_torch.scripts.test ...

The flags and defaults of the JAX package's ``scripts/test.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). As in
the JAX package, ``DDPM3D_FUSED=1`` in the environment serves the ResBlocks
through the fused conv kernel, and ``--int8 [--int8_scales FILE]`` serves
the conv sites in int8 (W8A8), with ``DDPM3D_INT8_EXCLUDE`` (sites kept out,
default ``in0_0,head_conv``) and ``DDPM3D_INT8_NO_TIME_SCALES=1`` (whole-
chain scales only) read once here. ``--use_ddim`` samples with DDIM,
``--use_dpm_solver [--dpm_order 1|2]`` with DPM-Solver++(2M), and
``--timesteps_file`` (a ``.npy`` of kept timesteps, as a distilled
student's chain) replaces the ``--timestep_respacing`` chain. Under
``torchrun`` each of the N processes takes one GPU (``LOCAL_RANK``) and a
slice of the patches (``--batch_size`` per GPU); rank 0 writes the outputs
and the log. The checkpoint is a ``.pt`` state dict
(``tools/export_torch_ckpt.py`` converts a JAX checkpoint).

Departures from the JAX CLI:

* ``--int8`` with ``DDPM3D_FUSED=1`` is refused (the JAX package silently
  serves bf16);
* ``--int8 --use_ddim`` is refused when time-bin scales are off
  (``DDPM3D_INT8_NO_TIME_SCALES=1``), not only when the file lacks them;
  the scales file is validated with the run's own sampler, and its
  checkpoint compared by stem (``.pt`` / ``.msgpack`` stripped);
* ``--int8 --use_dpm_solver`` is refused whatever ``--use_ddim`` says (the
  JAX gate lets it through with ``--use_ddim`` and binned scales, and its
  pipeline then runs DPM in int8);
* ``--torch_noise_seed`` with ``--use_dpm_solver`` is refused (the JAX
  pipeline lets the noise stream win and silently runs the stochastic
  chain).
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import torch

from .. import ops, resolve_device
from ..data import tiff_io
from ..data.patches import patch_grid, test_xy_starts, test_z_starts
from ..diffusion import get_named_beta_schedule, make_spaced_schedule
from ..inference import denoise_volume, load_volume_for_denoising, save_outputs
from ..models.factory import sr_create_model_and_diffusion
from ..ops import quant
from ..parallel import destroy, maybe_initialize_distributed
from ..utils import logger as logger_mod
from ..utils.config import (
    add_dict_to_argparser,
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ..utils.convert import load_checkpoint


def int8_config(args, fused: bool):
    """The int8 serving config of the run, or None without ``--int8``. The
    JAX CLI's gates: ``--use_dpm_solver`` is refused (here whatever
    ``--use_ddim`` says); ``--use_ddim`` only runs on per-time-bin scales
    (with a warning); a scales file is checked against the run
    (``quant.validate_scales_file``)."""
    if not args.int8:
        return None
    if args.use_dpm_solver:
        raise SystemExit(
            "--int8 with --use_dpm_solver is refused: deterministic chains "
            "accumulate quantization bias coherently, and DPM-Solver has no "
            "per-time-bin calibration. Serve DPM-Solver in bf16, or use "
            "ancestral respacing (--timestep_respacing 250/25) in int8")
    if fused:
        raise SystemExit(
            "--int8 with DDPM3D_FUSED=1 is refused: int8 and fused serving "
            "exclude each other (the JAX package would silently serve "
            "bf16); unset DDPM3D_FUSED or drop --int8")
    time_scales = os.environ.get("DDPM3D_INT8_NO_TIME_SCALES") != "1"
    scales = args.int8_scales
    if args.use_ddim:
        binned = (time_scales and bool(scales)
                  and quant.scale_tables(scales) is not None)
        if not binned:
            raise SystemExit(
                "--int8 with --use_ddim is refused: deterministic chains "
                "accumulate quantization bias coherently. Use ancestral "
                "respacing (--timestep_respacing 250/25), or for DDIM pass "
                "per-time-bin scales (tools/calibrate_int8.py --time_bins) "
                "via --int8_scales")
        warnings.warn(
            "--int8 --use_ddim with per-time-bin scales: keep the "
            "scales file's bins (whole-chain static scales collapse "
            "deterministic chains)")
    if scales:
        quant.validate_scales_file(
            scales, model_path=args.model_path,
            sampler="ddim" if args.use_ddim else "ddpm",
            respacing=args.timestep_respacing or str(args.diffusion_steps),
            model_config=dict(size=args.large_size,
                              model_channels=args.num_channels,
                              num_res_blocks=args.num_res_blocks))
    return quant.Int8Config(
        exclude=quant.parse_exclude(os.environ.get(
            "DDPM3D_INT8_EXCLUDE", quant.EXCLUDE_DEFAULT)),
        scales=scales, time_scales=time_scales)


def torch_noise_provider(seed: int, patch_size: int, num_steps: int):
    """The reference's draw order from a torch CPU generator seeded with
    ``seed``: per patch, x_T then one randn per reverse step. Returns the
    ``(lo, hi) -> (x_T, stream)`` provider that denoise_volume consumes in
    patch order. A range may start past the patches drawn so far: a rank
    of a multi-GPU run starts at its slice's first patch."""
    gen = torch.Generator().manual_seed(seed)
    consumed = {"next": 0}
    shape = (1, 1, patch_size, patch_size, patch_size)

    def provider(lo, hi):
        if lo < consumed["next"]:
            raise RuntimeError("noise stream consumed out of order")
        # one generator serves the whole volume in the reference's order, so
        # the patches before ``lo`` are drawn and dropped: rank r of W makes
        # r/W of the volume's (T + 1) * patch_size^3 host draws for nothing
        # (parity runs only)
        for _ in range(consumed["next"], lo):
            for _ in range(num_steps + 1):
                torch.randn(shape, generator=gen)
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
    fused = os.environ.get("DDPM3D_FUSED", "0") == "1"
    args = create_argparser().parse_args(argv)
    int8 = int8_config(args, fused)  # its --use_dpm_solver gate first
    if args.use_dpm_solver and args.torch_noise_seed >= 0:
        raise SystemExit(
            "--torch_noise_seed with --use_dpm_solver is refused: the "
            "reference's noise stream drives the stochastic chains, and "
            "DPM-Solver draws only x_T (the JAX pipeline would silently run "
            "the stochastic chain)")
    if args.use_dpm_solver and args.dpm_order not in (1, 2):
        raise SystemExit("--dpm_order: DPM-Solver++ has orders 1 and 2")
    rank, world_size = maybe_initialize_distributed(args.device)
    try:
        serve(args, fused, int8, rank, world_size)
    finally:
        destroy()


def serve(args, fused: bool, int8, rank: int, world_size: int) -> None:
    """Denoise every volume of ``--base_samples``; rank 0 logs and writes."""
    device = resolve_device(args.device)
    if rank == 0:
        logger = logger_mod.configure(args.save_dir or None)
        log, out_dir = logger.log, logger.dir
    else:
        log, out_dir = (lambda _msg: None), ""
    if world_size > 1:
        log(f"patch split over {world_size} ranks "
            f"({torch.distributed.get_backend()}), batch {args.batch_size} "
            "per rank")

    log("creating model...")
    model, sched, cfg = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()),
        fused=fused, int8=int8,
    )
    if args.timesteps_file:
        # an explicit kept-timestep chain (a distilled student's: the odd
        # positions of its teacher's, which the respacing grammar cannot
        # express)
        use_ts = sorted(int(t) for t in np.load(args.timesteps_file))
        sched = make_spaced_schedule(
            get_named_beta_schedule(args.noise_schedule, args.diffusion_steps),
            use_ts)
        log(f"using explicit {len(use_ts)}-step chain from "
            f"{args.timesteps_file}")
    if int8 is not None:
        scales = "dynamic"
        if int8.scales:
            scales = int8.scales + (" per time bin of the chain index"
                                    if int8.has_time_bins else " whole-chain")
        log("serving path: int8 (W8A8) convs, excluding "
            f"{','.join(int8.exclude) or 'none'}; activation scales: {scales}")
    else:
        log("serving path: " + (
            "fused ResBlock convs (DDPM3D_FUSED)" if model.fused
            else "unfused"))
    if args.use_dpm_solver:
        sampler = "DPM-Solver++(" + ("2M" if args.dpm_order == 2 else "1") + ")"
    elif args.use_ddim:
        sampler = f"DDIM (eta {args.eta})"
    else:
        sampler = "DDPM ancestral"
    log(f"sampler: {sampler}, {sched.num_timesteps}-step "
        + ("explicit chain" if args.timesteps_file else "chain"))
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
            use_ddim=args.use_ddim,
            eta=args.eta,
            use_dpm_solver=args.use_dpm_solver,
            dpm_order=args.dpm_order,
        )
        save_outputs(out_dir, vol_path, result, log=log)
        if "uncertainty_hwz" in stats:
            unc_path = os.path.join(
                out_dir,
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
    if device.type == "cuda":
        log("kernel launches on rank 0: " + json.dumps(
            {"launches": ops.launch_counts(), "routes": ops.route_counts()}))
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
