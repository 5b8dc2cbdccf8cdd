"""Calibrate static int8 activation scales over a real sampling chain.

Port of ``tools/calibrate_int8.py``: the same flags and defaults, plus
``--device`` (the card unless ``cpu``) and ``--seed``; ``--load_ckpt`` is
a ``.pt`` state dict, as the port's other entry points read. It runs the
respaced chain (linear 1000-step schedule, v-prediction, learned-range
variance; DDPM ancestral steps, or DDIM with eta 0) with the model in its
calibration mode (:class:`..ops.quant.ActCalibration`: every 3-D conv site
records its input abs-max, nothing is quantized), takes each site's
maximum over every step and volume, and writes the JSON the serving
``--int8_scales`` reads::

  {"scales": {site: amax * margin / 127},
   "scales_t": {site: [per time bin]},      (with --time_bins N > 0)
   "meta": {sampler, respacing, margin, ..., per_site_step_spread}}

Time bins split the chain's step index as the serving sites look them up:
step ``i`` of ``n`` falls in bin ``min(i * N // n, N - 1)``; a bin the
chain never filled takes the whole-chain maximum. Sites whose maximum is 0
get no scale (they stay dynamic). Calibration volumes are the synthetic
noisy phantoms of the JAX tool (``make_pair``, numpy seeds 321 + v); x_T
and the step noise are drawn per (``--seed``, volume, step) on the device.

    python -m ddpm3d_tpu_torch.tools.calibrate_int8 --load_ckpt ema.pt \\
        --factory --size 96 --model_channels 128 --num_res_blocks 2 \\
        --respacing 25 --out int8_scales.json
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..diffusion import (
    DiffusionConfig,
    LossType,
    MeanType,
    VarType,
    ddim_sample,
    make_schedule,
    make_spaced_schedule,
    p_sample,
    space_timesteps,
)
from ..diffusion.sampling import XT_STEP, step_noise
from ..diffusion.schedules import linear_beta_schedule
from ..ops.quant import ActCalibration
from ..utils.convert import load_checkpoint
from .e2e_learning_check import make_pair

T = 1000
RANDOM_CKPT = "RANDOM-INIT (speed profiling only)"


def chain_schedule(respacing: str):
    """The chain the JAX tool calibrates over: linear 1000 betas, respaced
    (``"1000"``: unspaced); v-prediction with learned-range variance."""
    betas = linear_beta_schedule(T)
    sched = (make_schedule(betas) if respacing == "1000" else
             make_spaced_schedule(betas,
                                  sorted(space_timesteps(T, respacing))))
    cfg = DiffusionConfig(MeanType.VELOCITY, VarType.LEARNED_RANGE,
                          LossType.MSE, original_num_steps=T)
    return sched, cfg


def calibrate_chain(
    model: torch.nn.Module,
    sched,
    cfg: DiffusionConfig,
    volumes: Sequence[Tuple[torch.Tensor, torch.Tensor, Callable]],
    sampler: str = "ddpm",
    time_bins: int = 8,
    on_volume: Optional[Callable[[int, int], None]] = None,
    step_seconds: Optional[list] = None,
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, np.ndarray]]:
    """Run the chain once per ``(low_res, x_T, noise)`` of ``volumes`` (on
    the model's device; ``noise(i)`` is chain step i's noise) with the
    model in its calibration mode. Returns, per site: the maximum over all
    steps and volumes, the minimum over steps of the per-step maximum, and
    the maximum within each of ``time_bins`` step bins (empty with 0).
    ``step_seconds`` receives each step's host wall time (the step and the
    read of its maxima, which waits for the device)."""
    n_steps = sched.num_timesteps
    nb = max(time_bins, 0)
    sched = sched.to(next(model.parameters()).device)
    calib = ActCalibration()
    amax_all: Dict[str, float] = {}
    step_min: Dict[str, float] = {}
    amax_bins: Dict[str, np.ndarray] = {}
    step = ddim_sample if sampler == "ddim" else p_sample
    model.set_calibration(calib)
    try:
        with torch.inference_mode():
            for v, (low, x, noise) in enumerate(volumes):
                for i in reversed(range(n_steps)):
                    t0 = time.perf_counter()
                    calib.reset()
                    t = torch.full((x.shape[0],), i, dtype=torch.long,
                                   device=x.device)
                    x = step(model, sched, cfg, x, t, noise(i),
                             model_kwargs={"low_res": low})["sample"]
                    b = min(i * nb // n_steps, nb - 1) if nb else 0
                    maxima = calib.maxima()
                    if step_seconds is not None:
                        step_seconds.append(time.perf_counter() - t0)
                    for site, m in maxima.items():
                        amax_all[site] = max(amax_all.get(site, 0.0), m)
                        step_min[site] = min(step_min.get(site, np.inf), m)
                        if nb:
                            bins = amax_bins.setdefault(site, np.zeros(nb))
                            bins[b] = max(bins[b], m)
                if on_volume is not None:
                    on_volume(v, len(amax_all))
    finally:
        model.set_calibration(None)
    return amax_all, step_min, amax_bins


def scales_json(amax_all, step_min, amax_bins, margin: float,
                meta: dict) -> dict:
    """The scales file: ``scales``, ``scales_t`` (when binned) and ``meta``
    (the given keys, then the chain's spreads), as the JAX tool writes."""
    scales, spreads, scales_t = {}, {}, {}
    for site, amax in sorted(amax_all.items()):
        if amax <= 0.0:
            continue  # a dead site stays on dynamic scales
        scales[site] = amax * margin / 127.0
        spreads[site] = (float(amax / step_min[site]) if step_min[site] > 0
                         else np.inf)
        if site in amax_bins:
            bins = np.where(amax_bins[site] > 0, amax_bins[site], amax)
            scales_t[site] = [float(b * margin / 127.0) for b in bins]
    worst = sorted(spreads.items(), key=lambda kv: -kv[1])[:5]
    out = {"scales": scales, "meta": dict(
        meta,
        max_step_spread=worst[0][1] if worst else None,
        worst_spread_sites=dict(worst),
        per_site_step_spread=spreads,
    )}
    if scales_t:
        out["scales_t"] = scales_t
    return out


def build_model(args) -> torch.nn.Module:
    """The served model: the factory's production SuperResModel
    (``--factory``: channel_mult from ``--size``), or the JAX tool's
    SuperResModel with ``--channel_mult``; bf16 torso."""
    from ..models import SuperResModel
    from ..models.factory import sr_create_model

    if args.factory:
        return sr_create_model(
            large_size=args.size, small_size=args.size,
            num_channels=args.model_channels,
            num_res_blocks=args.num_res_blocks, learn_sigma=True,
            class_cond=False, use_checkpoint=False,
            attention_resolutions="1000", num_heads=4, num_head_channels=64,
            num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
            resblock_updown=True, use_fp16=True)
    return SuperResModel(
        in_channels=1, model_channels=args.model_channels, out_channels=2,
        num_res_blocks=args.num_res_blocks, attention_resolutions=(),
        channel_mult=tuple(int(m) for m in args.channel_mult.split(",")),
        dims=3, use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False, dtype=torch.bfloat16)


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load_ckpt", type=str, default="",
                    help="the model's .pt state dict (EMA weights)")
    ap.add_argument("--allow_random", action="store_true",
                    help="calibrate a random-init model (meaningless "
                         "scales: for speed-profiling files only)")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--model_channels", type=int, default=32)
    ap.add_argument("--channel_mult", type=str, default="1,2")
    ap.add_argument("--num_res_blocks", type=int, default=1)
    ap.add_argument("--factory", action="store_true",
                    help="build the model through models/factory.py "
                         "sr_create_model with the production defaults "
                         "(channel_mult from --size): required for a "
                         "training-CLI checkpoint, so that the site names "
                         "are the serving CLI's")
    ap.add_argument("--respacing", type=str, default="25",
                    help="the chain to calibrate over: the one you serve")
    ap.add_argument("--n_volumes", type=int, default=2,
                    help="synthetic calibration volumes (distinct seeds)")
    ap.add_argument("--margin", type=float, default=1.0,
                    help="scale headroom: s = amax * margin / 127")
    ap.add_argument("--platform", type=str, default="",
                    help="accepted for the JAX tool's flags: cpu, or "
                         "gpu / cuda (--device wins)")
    ap.add_argument("--sampler", type=str, default="ddpm",
                    choices=["ddpm", "ddim"],
                    help="the chain whose activations are calibrated: "
                         "scales are trajectory-specific, calibrate on the "
                         "sampler you serve")
    ap.add_argument("--time_bins", type=int, default=8,
                    help="also write per-time-bin tables ('scales_t': "
                         "site -> [n_bins]) over equal step-index bins; 0 "
                         "disables")
    ap.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "int8_scales.json"))
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds x_T and the step noise")
    return ap


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    if not (args.load_ckpt or args.allow_random):
        raise SystemExit(
            "calibration needs a trained checkpoint (--load_ckpt); "
            "--allow_random only for speed-profiling scale files")
    device = args.device or {"gpu": "cuda"}.get(args.platform,
                                                args.platform or None)
    device = resolve_device(device)
    model = build_model(args)
    if args.load_ckpt:
        model.load_state_dict(load_checkpoint(args.load_ckpt), strict=True)
        print(f"loaded params from {args.load_ckpt}", flush=True)
    model.to(device).eval()
    sched, cfg = chain_schedule(args.respacing)
    S = args.size
    shape = (S, S, S, 1)

    def volume(v):
        noisy, _ = make_pair(np.random.default_rng(321 + v), (S, S, S))
        low = torch.from_numpy(noisy * 2.0 - 1.0)[None, ..., None].to(device)
        x_t = step_noise(args.seed, [v], XT_STEP, shape, device)
        return low, x_t, lambda i: step_noise(args.seed, [v], i, shape,
                                              device)

    def report(v, n_sites):
        print(f"volume {v}: calibrated {sched.num_timesteps} steps, "
              f"{n_sites} sites", flush=True)

    seconds = []
    amax_all, step_min, amax_bins = calibrate_chain(
        model, sched, cfg, (volume(v) for v in range(args.n_volumes)),
        args.sampler, args.time_bins, on_volume=report,
        step_seconds=seconds)
    out = scales_json(amax_all, step_min, amax_bins, args.margin, dict(
        sampler=args.sampler,
        respacing=args.respacing,
        margin=args.margin,
        n_volumes=args.n_volumes,
        size=S,
        model_channels=args.model_channels,
        channel_mult=[int(m) for m in model.channel_mult],
        num_res_blocks=args.num_res_blocks,
        factory=args.factory,
        ckpt=args.load_ckpt or RANDOM_CKPT,
        time_bins=max(args.time_bins, 0),
        chain_steps=sched.num_timesteps,
    ))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {len(out['scales'])} site scales to {args.out} "
          f"(median {1e3 * float(np.median(seconds)):.3f} ms per step, "
          f"first {1e3 * seconds[0]:.3f})")
    worst = out["meta"]["worst_spread_sites"]
    if worst:
        print("largest per-step range spreads (max/min over chain):")
        for site, spread in worst.items():
            print(f"  {spread:7.2f}x  {site}")
    return out


if __name__ == "__main__":
    main()
