"""Progressive distillation CLI of the PyTorch port.

    python -m ddpm3d_tpu_torch.scripts.distill --data_dir DATA \\
        --model_path RUN/model050000.pt --result_folder RUN/distill \\
        --target_steps 50 --steps_per_phase 2000 [--start_respacing 512] \\
        [--device cuda] <model and diffusion flags as in training>
    torchrun --nproc_per_node N -m ddpm3d_tpu_torch.scripts.distill ...

The flags and defaults of the JAX package's ``scripts/distill.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). The
teacher is a ``.pt`` state dict, read as the serving CLI reads it. The chain
is halved, teacher -> student, until it is at most ``--target_steps`` long;
after each phase rank 0 writes ``distilled_{N}steps.pt`` (the student, or its
EMA with ``--ema_rate``, under the reference's names) and
``distilled_{N}steps_ts.npy`` (its N kept timesteps), which serve as

    python -m ddpm3d_tpu_torch.scripts.test --model_path distilled_{N}steps.pt \\
        --timesteps_file distilled_{N}steps_ts.npy --use_ddim True ...

Under ``torchrun`` each process takes one GPU (``LOCAL_RANK``; gloo processes
with ``--device cpu``), its shard of the data and ``--batch_size / N`` rows
of each global batch, as the training CLI does.
"""

from __future__ import annotations

import argparse
import io
import json

import numpy as np
import torch

from .. import ops, resolve_device
from ..data import load_data, prefetch
from ..diffusion import get_named_beta_schedule, space_timesteps
from ..models.factory import sr_create_model_and_diffusion
from ..parallel import barrier, destroy, maybe_initialize_distributed, rank_batch
from ..training import progressive_distill
from ..utils import blobio
from ..utils import checkpoint as ckpt
from ..utils import logger
from ..utils.config import (
    add_dict_to_argparser,
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ..utils.convert import load_checkpoint


def main(argv=None):
    args = create_argparser().parse_args(argv)
    rank, world_size = maybe_initialize_distributed(args.device)
    try:
        distill(args, rank, world_size)
    finally:
        destroy()


def distill(args, rank: int, world_size: int) -> None:
    device = resolve_device(args.device)
    local_batch = rank_batch(args.batch_size, world_size)
    logger.configure(args.result_folder or None,
                     format_strs=None if rank == 0 else [])
    if world_size > 1:
        logger.log(f"data parallel over {world_size} ranks "
                   f"({torch.distributed.get_backend()}), global batch "
                   f"{args.batch_size}, {local_batch} per rank")

    logger.log("creating model...")
    model, _, cfg = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    model.load_state_dict(load_checkpoint(args.model_path), strict=True)
    logger.log(f"loaded teacher from {args.model_path}")

    betas = get_named_beta_schedule(args.noise_schedule, args.diffusion_steps)
    # plain section counts (e.g. --start_respacing 512), not ddimN: ddimN
    # needs an integer stride of the original chain
    start_ts = sorted(space_timesteps(
        args.diffusion_steps, args.start_respacing or [args.diffusion_steps]))
    data = prefetch(load_data(
        data_dir=args.data_dir, batch_size=local_batch,
        image_size=args.large_size, shard=rank, num_shards=world_size,
        seed=args.seed))

    logger.log(
        f"distilling {len(start_ts)} -> {args.target_steps} steps, "
        f"{args.steps_per_phase} optimizer steps per phase")
    for weights, use_ts in progressive_distill(
        model, betas, cfg, data,
        target_steps=args.target_steps,
        steps_per_phase=args.steps_per_phase,
        start_use_timesteps=start_ts,
        lr=args.lr,
        ema_rate=args.ema_rate,
        vb_weight=args.vb_weight,
        seed=args.seed,
        device=device,
    ):
        n = len(use_ts)
        out = blobio.join(logger.get_dir(), f"distilled_{n}steps.pt")
        ts_path = blobio.join(logger.get_dir(), f"distilled_{n}steps_ts.npy")
        if rank == 0:
            ckpt.save_state_dict(out, weights)
            buf = io.BytesIO()
            np.save(buf, np.asarray(use_ts))
            blobio.write_bytes(ts_path, buf.getvalue())
        barrier()
        logger.log(f"saved {out} (sample with --timesteps_file {ts_path})")
    if device.type == "cuda":
        logger.log("kernel launches on rank 0: "
                   + json.dumps(ops.counter_report()))
    logger.log("distillation complete")


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="",
        model_path="",
        result_folder="./distill",
        batch_size=1,
        lr=1e-4,
        ema_rate=0.0,
        target_steps=50,
        steps_per_phase=2000,
        vb_weight=0.0,
        # distill from a respaced teacher chain instead of all steps
        # (e.g. "256" distills 256 -> target); empty = the full chain
        start_respacing="",
        seed=0,
        device="cuda",
    )
    defaults.update(sr_model_and_diffusion_defaults())
    defaults["large_size"] = 96
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
