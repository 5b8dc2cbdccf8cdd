"""Training CLI of the PyTorch port.

    python -m ddpm3d_tpu_torch.scripts.train --data_dir DIR \\
        [--device cuda] [--seed 0] <model, diffusion and training flags>
    torchrun --nproc_per_node N -m ddpm3d_tpu_torch.scripts.train ...

The flags and defaults of the JAX package's ``scripts/train.py``, plus
``--seed`` (initial weights, t, noise and dropout) and ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Checkpoints are
``.pt`` files in ``--result_folder`` under the reference's names. With
``DIFFUSION_TRAINING_TEST`` set, training stops after the first save past
step 0. Under ``torchrun`` each of the N processes takes one GPU
(``LOCAL_RANK``; gloo processes with ``--device cpu``), its shard of the
data and ``--batch_size / N`` rows of each global batch, and the gradients
are all-reduced; rank 0 logs and writes.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..data import load_data, prefetch
from ..models.factory import sr_create_model_and_diffusion
from ..models.nn import init_params
from ..parallel import destroy, maybe_initialize_distributed, rank_batch
from ..training import TrainLoop
from ..utils import logger
from ..utils.config import (
    add_dict_to_argparser,
    args_to_dict,
    sr_model_and_diffusion_defaults,
    train_defaults,
)


def main(argv=None):
    args = create_argparser().parse_args(argv)
    rank, world_size = maybe_initialize_distributed(args.device)
    try:
        train(args, rank, world_size)
    finally:
        destroy()


def train(args, rank: int, world_size: int) -> None:
    device = resolve_device(args.device)
    local_batch = rank_batch(args.batch_size, world_size)
    logger.configure(args.result_folder or None,
                     format_strs=None if rank == 0 else [])
    if world_size > 1:
        logger.log(f"data parallel over {world_size} ranks "
                   f"({torch.distributed.get_backend()}), global batch "
                   f"{args.batch_size}, {local_batch} per rank")

    logger.log("creating model...")
    model, sched, cfg = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(model, seed=args.seed)
    logger.log("attention_resolutions:{%s}" % args.attention_resolutions)
    logger.log("num_channels:{%s}" % str(args.num_channels))
    logger.log("num_res_blocks:{%s}" % str(args.num_res_blocks))
    logger.log("num_head_channels:{%s}" % str(args.num_head_channels))

    logger.log("creating data loader...")
    data = prefetch(load_data(
        data_dir=args.data_dir, batch_size=local_batch,
        image_size=args.large_size, shard=rank, num_shards=world_size,
        seed=args.seed))

    logger.log("training...")
    TrainLoop(
        model=model,
        sched=sched,
        cfg=cfg,
        data=data,
        batch_size=args.batch_size,
        microbatch=args.microbatch,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        resume_checkpoint=args.resume_checkpoint,
        fp16_scale_growth=args.fp16_scale_growth,
        use_fp16_scaling=args.use_fp16_scaling,
        schedule_sampler=args.schedule_sampler,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        seed=args.seed,
        auto_resume=args.auto_resume,
        device=device,
    ).run_loop()


def create_argparser() -> argparse.ArgumentParser:
    defaults = train_defaults()
    defaults.update(sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
