"""Classifier-guided sampling CLI of the PyTorch port.

    python -m ddpm3d_tpu_torch.scripts.classifier_sample \\
        [--model_path model.pt] [--classifier_path classifier.pt] \\
        [--device cuda] <model, classifier and diffusion flags>

Samples class-conditional RGB images, ``--num_samples`` of
``--image_size``^2 in batches of ``--batch_size``, along the DDPM ancestral
chain (or DDIM with ``--use_ddim``) guided by grad_x log p(y | x) through
the classifier (times ``--classifier_scale``), and writes
``samples_{N}x{S}x{S}x3.npz`` (``arr_0`` the samples in [-1, 1], ``arr_1``
the labels) under the logger's directory (``--save_dir``). The flags and
defaults are the JAX package's ``scripts/classifier_sample.py``: a 64x64
2-D UNet (128 channels, 4 heads, attention at 16 and 8) and an
attention-pool classifier (width 128, attention at 32, 16 and 8); plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Without ``--model_path`` / ``--classifier_path`` the models keep their
initial weights (zero heads), as the JAX CLI's do.

Departures from the JAX CLI:

* the checkpoints are ``.pt`` state dicts under the reference names;
* the labels come from a ``torch.Generator`` seeded with ``--seed``, and
  x_T and the step noise from :func:`..diffusion.sampling.step_noise`
  keyed on (``--seed``, sample index, t), not from JAX keys.

The JAX CLI refuses ``DDPM3D_INT8`` because quantization rounding has zero
gradient, so the guidance term would silently vanish. The port reads no
int8 switch from the environment (its int8 is the serving CLI's ``--int8``
flag), and this CLI has no int8 flag: the parser refuses ``--int8``, and the
models it builds have no int8 site, so guidance is never quantized.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import ops, resolve_device
from ..diffusion import p_sample_loop
from ..models.factory import create_classifier, create_model_and_diffusion
from ..models.unet import NUM_CLASSES
from ..ops.conv3d import _full_f32
from ..utils import logger as logger_mod
from ..utils.config import (
    add_dict_to_argparser,
    args_to_dict,
    classifier_defaults,
    model_and_diffusion_defaults,
)
from ..utils.convert import load_checkpoint


def guidance(classifier, y: torch.Tensor, scale: float):
    """``cond_fn(x, t)`` = scale * grad_x sum_i log p(y_i | x_i, t) through
    ``classifier`` (the JAX CLI's ``logp``), taken under
    ``torch.enable_grad()`` on a detached x, so a chain under
    ``torch.no_grad()`` can call it; forward and backward in full f32
    (cuDNN without TF32, as the model's f32 convs)."""

    def cond_fn(x, t, **_):
        with torch.enable_grad(), _full_f32():
            x_in = x.detach().requires_grad_(True)
            logprobs = torch.log_softmax(classifier(x_in, t), dim=-1)
            selected = logprobs.gather(1, y[:, None]).sum()
            return torch.autograd.grad(selected, x_in)[0] * scale

    return cond_fn


def main(argv=None):
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    logger = logger_mod.configure(args.save_dir or None)
    log = logger.log

    log("creating model and diffusion...")
    model, sched, cfg = create_model_and_diffusion(
        **args_to_dict(args, model_and_diffusion_defaults().keys()))
    classifier = create_classifier(
        **args_to_dict(args, classifier_defaults().keys()))
    for name, net, path in (("model", model, args.model_path),
                            ("classifier", classifier, args.classifier_path)):
        if path:
            log(f"loading {name} {path}...")
            net.load_state_dict(load_checkpoint(path), strict=True)
        else:
            log(f"WARNING: no --{name}_path given; using initial weights")
        # frozen: no weight gradient in the guidance backward, and the
        # packed-weight caches of the conv kernels stay valid
        net.requires_grad_(False).to(device).eval()

    size = args.image_size
    gen = torch.Generator().manual_seed(args.seed)
    all_images, all_labels = [], []
    t0 = time.monotonic()
    while len(all_images) * args.batch_size < args.num_samples:
        first = len(all_images) * args.batch_size
        t_batch = time.monotonic()
        y = torch.randint(0, NUM_CLASSES, (args.batch_size,),
                          generator=gen).to(device)

        def model_fn(x, t, **_):
            return model(x, t, y=y) if args.class_cond else model(x, t)

        with torch.no_grad():
            sample = p_sample_loop(
                model_fn, sched, cfg, shape=(args.batch_size, size, size, 3),
                clip_denoised=args.clip_denoised,
                cond_fn=guidance(classifier, y, args.classifier_scale),
                seed=args.seed,
                sample_ids=range(first, first + args.batch_size),
                device=device, use_ddim=args.use_ddim)
        all_images.append(sample.cpu().numpy())
        all_labels.append(y.cpu().numpy())
        log(f"created {len(all_images) * args.batch_size} samples "
            f"({time.monotonic() - t_batch:.3f} s)")
    log(f"sampling: {time.monotonic() - t0:.3f} s wall, "
        f"{sched.num_timesteps}-step "
        + ("DDIM" if args.use_ddim else "DDPM") + " chain")

    arr = np.concatenate(all_images)[: args.num_samples]
    labels = np.concatenate(all_labels)[: args.num_samples]
    out = os.path.join(logger.dir,
                       f"samples_{'x'.join(map(str, arr.shape))}.npz")
    log(f"saving to {out}")
    np.savez(out, arr, labels)
    if device.type == "cuda":
        log("kernel launches: " + json.dumps(ops.counter_report()))
    log("sampling complete")
    return out


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        save_dir="",
        clip_denoised=True,
        num_samples=4,
        batch_size=1,
        use_ddim=False,
        model_path="",
        classifier_path="",
        classifier_scale=1.0,
        seed=0,
        device="cuda",
    )
    defaults.update(model_and_diffusion_defaults())
    defaults.update(classifier_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
