"""int8 (W8A8) quality check of the Seg* models and the EncoderUNetModel.

Port of ``tools/seg_int8_check.py``, with the same protocol at the same
defaults (24^3, 32 channels, (1, 2), 500 steps of batch 4, 1000-step
linear v-prediction, a 25-step respacing, 4 eval volumes):

- each fusion mode (add = SegModelv2, cat_conv = SegModelv3, midcat =
  SegModel_3d_noatt_midcat) trains a small v-pred conditional denoiser on
  ``make_pair`` volumes, then samples a matched-x_T respaced DDPM chain in
  float (bf16 torso) and in int8, and reports the chain PSNR against the
  clean volume for each and the mutual float-int8 PSNR;
- the ``EncoderUNetModel`` trains as a 2-class classifier on q-sampled
  volumes across t (the guidance regime; AdamW without decay, lr 3e-4),
  then reports the int8 logit drift and top-1 agreement on held-out
  volumes at t = 50, 300, 700.

int8 is the port's serving int8 (``set_int8(Int8Config())``: K5 on the
card, the exact plain int8 conv on the CPU), toggled on the trained eval
model; the JAX tool's ``sim`` (its value twin) has no counterpart, so there
is one int8 mode. ``--device`` replaces ``--platform`` (the card unless
``cpu``), ``--seed`` seeds the torch draws (t, the loss noise, the step
noise); x_T of eval volume i is drawn from a CPU ``torch.Generator``
seeded 900 + i; ``--out`` defaults under the temp dir.

    python -m ddpm3d_tpu_torch.tools.seg_int8_check [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

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
from ..diffusion.process import q_sample
from ..diffusion.schedules import linear_beta_schedule
from ..models.seg import SegModel_3d_noatt_midcat, SegModelv2, SegModelv3
from ..models.unet import EncoderUNetModel
from ..ops.quant import Int8Config
from ..training.train_loop import make_optimizer
from ..utils.metrics import psnr
from .e2e_learning_check import (
    Trainer,
    denoised,
    make_pair,
    model_fn_of,
    scale,
    to_volumes,
)

CTORS = {"add": SegModelv2, "cat_conv": SegModelv3,
         "midcat": SegModel_3d_noatt_midcat}
PROBE_T = (50, 300, 700)


def label_of(clean: np.ndarray) -> int:
    """2-class: does the clean volume's bright mass sit in the upper half?"""
    Z = clean.shape[0]
    return int(clean[: Z // 2].sum() < clean[Z // 2:].sum())


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--respace", type=str, default="25")
    ap.add_argument("--n_eval", type=int, default=4)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds t, the loss noise and the step noise")
    ap.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "SEG_INT8.json"))
    return ap


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    S = args.size
    shape = (S, S, S)
    T = args.diffusion_steps
    betas = linear_beta_schedule(T)
    sched = make_schedule(betas)
    cfg = DiffusionConfig(
        MeanType.VELOCITY, VarType.LEARNED_RANGE, LossType.MSE,
        original_num_steps=T,
    )
    rng = np.random.default_rng(0)
    train_pairs = [make_pair(rng, shape) for _ in range(32)]
    noisy_all = to_volumes(scale(np.stack([p[0] for p in train_pairs])),
                           device)
    clean_all = to_volumes(scale(np.stack([p[1] for p in train_pairs])),
                           device)
    evals = [make_pair(np.random.default_rng(500 + i), shape)
             for i in range(args.n_eval)]
    sp = make_spaced_schedule(betas, sorted(space_timesteps(T, args.respace)))

    results = {"protocol": {"argv": sys.argv[1:] if argv is None
                            else list(argv), "size": S,
                            "channels": args.channels, "steps": args.steps,
                            "respace": args.respace, "n_eval": args.n_eval,
                            "mean_type": "VELOCITY", "device": device.type,
                            "int8": "serving int8 (Int8Config())"},
               "fusions": {}, "encoder": {}}

    mk = dict(
        in_channels=1, cond_channels=1, model_channels=args.channels,
        out_channels=2, num_res_blocks=1, attention_resolutions=(),
        channel_mult=(1, 2), use_scale_shift_norm=True,
        resblock_updown=True, dtype=torch.bfloat16,
    )
    int8 = Int8Config()

    for fusion, ctor in CTORS.items():
        t0 = time.time()
        ema_rate = min(0.99, 1.0 - 10.0 / args.steps)
        trainer = Trainer(ctor(**mk), sched, cfg, 2e-4, ema_rate, args.seed,
                          device)
        for _ in range(args.steps):
            idx = torch.from_numpy(
                rng.integers(0, len(train_pairs), size=args.batch)).to(device)
            trainer.step(clean_all[idx], {"low_res": noisy_all[idx]})
        ema = trainer.ema_model()
        del trainer

        ps_fp, ps_q, ps_mutual, ps_noisy = [], [], [], []
        for i, (noisy, clean) in enumerate(evals):
            low = to_volumes(scale(noisy)[None], device)
            x_T = torch.randn((1, S, S, S, 1), generator=torch.Generator()
                              .manual_seed(900 + i)).to(device)
            outs = {}
            for mode, cfg8 in (("fp", None), ("int8", int8)):
                ema.set_int8(cfg8)
                with torch.no_grad():
                    out = p_sample_loop(
                        model_fn_of(ema), sp, cfg, noise=x_T,
                        model_kwargs={"low_res": low}, seed=args.seed,
                        sample_ids=[i], device=device)
                outs[mode] = denoised(out)[0]
            ema.set_int8(None)
            ps_fp.append(psnr(clean, outs["fp"], data_range=1.0))
            ps_q.append(psnr(clean, outs["int8"], data_range=1.0))
            ps_mutual.append(psnr(outs["fp"], outs["int8"], data_range=1.0))
            ps_noisy.append(psnr(clean, noisy, data_range=1.0))
        row = {
            "psnr_noisy": round(float(np.mean(ps_noisy)), 2),
            "psnr_fp": round(float(np.mean(ps_fp)), 2),
            "psnr_int8": round(float(np.mean(ps_q)), 2),
            "delta_db": round(float(np.mean(ps_q) - np.mean(ps_fp)), 2),
            "psnr_fp_vs_int8": round(float(np.mean(ps_mutual)), 2),
            "train_s": round(time.time() - t0, 1),
        }
        results["fusions"][fusion] = row
        print(f"[{fusion}] {row}", flush=True)
        # incremental flush: a truncated run keeps every completed row
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        del ema

    # ---- EncoderUNetModel as classifier: logits under int8 ----
    t0 = time.time()
    enc = EncoderUNetModel(
        in_channels=1, model_channels=args.channels, out_channels=2,
        num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
        use_scale_shift_norm=True, resblock_updown=True, pool="adaptive",
        dtype=torch.bfloat16,
    ).to(device)
    opt = make_optimizer(list(enc.parameters()), 3e-4, 0.0)
    sched_d = sched.to(device)
    noise_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    labels = torch.tensor([label_of(p[1]) for p in train_pairs],
                          device=device)
    # train on q_sample'd noisy versions across t (the guidance regime)
    enc.train()
    for _ in range(args.steps):
        idx = torch.from_numpy(
            rng.integers(0, len(train_pairs), size=args.batch)).to(device)
        t = torch.from_numpy(rng.integers(0, T, size=args.batch)).to(device)
        clean = clean_all[idx]
        x_t = q_sample(sched_d, clean, t, torch.randn(
            clean.shape, generator=noise_gen, device=device))
        loss = F.cross_entropy(enc(x_t, t).float(), labels[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    enc.eval().requires_grad_(False)

    agree, drift, correct_fp, correct_q = [], [], [], []
    for i, (noisy, clean) in enumerate(evals):
        y = label_of(clean)
        x0 = to_volumes(scale(clean)[None], device)
        for tt in PROBE_T:
            eps = torch.randn(x0.shape, generator=torch.Generator()
                              .manual_seed(7_000 + i * 10 + tt)).to(device)
            t = torch.full((1,), tt, dtype=torch.long, device=device)
            x_t = q_sample(sched_d, x0, t, eps)
            logits = {}
            for mode, cfg8 in (("fp", None), ("int8", int8)):
                enc.set_int8(cfg8)
                with torch.no_grad():
                    logits[mode] = enc(x_t, t).float()[0].cpu().numpy()
            enc.set_int8(None)
            agree.append(int(np.argmax(logits["fp"]) ==
                             np.argmax(logits["int8"])))
            drift.append(float(np.max(np.abs(logits["fp"] -
                                             logits["int8"]))))
            correct_fp.append(int(np.argmax(logits["fp"]) == y))
            correct_q.append(int(np.argmax(logits["int8"]) == y))
    results["encoder"] = {
        "top1_agreement": round(float(np.mean(agree)), 3),
        "max_logit_drift": round(float(np.max(drift)), 4),
        "mean_logit_drift": round(float(np.mean(drift)), 4),
        "acc_fp": round(float(np.mean(correct_fp)), 3),
        "acc_int8": round(float(np.mean(correct_q)), 3),
        "n_probes": len(agree),
        "train_s": round(time.time() - t0, 1),
    }
    print(f"[encoder] {results['encoder']}", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
