"""Whole-volume quality harness: the serving CLI end to end, scored.

Port of ``tools/volume_quality.py``. For each config it runs the port's
serving CLI (``python -m ddpm3d_tpu_torch.scripts.test``) once over every
missing volume (multi-volume ``--base_samples``): patch grid, full reverse
chains, Hann blending, /4 normalization, file IO. It then scores the
blended outputs against the clean volumes (PSNR, SSIM) and runs a seam
check: PSNR over the voxels one patch covers (interior) against those two
or more cover (seam), which patch-level studies cannot see.

Config syntax: ``<sampler><steps>:<precision>[@n_volumes]``, sampler in
{ddpm, ddim}, precision in {bf16, int8} (int8 with ``--int8_scales`` when
given: the static-calibration serving mode; a ``respacing:file,...`` map
picks a file per respacing). Each config's denoised TIFFs and
``walls.json`` (sampling seconds per volume, parsed from the CLI's
``multi-volume [i/n] name: sampling Xs wall`` lines, or its one
``sampling Xs wall`` line for a single volume) stay in
``--workdir/<config>``: a rerun resumes from them, ``--score_only`` scores
what exists without sampling.

Departures from the JAX tool: it forwards ``--device`` (not
``--platform`` or ``--segment_steps``, which it does not take), and
``--use_fp16 True``, so ``bf16`` serves the bf16 torso (the JAX tool
forwarded no ``--use_fp16`` and its CLI served f32); ``--workdir`` and
``--out`` default under the temp dir.

    python -m ddpm3d_tpu_torch.tools.volume_quality \\
        --eval_low_dir LOW --eval_clean_dir CLEAN --model_path ema.pt \\
        --configs ddpm25:bf16,ddpm25:int8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import resolve_device
from ..data import tiff_io
from ..data.patches import patch_grid, test_xy_starts, test_z_starts
from ..utils.metrics import psnr, ssim

# the directory that holds the package, for the CLI subprocess's imports
PACKAGE_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
SERVE_MODULE = "ddpm3d_tpu_torch.scripts.test"
WALL_RE = re.compile(r"sampling ([0-9.]+)s wall")
MV_WALL_RE = re.compile(
    r"multi-volume \[\d+/\d+\] (\S+): sampling ([0-9.]+)s wall")


def coverage_mask(shape_zxy, patch_size, num_xy_patches):
    """Per-voxel count of covering patches for the fixed test grid."""
    Z, H, W = shape_zxy
    xs = test_xy_starts(H, patch_size, num_xy_patches)
    ys = test_xy_starts(W, patch_size, num_xy_patches)
    zs = test_z_starts(Z, patch_size)
    cov = np.zeros(shape_zxy, np.int32)
    for (x, y, z) in patch_grid(xs, ys, zs):
        cov[z:z + patch_size, x:x + patch_size, y:y + patch_size] += 1
    return cov


def region_psnr(a, b, mask, data_range):
    if not mask.any():
        return None
    mse = float(np.mean((a[mask] - b[mask]) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range * data_range / mse))


def parse_config(spec: str, n_volumes: int):
    """``ddpm25:int8@4`` -> (sampler, steps, precision, n_volumes)."""
    if "@" in spec:
        spec, n_str = spec.split("@")
        n_volumes = int(n_str)
    sampler_steps, precision = spec.split(":")
    m = re.fullmatch(r"(ddpm|ddim)(\d+)", sampler_steps)
    if not m or precision not in ("bf16", "int8"):
        raise ValueError(f"bad config {spec}")
    return m.group(1), int(m.group(2)), precision, n_volumes


def create_argparser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eval_low_dir", required=True)
    ap.add_argument("--eval_clean_dir", required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--configs", default="ddpm25:bf16,ddpm25:int8,"
                    "ddpm250:bf16@4,ddpm250:int8@4")
    ap.add_argument("--int8_scales", default="",
                    help="static int8 scales file for int8 configs; or a "
                    "respacing->file map '25:f25.json,1000:f1000.json' "
                    "(per-time-bin files are respacing-specific)")
    ap.add_argument("--n_volumes", type=int, default=8,
                    help="default volumes per config (@N overrides)")
    ap.add_argument("--batch_size", type=int, default=3)
    ap.add_argument("--patch_size", type=int, default=96)
    ap.add_argument("--blend", default="hann")
    ap.add_argument("--workdir", default=osp.join(tmp, "volume_quality"))
    ap.add_argument("--out", default=osp.join(tmp, "VOLUME_QUALITY.json"))
    # model flags forwarded to the serving CLI
    ap.add_argument("--num_channels", type=int, default=128)
    ap.add_argument("--num_res_blocks", type=int, default=2)
    ap.add_argument("--num_head_channels", type=int, default=64)
    ap.add_argument("--attention_resolutions", default="1000")
    ap.add_argument("--learn_sigma", default="True")
    ap.add_argument("--predict_v", default="True")
    ap.add_argument("--use_scale_shift_norm", default="True")
    ap.add_argument("--resblock_updown", default="True")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="forwarded to the serving CLI (cuda or cpu)")
    ap.add_argument("--timeout_s", type=int, default=36000,
                    help="per-config subprocess timeout (one process "
                    "denoises every missing volume of a config)")
    ap.add_argument("--score_only", action="store_true",
                    help="score whatever denoised tifs exist in the "
                    "workdir without launching any sampling")
    return ap


def main(argv=None) -> dict:
    """Runs and scores every config; returns the written payload."""
    args = create_argparser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise here
    names = sorted(os.listdir(args.eval_low_dir))
    pairs = []
    for n in names:
        lo = osp.abspath(osp.join(args.eval_low_dir, n))
        cl = osp.join(args.eval_clean_dir, n)
        if not osp.exists(cl):
            raise FileNotFoundError(f"no clean counterpart for {n}")
        pairs.append((n, lo, cl))
    if not pairs:
        raise FileNotFoundError("no eval volumes found")

    cleans = {n: tiff_io.imread(cl) for n, _, cl in pairs}
    lows = {n: tiff_io.imread(lo) for n, lo, _ in pairs}
    shape = next(iter(cleans.values())).shape
    dr = float(max(c.max() for c in cleans.values()))

    cov = coverage_mask(shape, args.patch_size, 3)
    interior = cov == 1
    seam = cov >= 2

    # noisy-input baseline row (control for the seam check too)
    def vol_metrics(out, clean):
        return {
            "psnr_db": psnr(clean, out, data_range=dr),
            "ssim": ssim(clean, out, data_range=dr),
            "psnr_interior_db": region_psnr(clean, out, interior, dr),
            "psnr_seam_db": region_psnr(clean, out, seam, dr),
        }

    noisy_rows = [vol_metrics(lows[n], cleans[n]) for n, _, _ in pairs]

    def agg(rows_per_vol, extra=None):
        keys = ["psnr_db", "ssim", "psnr_interior_db", "psnr_seam_db"]
        out = {}
        for k in keys:
            vals = [r[k] for r in rows_per_vol if r[k] is not None]
            out[k] = round(float(np.mean(vals)), 3)
            out[k + "_std"] = round(float(np.std(vals)), 3)
        out["seam_minus_interior_db"] = round(
            out["psnr_seam_db"] - out["psnr_interior_db"], 3
        )
        out["n_volumes"] = len(rows_per_vol)
        if extra:
            out.update(extra)
        return out

    results = {"noisy_input": agg(noisy_rows)}

    def payload(partial):
        return {
            "protocol": {
                "argv": sys.argv if argv is None else list(argv),
                "model_path": args.model_path,
                "int8_scales": args.int8_scales or None,
                "volume_shape_zxy": list(shape),
                "data_range": dr,
                "patch_size": args.patch_size,
                "blend": args.blend,
                "normalize_div4": True,
                "seam_voxels": int(seam.sum()),
                "interior_voxels": int(interior.sum()),
                "pipeline": (f"python -m {SERVE_MODULE} subprocess per "
                             "config (multi-volume --base_samples)"),
                "device": args.device,
                "partial": partial,
            },
            "results": results,
        }

    def flush(partial):
        # incremental write: a killed run keeps every fully-scored volume;
        # reruns resume from the denoised tifs already on disk
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload(partial), f, indent=1)
        os.replace(tmp, args.out)

    def base_cmd(respacing, sampler, precision):
        cmd = [
            sys.executable, "-m", SERVE_MODULE,
            "--model_path", osp.abspath(args.model_path),
            "--large_size", str(args.patch_size),
            "--num_channels", str(args.num_channels),
            "--num_res_blocks", str(args.num_res_blocks),
            "--num_head_channels", str(args.num_head_channels),
            "--attention_resolutions", args.attention_resolutions,
            "--learn_sigma", args.learn_sigma,
            "--predict_v", args.predict_v,
            "--use_scale_shift_norm", args.use_scale_shift_norm,
            "--resblock_updown", args.resblock_updown,
            "--use_fp16", "True",
            "--diffusion_steps", "1000",
            "--noise_schedule", "linear",
            "--timestep_respacing", respacing,
            "--use_ddim", str(sampler == "ddim"),
            "--batch_size", str(args.batch_size),
            "--normalize_div4", "True",
            "--blend", args.blend,
            "--seed", str(args.seed),
            "--device", args.device,
        ]
        if precision == "int8":
            cmd += ["--int8", "True"]
            scales = args.int8_scales
            if (scales and ":" in scales
                    and not scales.startswith("const:")):
                mapped = dict(
                    kv.split(":", 1) for kv in scales.split(",") if kv
                )
                scales = mapped.get(respacing, "")
                if not scales:
                    print(f"NOTE: no int8 scales mapped for respacing "
                          f"{respacing}; running dynamic scales",
                          flush=True)
            if scales:
                cmd += ["--int8_scales", osp.abspath(scales)
                        if not scales.startswith("const:") else scales]
        return cmd

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    for spec in args.configs.split(","):
        spec = spec.strip()
        if not spec:
            continue
        sampler, steps, precision, n_vols = parse_config(spec, args.n_volumes)
        spec = spec.split("@")[0] if "@" in spec else spec
        respacing = str(steps) if sampler == "ddpm" else f"ddim{steps}"

        cfg_dir = osp.join(args.workdir, f"{sampler}{steps}_{precision}")
        os.makedirs(cfg_dir, exist_ok=True)
        walls_json = osp.join(cfg_dir, "walls.json")
        walls_by_stem = {}
        if osp.exists(walls_json):
            with open(walls_json) as f:
                walls_by_stem = json.load(f)

        def tif_for(n):
            return osp.join(cfg_dir, f"denoised_{osp.splitext(n)[0]}.tif")

        # one serving process denoises every missing volume of this config
        # (--base_samples list): model build and kernel load amortize
        missing = [
            (n, lo) for n, lo, _ in pairs[:n_vols]
            if not osp.exists(tif_for(n))
        ]
        if missing and args.score_only:
            print(f"{spec}: score_only — {len(missing)} volumes not "
                  "sampled, scoring the rest", flush=True)
            missing = []
        if missing:
            cmd = base_cmd(respacing, sampler, precision) + [
                "--base_samples", ",".join(lo for _, lo in missing),
                "--save_dir", cfg_dir,
            ]
            t0 = time.time()
            proc = subprocess.run(
                cmd, capture_output=True, text=True,
                timeout=args.timeout_s, env=env,
            )
            wall = time.time() - t0
            if proc.returncode != 0:
                print(proc.stdout[-3000:])
                print(proc.stderr[-3000:])
                raise RuntimeError(f"{spec} on {[n for n, _ in missing]} "
                                   "failed")
            txt = proc.stdout + proc.stderr
            for stem_name, w in MV_WALL_RE.findall(txt):
                walls_by_stem[osp.splitext(stem_name)[0]] = float(w)
            if len(missing) == 1 and not MV_WALL_RE.search(txt):
                mw = WALL_RE.search(txt)
                walls_by_stem[osp.splitext(missing[0][0])[0]] = (
                    float(mw.group(1)) if mw else wall)
            with open(walls_json, "w") as f:
                json.dump(walls_by_stem, f)

        rows, walls = [], []
        for n, lo, _ in pairs[:n_vols]:
            stem = osp.splitext(n)[0]
            out_tif = tif_for(n)
            if not osp.exists(out_tif):
                continue  # score_only: the row keeps honest n_volumes
            out = tiff_io.imread(out_tif)
            if out.shape != shape:
                raise ValueError(f"{out_tif}: shape {out.shape}, "
                                 f"want {shape}")
            rows.append(vol_metrics(out, cleans[n]))
            if stem in walls_by_stem:
                walls.append(walls_by_stem[stem])
            results[spec] = agg(rows, extra={
                "sampling_wall_s_mean": (
                    round(float(np.mean(walls)), 1) if walls else None
                ),
            })
            flush(partial=True)
            print(f"{spec} {n}: psnr {rows[-1]['psnr_db']:.2f} dB",
                  flush=True)
        if spec in results:
            print(f"== {spec}: {json.dumps(results[spec])}", flush=True)
        else:
            print(f"== {spec}: no volumes scored", flush=True)

    flush(partial=False)
    print(f"wrote {args.out}")
    return payload(partial=False)


if __name__ == "__main__":
    main()
