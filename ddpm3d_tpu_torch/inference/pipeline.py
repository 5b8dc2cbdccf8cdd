"""Whole-volume denoising: patch grid -> reverse chain per patch batch ->
Hann blend -> .npz / .tif outputs.

Port of ``ddpm3d_tpu/inference/pipeline.py``: the patches run in order,
``batch_size`` at a time, through the DDPM ancestral chain or, with
``use_ddim``, the DDIM chain, or with ``use_dpm_solver`` DPM-Solver++(2M).
Each patch's noise is keyed by its global index (and the seed), so the
result does not depend on the batch size or the GPU count. Under
``torchrun`` (a process group, :mod:`..parallel`) each rank samples a
contiguous slice of the patches and the slices are gathered; rank 0 blends,
logs and writes. A model served in int8 (``model.int8``) is told each
step's chain index, which picks its per-time-bin activation scales.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data import tiff_io
from ..data.patches import (
    blend_patches_count,
    blend_patches_hann,
    extract_patches_zxy,
    patch_grid,
    test_xy_starts,
    test_z_starts,
)
from ..diffusion import DiffusionConfig, Schedule
from ..diffusion.dpm_solver import dpm_solver_pp_sample_loop
from ..diffusion.sampling import XT_STEP, p_sample_loop, step_noise
from ..parallel import all_gather_rows, pad_to_multiple, world

Log = Callable[[str], None]


def _quiet(_msg: str) -> None:
    pass


def log_stage_stats(stage: str, arr: np.ndarray, log: Log = print) -> None:
    """min/max/mean/std line after a pipeline stage."""
    a = np.asarray(arr)
    log(f"[stage:{stage}] shape={tuple(a.shape)} min={a.min():.4f} "
        f"max={a.max():.4f} mean={a.mean():.4f} std={a.std():.4f}")


def load_volume_for_denoising(
    path: str, enforce_contract: bool = True, log: Log = print
) -> np.ndarray:
    """Load a (Z, H, W) volume (.tif/.tiff/.npz/.npy) without normalization,
    checking the scanner's 200x200x[90..130] shape contract."""
    ext = osp.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        vol = tiff_io.imread(path)
    elif ext == ".npz":
        vol = np.load(path)["arr_0"]
    elif ext == ".npy":
        vol = np.load(path)
    else:
        raise ValueError(f"unsupported input type: {ext}")
    vol = np.asarray(vol)
    if vol.ndim == 4 and vol.shape[0] == 1:
        vol = vol[0]
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D volume, got {vol.shape}")
    if enforce_contract:
        D, H, W = vol.shape
        if H != 200 or W != 200:
            raise ValueError(f"Expected 200x200 XY dimensions, got {H}x{W}")
        if not 90 <= D <= 130:
            raise ValueError(f"Expected Z dimension 90-130, got {D}")
    vol = vol.astype(np.float32)
    log_stage_stats("load", vol, log)
    return vol


def denoise_patches(
    model: torch.nn.Module,
    sched: Schedule,
    cfg: DiffusionConfig,
    low_patches: np.ndarray,
    *,
    seed: int = 10,
    batch_size: int = 1,
    clip_denoised: bool = True,
    noise: Optional[np.ndarray] = None,
    noise_stream=None,
    progress_cb: Optional[Callable[[int, int], None]] = None,
    device=None,
    use_ddim: bool = False,
    eta: float = 0.0,
    use_dpm_solver: bool = False,
    dpm_order: int = 2,
) -> np.ndarray:
    """Run the full reverse chain on conditioner patches [P, Z, X, Y] and
    return the denoised [P, Z, X, Y] (f32, host), on every rank.

    The chain runs on ``device``: ``cuda`` unless the caller passes
    ``"cpu"``. It raises when no card is there and when the model lies on
    another device, rather than moving anything.

    With a process group of W ranks, rank r samples the r-th of W
    contiguous slices of the patches, whose sizes differ by at most one,
    ``batch_size`` at a time (the batch is per GPU). Each slice is padded
    to ceil(P / W) rows (P padded to a multiple of W: the gather is never
    ragged) and the slices are gathered in rank order; the pad rows are
    zeros, not sampled, and dropped after the gather.

    ``noise`` [P, Z, X, Y] is x_T. ``noise_stream`` supplies every step's
    noise, ordered t = T-1 .. 0: an array [P, T, Z, X, Y] (with ``noise``),
    or a callable ``(lo, hi) -> (x_T [n, Z, X, Y], stream [n, T, Z, X, Y])``
    called for increasing patch ranges, so only one batch's noise exists at
    a time. Without them, noise is drawn per (seed, global patch index, t).

    ``use_ddim`` runs DDIM steps with ``eta``; ``use_dpm_solver`` runs
    DPM-Solver++ of ``dpm_order`` from x_T (``noise``, else drawn as the
    other chains draw it). A noise stream with ``use_dpm_solver`` raises
    (the JAX pipeline silently runs the stochastic chain then), as does an
    int8 model. An int8 model's sites read their scales for the bin of the
    chain index ``i`` (the respaced step, ``clip(i * n_bins //
    chain_steps)``), set before each step on the host: the JAX pipeline
    bins on the model's timestep ``timestep_map[i]`` instead, which agrees
    on an unspaced chain only."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device != device:
        raise RuntimeError(
            f"the model's parameters are on {model_device} but the chain "
            f"runs on {device}: move the model with model.to({str(device)!r}) "
            f"or pass device={model_device.type!r}")
    P = low_patches.shape[0]
    T = sched.num_timesteps
    sched = sched.to(device)
    stream_fn = noise_stream if callable(noise_stream) else None
    if noise_stream is not None and stream_fn is None and noise is None:
        raise ValueError("noise_stream requires explicit x_T noise")
    int8 = getattr(model, "int8", None)
    if use_dpm_solver and noise_stream is not None:
        raise ValueError(
            "use_dpm_solver takes x_T only: a per-step noise stream drives "
            "the stochastic chains")
    if use_dpm_solver and int8 is not None:
        raise ValueError(
            "use_dpm_solver with an int8 model is refused: deterministic "
            "chains accumulate quantization bias coherently")

    def model_fn(x, t, low_res):
        return model(x, t, low_res=low_res).float()

    before_step = int8.set_chain_step if int8 is not None else None

    # slices that differ by at most one patch: a rank that finishes early
    # waits in the gather, for at most one batch's chain (NCCL aborts a
    # collective that waits longer than its timeout, 10 min by default)
    rank, world_size = world()
    sizes = [P // world_size + (r < P % world_size)
             for r in range(world_size)]
    n = pad_to_multiple(P, world_size) // world_size  # the largest slice
    first = sum(sizes[:rank])
    last = first + sizes[rank]
    outs = []
    with torch.inference_mode():
        for lo in range(first, last, batch_size):
            hi = min(last, lo + batch_size)
            low = torch.from_numpy(
                np.ascontiguousarray(low_patches[lo:hi])[..., None]).to(device)
            x_t = stream = None
            if stream_fn is not None:
                x_t, stream = stream_fn(lo, hi)
            elif noise is not None:
                x_t = noise[lo:hi]
                if noise_stream is not None:
                    stream = noise_stream[lo:hi]
            if x_t is not None:
                x_t = torch.from_numpy(
                    np.ascontiguousarray(x_t, np.float32)[..., None]).to(device)
            if stream is not None:
                if stream.shape[1] != T:
                    raise ValueError(
                        f"noise_stream has {stream.shape[1]} steps, chain has {T}")
                # [n, T, ...] -> [T, n, ..., 1], moved to the card step by step
                stream = torch.from_numpy(
                    np.asarray(stream, np.float32)).movedim(1, 0)[..., None]
            ids = range(lo, hi)  # global: the noise does not depend on W
            if use_dpm_solver:
                if x_t is None:
                    x_t = step_noise(seed, ids, XT_STEP, low.shape[1:], device)
                img = dpm_solver_pp_sample_loop(
                    model_fn, sched, cfg, x_t, clip_denoised=clip_denoised,
                    model_kwargs={"low_res": low}, order=dpm_order,
                    device=device)
            else:
                img = p_sample_loop(
                    model_fn, sched, cfg, shape=low.shape, noise=x_t,
                    noise_stream=stream, clip_denoised=clip_denoised,
                    model_kwargs={"low_res": low}, seed=seed,
                    sample_ids=ids, device=device,
                    before_step=before_step, use_ddim=use_ddim, eta=eta,
                )
            outs.append(img[..., 0])
            if progress_cb is not None:
                progress_cb(hi - first, last - first)
    if int8 is not None:
        int8.set_chain_step(None)
    pad = torch.zeros((n - sizes[rank],) + low_patches.shape[1:],
                      device=device)
    rows = all_gather_rows(torch.cat(outs + [pad]))
    return torch.cat([rows[r * n:r * n + size]
                      for r, size in enumerate(sizes)]).cpu().numpy()


def denoise_volume(
    model: torch.nn.Module,
    sched: Schedule,
    cfg: DiffusionConfig,
    volume_zxy: np.ndarray,
    *,
    seed: int = 10,
    patch_size: int = 96,
    num_xy_patches: int = 3,
    clip_denoised: bool = True,
    batch_size: int = 1,
    blend: str = "hann",
    normalize_div4: bool = False,
    num_samples: int = 1,
    noise: Optional[np.ndarray] = None,
    noise_stream=None,
    log: Log = print,
    device=None,
    use_ddim: bool = False,
    eta: float = 0.0,
    use_dpm_solver: bool = False,
    dpm_order: int = 2,
) -> Tuple[Optional[np.ndarray], Dict]:
    """Denoise a whole (Z, H, W) volume; returns ((H, W, Z) result, stats).

    Fixed patch grid, full reverse chain per patch, 3-D Hann blending (or
    ``blend="count"`` averaging), noise-reduction stats. ``normalize_div4``
    clips the input at 4 and divides by 4, and scales the output back.
    ``num_samples > 1`` draws that many chains and returns their mean, with
    the per-voxel std in ``stats["uncertainty_hwz"]``. The chain runs on
    ``device`` as in :func:`denoise_patches`: ``cuda`` unless the caller
    passes ``"cpu"``, and the model must lie there; ``use_ddim``, ``eta``,
    ``use_dpm_solver`` and ``dpm_order`` choose the sampler as there.

    Under a process group every rank samples its slice of the patches; rank
    0 blends, logs and returns the result and all stats, the other ranks
    return ``(None, {"sample_wall_s": ...})`` and log nothing."""
    rank = world()[0]
    if rank != 0:
        log = _quiet
    Z, H, W = volume_zxy.shape
    if normalize_div4:
        volume_zxy = np.clip(volume_zxy, None, 4.0) / 4.0
    xs = test_xy_starts(H, patch_size, num_xy_patches)
    ys = test_xy_starts(W, patch_size, num_xy_patches)
    zs = test_z_starts(Z, patch_size)
    grid = patch_grid(xs, ys, zs)
    log(f"Patch grid: X {xs}, Y {ys}, Z {zs} -> {len(grid)} patches")

    low = extract_patches_zxy(volume_zxy, grid, patch_size)  # [P, Z, X, Y]
    log_stage_stats("patches", low, log)

    def blend_one(denoised):
        log_stage_stats("sampled", denoised, log)
        patches_xyz = np.transpose(denoised, (0, 2, 3, 1))
        if blend == "count":
            out, uncovered = blend_patches_count(
                patches_xyz, grid, (H, W, Z), patch_size)
            if uncovered:
                log(f"WARNING: {uncovered} voxels covered by no patch")
        else:
            out = blend_patches_hann(patches_xyz, grid, (H, W, Z), patch_size)
        return out * 4.0 if normalize_div4 else out

    S = max(1, num_samples)
    if (noise is not None or noise_stream is not None) and S != 1:
        raise ValueError("explicit noise implies a single draw")
    low_all = np.concatenate([low] * S) if S > 1 else low
    t0 = time.monotonic()
    denoised_all = denoise_patches(
        model, sched, cfg, low_all, seed=seed, batch_size=batch_size,
        clip_denoised=clip_denoised, noise=noise, noise_stream=noise_stream,
        progress_cb=lambda done, total: log(
            f"denoised {done}/{total} patch-draws "
            f"[{time.monotonic() - t0:.1f}s]"),
        device=device, use_ddim=use_ddim, eta=eta,
        use_dpm_solver=use_dpm_solver, dpm_order=dpm_order,
    )
    sample_wall_s = time.monotonic() - t0
    if rank != 0:
        return None, {"sample_wall_s": sample_wall_s}
    P = low.shape[0]
    draws = [blend_one(denoised_all[s * P:(s + 1) * P]) for s in range(S)]
    result = np.mean(draws, axis=0) if S > 1 else draws[0]
    log_stage_stats("blended", result, log)

    original_std = float(volume_zxy.std())
    denoised_std = float(result.std())
    stats = {
        "original_std": original_std,
        "denoised_std": denoised_std,
        "sample_wall_s": sample_wall_s,
        "noise_reduction_pct": (
            (original_std - denoised_std) / original_std * 100.0
            if original_std > 0 else 0.0),
    }
    if S > 1:
        uncertainty = np.std(draws, axis=0)
        stats["uncertainty_hwz"] = uncertainty
        stats["mean_uncertainty"] = float(uncertainty.mean())
        log(f"uncertainty map over {S} draws: "
            f"mean sigma {stats['mean_uncertainty']:.4f}")
    log(f"Full image denoising: original std {original_std:.4f}, "
        f"denoised std {denoised_std:.4f}, "
        f"noise reduction {stats['noise_reduction_pct']:.1f}% "
        f"(sampling {sample_wall_s:.1f}s wall)")
    return result, stats


def save_outputs(
    out_dir: str, base_samples: str, result_hwz: np.ndarray, log: Log = print
) -> Tuple[str, Optional[str]]:
    """Write ``denoised_<name>.npz`` of the (H, W, Z) volume, and a (Z, H, W)
    ``.tif`` for TIFF inputs, on rank 0; ``("", None)`` on the other ranks
    writes nothing."""
    if world()[0] != 0:
        return "", None
    os.makedirs(out_dir, exist_ok=True)
    base = osp.basename(base_samples)
    for ext in (".tif", ".tiff", ".npz", ".npy"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    npz_path = osp.join(out_dir, f"denoised_{base}.npz")
    np.savez(npz_path, result_hwz)
    log(f"saving to {npz_path}")
    tif_path = None
    if base_samples.endswith((".tif", ".tiff")):
        tif_path = npz_path.replace(".npz", ".tif")
        tiff_io.imwrite(tif_path, result_hwz.transpose(2, 0, 1).astype(np.float32))
        log(f"Saved denoised TIFF: {tif_path}")
    return npz_path, tif_path
