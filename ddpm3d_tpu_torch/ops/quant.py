"""int8 (W8A8) serving: quantization, static scale files, the quantized
conv sites.

Port of ``ddpm3d_tpu/ops/quant.py`` for the int8 serving path:

- weights: symmetric per-output-channel scales (:func:`quantize_kernel`),
  quantized once per parameter version by the conv modules, not per step;
- activations: symmetric per-sample scales (:func:`quantize_act`), dynamic
  (abs-max each call) or static per conv site, from a calibration file
  (``tools/calibrate_int8.py``): one whole-chain scale per site
  (``scales``), or per-time-bin tables (``scales_t``) looked up with the
  chain step (:class:`Int8Config`);
- the conv: int8 x int8 -> int32, then ``acc * (s_x * s_w) + bias`` in f32
  (:mod:`.conv3d_s8`, the hand-written kernel on the card);
- up-sampling sites: the four phase kernels of ``conv(nearest_up2(x))`` are
  quantized per phase, the activation once at low resolution
  (:func:`conv3d_int8` with ``upsample``).

Calibration (:class:`ActCalibration`, the JAX package's
``DDPM3D_INT8_CALIB=1``): a model in its calibration mode
(``model.set_calibration``) records each conv site's input abs-max, which
``ddpm3d_tpu_torch/tools/calibrate_int8.py`` turns into a scales file.

Inference only. The library reads no environment variable: the serving CLI
reads ``DDPM3D_INT8_EXCLUDE`` and ``DDPM3D_INT8_NO_TIME_SCALES`` once and
passes an :class:`Int8Config` to the model factory. The JAX package's
``DDPM3D_INT8=sim``, ``DDPM3D_INT8_IMPL``, ``*_SITES`` and its Pallas mode
choice pick TPU/XLA lowerings of the same function and are not ported.

The time bin: ``bin = clip(i * n_bins // chain_steps, 0, n_bins - 1)`` on
the chain index ``i`` (the respaced step the sampler runs), which is how
the calibrator wrote the tables (``tools/calibrate_int8.py:213-220``). The
JAX package's serving bins on the model's timestep (``timestep_map[i]``),
which agrees on an unspaced chain and puts every step but the last of a
25-step respacing into the last bin; the port bins as the file was written
(an intended divergence).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import tracing
from . import conv3d_s8 as s8
from .phase_up import stacked_phase_weight

EXCLUDE_DEFAULT = "in0_0,head_conv"


def parse_exclude(spec: str) -> Tuple[str, ...]:
    """``"a,b"`` -> ("a", "b"); empty entries dropped (``""`` quantizes
    every site)."""
    return tuple(p for p in spec.split(",") if p)


def int8_excluded(path: str, patterns: Sequence[str]) -> bool:
    """True if a conv site's path contains one of ``patterns`` (the JAX
    package's ``DDPM3D_INT8_EXCLUDE`` substring match). The default keeps the
    2 -> C input and C -> 2 head convs in bf16/f32."""
    return any(p in path for p in patterns)


def _abs_max_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true division (1 where amax is 0). The divisor is
    a tensor of amax's shape: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)


def quantize_act(
    x: torch.Tensor, static_scale: Optional[float] = None, spatial=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-sample int8 quantization of ``x`` [B, ...].

    Dynamic: the f32 abs-max of each sample, ``scale = amax / 127`` (an
    all-zero sample gets 1). Static: the given scale for every sample; values
    beyond it saturate. Then ``q = clip(round(x / scale), -127, 127)``,
    rounding half to even. Returns ``(q int8 like x, scale [B] f32)``.
    ``spatial`` (a :class:`..parallel.SpatialGroup` over which each sample
    is split): the dynamic abs-max is the max over the group's, so the
    scale equals the unsharded one bit for bit (a max has no order).

    Passes over x: one abs-max reduction (exact from x's dtype), then the
    division in f32 and three in-place passes (round, clamp, cast); few
    torch calls, as each costs host time on the serving path."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_act takes bf16 or f32, got {x.dtype}")
    B = x.shape[0]
    if static_scale is not None:
        scale = torch.full((B,), float(static_scale), dtype=torch.float32,
                           device=x.device)
    else:
        amax = torch.linalg.vector_norm(
            x.reshape(B, -1), float("inf"), dim=1, dtype=torch.float32)
        if spatial is not None:
            amax = spatial.all_reduce_max(amax)
        scale = _abs_max_scale(amax)
    # bf16 / f32 tensor promotes to f32: float(x) / scale, as the JAX code
    q = torch.div(x, scale.reshape((B,) + (1,) * (x.dim() - 1)))
    return q.round_().clamp_(-127, 127).to(torch.int8), scale


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weights: ``weight`` (Cout, ...) ->
    ``(q int8, s_w [Cout] f32)`` with ``weight ~= q * s_w``."""
    w = weight.detach().float()
    s_w = _abs_max_scale(w.abs().amax(dim=tuple(range(1, w.dim()))))
    q = torch.round(w / s_w.reshape((-1,) + (1,) * (w.dim() - 1)))
    return q.clamp_(-127, 127).to(torch.int8), s_w


def static_scales(fname: str) -> Dict[str, float]:
    """Whole-chain per-site scales of a calibration file (``{"scales":
    {site: s}}``), or ``{"__const__": s}`` for ``const:<s>`` (one scale at
    every site: a speed-profiling mode, never a serving config)."""
    if fname.startswith("const:"):
        return {"__const__": float(fname[len("const:"):])}
    with open(fname) as f:
        return {str(k): float(v) for k, v in json.load(f)["scales"].items()}


def scale_tables(fname: str) -> Optional[dict]:
    """Per-time-bin tables of a calibration file: ``{"n_bins": N,
    "chain_steps": T, "sites": {site: (N,) float32}}``, or None when the file
    has no ``scales_t`` (or is ``const:<s>``)."""
    if fname.startswith("const:"):
        return None
    with open(fname) as f:
        data = json.load(f)
    st = data.get("scales_t")
    if not st:
        return None
    meta = data.get("meta") or {}
    return {
        "n_bins": int(meta["time_bins"]),
        "chain_steps": int(meta["chain_steps"]),
        "sites": {str(k): np.asarray(v, np.float32) for k, v in st.items()},
    }


def time_bin(step: int, n_bins: int, chain_steps: int) -> int:
    """The table bin of chain index ``step``."""
    return min(max(step * n_bins // chain_steps, 0), n_bins - 1)


def _stem(path: str) -> str:
    base = os.path.basename(path)
    for ext in (".pt", ".msgpack"):
        if base.endswith(ext):
            return base[: -len(ext)]
    return base


def validate_scales_file(
    fname: str,
    *,
    model_path: str = "",
    sampler: str = "",
    respacing: str = "",
    model_config: Optional[dict] = None,
) -> None:
    """Check a calibration file's ``meta`` against the serving run (the JAX
    package's ``validate_scales_file``): a hard error on a checkpoint or
    model-config mismatch, a warning on a sampler or respacing mismatch, on
    a file without ``meta`` and on ``const:<s>``.

    Checkpoints compare by stem, ``.pt`` / ``.msgpack`` stripped: the port
    serves the ``.pt`` converted from the ``.msgpack`` the file names (the
    JAX package compares whole base names). ``model_config`` keys checked
    when both sides have them: ``size``, ``model_channels``,
    ``channel_mult``, ``num_res_blocks``."""
    if fname.startswith("const:"):
        warnings.warn(
            "int8 scales const:<s> applies ONE scale to every site — a "
            "speed-profiling mode, never a serving config (real per-site "
            "ranges span orders of magnitude).")
        return
    with open(fname) as f:
        meta = json.load(f).get("meta") or {}
    if not meta:
        warnings.warn(
            f"int8 scales file {fname} has no 'meta' block — cannot verify "
            "it matches this checkpoint/sampler. Recalibrate.")
        return
    if model_path and meta.get("ckpt"):
        want, got = _stem(model_path), _stem(str(meta["ckpt"]))
        if got != want:
            raise ValueError(
                f"int8 scales file {fname} was calibrated on checkpoint "
                f"'{got}' but this run serves '{want}' — activation ranges "
                "are checkpoint-specific (recalibrate with "
                "tools/calibrate_int8.py --load_ckpt <this checkpoint>)")
    for key in ("size", "model_channels", "channel_mult", "num_res_blocks"):
        if model_config and key in model_config and key in meta:
            if (list(np.ravel(meta[key]))
                    != list(np.ravel(model_config[key]))):
                raise ValueError(
                    f"int8 scales file {fname} was calibrated on a model "
                    f"with {key}={meta[key]} but this run uses "
                    f"{key}={model_config[key]}")
    if sampler and meta.get("sampler") and meta["sampler"] != sampler:
        warnings.warn(
            f"int8 scales file {fname} was calibrated on the "
            f"'{meta['sampler']}' chain but this run samples with "
            f"'{sampler}' — static scales are trajectory-specific.")
    if respacing and meta.get("respacing") and (
            str(meta["respacing"]) != str(respacing)):
        warnings.warn(
            f"int8 scales file {fname} was calibrated over the "
            f"'{meta['respacing']}' respacing but this run uses "
            f"'{respacing}' — per-step activation ranges spread up to "
            f"{meta.get('max_step_spread', 'N/A')}x across the chain "
            "(file meta); verify quality at this respacing.")


@dataclasses.dataclass
class Int8Config:
    """What the int8 conv sites of one model serve with.

    ``exclude``: site substrings kept out of int8. ``scales``: a calibration
    file or ``const:<s>``; empty for dynamic scales everywhere.
    ``time_scales``: use the file's per-time-bin tables when it has them
    (False: the JAX package's ``DDPM3D_INT8_NO_TIME_SCALES=1``).

    The sampler calls :meth:`set_chain_step` before each step; a site then
    reads its scale for that step's bin (:meth:`act_scale`), a Python float
    on the host. ``bins_used`` records the bins looked up."""

    exclude: Tuple[str, ...] = parse_exclude(EXCLUDE_DEFAULT)
    scales: str = ""
    time_scales: bool = True

    def __post_init__(self):
        self.exclude = tuple(self.exclude)
        self._static = static_scales(self.scales) if self.scales else {}
        self._tables = (scale_tables(self.scales)
                        if self.scales and self.time_scales else None)
        self._warned = set()
        self.chain_step: Optional[int] = None
        self.bins_used = set()

    @property
    def has_time_bins(self) -> bool:
        return self._tables is not None

    def set_chain_step(self, step: Optional[int]) -> None:
        """The chain index of the step about to run (None: no chain)."""
        self.chain_step = step

    def quantized(self, site: str) -> bool:
        return not int8_excluded(site, self.exclude)

    def act_scale(self, site: str) -> Optional[float]:
        """The static activation scale of ``site`` at the current chain
        step, or None for a dynamic one: the site's per-bin entry when the
        tables have it and a chain step is set, else its whole-chain scale;
        a site missing from the file warns once and goes dynamic."""
        tab = self._tables
        if (tab is not None and self.chain_step is not None
                and site in tab["sites"]):
            b = time_bin(self.chain_step, tab["n_bins"], tab["chain_steps"])
            self.bins_used.add(b)
            return float(tab["sites"][site][b])
        if not self._static:
            return None
        if "__const__" in self._static:
            return self._static["__const__"]
        s = self._static.get(site)
        if s is None and site not in self._warned:
            self._warned.add(site)
            warnings.warn(
                f"int8 scales file has no entry for conv site '{site}' — "
                "falling back to dynamic abs-max for it (was the scales "
                "file calibrated on this model config?)")
        return s


class ActCalibration:
    """The calibration mode of a model's conv sites (the counterpart of
    ``DDPM3D_INT8_CALIB=1``, ``ddpm3d_tpu/ops/conv3d.py:269-287``), an
    explicit state that ``model.set_calibration`` attaches: each 3-D conv
    site records the f32 abs-max of its input (on an up site the
    low-resolution input, before the phase upsample, as JAX sows it),
    keeping the largest over calls. Nothing is quantized; the excluded
    sites record too (JAX sows before it checks the exclusions). The maxima
    stay on the input's device until :meth:`maxima` reads them all in one
    transfer; :meth:`reset` starts anew."""

    def __init__(self):
        self._amax: Dict[str, torch.Tensor] = {}

    def record(self, site: str, x: torch.Tensor) -> None:
        m = torch.linalg.vector_norm(x.detach(), float("inf"),
                                     dtype=torch.float32)
        prev = self._amax.get(site)
        self._amax[site] = m if prev is None else torch.maximum(prev, m)

    def reset(self) -> None:
        self._amax = {}

    def maxima(self) -> Dict[str, float]:
        """{site: max |x| over the calls since the last reset}."""
        if not self._amax:
            return {}
        sites = list(self._amax)
        values = torch.stack([self._amax[s] for s in sites]).cpu().tolist()
        return dict(zip(sites, values))


def quantize_weight(weight: torch.Tensor, upsample: bool = False):
    """A conv site's int8 weight: ``(wq (N, Cin, k, k, k) int8, s_w [N])``
    from the f32 parameter (Cout, Cin, k, k, k); with ``upsample`` the four
    phase kernels stacked (N = 4 * Cout), each quantized per output
    channel: the zeros around a phase kernel leave its abs-max as it is, so
    this is the JAX package's per-phase ``quantize_kernel``."""
    w = stacked_phase_weight(weight) if upsample else weight.detach().float()
    return quantize_kernel(w)


def conv3d_int8(
    x: torch.Tensor,
    wq: torch.Tensor,
    s_w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act_scale: Optional[float] = None,
    upsample: bool = False,
    w_packed: Optional[torch.Tensor] = None,
    spatial=None,
) -> torch.Tensor:
    """One quantized conv site on ``x`` [B, D, H, W, Cin] (bf16 or f32):
    quantize the activation per sample (or with ``act_scale``), the int8
    conv with the site's quantized weight (:func:`quantize_weight`), the
    result in x's dtype. The 3x3x3 and 1x1x1 sites add the bias in f32
    before the rounding (``conv3d_folded_int8``); the phase route
    (``upsample``) returns the upsampled output with the bias added after
    it (``upsample_conv_folded_int8`` and its caller). ``spatial``: the
    dynamic scale over the group (:func:`quantize_act`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "int8 serving is inference-only (the kernel has no backward): "
            "call it under torch.no_grad() or torch.inference_mode()")
    with tracing.span("ddpm.conv.quantize"):
        xq, s_x = quantize_act(x, act_scale, spatial)
    return s8.conv3d_s8(xq, wq, s_x, s_w, bias, x.dtype, upsample,
                        w_packed=w_packed)
