"""NN primitives of the 1-, 2- and 3-D UNets, channels-last ``[B, ..., C]``.

Port of ``ddpm3d_tpu/models/nn.py``.
Parameter names and shapes follow the reference torch modules (convs
``(out, in, *k)``, GroupNorm ``weight``/``bias``), so reference
state dicts load with ``strict=True``. The 3x3x3 convs and the GroupNorms
(of every rank) run the hand-written kernels of :mod:`ddpm3d_tpu_torch.ops`
on the card, through autograd Functions whose backward is the same on both
devices. The 1-D and 2-D convs, and every 1x1 conv, are PyTorch calls
(``F.conv1d``/``F.conv2d``, ``F.linear``), as the JAX package runs them
through ``flax.linen.Conv``: never int8 sites, never fused. The
fused serving path (inference only) folds a GroupNorm into a [B, C] affine
(``GroupNorm32(..., fold_only=True)``) that the next conv applies in its
prologue (``Conv3x3x3(..., fused=True)``). The int8 serving path (inference
only) runs a conv site through :func:`..ops.quant.conv3d_int8` when the
model attached an :class:`..ops.quant.Int8Config` that quantizes the site;
the calibration mode records each site's input abs-max into the model's
:class:`..ops.quant.ActCalibration`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3d as conv_ops
from ..ops import conv3d_fused as fused_ops
from ..ops import conv3d_s8 as s8_ops
from ..ops import groupnorm as gn_ops
from ..ops import quant

NORM_GROUPS = gn_ops.NORM_GROUPS


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal embeddings [N] -> [N, dim] in f32, cos first then sin."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm(32) in f32, cast back to the input dtype, with the optional
    FiLM scale/shift and SiLU folded into the normalize pass.

    With ``fold_only=True`` (the fused path) the call returns the folded
    per-channel affine (g, b), [B, C] f32 each, from ``stats`` ([B, 2, C]
    sums, e.g. a fused conv's) or, without them, from the stats of x; the
    normalize then happens in the consumer conv's prologue."""

    def __init__(self, channels: int, num_groups: int = NORM_GROUPS,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(
        self,
        x: torch.Tensor,
        film_scale: Optional[torch.Tensor] = None,
        film_shift: Optional[torch.Tensor] = None,
        apply_silu: bool = False,
        stats: Optional[torch.Tensor] = None,
        fold_only: bool = False,
    ):
        if fold_only:
            if stats is None:
                stats = gn_ops.channel_stats(
                    x.reshape(x.shape[0], -1, x.shape[-1]))
            return gn_ops.fold_gn_affine(
                stats, math.prod(x.shape[1:-1]), self.weight, self.bias,
                self.num_groups, self.eps,
                film_scale=film_scale, film_shift=film_shift)
        return gn_ops.group_norm(
            x, self.weight, self.bias, self.num_groups, self.eps,
            film_scale=film_scale, film_shift=film_shift, apply_silu=apply_silu,
        )


class _Int8Site:
    """A conv module's int8 modes: ``int8`` (the model's config, or None),
    ``calib`` (a :class:`..ops.quant.ActCalibration` that records the
    site's input abs-max, or None) and ``site`` (its flax module path, as
    the scales files key it) are attached by the model. The quantized
    weight (per output channel, or per phase on the up route) and its
    packed layout on the card are cached per parameter version: quantized
    once, not per step."""

    int8: Optional[quant.Int8Config] = None
    calib: Optional[quant.ActCalibration] = None
    site: str = ""
    _q_key = None
    _q = None

    def _record(self, x: torch.Tensor) -> None:
        if self.calib is not None:
            self.calib.record(self.site, x)

    def int8_active(self) -> bool:
        return self.int8 is not None and self.int8.quantized(self.site)

    def _int8(self, x: torch.Tensor, bias: torch.Tensor,
              upsample: bool = False) -> torch.Tensor:
        if self.training:
            raise RuntimeError(
                f"int8 site {self.site} is inference-only: call model.eval()")
        key = (x.device, upsample, self.weight.data_ptr(),
               self.weight._version)
        if key != self._q_key:
            wq, s_w = quant.quantize_weight(self.weight, upsample)
            packed = (s8_ops.pack_weight_s8(wq) if x.device.type == "cuda"
                      else None)
            self._q, self._q_key = (wq, s_w, packed), key
        wq, s_w, packed = self._q
        return quant.conv3d_int8(x, wq, s_w, bias,
                                 self.int8.act_scale(self.site),
                                 upsample=upsample, w_packed=packed)


class Conv3x3x3(_Int8Site, nn.Module):
    """Stride-1 SAME 3x3x3 conv over the conv kernel, computed in the input's
    dtype (params stay f32). Without autograd (inference) the weight is kept
    packed in the kernel's layout on the card and repacked when the
    parameter changes; a forward that records gradients packs afresh.

    ``upsample=True`` convolves ``nearest_up2_HW(x)``: an int8 site computes
    it from the low-resolution x by the phase route, any other upsamples
    first. ``fused=True`` runs the fused kernel (:func:`..ops.conv3d_fused.
    conv3d_fused`, inference only) with ``fused_kw`` its prologue, skip and
    stats arguments; it returns what that function returns."""

    def __init__(self, in_ch: int, out_ch: int, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self._packed = None
        self._packed_key = None

    def _packed_weight(self, x: torch.Tensor,
                       fused: bool) -> Optional[torch.Tensor]:
        if x.device.type != "cuda" or (
                torch.is_grad_enabled() and self.weight.requires_grad):
            return None
        key = (x.dtype, x.device, self.weight.data_ptr(), self.weight._version,
               fused)
        if key != self._packed_key:
            # the fused kernel takes the tap-major layout at every Cin
            pack = (fused_ops.pack_weight_fused if fused
                    else conv_ops.pack_weight_kernel)
            self._packed = pack(self.weight, x.dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, fused: bool = False,
                upsample: bool = False, **fused_kw):
        self._record(x)  # before the upsample, where JAX sows
        if self.int8_active():  # never fused: the model refuses both
            return self._int8(x, self.bias, upsample)
        if upsample:
            x = upsample_nearest(x)
        packed = self._packed_weight(x, fused)
        if fused:
            return fused_ops.conv3d_fused(
                x, self.weight, self.bias, w_packed=packed, **fused_kw)
        return conv_ops.conv3d(x, self.weight, self.bias, w_packed=packed)


class Conv1x1x1(_Int8Site, nn.Module):
    """1x1x1 conv (the ResBlock skip) as a plain matmul in the input dtype,
    or, at an int8 site, through the int8 conv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._record(x)
        if self.int8_active():
            return self._int8(x, self.bias)
        w = self.weight.reshape(self.weight.shape[:2]).to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype))


class ConvNd(nn.Module):
    """A ``dims``-D conv of channels-last x with a ``kernel_size`` (3 or 1)
    window, ``stride`` and symmetric padding ``k // 2`` (torch's, not XLA's
    "SAME": ``ddpm3d_tpu/models/nn.py:conv_nd``), computed in x's dtype or
    the ``dtype`` given (f32 params cast, as flax's ``dtype=``). A 3-wide
    window takes ``dims`` 1 or 2 (``F.conv1d``/``F.conv2d``; the 3-D convs
    are :class:`Conv3x3x3`); a 1-wide one any ``dims`` (``F.linear``). On
    the card, f32 3-wide convs run in full f32 (cuDNN without TF32, as the
    3-D convs' plain path), whatever ``torch.backends.cudnn.allow_tf32``
    says; their backward reads the flag when it runs, so a caller that
    differentiates through them (:func:`..scripts.classifier_sample.guidance`)
    holds the same guard. 1x1 ones follow
    ``torch.backends.cuda.matmul.allow_tf32``, which PyTorch leaves off."""

    def __init__(self, dims: int, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, zero_init: bool = False):
        super().__init__()
        if kernel_size == 3 and dims not in (1, 2):
            raise ValueError(f"3-wide ConvNd takes dims 1 or 2, got {dims}")
        if kernel_size not in (1, 3) or (kernel_size == 1 and stride != 1):
            raise ValueError(f"kernel {kernel_size} stride {stride}")
        self.dims, self.stride = dims, stride
        self.zero_init = zero_init
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch) + (kernel_size,) * dims))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, upsample: bool = False,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``upsample=True`` convolves ``upsample_nearest(x)``."""
        dtype = dtype or x.dtype
        x = x.to(dtype)
        if upsample:
            x = upsample_nearest(x)
        # as flax's Conv: the product rounded to ``dtype``, then the bias
        # added (a second rounding; bf16 results then equal the JAX ones)
        w, b = self.weight.to(dtype), self.bias.to(dtype)
        if self.weight.shape[2] == 1:
            return F.linear(x, w.reshape(w.shape[:2])) + b
        conv = F.conv1d if self.dims == 1 else F.conv2d
        with conv_ops._full_f32():
            y = conv(x.movedim(-1, 1), w, stride=self.stride, padding=1)
        return y.movedim(1, -1) + b


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` computed in ``dtype`` (f32 params cast, as flax's dtype=)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _pooled_axes(x: torch.Tensor) -> Tuple[int, ...]:
    """The axes a UNet resamples: H and W of [B, D, H, W, C] (depth never),
    H and W of [B, H, W, C], L of [B, L, C] (``nn.py:downsample_stride``)."""
    if x.dim() == 5:
        return (2, 3)
    if x.dim() in (3, 4):
        return tuple(range(1, x.dim() - 1))
    raise ValueError(f"unsupported rank {x.dim()}")


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """x2 average pooling (window = stride, floor) of the axes a UNet
    resamples (:func:`_pooled_axes`). Sums in f32."""
    axes = _pooled_axes(x)
    xf = x.float()
    shape, summed = [], []
    for ax, n in enumerate(x.shape):
        if ax in axes:
            xf = xf.narrow(ax, 0, n // 2 * 2)
            shape += [n // 2, 2]
            summed.append(len(shape) - 1)
        else:
            shape.append(n)
    pooled = xf.reshape(shape).sum(dim=tuple(summed)) * (0.5 ** len(axes))
    return pooled.to(x.dtype)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of the axes a UNet resamples
    (:func:`_pooled_axes`): H and W of a volume, both axes of an image."""
    for ax in _pooled_axes(x):
        x = x.repeat_interleave(2, dim=ax)
    return x


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0, zero_heads: bool = True) -> None:
    """Initialise ``model`` from ``seed`` as the JAX package initialises its
    params: Kaiming-uniform (fan-in) convs, uniform(+-1/sqrt(fan_in))
    linears, zero biases, unit GroupNorm scales. Output convs marked
    ``zero_init`` start at 0 unless ``zero_heads`` is False (random heads
    make a forward non-trivial for tests and smokes). An attention pool's
    positional embedding is normal with std 1/sqrt(C)."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (Conv3x3x3, Conv1x1x1, ConvNd)):
            fan_in = m.weight[0].numel()
            if getattr(m, "zero_init", False) and zero_heads:
                m.weight.zero_()
            else:
                uniform_(m.weight, math.sqrt(3.0 / fan_in))
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            uniform_(m.weight, math.sqrt(1.0 / m.weight.shape[1]))
            m.bias.zero_()
        elif isinstance(m, GroupNorm32):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        elif hasattr(m, "positional_embedding"):
            pe = m.positional_embedding
            pe.copy_(torch.randn(pe.shape, generator=g) / math.sqrt(pe.shape[0]))
