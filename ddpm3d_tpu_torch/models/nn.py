"""NN primitives of the 3-D UNet, channels-last ``[B, D, H, W, C]``.

Port of the parts of ``ddpm3d_tpu/models/nn.py`` the denoising path uses.
Parameter names and shapes follow the reference torch modules (convs
``(out, in, kd, kh, kw)``, GroupNorm ``weight``/``bias``), so reference
state dicts load with ``strict=True``. The 3x3x3 convs and the GroupNorms
run the hand-written kernels of :mod:`ddpm3d_tpu_torch.ops` on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3d as conv_ops
from ..ops import groupnorm as gn_ops

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
    FiLM scale/shift and SiLU folded into the normalize pass."""

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
    ) -> torch.Tensor:
        return gn_ops.group_norm(
            x, self.weight, self.bias, self.num_groups, self.eps,
            film_scale=film_scale, film_shift=film_shift, apply_silu=apply_silu,
        )


class Conv3x3x3(nn.Module):
    """Stride-1 SAME 3x3x3 conv over the conv kernel, computed in the input's
    dtype (params stay f32). On the card the weight is kept packed in the
    kernel's layout and repacked when the parameter changes."""

    def __init__(self, in_ch: int, out_ch: int, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self._packed = None
        self._packed_key = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = None
        if x.device.type == "cuda":
            key = (x.dtype, x.device, self.weight.data_ptr(),
                   self.weight._version)
            if key != self._packed_key:
                self._packed = conv_ops.pack_weight(self.weight, x.dtype)
                self._packed_key = key
            packed = self._packed
        return conv_ops.conv3d(x, self.weight, self.bias, w_packed=packed)


class Conv1x1x1(nn.Module):
    """1x1x1 conv (the ResBlock skip) as a plain matmul in the input dtype."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[:2]).to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype))


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` computed in ``dtype`` (f32 params cast, as flax's dtype=)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def avg_pool_hw(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling over H and W of [B, D, H, W, C] (window = stride,
    floor); depth is never resampled. Sums in f32."""
    B, D, H, W, C = x.shape
    xf = x[:, :, : H // 2 * 2, : W // 2 * 2].float()
    pooled = xf.reshape(B, D, H // 2, 2, W // 2, 2, C).sum(dim=(3, 5)) * 0.25
    return pooled.to(x.dtype)


def upsample_nearest_hw(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of H and W of [B, D, H, W, C]; D is kept."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0, zero_heads: bool = True) -> None:
    """Initialise ``model`` from ``seed`` as the JAX package initialises its
    params: Kaiming-uniform (fan-in) convs, uniform(+-1/sqrt(fan_in))
    linears, zero biases, unit GroupNorm scales. Output convs marked
    ``zero_init`` start at 0 unless ``zero_heads`` is False (random heads
    make a forward non-trivial for tests and smokes)."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (Conv3x3x3, Conv1x1x1)):
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
