"""3-D diffusion UNet in PyTorch, channels-last ``[B, D, H, W, C]``.

Port of ``ddpm3d_tpu/models/unet.py`` for the denoising path: the unfused
``ResBlock`` (in-block up/down, FiLM scale-shift norm), ``UNetModel`` without
attention and ``SuperResModel`` (concat conditioner). The wiring comes from
:func:`.plan.plan_unet` (the reference's pair-pop decoder); module names
follow the reference torch state dict (``input_blocks.i.j.in_layers.2``,
``out.2`` ...).

Dtypes as in the JAX package: params are f32; ``dtype`` (bf16 for
``use_fp16``) is the torso's activation dtype; GroupNorm computes in f32 and
casts back; the time embedding is f32 and each ResBlock's ``emb`` dense runs
in the torso dtype; the head (norm, SiLU, conv) runs in the input's dtype.
The anisotropic pyramid never resamples depth: down blocks pool H and W
before ``in_conv``, up blocks upsample H and W before it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as prim
from .plan import AttnSpec, ConvSpec, DownSpec, ResSpec, UpSpec, plan_unet

NUM_CLASSES = 1000


class ResBlock(nn.Module):
    """Residual block with timestep FiLM conditioning and optional in-block
    up/down resampling (the JAX package's unfused branch)."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.ModuleList([
            prim.GroupNorm32(channels), nn.SiLU(),
            prim.Conv3x3x3(channels, out_channels),
        ])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(),
            nn.Linear(emb_channels,
                      2 * out_channels if use_scale_shift_norm else out_channels),
        ])
        self.out_layers = nn.ModuleList([
            prim.GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            prim.Conv3x3x3(out_channels, out_channels, zero_init=True),
        ])
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else prim.Conv1x1x1(channels, out_channels)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x, apply_silu=True)
        if self.up:
            h = prim.upsample_nearest_hw(h)
            x = prim.upsample_nearest_hw(x)
        elif self.down:
            h = prim.avg_pool_hw(h)
            x = prim.avg_pool_hw(x)
        h = self.in_layers[2](h)
        emb_out = prim.linear(self.emb_layers[1], F.silu(emb), h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.float().chunk(2, dim=-1)
            h = self.out_layers[0](
                h, film_scale=scale, film_shift=shift, apply_silu=True)
        else:
            h = h + emb_out[:, None, None, None, :]
            h = self.out_layers[0](h, apply_silu=True)
        h = self.out_layers[2](h)
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    """(1, 2, 2) downsample: a stride-(1,2,2) 3x3x3 conv with padding 1 —
    computed as the stride-1 conv sampled at even H, W — or 2x2 pooling."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = prim.Conv3x3x3(channels, out_channels)
        elif channels != out_channels:
            raise ValueError("pooling keeps the channel count")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_conv:
            return self.op(x)[:, :, ::2, ::2].contiguous()
        return prim.avg_pool_hw(x)


class Upsample(nn.Module):
    """H, W nearest x2 upsampling, then an optional 3x3x3 conv."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = prim.Conv3x3x3(channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = prim.upsample_nearest_hw(x)
        return self.conv(x) if self.use_conv else x


class UNetModel(nn.Module):
    """The UNet with timestep (and optional class) conditioning. Attention
    blocks are not ported yet: a plan that needs one raises."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (),
        dropout: float = 0.0,
        channel_mult: Sequence[float] = (1, 2, 4, 8),
        conv_resample: bool = True,
        dims: int = 3,
        num_classes: Optional[int] = None,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        middle_attention: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dims != 3:
            raise NotImplementedError("the port builds 3-D UNets only")
        plan = plan_unet(
            in_channels=in_channels, model_channels=model_channels,
            out_channels=out_channels, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, conv_resample=conv_resample,
            num_heads=num_heads, num_head_channels=num_head_channels,
            num_heads_upsample=num_heads_upsample,
            resblock_updown=resblock_updown, middle_attention=middle_attention,
        )
        stages = plan.input_blocks + (plan.middle_block,) + plan.output_blocks
        if any(isinstance(s, AttnSpec) for stage in stages for s in stage):
            raise NotImplementedError(
                "attention blocks are not ported yet (ROADMAP.md Queue 1 "
                "item 7); use middle_attention=False and no attention "
                "resolutions"
            )
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.dtype = dtype
        emb_ch = 4 * model_channels
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, emb_ch), nn.SiLU(),
            nn.Linear(emb_ch, emb_ch),
        )
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_ch)

        def build(spec):
            if isinstance(spec, ConvSpec):
                return prim.Conv3x3x3(spec.in_ch, spec.out_ch)
            if isinstance(spec, ResSpec):
                return ResBlock(
                    spec.in_ch, emb_ch, spec.out_ch, dropout=dropout,
                    use_scale_shift_norm=use_scale_shift_norm,
                    up=spec.up, down=spec.down,
                )
            if isinstance(spec, DownSpec):
                return Downsample(spec.in_ch, spec.out_ch, spec.use_conv)
            if isinstance(spec, UpSpec):
                return Upsample(spec.in_ch, spec.out_ch, spec.use_conv)
            raise TypeError(spec)

        def stage_list(stage):
            return nn.ModuleList([build(s) for s in stage])

        self.input_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.input_blocks])
        self.middle_block = stage_list(plan.middle_block)
        self.output_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.output_blocks])
        self.out = nn.ModuleList([
            prim.GroupNorm32(plan.head_norm_ch), nn.SiLU(),
            prim.Conv3x3x3(plan.head_conv_in_ch, plan.out_channels,
                           zero_init=True),
        ])
        prim.init_params(self, seed=0)

    @staticmethod
    def _run_stage(stage: nn.ModuleList, h: torch.Tensor,
                   emb: torch.Tensor) -> torch.Tensor:
        # only ResBlocks take the timestep embedding
        for m in stage:
            h = m(h, emb) if isinstance(m, ResBlock) else m(h)
        return h

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        y: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass y iff the model is class-conditional")
        emb = self.time_embed(
            prim.timestep_embedding(timesteps, self.model_channels))
        if y is not None:
            emb = emb + self.label_emb(y)
        h = x.to(self.dtype)
        hs = []
        for stage in self.input_blocks:
            h = self._run_stage(stage, h, emb)
            hs.append(h)
        h = self._run_stage(self.middle_block, h, emb)
        for stage in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._run_stage(stage, h, emb)
        h = self.out[0](h.to(x.dtype), apply_silu=True)
        return self.out[2](h)


class SuperResModel(UNetModel):
    """Conditional denoiser: the full-resolution conditioner is concatenated
    onto x channel-wise (in_channels doubles). ``middle_attention=False``
    gives the production SuperResModel_noatt."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels * 2, *args, **kwargs)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        low_res: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if low_res is None:
            raise ValueError("SuperResModel requires the low_res conditioner")
        return super().forward(
            torch.cat([x, low_res.to(x.dtype)], dim=-1), timesteps, y=y)
