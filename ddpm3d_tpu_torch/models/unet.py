"""3-D diffusion UNet in PyTorch, channels-last ``[B, D, H, W, C]``.

Port of ``ddpm3d_tpu/models/unet.py`` for the denoising and training paths:
``ResBlock`` (in-block up/down, FiLM scale-shift norm, dropout in ``train()``
mode, and the fused serving branch), ``UNetModel`` without attention and
``SuperResModel`` (concat conditioner). The wiring comes from
:func:`.plan.plan_unet` (the reference's pair-pop decoder); module names
follow the reference torch state dict (``input_blocks.i.j.in_layers.2``,
``out.2`` ...).

Dtypes as in the JAX package: params are f32; ``dtype`` (bf16 for
``use_fp16``) is the torso's activation dtype; GroupNorm computes in f32 and
casts back; the time embedding is f32 and each ResBlock's ``emb`` dense runs
in the torso dtype; the head (norm, SiLU, conv) runs in the input's dtype.
The anisotropic pyramid never resamples depth: down blocks pool H and W
before ``in_conv``, up blocks upsample H and W before it.

Int8 serving (``int8=`` an :class:`..ops.quant.Int8Config`, inference
only) gives every conv module its site name (its flax module path, as the
scales files key it: ``unet/in1_0/in_conv``) and the config; the sites the
config quantizes run the int8 conv, the up blocks' ``in_conv`` and the
``Upsample`` convs by the phase route on the low-resolution input
(``ddpm3d_tpu/models/unet.py:197-211, 350-354``). Int8 and the fused path
exclude each other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.quant import Int8Config
from ..utils.convert import torch_module_to_flax_path
from . import nn as prim
from .plan import AttnSpec, ConvSpec, DownSpec, ResSpec, UpSpec, plan_unet

NUM_CLASSES = 1000
# with use_checkpoint, only ResBlocks at downsample rate <= this recompute
# their forward in the backward (the JAX package's default rule,
# models/unet.py:_remat_max_ds); deeper blocks keep their activations
REMAT_MAX_DS = 2


class ResBlock(nn.Module):
    """Residual block with timestep FiLM conditioning and optional in-block
    up/down resampling.

    With ``fused=True``, in eval mode, scale-shift norm, no dropout and no
    up/down, both convs run through the fused kernel (``ops/
    conv3d_fused.py``; the JAX package's fused branch, ``unet.py:157-194``):
    each GroupNorm(+FiLM)+SiLU is folded into a [B, C] affine that the conv
    applies in its prologue, the residual add is the second conv's
    epilogue, and each conv emits the per-channel sums that fold the next
    GroupNorm. ``x_stats`` carries such sums in; the fused call returns
    ``(out, out_stats)``, the unfused one ``out``."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
        fused: bool = False,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.dropout = dropout
        self.fused = fused
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

    def fusable(self) -> bool:
        """The JAX package's ``_fusable`` without its TPU tiling terms."""
        return (self.fused and not self.training and not self.up
                and not self.down and self.use_scale_shift_norm
                and self.dropout == 0.0)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                x_stats: Optional[torch.Tensor] = None):
        if self.fusable():
            return self._forward_fused(x, emb, x_stats)
        h = self.in_layers[0](x, apply_silu=True)
        if self.up:
            x = prim.upsample_nearest_hw(x)
        elif self.down:
            h = prim.avg_pool_hw(h)
            x = prim.avg_pool_hw(x)
        h = self.in_layers[2](h, upsample=self.up)
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

    def _forward_fused(self, x, emb, x_stats):
        g1, b1 = self.in_layers[0](x, stats=x_stats, fold_only=True)
        h, h_stats = self.in_layers[2](
            x, fused=True, prologue_g=g1, prologue_b=b1, prologue_silu=True,
            want_stats=True)
        emb_out = prim.linear(self.emb_layers[1], F.silu(emb), x.dtype)
        scale, shift = emb_out.float().chunk(2, dim=-1)
        g2, b2 = self.out_layers[0](
            h, stats=h_stats, film_scale=scale, film_shift=shift,
            fold_only=True)
        return self.out_layers[3](
            h, fused=True, prologue_g=g2, prologue_b=b2, prologue_silu=True,
            skip=self.skip_connection(x), want_stats=True)


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
        if self.use_conv:
            return self.conv(x, upsample=True)
        return prim.upsample_nearest_hw(x)


class UNetModel(nn.Module):
    """The UNet with timestep (and optional class) conditioning. Attention
    blocks are not ported yet: a plan that needs one raises."""

    # prefix of the conv sites' flax module paths
    SITE_PREFIX = ""

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
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        fused: bool = False,
        int8: Optional[Int8Config] = None,
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
                "attention blocks are not ported yet (ROADMAP.md Queue 1, "
                "attention and the model zoo); use middle_attention=False "
                "and no attention resolutions"
            )
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.use_checkpoint = use_checkpoint
        self.dtype = dtype
        # the fused serving path (inference only) is off under remat, as in
        # the JAX package
        self.fused = fused and not use_checkpoint
        # downsample rate of each stage (the JAX forward's ds bookkeeping)
        self._stage_ds = []
        ds = 1
        for stage in plan.input_blocks:
            self._stage_ds.append(ds)
            if any(isinstance(s, DownSpec) or (isinstance(s, ResSpec) and s.down)
                   for s in stage):
                ds *= 2
        self._stage_ds.append(ds)  # middle block
        for stage in plan.output_blocks:
            self._stage_ds.append(ds)
            if any(isinstance(s, UpSpec) or (isinstance(s, ResSpec) and s.up)
                   for s in stage):
                ds //= 2
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
                    up=spec.up, down=spec.down, fused=self.fused,
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
        self.set_int8(int8)

    def set_int8(self, int8: Optional[Int8Config]) -> None:
        """Serve the conv sites ``int8`` quantizes in int8 (None: none);
        each conv module gets the config and its site name."""
        if int8 is not None and self.fused:
            raise ValueError(
                "int8 and fused serving exclude each other (the JAX package "
                "serves bf16 when both are asked for); choose one")
        self.int8 = int8
        for name, m in self.named_modules():
            if isinstance(m, (prim.Conv3x3x3, prim.Conv1x1x1)):
                m.int8 = int8
                m.site = self.SITE_PREFIX + torch_module_to_flax_path(name)

    def _run_stage(self, i: int, stage: nn.ModuleList, h: torch.Tensor,
                   emb: torch.Tensor, stats: Optional[torch.Tensor]):
        """Run stage ``i`` (input, middle, output stages in order). Only
        ResBlocks take the timestep embedding; with ``use_checkpoint`` those
        at downsample rate <= REMAT_MAX_DS recompute in the backward.

        ``stats`` threads the fused path's per-channel sums of ``h`` from
        block to block; any other op and any unfused ResBlock drops them
        (the next fused block then takes the stats of its input). Returns
        ``(h, stats)``."""
        remat = (self.use_checkpoint and torch.is_grad_enabled()
                 and self._stage_ds[i] <= REMAT_MAX_DS)
        for m in stage:
            if not isinstance(m, ResBlock):
                h, stats = m(h), None
            elif remat:
                h, stats = torch.utils.checkpoint.checkpoint(
                    m, h, emb, use_reentrant=False), None
            else:
                out = m(h, emb, stats)
                h, stats = out if isinstance(out, tuple) else (out, None)
        return h, stats

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
        stats = None
        hs = []
        stages = (list(self.input_blocks) + [self.middle_block]
                  + list(self.output_blocks))
        n_in = len(self.input_blocks)
        for i, stage in enumerate(stages):
            if i > n_in:
                h_skip, skip_stats = hs.pop()
                h = torch.cat([h, h_skip], dim=-1)
                # per-channel sums concatenate like the activations
                stats = (torch.cat([stats, skip_stats], dim=-1)
                         if stats is not None and skip_stats is not None
                         else None)
            h, stats = self._run_stage(i, stage, h, emb, stats)
            if i < n_in:
                hs.append((h, stats))
        h = self.out[0](h.to(x.dtype), apply_silu=True)
        return self.out[2](h)


class SuperResModel(UNetModel):
    """Conditional denoiser: the full-resolution conditioner is concatenated
    onto x channel-wise (in_channels doubles). ``middle_attention=False``
    gives the production SuperResModel_noatt."""

    # the JAX SuperResModel wraps its UNet as ``unet``
    SITE_PREFIX = "unet/"

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
