"""The dual-branch conditional UNets (the Seg* family), channels-last.

Port of ``ddpm3d_tpu/models/seg.py``: a second half-UNet, the encoder
(:class:`.unet.EncoderUNetModel` without its middle block and head),
takes the raw conditioner, and its per-stage features are fused into the
main branch, which takes ``cat(x, low_res)`` (``in_channels +
cond_channels`` inputs). Three fusions:

- ``add``: ``h + feature`` after each input stage;
- ``cat_conv``: a 1x1 conv (``conv_down.i``, the JAX ``fuse{i}``) of
  ``cat(h, feature)`` back to h's channels after each input stage;
- ``midcat``: only the encoder's final activation, concatenated before the
  middle block, whose first ResBlock then takes twice the channels (with a
  1x1 skip).

As in JAX, nothing threads the fused path's stats across stages, and the
model never fuses: the JAX Seg config has no ``fused`` key
(``ddpm3d_tpu/models/unet.py:386``), so ``fused=True`` raises. The head
(GroupNorm, SiLU, conv) runs in x's dtype, as ``SuperResModel``'s. Int8
serving and calibration (:class:`.unet.ConvSites`) reach both branches and
the ``cat_conv`` 1x1 sites; the site names are JAX's, with no ``unet/``
prefix (``encoder/in1_0/in_conv``, ``fuse2``, ``mid_0/skip``).

Under a spatial group (``set_spatial``, inference only; JAX's
``denoise_patches`` serves any model under its ``(data, spatial)`` mesh)
both branches hold the same H rows: the encoder's convs, GroupNorms and
int8 sites take the group as the main branch's do, and every fusion (the
input concat, ``add``, ``cat_conv``'s 1x1 conv, ``midcat``'s concat) and
the skip concats are H-local. The encoder returns its features alone
under a group: no head, no mean.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.quant import Int8Config
from ..utils import tracing
from . import nn as prim
from .plan import ResSpec, plan_unet
from .unet import (
    ConvSites,
    EncoderUNetModel,
    _build_stage,
    _run_stage,
    _stage_rates,
    _time_embed,
    conv_nd,
)

FUSIONS = ("add", "cat_conv", "midcat")


class SegUNetModel(ConvSites, nn.Module):
    """Main denoising UNet + conditioner encoder with feature fusion."""

    SPATIAL_SERVING = True

    def __init__(
        self,
        in_channels: int,
        cond_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (),
        dropout: float = 0.0,
        channel_mult: Sequence[float] = (1, 1, 2, 3, 4),
        conv_resample: bool = True,
        dims: int = 3,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        middle_attention: bool = False,
        fusion: str = "add",
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        fused: bool = False,
        int8: Optional[Int8Config] = None,
    ):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"fusion must be one of {FUSIONS}, got {fusion!r}")
        if fused:
            raise ValueError(
                "the Seg models never fuse (the JAX Seg config has no fused "
                "key): build with fused=False")
        plan = plan_unet(
            in_channels=in_channels + cond_channels,
            model_channels=model_channels, out_channels=out_channels,
            num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, conv_resample=conv_resample,
            num_heads=num_heads, num_head_channels=num_head_channels,
            num_heads_upsample=num_heads_upsample,
            resblock_updown=resblock_updown, middle_attention=middle_attention,
        )
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.fusion = fusion
        self.use_checkpoint = use_checkpoint
        self.dims = dims
        self.dtype = dtype
        self.fused = False
        # JAX builds the encoder without use_new_attention_order
        self.encoder = EncoderUNetModel(
            in_channels=cond_channels, model_channels=model_channels,
            out_channels=3, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions, dropout=dropout,
            channel_mult=channel_mult, conv_resample=conv_resample,
            dims=dims, num_heads=num_heads,
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown, include_middle=False,
            use_checkpoint=use_checkpoint, dtype=dtype, head=False,
        )
        self._stage_ds = _stage_rates(plan)
        # a feature is added to (or concatenated with) the main branch's
        # activation of its stage: both pool H alike, so a spatial rank's
        # rows are the same in both
        assert self.encoder.spatial_multiple == self.spatial_multiple
        emb_ch = 4 * model_channels
        self.time_embed = _time_embed(model_channels)

        def stage_list(stage):
            return _build_stage(stage, dims, emb_ch, dropout,
                                use_scale_shift_norm, use_new_attention_order)

        self.input_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.input_blocks])
        if fusion == "cat_conv":
            self.conv_down = nn.ModuleList(
                [conv_nd(dims, 2 * ch, ch, 1) for ch in plan.skip_chs])
        mid_plan = plan.middle_block
        if fusion == "midcat":
            ch = plan.middle_block[0].out_ch
            mid_plan = (ResSpec(2 * ch, ch),) + tuple(plan.middle_block[1:])
        self.middle_block = stage_list(mid_plan)
        self.output_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.output_blocks])
        self.out = nn.ModuleList([
            prim.GroupNorm32(plan.head_norm_ch), nn.SiLU(),
            conv_nd(dims, plan.head_conv_in_ch, plan.out_channels, 3,
                    zero_init=True),
        ])
        prim.init_params(self, seed=0)
        self.set_int8(int8)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if low_res is None:
            raise ValueError("SegUNetModel requires the low_res conditioner")
        with tracing.span("ddpm.model.forward"):
            return self._forward(x, timesteps, low_res)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                 low_res: torch.Tensor) -> torch.Tensor:
        self._check_spatial_input(x)
        feats, final = self.encoder(low_res, timesteps, return_features=True)
        emb = self.time_embed(
            prim.timestep_embedding(timesteps, self.model_channels))
        # JAX remats every ResBlock of the branch under use_checkpoint
        remat = self.use_checkpoint and torch.is_grad_enabled()
        h = torch.cat([x, low_res.to(x.dtype)], dim=-1).to(self.dtype)
        hs = []
        for i, stage in enumerate(self.input_blocks):
            h, _ = _run_stage(stage, h, emb, None, remat)
            if self.fusion == "add":
                h = h + feats[i].to(h.dtype)
            elif self.fusion == "cat_conv":
                h = self.conv_down[i](torch.cat([h, feats[i].to(h.dtype)], -1))
            hs.append(h)
        if self.fusion == "midcat":
            h = torch.cat([h, final.to(h.dtype)], dim=-1)
        h, _ = _run_stage(self.middle_block, h, emb, None, remat)
        for stage in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            h, _ = _run_stage(stage, h, emb, None, remat)
        h = self.out[0](h.to(x.dtype), apply_silu=True)
        return self.out[2](h)


def SegModelv2(**kw) -> SegUNetModel:
    """Additive fusion, conditioner concat (reference unet.py:1698-1745)."""
    return SegUNetModel(fusion="add", **kw)


def SegModelv2_3d_noatt(**kw) -> SegUNetModel:
    """3-D additive fusion without middle attention (unet.py:1806-1856)."""
    kw.setdefault("dims", 3)
    kw.setdefault("middle_attention", False)
    return SegUNetModel(fusion="add", **kw)


def SegModelv3(**kw) -> SegUNetModel:
    """Concat + 1x1-conv fusion (reference SegModelv3_6c,
    unet.py:1913-1981)."""
    return SegUNetModel(fusion="cat_conv", **kw)


def SegModel_3d_noatt_midcat(**kw) -> SegUNetModel:
    """Middle-concat fusion of the encoder's final feature
    (reference unet.py:1859-1910 + UNetModel_noatt_midcat)."""
    kw.setdefault("dims", 3)
    kw.setdefault("middle_attention", False)
    return SegUNetModel(fusion="midcat", **kw)
