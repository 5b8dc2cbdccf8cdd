"""Diffusion UNets in PyTorch, channels-last ``[B, (D,) (H,) L, C]``.

Port of ``ddpm3d_tpu/models/unet.py``: ``ResBlock`` (in-block up/down, FiLM
scale-shift norm, dropout in ``train()`` mode, and the fused serving
branch), ``AttentionBlock`` (self-attention over all flattened voxels, both
qkv layouts), ``UNetModel`` in 1, 2 or 3 spatial dims with attention at any
stage, ``SuperResModel`` (concat conditioner), and the classifier
``EncoderUNetModel`` with its ``AttentionPool`` and spatial heads. The
wiring comes from :func:`.plan.plan_unet` (the reference's pair-pop
decoder); module names follow the reference torch state dict
(``input_blocks.i.j.in_layers.2``, ``middle_block.1.qkv``, ``out.2`` ...).

Dtypes as in the JAX package: params are f32; ``dtype`` (bf16 for
``use_fp16``) is the torso's activation dtype; GroupNorm computes in f32 and
casts back; the time embedding is f32 and each ResBlock's ``emb`` dense runs
in the torso dtype; the head (norm, SiLU, conv) runs in the input's dtype.
The anisotropic pyramid never resamples depth: down blocks pool H and W
before ``in_conv``, up blocks upsample H and W before it; a 2-D model
resamples both axes, a 1-D one its one. Attention computes its logits and
softmax in f32 from q and k in the torso dtype (no
``scaled_dot_product_attention``: it cannot keep the f32 logits of bf16 q
and k) and recomputes itself in the backward, as the JAX package's
``remat`` does.

Int8 serving (``int8=`` an :class:`..ops.quant.Int8Config`, inference
only) gives every conv module its site name (its flax module path, as the
scales files key it: ``unet/in1_0/in_conv``) and the config; the sites the
config quantizes run the int8 conv, the up blocks' ``in_conv`` and the
``Upsample`` convs by the phase route on the low-resolution input
(``ddpm3d_tpu/models/unet.py:197-211, 350-354``). Int8 and the fused path
exclude each other. Int8 serves 3-D models only: the attention's ``qkv``
and ``proj_out`` are 1-D convs, which the JAX package's int8 path (its
folded 3-D convs) never quantizes, and neither does the port. The same
sites record their inputs' abs-max in the calibration mode
(``set_calibration``, :class:`ConvSites`), which int8 and fused refuse.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.quant import ActCalibration, Int8Config
from ..utils.convert import torch_module_to_flax_path
from . import nn as prim
from .plan import AttnSpec, ConvSpec, DownSpec, ResSpec, UpSpec, plan_unet

NUM_CLASSES = 1000
# with use_checkpoint, only ResBlocks at downsample rate <= this recompute
# their forward in the backward (the JAX package's default rule,
# models/unet.py:_remat_max_ds); deeper blocks keep their activations
REMAT_MAX_DS = 2




def conv_nd(dims: int, in_ch: int, out_ch: int, kernel_size: int,
            zero_init: bool = False) -> nn.Module:
    """A stride-1 conv of a ``dims``-D model: the 3x3x3 kernel conv or the
    1x1x1 skip (int8 sites) in 3-D, :class:`.nn.ConvNd` otherwise."""
    if dims != 3:
        return prim.ConvNd(dims, in_ch, out_ch, kernel_size, zero_init=zero_init)
    if kernel_size == 3:
        return prim.Conv3x3x3(in_ch, out_ch, zero_init=zero_init)
    return prim.Conv1x1x1(in_ch, out_ch)


class ResBlock(nn.Module):
    """Residual block with timestep FiLM conditioning and optional in-block
    up/down resampling, in ``dims`` 1, 2 or 3.

    With ``fused=True``, in eval mode, in 3-D, scale-shift norm, no dropout
    and no up/down, both convs run through the fused kernel (``ops/
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
        dims: int = 3,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.dropout = dropout
        self.fused = fused
        self.dims = dims
        self.in_layers = nn.ModuleList([
            prim.GroupNorm32(channels), nn.SiLU(),
            conv_nd(dims, channels, out_channels, 3),
        ])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(),
            nn.Linear(emb_channels,
                      2 * out_channels if use_scale_shift_norm else out_channels),
        ])
        self.out_layers = nn.ModuleList([
            prim.GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            conv_nd(dims, out_channels, out_channels, 3, zero_init=True),
        ])
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else conv_nd(dims, channels, out_channels, 1)
        )

    def fusable(self) -> bool:
        """The JAX package's ``_fusable`` without its TPU tiling terms; its
        ``x.ndim == 5`` is ``dims == 3`` (the fused kernel is a 3-D conv)."""
        return (self.fused and not self.training and not self.up
                and not self.down and self.use_scale_shift_norm
                and self.dropout == 0.0 and self.dims == 3)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                x_stats: Optional[torch.Tensor] = None):
        if self.fusable():
            return self._forward_fused(x, emb, x_stats)
        h = self.in_layers[0](x, apply_silu=True)
        if self.up:
            x = prim.upsample_nearest(x)
        elif self.down:
            h = prim.avg_pool(h)
            x = prim.avg_pool(x)
        h = self.in_layers[2](h, upsample=self.up)
        emb_out = prim.linear(self.emb_layers[1], F.silu(emb), h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.float().chunk(2, dim=-1)
            h = self.out_layers[0](
                h, film_scale=scale, film_shift=shift, apply_silu=True)
        else:
            h = h + emb_out.reshape(
                (emb_out.shape[0],) + (1,) * (h.dim() - 2) + emb_out.shape[-1:])
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


def qkv_attention(qkv: torch.Tensor, num_heads: int, new_order: bool,
                  weights_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Multi-head attention of qkv [B, T, 3C] -> [B, T, C]
    (``ddpm3d_tpu/models/unet.py:293-311``). ``new_order``: the layout
    ``[q_all | k_all | v_all]`` (QKVAttention), else per-head ``[q|k|v]``
    triples (QKVAttentionLegacy). q and k are scaled by ``ch^-1/4`` in
    qkv's dtype; the logits and the softmax are f32 (the products of bf16 q
    and k are exact in f32); the weights are cast to ``weights_dtype``
    (default qkv's) before the product with v, which runs in the promoted
    dtype of the two."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    ch = C // num_heads
    if new_order:
        q, k, v = (t.reshape(B, T, num_heads, ch) for t in qkv.chunk(3, -1))
    else:
        q, k, v = qkv.reshape(B, T, num_heads, 3 * ch).chunk(3, -1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    q = (q * scale).transpose(1, 2).float()          # [B, H, T, ch]
    k = (k * scale).permute(0, 2, 3, 1).float()      # [B, H, ch, S]
    weights = torch.softmax(torch.matmul(q, k), dim=-1)
    dt = torch.promote_types(weights_dtype or qkv.dtype, v.dtype)
    weights = weights.to(weights_dtype or qkv.dtype).to(dt)
    a = torch.matmul(weights, v.transpose(1, 2).to(dt))  # [B, H, T, ch]
    return a.transpose(1, 2).reshape(B, T, C)


class AttentionBlock(nn.Module):
    """Self-attention over all flattened voxels of x [B, ..., C], with a
    residual (``ddpm3d_tpu/models/unet.py:267-313``): GroupNorm32 (the GN
    kernels on the card), a 1-D 1x1 ``qkv`` conv, :func:`qkv_attention`, a
    zero-initialised 1-D 1x1 ``proj_out``. Computed in x's dtype. With
    grad enabled it keeps no activations and recomputes in the backward
    (the JAX package always wraps it in ``remat``)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 use_new_attention_order: bool = False):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels over {num_heads} heads")
        self.num_heads = num_heads
        self.use_new_attention_order = use_new_attention_order
        self.norm = prim.GroupNorm32(channels)
        self.qkv = prim.ConvNd(1, channels, 3 * channels, 1)
        self.proj_out = prim.ConvNd(1, channels, channels, 1, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._attend, x, use_reentrant=False)
        return self._attend(x)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.reshape(x.shape[0], -1, x.shape[-1])
        a = qkv_attention(self.qkv(self.norm(xt)), self.num_heads,
                          self.use_new_attention_order)
        return (xt + self.proj_out(a)).reshape(x.shape)


class Downsample(nn.Module):
    """Stride-2 downsample of the resampled axes (H, W of a volume): a 3-wide
    conv with padding 1 or x2 pooling. In 3-D the conv is the stride-1 conv
    kernel sampled at even H, W (the same values)."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool,
                 dims: int = 3):
        super().__init__()
        self.use_conv = use_conv
        self.dims = dims
        if use_conv:
            self.op = (prim.Conv3x3x3(channels, out_channels) if dims == 3
                       else prim.ConvNd(dims, channels, out_channels, 3,
                                        stride=2))
        elif channels != out_channels:
            raise ValueError("pooling keeps the channel count")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_conv:
            return prim.avg_pool(x)
        if self.dims == 3:
            return self.op(x)[:, :, ::2, ::2].contiguous()
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2 upsampling of the resampled axes, then an optional 3-wide
    conv."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool,
                 dims: int = 3):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = conv_nd(dims, channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_conv:
            return self.conv(x, upsample=True)
        return prim.upsample_nearest(x)


def _build_stage(stage, dims: int, emb_ch: int, dropout: float,
                 use_scale_shift_norm: bool, use_new_attention_order: bool,
                 fused: bool = False) -> nn.ModuleList:
    """The modules of one plan stage, in order."""

    def build(spec):
        if isinstance(spec, ConvSpec):
            return conv_nd(dims, spec.in_ch, spec.out_ch, 3)
        if isinstance(spec, ResSpec):
            return ResBlock(
                spec.in_ch, emb_ch, spec.out_ch, dropout=dropout,
                use_scale_shift_norm=use_scale_shift_norm,
                up=spec.up, down=spec.down, fused=fused, dims=dims,
            )
        if isinstance(spec, AttnSpec):
            return AttentionBlock(spec.ch, spec.num_heads,
                                  use_new_attention_order)
        if isinstance(spec, DownSpec):
            return Downsample(spec.in_ch, spec.out_ch, spec.use_conv, dims)
        if isinstance(spec, UpSpec):
            return Upsample(spec.in_ch, spec.out_ch, spec.use_conv, dims)
        raise TypeError(spec)

    return nn.ModuleList([build(s) for s in stage])


def _time_embed(model_channels: int) -> nn.Sequential:
    emb_ch = 4 * model_channels
    return nn.Sequential(nn.Linear(model_channels, emb_ch), nn.SiLU(),
                         nn.Linear(emb_ch, emb_ch))


class ConvSites:
    """The serving modes of a 3-D model's conv sites (its
    :class:`.nn.Conv3x3x3` and :class:`.nn.Conv1x1x1` modules, each named by
    its flax module path after ``SITE_PREFIX``, as the scales files key
    them): int8 serving and int8 calibration. A model that mixes this in
    has ``dims`` and ``fused``."""

    # prefix of the conv sites' flax module paths
    SITE_PREFIX = ""
    int8: Optional[Int8Config] = None
    calib: Optional[ActCalibration] = None

    def _sites(self):
        for name, m in self.named_modules():
            if isinstance(m, (prim.Conv3x3x3, prim.Conv1x1x1)):
                m.site = self.SITE_PREFIX + torch_module_to_flax_path(name)
                yield m

    def set_int8(self, int8: Optional[Int8Config]) -> None:
        """Serve the conv sites ``int8`` quantizes in int8 (None: none);
        each conv module gets the config and its site name."""
        if int8 is not None and self.fused:
            raise ValueError(
                "int8 and fused serving exclude each other (the JAX package "
                "serves bf16 when both are asked for); choose one")
        if int8 is not None and self.dims != 3:
            raise ValueError(
                "int8 serves 3-D models only (the JAX package quantizes its "
                "3-D convs alone; a 1-D or 2-D model has no int8 site)")
        if int8 is not None and self.calib is not None:
            raise ValueError("int8 serving and calibration exclude each "
                             "other: calibration records unquantized inputs")
        self.int8 = int8
        for m in self._sites():
            m.int8 = int8
            # a weight changed through ``.data`` keeps its version: the
            # quantized weight is rebuilt from the parameter after a switch
            m._q_key = m._q = None

    def set_calibration(self, calib: Optional[ActCalibration]) -> None:
        """Record every conv site's input abs-max into ``calib`` (None:
        stop), the calibration mode of :class:`..ops.quant.ActCalibration`.
        Refused on an int8 or a fused model: the ranges are those of the
        unquantized, unfused convs."""
        if calib is not None and (self.int8 is not None or self.fused):
            raise ValueError(
                "calibration records the unquantized, unfused convs' inputs: "
                "build the model without int8 and fused")
        if calib is not None and self.dims != 3:
            raise ValueError("calibration records 3-D conv sites; a 1-D or "
                             "2-D model has none")
        self.calib = calib
        for m in self._sites():
            m.calib = calib


class UNetModel(ConvSites, nn.Module):
    """The UNet with timestep (and optional class) conditioning, in ``dims``
    1, 2 or 3, with attention at the stages the plan puts it."""

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
        use_new_attention_order: bool = False,
        middle_attention: bool = True,
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        fused: bool = False,
        int8: Optional[Int8Config] = None,
    ):
        super().__init__()
        if dims not in (1, 2, 3):
            raise ValueError(f"dims must be 1, 2 or 3, got {dims}")
        plan = plan_unet(
            in_channels=in_channels, model_channels=model_channels,
            out_channels=out_channels, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, conv_resample=conv_resample,
            num_heads=num_heads, num_head_channels=num_head_channels,
            num_heads_upsample=num_heads_upsample,
            resblock_updown=resblock_updown, middle_attention=middle_attention,
        )
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_classes = num_classes
        self.use_checkpoint = use_checkpoint
        self.dims = dims
        self.dtype = dtype
        # the fused serving path (inference only) is off under remat, as in
        # the JAX package; only 3-D ResBlocks fuse (ResBlock.fusable)
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
        self.time_embed = _time_embed(model_channels)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_ch)

        def stage_list(stage):
            return _build_stage(stage, dims, emb_ch, dropout,
                                use_scale_shift_norm, use_new_attention_order,
                                fused=self.fused)

        self.input_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.input_blocks])
        self.middle_block = stage_list(plan.middle_block)
        self.output_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.output_blocks])
        self.out = nn.ModuleList([
            prim.GroupNorm32(plan.head_norm_ch), nn.SiLU(),
            conv_nd(dims, plan.head_conv_in_ch, plan.out_channels, 3,
                    zero_init=True),
        ])
        prim.init_params(self, seed=0)
        self.set_int8(int8)

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
            # with use_checkpoint, the ResBlocks at downsample rate <=
            # REMAT_MAX_DS recompute in the backward
            remat = (self.use_checkpoint and torch.is_grad_enabled()
                     and self._stage_ds[i] <= REMAT_MAX_DS)
            h, stats = _run_stage(stage, h, emb, stats, remat)
            if i < n_in:
                hs.append((h, stats))
        h = self.out[0](h.to(x.dtype), apply_silu=True)
        return self.out[2](h)


def _run_stage(stage: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
               stats: Optional[torch.Tensor], remat: bool):
    """One stage's modules in order (the reference's TimestepEmbedSequential):
    ResBlocks take ``emb``; ``remat`` recomputes them in the backward.

    ``stats`` threads the fused path's per-channel sums of ``h`` from block
    to block; any other op (an attention block among them) and any unfused
    ResBlock drops them (the next fused block then takes the stats of its
    input). Returns ``(h, stats)``."""
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


class AttentionPool(nn.Module):
    """The classifier's attention-pooling head
    (``ddpm3d_tpu/models/unet.py:669-701``): prepend the mean token, add a
    learned positional embedding over the T + 1 tokens, attend (per-head
    ``[q|k|v]`` triples, as the JAX package), project to ``out_channels``
    and take token 0. ``qkv_proj`` and ``c_proj`` compute in ``dtype``; the
    attention weights are cast to the input's dtype.

    ``positional_embedding`` is (C, T + 1), the reference's channels-first
    layout (the JAX package's ``pos`` is its transpose), so T, the bottom
    token count, is fixed when the head is built."""

    def __init__(self, channels: int, num_head_channels: int,
                 out_channels: int, n_tokens: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_head_channels:
            raise ValueError(f"{channels} channels, heads of {num_head_channels}")
        self.num_heads = channels // num_head_channels
        self.dtype = dtype
        self.positional_embedding = nn.Parameter(
            torch.empty(channels, n_tokens + 1))
        self.qkv_proj = prim.ConvNd(1, channels, 3 * channels, 1)
        self.c_proj = prim.ConvNd(1, channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xt = x.reshape(B, -1, C)
        if xt.shape[1] + 1 != self.positional_embedding.shape[1]:
            raise ValueError(
                f"the pool was built for {self.positional_embedding.shape[1] - 1}"
                f" tokens, got {xt.shape[1]} (build the classifier with the "
                "input's size)")
        xt = torch.cat([xt.mean(dim=1, keepdim=True), xt], dim=1)
        xt = xt + self.positional_embedding.t()[None].to(xt.dtype)
        a = qkv_attention(self.qkv_proj(xt, dtype=self.dtype), self.num_heads,
                          new_order=False, weights_dtype=xt.dtype)
        return self.c_proj(a, dtype=self.dtype)[:, 0]


def _spatial_shape(image_size, dims: int) -> Tuple[int, ...]:
    if isinstance(image_size, int):
        return (image_size,) * dims
    shape = tuple(int(n) for n in image_size)
    if len(shape) != dims:
        raise ValueError(f"image_size {image_size} for a {dims}-D model")
    return shape


class EncoderUNetModel(ConvSites, nn.Module):
    """Half-UNet encoder with a pooling head, the classifier of guidance
    (``ddpm3d_tpu/models/unet.py:704-847``): the UNet's input stages and
    (``include_middle``) its middle block with attention, then ``pool``:

    * ``adaptive``: GroupNorm, SiLU, spatial mean, zero-init 1x1 conv;
    * ``attention``: GroupNorm, SiLU, :class:`AttentionPool`;
    * ``spatial``: each stage's spatial mean (in the input's dtype),
      concatenated, dense 2048, ReLU, dense ``out_channels``;
    * ``spatial_v2``: the same with GroupNorm + SiLU in place of the ReLU.

    ``image_size`` (an int, or the spatial shape, e.g. an anisotropic
    (D, H, W)) sizes the attention pool's positional embedding: the JAX
    package sizes it at ``init`` on the real input. ``head=False`` builds
    no head (the Seg models' encoder, which only returns features: the JAX
    module makes its head's params on the first call that reaches it). The
    head's names
    (:mod:`..utils.convert`): ``out.0`` its norm (spatial: the first
    dense), ``out.2`` its conv or pool (spatial: the last dense;
    spatial_v2: ``out.1`` its norm, ``out.3`` the last dense).

    A 3-D encoder serves its conv sites in int8 (``int8=``, ``set_int8``)
    and records them in the calibration mode (:class:`ConvSites`): its
    3x3x3 convs and 1x1x1 skips, named by their flax paths (``in1_0/
    in_conv``), the sites JAX's encoder quantizes under ``DDPM3D_INT8=1``
    (the head's conv is a plain 1x1 conv in both packages)."""

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
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        pool: str = "adaptive",
        include_middle: bool = True,
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        image_size: Union[int, Sequence[int], None] = None,
        head: bool = True,
        int8: Optional[Int8Config] = None,
    ):
        super().__init__()
        if dims not in (1, 2, 3):
            raise ValueError(f"dims must be 1, 2 or 3, got {dims}")
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(f"unexpected pool {pool}")
        plan = plan_unet(
            in_channels=in_channels, model_channels=model_channels,
            out_channels=out_channels, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, conv_resample=conv_resample,
            num_heads=num_heads, num_head_channels=num_head_channels,
            resblock_updown=resblock_updown, middle_attention=True,
        )
        self.model_channels = model_channels
        self.dims = dims
        self.pool = pool
        self.include_middle = include_middle
        self.use_checkpoint = use_checkpoint
        self.dtype = dtype
        self.fused = False
        emb_ch = 4 * model_channels
        self.time_embed = _time_embed(model_channels)

        def stage_list(stage):
            return _build_stage(stage, dims, emb_ch, dropout,
                                use_scale_shift_norm, use_new_attention_order)

        self.input_blocks = nn.ModuleList(
            [stage_list(s) for s in plan.input_blocks])
        if include_middle:
            self.middle_block = stage_list(plan.middle_block)
        ch = plan.skip_chs[-1]
        self.head = head
        if head:
            if pool == "adaptive":
                self.out = nn.ModuleList([
                    prim.GroupNorm32(ch), nn.SiLU(),
                    prim.ConvNd(dims, ch, out_channels, 1, zero_init=True)])
            elif pool == "attention":
                if num_head_channels == -1:
                    raise ValueError(
                        "pool='attention' needs num_head_channels")
                if image_size is None:
                    raise ValueError("pool='attention' needs image_size (the "
                                     "input's spatial size)")
                shape = list(_spatial_shape(image_size, dims))
                # the (1,)2,2 pyramid: a stride-2 conv with padding 1 keeps
                # ceil(n / 2), pooling floor(n / 2)
                strided = conv_resample and not resblock_updown
                for _ in range(len(channel_mult) - 1):
                    for ax in range(1 if dims == 3 else 0, dims):
                        shape[ax] = (shape[ax] + strided) // 2
                self.out = nn.ModuleList([
                    prim.GroupNorm32(ch), nn.SiLU(),
                    AttentionPool(ch, num_head_channels, out_channels,
                                  math.prod(shape), dtype=dtype)])
            else:
                n_feat = sum(plan.skip_chs) + (ch if include_middle else 0)
                layers = [nn.Linear(n_feat, 2048)]
                layers += ([prim.GroupNorm32(2048), nn.SiLU()]
                           if pool == "spatial_v2" else [nn.ReLU()])
                self.out = nn.ModuleList(
                    layers + [nn.Linear(2048, out_channels)])
        prim.init_params(self, seed=0)
        self.set_int8(int8)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                return_features: bool = False):
        """Logits [B, out_channels] in the head's dtype; with
        ``return_features``, ``(features, h)``: every input stage's output
        and the last activation, in the torso's layout and dtype."""
        emb = self.time_embed(
            prim.timestep_embedding(timesteps, self.model_channels))
        remat = self.use_checkpoint and torch.is_grad_enabled()
        spatial = tuple(range(1, self.dims + 1))

        def spatial_mean(t):
            t = t.to(x.dtype)
            if self.dims == 3:  # H, W first, then depth (the JAX fold order)
                return t.mean(dim=(2, 3)).mean(dim=1)
            return t.mean(dim=spatial)

        h = x.to(self.dtype)
        sp = self.pool.startswith("spatial")
        features: List[torch.Tensor] = []
        means: List[torch.Tensor] = []
        for stage in self.input_blocks:
            h, _ = _run_stage(stage, h, emb, None, remat)
            features.append(h)
            if sp:
                means.append(spatial_mean(h))
        if self.include_middle:
            h, _ = _run_stage(self.middle_block, h, emb, None, remat)
            if sp:
                means.append(spatial_mean(h))
        if return_features:
            return features, h
        if not self.head:
            raise ValueError("built without a head (head=False): call with "
                             "return_features=True")
        if sp:
            h = torch.cat(means, dim=-1).float()
            h = F.linear(h, self.out[0].weight, self.out[0].bias)
            if self.pool == "spatial_v2":
                h = self.out[1](h, apply_silu=True)
            else:
                h = F.relu(h)
            return F.linear(h, self.out[-1].weight, self.out[-1].bias)
        h = self.out[0](h.to(x.dtype), apply_silu=True)
        if self.pool == "adaptive":
            h = h.mean(dim=spatial, keepdim=True)
            return self.out[2](h).reshape(h.shape[0], -1)
        return self.out[2](h)
