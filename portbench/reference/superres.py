"""Plain PyTorch reference of the conditional 3-D denoiser (SuperResModel
without attention, scale-shift norm, in-block resampling), channels-last
``[B, D, H, W, C]``, computed from a dict of parameters keyed as the
published torch state dict. Nothing here imports the program.

Precision as the configuration states it: f32 parameters; a bf16 torso
(3x3x3 convs through ``F.conv3d`` in bf16, 1x1 skips and FiLM denses in
bf16); GroupNorm, FiLM and SiLU in f32, cast back; the time embedding in
f32; the head (its norm and conv) in f32 with TF32 off. With a
:class:`.quant.SiteQuant` every conv site it quantizes runs W8A8 (or the
int4 control) on its bf16 input. The anisotropic pyramid resamples H and W
only.

What the harness takes from a reference module by name (the configuration's
``reference``): :func:`shapes`, :func:`weight_rules`, :func:`build` and
:func:`layout`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

GROUPS = 32
GN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Block:
    """One module of a stage: ``kind`` "conv" (the input conv) or "res"."""
    kind: str
    cin: int
    cout: int
    up: bool = False
    down: bool = False


@dataclasses.dataclass(frozen=True)
class Arch:
    model_channels: int
    channel_mult: Tuple[int, ...]
    num_res_blocks: int
    in_channels: int = 2
    out_channels: int = 2

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        return cls(cfg["num_channels"], tuple(cfg["channel_mult"]),
                   cfg["num_res_blocks"], 2 * cfg["in_channels"],
                   2 * cfg["in_channels"] if cfg["learn_sigma"]
                   else cfg["in_channels"])


def plan(a: Arch) -> Tuple[List[List[Block]], List[Block], List[List[Block]]]:
    """Input stages, middle stage, output stages: the published
    constructor's channel bookkeeping, its decoder popping two skip widths
    per block and pushing one back."""
    mc = a.model_channels
    ch = a.channel_mult[0] * mc
    inputs = [[Block("conv", a.in_channels, ch)]]
    chans = [ch]
    for level, mult in enumerate(a.channel_mult):
        for _ in range(a.num_res_blocks):
            inputs.append([Block("res", ch, mult * mc)])
            ch = mult * mc
            chans.append(ch)
        if level != len(a.channel_mult) - 1:
            inputs.append([Block("res", ch, ch, down=True)])
            chans.append(ch)
    middle = [Block("res", ch, ch), Block("res", ch, ch)]
    outputs = []
    for level in range(len(a.channel_mult) - 1, -1, -1):
        for i in range(a.num_res_blocks + 1):
            inch = chans.pop()
            outch = chans.pop() if chans else inch
            stage = [Block("res", 2 * inch, outch)]
            if level and i == a.num_res_blocks:
                stage.append(Block("res", outch, outch, up=True))
            outputs.append(stage)
            chans.append(outch)
    return inputs, middle, outputs


def stage_prefixes(a: Arch):
    """(torch module prefix, flax site prefix, block) of every block in
    forward order, and each output stage's index among them."""
    inputs, middle, outputs = plan(a)
    out = []
    for i, stage in enumerate(inputs):
        for j, b in enumerate(stage):
            out.append((f"input_blocks.{i}.{j}", f"in{i}_{j}", b))
    for j, b in enumerate(middle):
        out.append((f"middle_block.{j}", f"mid_{j}", b))
    for i, stage in enumerate(outputs):
        for j, b in enumerate(stage):
            out.append((f"output_blocks.{i}.{j}", f"out{i}_{j}", b))
    return out


def param_shapes(a: Arch) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the published state dict's
    naming."""
    mc, emb = a.model_channels, 4 * a.model_channels
    s = {"time_embed.0.weight": (emb, mc), "time_embed.0.bias": (emb,),
         "time_embed.2.weight": (emb, emb), "time_embed.2.bias": (emb,)}
    for pre, _, b in stage_prefixes(a):
        if b.kind == "conv":
            s[f"{pre}.weight"] = (b.cout, b.cin, 3, 3, 3)
            s[f"{pre}.bias"] = (b.cout,)
            continue
        s.update({
            f"{pre}.in_layers.0.weight": (b.cin,),
            f"{pre}.in_layers.0.bias": (b.cin,),
            f"{pre}.in_layers.2.weight": (b.cout, b.cin, 3, 3, 3),
            f"{pre}.in_layers.2.bias": (b.cout,),
            f"{pre}.emb_layers.1.weight": (2 * b.cout, emb),
            f"{pre}.emb_layers.1.bias": (2 * b.cout,),
            f"{pre}.out_layers.0.weight": (b.cout,),
            f"{pre}.out_layers.0.bias": (b.cout,),
            f"{pre}.out_layers.3.weight": (b.cout, b.cout, 3, 3, 3),
            f"{pre}.out_layers.3.bias": (b.cout,),
        })
        if b.cin != b.cout:
            s[f"{pre}.skip_connection.weight"] = (b.cout, b.cin, 1, 1, 1)
            s[f"{pre}.skip_connection.bias"] = (b.cout,)
    head_in = a.channel_mult[0] * mc
    s.update({"out.0.weight": (head_in,), "out.0.bias": (head_in,),
              "out.2.weight": (a.out_channels, head_in, 3, 3, 3),
              "out.2.bias": (a.out_channels,)})
    return s


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y):
    return y.permute(0, 2, 3, 4, 1)


def conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          in_f32: bool = False) -> torch.Tensor:
    """Stride-1 SAME 3x3x3 conv with the weight in x's dtype (f32 without
    TF32); with ``in_f32`` a bf16 x and weight are convolved in f32, the
    bias added in f32, and the sum rounded once to bf16."""
    dt = torch.float32 if in_f32 else x.dtype
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(_ncdhw(x.to(dt)), w.to(x.dtype).to(dt), b.to(dt),
                     padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return _ndhwc(y).to(x.dtype)


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(32) of x [B, ..., C], FiLM ``* (1 + scale) + shift`` and
    SiLU, back to x's dtype: each group's mean and variance in f64, then
    one per-channel f32 affine ``x * g + c`` and ``h * sigmoid(h)``."""
    B, C = x.shape[0], x.shape[-1]
    xr = x.reshape(B, -1, C)
    n = xr.shape[1] * (C // GROUPS)
    s1 = xr.sum(dim=1, dtype=torch.float64)
    s2 = (xr.float() * xr.float()).sum(dim=1, dtype=torch.float64)
    s1 = s1.reshape(B, GROUPS, -1).sum(-1)
    s2 = s2.reshape(B, GROUPS, -1).sum(-1)
    mean = s1 / n
    rstd = torch.rsqrt(torch.clamp(s2 / n - mean * mean, min=0.0) + GN_EPS)
    mean = mean.repeat_interleave(C // GROUPS, dim=-1).float()
    rstd = rstd.repeat_interleave(C // GROUPS, dim=-1).float()
    g = w.float()[None] * rstd
    c = b.float()[None] - mean * g
    if scale is not None:
        g, c = g * (1.0 + scale), c * (1.0 + scale) + shift
    h = xr.float() * g[:, None] + c[:, None]
    return (h * torch.sigmoid(h)).to(x.dtype).reshape(x.shape)


def pool(x: torch.Tensor) -> torch.Tensor:
    """x2 average pooling of H and W, summed in f32."""
    return _ndhwc(F.avg_pool3d(_ncdhw(x.float()), (1, 2, 2))).to(x.dtype)


def up(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of H and W."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SuperRes:
    """The reference denoiser over parameters ``p`` (f32, any device)."""

    def __init__(self, arch: Arch, p: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.bfloat16, quant=None):
        self.arch, self.p, self.dtype, self.quant = arch, p, dtype, quant
        self.blocks = stage_prefixes(arch)
        inputs, middle, _ = plan(arch)
        self.n_in = sum(len(s) for s in inputs)
        self.n_mid = len(middle)

    def site(self, name: str, path: str, x, upsample: bool = False):
        """Conv site ``path`` (``unet/<site>``, as the scales files key
        it) with parameters ``name``, on its input x as the site takes it
        (on an up site the low-resolution x)."""
        return self._site(name, path.split("/", 1)[1], x, upsample)

    def _site(self, name: str, site: str, x, upsample: bool = False):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.quant is not None and self.quant.quantized("unet/" + site):
            return self.quant.conv("unet/" + site, x, w, b, upsample)
        if w.shape[-1] == 1:
            return F.linear(x, w.reshape(w.shape[:2]).to(x.dtype),
                            b.to(x.dtype))
        # beside quantized sites a bf16 conv rounds once, from f32 sums:
        # the quantizers downstream turn its last bit into whole steps
        return conv3(up(x) if upsample else x, w, b,
                     in_f32=self.quant is not None)

    def _res(self, pre: str, site: str, blk: Block, x, emb):
        p = self.p
        h = group_norm(x, p[pre + ".in_layers.0.weight"],
                       p[pre + ".in_layers.0.bias"])
        if blk.down:
            h, x = pool(h), pool(x)
        elif blk.up:
            x = up(x)
        h = self._site(pre + ".in_layers.2", site + "/in_conv", h, blk.up)
        e = F.linear(F.silu(emb).to(h.dtype),
                     p[pre + ".emb_layers.1.weight"].to(h.dtype),
                     p[pre + ".emb_layers.1.bias"].to(h.dtype)).float()
        scale, shift = e.chunk(2, dim=-1)
        h = group_norm(h, p[pre + ".out_layers.0.weight"],
                       p[pre + ".out_layers.0.bias"], scale, shift)
        h = self._site(pre + ".out_layers.3", site + "/out_conv", h)
        if blk.cin != blk.cout:
            x = self._site(pre + ".skip_connection", site + "/skip", x)
        return x + h

    def __call__(self, x: torch.Tensor, t: torch.Tensor,
                 low: torch.Tensor) -> torch.Tensor:
        """x, low [B, D, H, W, 1] f32; t [B] the model's timesteps; -> the
        f32 output [B, D, H, W, out_channels]."""
        p = self.p
        xin = torch.cat([x.float(), low.float()], dim=-1)
        te = timestep_embedding(t, self.arch.model_channels)
        emb = F.linear(F.silu(F.linear(te, p["time_embed.0.weight"],
                                       p["time_embed.0.bias"])),
                       p["time_embed.2.weight"], p["time_embed.2.bias"])
        h = xin.to(self.dtype)
        hs = []
        prev_stage = None
        for k, (pre, site, blk) in enumerate(self.blocks):
            stage = pre.rsplit(".", 1)[0]
            if k >= self.n_in + self.n_mid and stage != prev_stage:
                h = torch.cat([h, hs.pop()], dim=-1)
            if blk.kind == "conv":
                h = self._site(pre, site, h)
            else:
                h = self._res(pre, site, blk, h, emb)
            if k < self.n_in and (k + 1 == self.n_in or
                                  self.blocks[k + 1][0].rsplit(".", 1)[0]
                                  != stage):
                hs.append(h)
            prev_stage = stage
        h = group_norm(h.float(), p["out.0.weight"], p["out.0.bias"])
        return self._site("out.2", "head_conv", h).float()


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """A configuration's parameters and their shapes."""
    return param_shapes(Arch.from_config(cfg))


def weight_rules(cfg: dict) -> dict:
    """How a seed draw treats this model's parameters: the GroupNorm
    affines (by name suffix), the head's parameters, and from which of the
    head's output rows on they are the learned variance's (0: none)."""
    return {"norm_suffixes": ("in_layers.0.weight", "in_layers.0.bias",
                              "out_layers.0.weight", "out_layers.0.bias",
                              "out.0.weight", "out.0.bias"),
            "head": ("out.2.weight", "out.2.bias"),
            "var_rows": cfg["in_channels"] if cfg["learn_sigma"] else 0}


def build(cfg: dict, p: Dict[str, torch.Tensor], quant=None) -> SuperRes:
    """The reference model of a configuration over parameters ``p``."""
    dtype = torch.bfloat16 if cfg["use_fp16"] else torch.float32
    return SuperRes(Arch.from_config(cfg), p, dtype, quant)


def layout(cfg: dict, patch: Tuple[int, int, int]):
    """The conv sites and GroupNorms of one batch-1 forward at ``patch``
    (D, H, W), in forward order: sites as dicts (``site``, ``cin``,
    ``cout``, ``k`` 3 or 1, ``in_voxels``, ``out_voxels``, ``up``,
    ``precision`` as the configuration runs it before int8: bf16, or f32
    for the head), norms as (channels, voxels, precision). The pyramid
    resamples H and W; a down block pools before its in_conv, an up block
    convolves the upsampled input."""
    arch = Arch.from_config(cfg)
    torso = "bf16" if cfg["use_fp16"] else "f32"
    D, H, W = patch
    r = 1
    sites, norms = [], []

    def vox(rate):
        return D * (H // rate) * (W // rate)

    def conv(site, cin, cout, rate_in, rate_out, k=3, prec=torso):
        sites.append({"site": site, "cin": cin, "cout": cout, "k": k,
                      "in_voxels": vox(rate_in), "out_voxels": vox(rate_out),
                      "up": rate_out < rate_in, "precision": prec})

    for _, site, blk in stage_prefixes(arch):
        if blk.kind == "conv":
            conv(site, blk.cin, blk.cout, r, r)
            continue
        norms.append((blk.cin, vox(r), torso))
        r_out = r * 2 if blk.down else (r // 2 if blk.up else r)
        conv(site + "/in_conv", blk.cin, blk.cout,
             r_out if blk.down else r, r_out)
        norms.append((blk.cout, vox(r_out), torso))
        conv(site + "/out_conv", blk.cout, blk.cout, r_out, r_out)
        if blk.cin != blk.cout:
            conv(site + "/skip", blk.cin, blk.cout, r_out, r_out, k=1)
        r = r_out
    head_in = arch.channel_mult[0] * arch.model_channels
    norms.append((head_in, vox(r), "f32"))
    conv("head_conv", head_in, arch.out_channels, r, r, prec="f32")
    return sites, norms
