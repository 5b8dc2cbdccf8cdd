"""Static UNet wiring plans (own copy of ``ddpm3d_tpu/models/plan.py``).

The reference builds its block lists with running channel bookkeeping inside
``UNetModel.__init__`` (unet.py:480-669), including a **non-standard
"pair-pop" decoder**: each decoder stage pops the skip width ``inch``, peeks
the next width ``outch``, builds ``ResBlock(inch*2 -> outch)`` and re-pushes
``outch`` (unet.py:618-663). Getting this wrong silently breaks checkpoint
compatibility, so the wiring is computed by a pure function and the
PyTorch modules simply instantiate what the plan says.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ResSpec:
    in_ch: int
    out_ch: int
    up: bool = False
    down: bool = False


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    ch: int
    num_heads: int


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    in_ch: int
    out_ch: int


@dataclasses.dataclass(frozen=True)
class DownSpec:
    in_ch: int
    out_ch: int
    use_conv: bool


@dataclasses.dataclass(frozen=True)
class UpSpec:
    in_ch: int
    out_ch: int
    use_conv: bool


# One encoder/decoder stage = a sequence of specs applied in order
# (the reference's TimestepEmbedSequential, unet.py:66-78).
Stage = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    input_blocks: Tuple[Stage, ...]
    middle_block: Stage
    output_blocks: Tuple[Stage, ...]
    # Channel counts of the skip tensors pushed by each encoder stage
    # (reference ``input_block_chans`` before decoding starts).
    skip_chs: Tuple[int, ...]
    # Width entering the final head's GroupNorm (``outch`` after the loop).
    head_norm_ch: int
    # The head conv maps input_ch -> out_channels (unet.py:665-669 uses
    # ``input_ch``, which equals head_norm_ch for all shipped configs).
    head_conv_in_ch: int
    out_channels: int


def _num_heads_for(ch: int, num_heads: int, num_head_channels: int) -> int:
    if num_head_channels == -1:
        return num_heads
    assert ch % num_head_channels == 0, (
        f"channels {ch} not divisible by num_head_channels {num_head_channels}"
    )
    return ch // num_head_channels


def plan_unet(
    in_channels: int,
    model_channels: int,
    out_channels: int,
    num_res_blocks: int,
    attention_resolutions: Sequence[int],
    channel_mult: Sequence[float] = (1, 2, 4, 8),
    conv_resample: bool = True,
    num_heads: int = 1,
    num_head_channels: int = -1,
    num_heads_upsample: int = -1,
    resblock_updown: bool = False,
    middle_attention: bool = True,
) -> UNetPlan:
    """Reproduce the reference's constructor bookkeeping (unet.py:480-669)."""
    if num_heads_upsample == -1:
        num_heads_upsample = num_heads
    attention_resolutions = set(attention_resolutions)

    ch = input_ch = int(channel_mult[0] * model_channels)
    input_blocks: List[Stage] = [(ConvSpec(in_channels, ch),)]
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            stage: List[object] = [ResSpec(ch, int(mult * model_channels))]
            ch = int(mult * model_channels)
            if ds in attention_resolutions:
                stage.append(
                    AttnSpec(ch, _num_heads_for(ch, num_heads, num_head_channels))
                )
            input_blocks.append(tuple(stage))
            input_block_chans.append(ch)
        if level != len(channel_mult) - 1:
            out_ch = ch
            if resblock_updown:
                input_blocks.append((ResSpec(ch, out_ch, down=True),))
            else:
                input_blocks.append((DownSpec(ch, out_ch, conv_resample),))
            ch = out_ch
            input_block_chans.append(ch)
            ds *= 2

    middle: List[object] = [ResSpec(ch, ch)]
    if middle_attention:
        middle.append(AttnSpec(ch, _num_heads_for(ch, num_heads, num_head_channels)))
    middle.append(ResSpec(ch, ch))

    skip_chs = tuple(input_block_chans)

    # Pair-pop decoder (unet.py:618-663): pop inch, pop outch (or reuse inch
    # when the stack empties), ResBlock(inch*2 -> outch), re-push outch.
    output_blocks: List[Stage] = []
    chans = list(input_block_chans)
    outch = ch
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            inch = chans.pop()
            outch = chans.pop() if chans else inch
            stage = [ResSpec(inch * 2, outch)]
            if ds in attention_resolutions:
                stage.append(
                    AttnSpec(
                        outch,
                        _num_heads_for(outch, num_heads_upsample, num_head_channels),
                    )
                )
            if level and i == num_res_blocks:
                if resblock_updown:
                    stage.append(ResSpec(outch, outch, up=True))
                else:
                    stage.append(UpSpec(outch, outch, conv_resample))
                ds //= 2
            output_blocks.append(tuple(stage))
            chans.append(outch)

    return UNetPlan(
        input_blocks=tuple(input_blocks),
        middle_block=tuple(middle),
        output_blocks=tuple(output_blocks),
        skip_chs=skip_chs,
        head_norm_ch=outch,
        head_conv_in_ch=input_ch,
        out_channels=out_channels,
    )


def attention_ds_from_resolutions(image_size: int, attention_resolutions) -> Tuple[int, ...]:
    """Translate a resolution list ("16,8" or [16, 8]) into downsample rates
    (reference script_util.py:162-165, 363-365). The shipped 3-D config uses
    "1000", giving ds=[0] which matches no level — attention disabled."""
    if isinstance(attention_resolutions, str):
        parts = [int(r) for r in attention_resolutions.split(",") if r]
    else:
        parts = [int(r) for r in attention_resolutions]
    return tuple(image_size // r for r in parts)
