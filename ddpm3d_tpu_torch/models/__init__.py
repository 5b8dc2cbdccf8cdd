"""The model layer: primitives, wiring plan, the UNets, the classifier and
the factories."""

from .plan import AttnSpec, ConvSpec, DownSpec, ResSpec, UpSpec, plan_unet
from .unet import (
    AttentionBlock,
    AttentionPool,
    Downsample,
    EncoderUNetModel,
    ResBlock,
    SuperResModel,
    UNetModel,
    Upsample,
)
