"""The model layer: primitives, wiring plan, the UNets, the classifier, the
dual-branch Seg* models, the reference's class-name aliases and the
factories."""

from .aliases import (
    EncoderUNetModelv2,
    EncoderUNetModelv3,
    SegModelv2_6c,
    SegModelv3_6c,
    UNetModelv2,
)
from . import nn
from .plan import (
    AttnSpec,
    ConvSpec,
    DownSpec,
    ResSpec,
    UNetPlan,
    UpSpec,
    attention_ds_from_resolutions,
    plan_unet,
)
from .seg import (
    SegModel_3d_noatt_midcat,
    SegModelv2,
    SegModelv2_3d_noatt,
    SegModelv3,
    SegUNetModel,
)
from .unet import (
    AttentionBlock,
    AttentionPool,
    ConvSites,
    Downsample,
    EncoderUNetModel,
    ResBlock,
    SuperResModel,
    UNetModel,
    Upsample,
)
