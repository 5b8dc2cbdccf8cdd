"""By-name aliases for the reference's remaining model class names.

Port of ``ddpm3d_tpu/models/aliases.py``, with its reasoning kept.

The underlying capabilities are already provided by the parameterized
implementations (``UNetModel``, ``SegUNetModel``, ``EncoderUNetModel``);
these thin wrappers close the drop-in API-surface gap for users migrating
by class name (reference guided_diffusion/unet.py:1327, 1752, 1916, 2199,
2371). Each docstring records how the alias maps onto the generic model —
and, where the reference class is internally inconsistent, which consistent
interpretation the alias implements.
"""

from __future__ import annotations

from .seg import SegUNetModel
from .unet import EncoderUNetModel, UNetModel


def UNetModelv2(**kw) -> UNetModel:
    """Reference ``UNetModelv2`` (unet.py:1327-1652).

    Its only delta vs ``UNetModel`` is an explicit ``out_channels=ch`` on
    the first middle ResBlock (unet.py:1474-1483) — which is what the
    generic plan already produces (``ResSpec(ch, ch)``; see
    models/plan.py and tests/test_unet_plan.py), so this is the canonical
    model under another name.
    """
    return UNetModel(**kw)


def EncoderUNetModelv2(**kw) -> EncoderUNetModel:
    """Reference ``EncoderUNetModelv2`` (unet.py:2199-2368): half-UNet
    encoder with the middle block removed, exposing per-stage features
    (the reference stores them on ``self.hs`` for the Seg* models to pop,
    unet.py:2364-2366).

    Call ``forward(x, t, return_features=True)`` to receive
    ``(features, final)`` — the functional analog of the reference's
    side-channel ``self.hs`` list.
    """
    kw.setdefault("include_middle", False)
    return EncoderUNetModel(**kw)


def EncoderUNetModelv3(**kw) -> EncoderUNetModel:
    """Reference ``EncoderUNetModelv3`` (unet.py:2371-2512): like v2 but
    without feature storage — forward returns only the final encoder
    activation (unet.py:2497-2512). Same module; simply don't request
    ``return_features`` (or ignore the feature list).
    """
    kw.setdefault("include_middle", False)
    return EncoderUNetModel(**kw)


def SegModelv2_6c(**kw) -> SegUNetModel:
    """Reference ``SegModelv2_6c`` (unet.py:1752-1803): additive per-stage
    fusion of an encoder branch, aux-channel conditioner.

    NOTE: the reference class cannot run a forward pass as written — the
    constructor sizes the main branch for ``in_channels + 3`` inputs
    (unet.py:1760) while the encoder branch is built for 6 channels
    (unet.py:1762) yet receives the same ``low_res`` tensor the main
    branch concatenates (unet.py:1783-1787); no channel count satisfies
    both. This alias implements the consistent interpretation: a
    3-channel conditioner feeds both the main-branch concat and the
    encoder (override with ``cond_channels=``).
    """
    kw.setdefault("cond_channels", 3)
    return SegUNetModel(fusion="add", **kw)


def SegModelv3_6c(**kw) -> SegUNetModel:
    """Reference ``SegModelv3_6c`` (unet.py:1916-1981): per-stage concat +
    1x1-conv fusion of the encoder branch's features (unet.py:1971-1975).

    Shares the channel-bookkeeping inconsistency of ``SegModelv2_6c``
    (see that alias); implemented with a consistent 3-channel conditioner
    default (override with ``cond_channels=``).
    """
    kw.setdefault("cond_channels", 3)
    return SegUNetModel(fusion="cat_conv", **kw)
