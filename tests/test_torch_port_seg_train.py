"""One training step of the port's Seg* models against jax.grad (CPU: the
kernels' plain versions, behind the same autograd Functions the card
runs), for each fusion at the tiny size of tests/test_torch_port_seg.py;
and the launches per forward of the production-depth Seg models that
chip_smoke.py pins on the card, counted on the plain path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.diffusion import losses as jloss
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu_torch.diffusion import losses as tloss
from ddpm3d_tpu_torch.models import SegUNetModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.ops import conv3d as conv_ops
from ddpm3d_tpu_torch.ops import conv3d_s8 as s8_ops
from ddpm3d_tpu_torch.ops import groupnorm as gn_ops
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict
from test_torch_port_seg import FUSIONS, _case, _port, _t, _two_threads  # noqa: F401

# whole-model gradients, per tensor (tests/test_torch_port_train.py): a
# tensor whose gradient is zero in exact arithmetic holds only rounding
# noise, so the scale has a floor of ZERO_GRAD_FLOOR x the largest gradient
GRAD_TOL = 1e-4
ZERO_GRAD_FLOOR = 1e-3


def _train_batch(x):
    noise = np.random.default_rng(6).standard_normal(x.shape)
    return np.clip(x, -1, 1), noise.astype(np.float32)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seg_training_step_matches_jax_grad(fusion):
    """The hybrid loss (MSE + learned-range vb) of one training batch
    through the port's training_losses, unchanged for a Seg model: the loss
    and every parameter gradient against jax.grad on the same params, t
    and noise."""
    jm, params, x, low, t = _case(fusion)
    x0, noise = _train_batch(x)
    js, jcfg = jfactory.create_gaussian_diffusion(steps=1000,
                                                  learn_sigma=True)
    ts, tcfg = tfactory.create_gaussian_diffusion(steps=1000,
                                                  learn_sigma=True)

    def jax_loss(p):
        terms = jloss.training_losses(
            jax.random.key(0),
            lambda a, tt, **k: jm.apply({"params": p}, a, tt, **k),
            js, jcfg, jnp.asarray(x0), jnp.asarray(t),
            model_kwargs={"low_res": jnp.asarray(low)},
            noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          ref_grads))
    model = _port(fusion, params).train()
    terms = tloss.training_losses(
        model, ts, tcfg, _t(x0), _t(t).long(),
        model_kwargs={"low_res": _t(low)}, noise=_t(noise))
    loss = terms["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(ref)
    floor = ZERO_GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        err = (grads[name] - r).abs().max().item()
        assert err <= GRAD_TOL * max(r.abs().max().item(), floor), name


# the card's launches per forward of the full-width Seg models at the
# production flags (chip_smoke.py SEG_LAUNCHES), counted on the plain path
# at the production depth (a narrower torso launches the same kernels on
# the same routes: every width is a multiple of 8, the head still fits
# f32_head):
# the main branch's 72 convs and 71 GroupNorms plus the encoder's 29 convs
# (its Cin = 1 input conv on the sm90_cin1 route) and 28 GroupNorms; the 1x1
# convs (skips, fuse{i}) are matmuls. In int8, the K5 sites: the main
# branch's 88, the encoder's 28 3x3 + 3 skips, and the fusion's 1x1 sites
# (15 fuse{i} for cat_conv, the middle block's skip for midcat)
SEG_LAUNCHES = {
    fusion: {"conv3d": 101, "conv3d_s8": 0, "gn_stats": 99, "gn_apply": 99}
    for fusion in FUSIONS}
SEG_ROUTES = {"sm90": 98, "sm90_narrow": 1, "sm90_cin1": 1, "f32_head": 1}
SEG_INT8_LAUNCHES = {
    "add": {"conv3d": 3, "conv3d_s8": 119, "gn_stats": 99, "gn_apply": 99},
    "cat_conv": {"conv3d": 3, "conv3d_s8": 134, "gn_stats": 99,
                 "gn_apply": 99},
    "midcat": {"conv3d": 3, "conv3d_s8": 120, "gn_stats": 99,
               "gn_apply": 99},
}
SEG_INT8_ROUTES = {"sm90_narrow": 1, "sm90_cin1": 1, "f32_head": 1}


def production_seg(fusion, model_channels=128, **kw) -> SegUNetModel:
    """test_DDPM_3d_tpu.sh's model flags on the Seg family: 128 channels,
    (1, 1, 2, 3, 4), 2 res blocks, learned sigma, scale-shift norm,
    resblock up/down, no attention, bf16 torso."""
    return SegUNetModel(
        in_channels=1, cond_channels=1, model_channels=model_channels,
        out_channels=2,
        num_res_blocks=2, channel_mult=(1, 1, 2, 3, 4),
        use_scale_shift_norm=True, resblock_updown=True, fusion=fusion,
        dtype=torch.bfloat16, **kw).eval()


@pytest.mark.parametrize("fusion", FUSIONS)
def test_production_seg_launches(fusion, monkeypatch):
    """Launches per forward of each full-width Seg model, bf16 and int8,
    by kernel and by the conv's route (``conv3d_route`` of each call, as
    the card picks)."""
    counts, routes = {}, {}

    def counting(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            if name == "conv3d":
                r = conv_ops.conv3d_route(a[0].shape, a[0].dtype,
                                          a[1].shape[0])
                routes[r] = routes.get(r, 0) + 1
            return fn(*a, **k)
        return wrapper

    for mod, name, key in ((conv_ops, "conv3d", "conv3d"),
                           (s8_ops, "conv3d_s8", "conv3d_s8"),
                           (gn_ops, "channel_stats", "gn_stats"),
                           (gn_ops, "gn_apply", "gn_apply")):
        monkeypatch.setattr(mod, name, counting(key, getattr(mod, name)))
    x = torch.zeros((1, 1, 16, 16, 1))
    t = torch.tensor([10])
    model = production_seg(fusion, model_channels=32)
    for int8, want, want_routes in (
            (None, SEG_LAUNCHES, SEG_ROUTES),
            (quant.Int8Config(), SEG_INT8_LAUNCHES, SEG_INT8_ROUTES)):
        model.set_int8(int8)
        counts.update({k: 0 for k in want[fusion]})
        routes.clear()
        with torch.no_grad():
            model(x, t, low_res=x)
        assert counts == want[fusion], int8
        assert routes == want_routes, int8
