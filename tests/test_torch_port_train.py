"""The port's training slice against the JAX package, on the same
numpy-seeded inputs (f32, CPU: the kernels' plain versions behind the same
autograd Functions the card runs).

Covers the process additions, every loss term and (loss, mean, var) mode,
the conv and GroupNorm backward, whole-model gradients, one AdamW + EMA
update against optax, the update half's policies, the loss-second-moment
sampler, the training data, the checkpoint helpers and resume, a
port-written checkpoint served by the JAX package, and the training CLI.
"""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm3d_tpu.data import dataset as jdata
from ddpm3d_tpu.data import patches as jpatches
from ddpm3d_tpu.diffusion import losses as jloss
from ddpm3d_tpu.diffusion import process as jproc
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu.models import nn as jnn
from ddpm3d_tpu.ops.conv3d_mxu import _xla_conv3d, conv3d_mxu
from ddpm3d_tpu.training import resample as jres
from ddpm3d_tpu.training.train_loop import make_optimizer as jax_make_optimizer
from ddpm3d_tpu.utils import checkpoint as jckpt
from ddpm3d_tpu.utils import logger as jlogger
from ddpm3d_tpu.utils.torch_import import load_torch_checkpoint
from ddpm3d_tpu_torch.data import dataset as tdata
from ddpm3d_tpu_torch.data import patches as tpatches
from ddpm3d_tpu_torch.data import tiff_io as ttiff
from ddpm3d_tpu_torch.diffusion import losses as tloss
from ddpm3d_tpu_torch.diffusion import process as tproc
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import groupnorm as gn
from ddpm3d_tpu_torch.scripts import train as train_cli
from ddpm3d_tpu_torch.training import resample as tres
from ddpm3d_tpu_torch.training import train_loop as tl
from ddpm3d_tpu_torch.utils import checkpoint as tckpt
from ddpm3d_tpu_torch.utils import logger as tlogger
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict

TINY = dict(
    model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 2), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)
# whole-model gradients: f32 sums over ~10 conv/GN layers, reordered
# against XLA; per tensor, max |diff| <= GRAD_TOL * max |ref|. A tensor whose
# gradient is zero in exact arithmetic (a conv bias right before a
# one-channel-per-group GroupNorm) holds only rounding noise, so the scale
# has a floor of ZERO_GRAD_FLOOR times the largest gradient of the model.
GRAD_TOL = 1e-4
ZERO_GRAD_FLOOR = 1e-3


def t2n(t):
    return t.detach().numpy()


def _cfgs(loss_type, mean_type, var_type, steps=1000):
    jcfg = jproc.DiffusionConfig(
        mean_type=mean_type, var_type=var_type, loss_type=loss_type,
        original_num_steps=steps)
    tcfg = tproc.DiffusionConfig(
        mean_type=tproc.MeanType(mean_type.value),
        var_type=tproc.VarType(var_type.value),
        loss_type=tproc.LossType(loss_type.value), original_num_steps=steps)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def scheds():
    js, _ = jfactory.create_gaussian_diffusion(steps=1000, timestep_respacing="10")
    ts, _ = tfactory.create_gaussian_diffusion(steps=1000, timestep_respacing="10")
    return js, ts


# ------------------------------------------------------------ process math


def test_process_additions_match_jax(rng, scheds):
    js, ts = scheds
    x0 = rng.standard_normal((3, 2, 3, 4, 1), dtype=np.float32)
    noise = rng.standard_normal(x0.shape, dtype=np.float32)
    x0h = rng.standard_normal(x0.shape, dtype=np.float32)
    t = np.array([0, 5, 9])
    J = lambda a: jnp.asarray(a)
    T = torch.from_numpy
    for ref, got in [
        (jproc.q_mean_variance(js, J(x0), J(t)),
         tproc.q_mean_variance(ts, T(x0), T(t))),
        ((jproc.q_sample(js, J(x0), J(t), J(noise)),),
         (tproc.q_sample(ts, T(x0), T(t), T(noise)),)),
        ((jproc.predict_v(js, J(x0), J(t), J(noise)),),
         (tproc.predict_v(ts, T(x0), T(t), T(noise)),)),
        ((jproc.predict_eps_from_xstart(js, J(noise), J(t), J(x0h)),),
         (tproc.predict_eps_from_xstart(ts, T(noise), T(t), T(x0h)),)),
    ]:
        for r, g in zip(ref, got):
            np.testing.assert_allclose(t2n(g), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


def test_loss_terms_match_jax(rng):
    a, b, c, d = (rng.standard_normal((2, 3, 4, 5, 1), dtype=np.float32)
                  for _ in range(4))
    x = np.clip(rng.uniform(-1.2, 1.2, a.shape), -1, 1).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    pairs = [
        (jloss.mean_flat(J(a)), tloss.mean_flat(T(a))),
        (jloss.normal_kl(J(a), J(b), J(c), J(d)),
         tloss.normal_kl(T(a), T(b), T(c), T(d))),
        (jloss.normal_kl(J(a), J(b), 0.0, 0.0),
         tloss.normal_kl(T(a), T(b), 0.0, 0.0)),
        (jloss.approx_standard_normal_cdf(J(a)),
         tloss.approx_standard_normal_cdf(T(a))),
        # the decoder term's regime (t = 0: std ~ 0.01, about one 2/255
        # bin); far in the tail the bin mass is an f32 cancellation in both
        (jloss.discretized_gaussian_log_likelihood(
            J(x), means=J(x) + J(a) * 0.01, log_scales=J(b) * 0.1 - 4.6),
         tloss.discretized_gaussian_log_likelihood(
            T(x), means=T(x) + T(a) * 0.01, log_scales=T(b) * 0.1 - 4.6)),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(t2n(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("loss_type", list(jproc.LossType))
@pytest.mark.parametrize("mean_type", list(jproc.MeanType))
@pytest.mark.parametrize("var_type", list(jproc.VarType))
def test_training_losses_all_modes(rng, scheds, loss_type, mean_type, var_type):
    """A fixed model output, the same t (t = 0 included) and noise."""
    js, ts = scheds
    jcfg, tcfg = _cfgs(loss_type, mean_type, var_type)
    learned = var_type in (jproc.VarType.LEARNED, jproc.VarType.LEARNED_RANGE)
    x0 = np.clip(rng.standard_normal((3, 2, 3, 4, 1)), -1, 1).astype(np.float32)
    noise = rng.standard_normal(x0.shape, dtype=np.float32)
    out = rng.uniform(-1, 1, x0.shape[:-1] + (2 if learned else 1,)).astype(
        np.float32)
    t = np.array([0, 4, 9])
    ref = jloss.training_losses(
        jax.random.key(0), lambda x, tt, **kw: jnp.asarray(out), js, jcfg,
        jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise))
    got = tloss.training_losses(
        lambda x, tt, **kw: torch.from_numpy(out), ts, tcfg,
        torch.from_numpy(x0), torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_calc_bpd_loop_matches_jax_terms(rng):
    """The port's loop with given per-step noise against the JAX terms
    (vb_terms_bpd per t, prior_bpd) on the same noise."""
    js, jcfg = jfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="3")
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="3")
    x0 = np.clip(rng.standard_normal((2, 2, 3, 4, 1)), -1, 1).astype(np.float32)
    noise = rng.standard_normal((3,) + x0.shape, dtype=np.float32)
    out = rng.uniform(-1, 1, x0.shape[:-1] + (2,)).astype(np.float32)
    got = tloss.calc_bpd_loop(
        lambda x, tt, **kw: torch.from_numpy(out), ts, tcfg,
        torch.from_numpy(x0), noise=torch.from_numpy(noise))
    vb = []
    for i, t_scalar in enumerate((2, 1, 0)):
        t = jnp.full((2,), t_scalar)
        x_t = jproc.q_sample(js, jnp.asarray(x0), t, jnp.asarray(noise[i]))
        vb.append(jloss.vb_terms_bpd(
            lambda x, tt, **kw: jnp.asarray(out), js, jcfg,
            jnp.asarray(x0), x_t, t)["output"])
    vb = np.stack([np.asarray(v) for v in vb], axis=1)
    prior = np.asarray(jloss.prior_bpd(js, jnp.asarray(x0)))
    np.testing.assert_allclose(t2n(got["vb"]), vb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t2n(got["prior_bpd"]), prior, rtol=1e-5)
    np.testing.assert_allclose(t2n(got["total_bpd"]), vb.sum(1) + prior,
                               rtol=1e-5)


# ------------------------------------------------------------ kernel VJPs


@pytest.mark.parametrize("impl,shape,cout", [
    ("pallas_interpret", (1, 2, 4, 8, 128), 128),
    ("xla", (2, 5, 6, 7, 16), 8),
    ("xla", (1, 4, 8, 8, 2), 16),    # Cin = 2: the input conv
    ("xla", (1, 4, 8, 8, 16), 2),    # Cout = 2: the head conv's dx is 2 -> 16
])
def test_conv_function_grads_match_jax_vjp(rng, impl, shape, cout):
    cin = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout), dtype=np.float32)
         / np.sqrt(27 * cin)).astype(np.float32)
    b = rng.standard_normal((cout,), dtype=np.float32)
    dy = rng.standard_normal(shape[:-1] + (cout,), dtype=np.float32)
    if impl == "xla":
        f = lambda x_, w_, b_: _xla_conv3d(x_, w_) + b_
    else:
        f = lambda x_, w_, b_: conv3d_mxu(x_, w_, b_, interpret=True)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    wt.requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    cv.conv3d(xt, wt, bt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(t2n(xt.grad), rdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(wt.grad), rdw.transpose(4, 3, 0, 1, 2),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t2n(bt.grad), rdb, rtol=1e-5, atol=1e-5)


def test_conv_skips_dx_when_not_needed(rng):
    """The input conv's input needs no gradient: no dx is computed."""
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 2), dtype=np.float32))
    w = torch.zeros((8, 2, 3, 3, 3), requires_grad=True)
    calls = []
    orig = cv.conv3d_dx
    cv.conv3d_dx = lambda *a: calls.append(1) or orig(*a)
    try:
        cv.conv3d(x, w).sum().backward()
    finally:
        cv.conv3d_dx = orig
    assert calls == [] and w.grad is not None


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_gn_function_grads_match_jax_vjp(rng, film, silu):
    B, C = 2, 64
    x = (rng.standard_normal((B, 3, 4, 5, C)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C)).astype(np.float32)
    fs = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    fh = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    ct = rng.standard_normal(x.shape, dtype=np.float32)
    args = [x, scale, bias] + ([fs, fh] if film else [])

    def f(x_, s_, b_, *fl):
        return jnn.group_norm_f32(
            x_, s_, b_, film_scale=fl[0] if film else None,
            film_shift=fl[1] if film else None, apply_silu=silu)

    ref_out, vjp = jax.vjp(f, *map(jnp.asarray, args))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = gn.group_norm(ts[0], ts[1], ts[2],
                        film_scale=ts[3] if film else None,
                        film_shift=ts[4] if film else None, apply_silu=silu)
    np.testing.assert_allclose(t2n(out), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    out.backward(torch.from_numpy(ct))
    for name, t, r in zip(["x", "scale", "bias", "film_scale", "film_shift"],
                          ts, ref):
        np.testing.assert_allclose(t2n(t.grad), r, rtol=1e-5, atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------ whole model


def _random_jax_params(model, x_shape, seed):
    x0 = jnp.zeros(x_shape)
    params = jax.jit(lambda x: model.init(
        jax.random.key(0), x, jnp.zeros((x_shape[0],), jnp.int32),
        low_res=x))(x0)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if path[-1].key == "scale" else 0.05 * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def _port_model(params, **cfg):
    model = SuperResModel(in_channels=1, **cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def _batch(rng, shape=(2, 4, 16, 16, 1)):
    x0 = np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32)
    low = rng.standard_normal(shape, dtype=np.float32)
    noise = rng.standard_normal(shape, dtype=np.float32)
    return x0, low, noise


@pytest.mark.parametrize("scale_shift", [True, False])
def test_model_gradients_match_jax_grad(rng, scale_shift):
    """Hybrid loss (MSE + learned-range vb) of the tiny SuperResModel: every
    parameter gradient against jax.grad on the same params, t and noise;
    use_checkpoint=True gives the same gradients as False."""
    cfg = dict(TINY, use_scale_shift_norm=scale_shift)
    jm = JaxSuperRes(in_channels=1, **cfg)
    params = _random_jax_params(jm, (1, 4, 16, 16, 1), seed=5)
    js, jcfg = jfactory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    ts, tcfg = tfactory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    x0, low, noise = _batch(rng)
    t = np.array([3, 870])

    def jax_loss(p):
        terms = jloss.training_losses(
            jax.random.key(0),
            lambda x, tt, **kw: jm.apply({"params": p}, x, tt, **kw),
            js, jcfg, jnp.asarray(x0), jnp.asarray(t),
            model_kwargs={"low_res": jnp.asarray(low)}, noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    grads = {}
    for remat in (False, True):
        model = _port_model(params, **dict(cfg, use_checkpoint=remat))
        terms = tloss.training_losses(
            model, ts, tcfg, torch.from_numpy(x0), torch.from_numpy(t),
            model_kwargs={"low_res": torch.from_numpy(low)},
            noise=torch.from_numpy(noise))
        loss = terms["loss"].mean()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert sorted(grads[False]) == sorted(ref)
    floor = ZERO_GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        err = np.abs(t2n(grads[False][name]) - r).max()
        assert err <= GRAD_TOL * max(np.abs(r).max(), floor), (
            f"{name}: max |diff| {err} vs max |ref| {np.abs(r).max()}")
        torch.testing.assert_close(grads[True][name], grads[False][name],
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ update half


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(arrays["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(arrays["b"].copy()))


def _state(arrays, rates=(0.9,), lg=None):
    model = _Params(arrays)
    params = list(model.parameters())
    return tl.TrainState(
        step=0, model=model,
        optimizer=tl.make_optimizer(params, 1e-3, 0.05),
        ema_params=[[p.detach().clone() for p in params] for _ in rates],
        lg_loss_scale=lg)


def _set_grads(state, grads):
    for p, g in zip(state.model.parameters(), (grads["w"], grads["b"])):
        p.grad = torch.from_numpy(g.copy())


def test_adamw_and_ema_match_optax(rng):
    """Three updates with the linear anneal and weight decay: params,
    moments and EMA against optax.adamw and e * rate + p * (1 - rate)."""
    arrays = {"w": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal((3,), dtype=np.float32)}
    lr, wd, anneal, rate = 1e-3, 0.05, 4, 0.9
    opt = jax_make_optimizer(lr, wd, anneal)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstate = opt.init(jparams)
    jema = dict(jparams)
    state = _state(arrays, rates=(rate,))
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32)
                 for k, v in arrays.items()}
        updates, jstate = opt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = {k: jema[k] * rate + jparams[k] * (1.0 - rate) for k in jema}
        _set_grads(state, grads)
        terms = {"loss": torch.ones(1)}
        m = tl.apply_update(state, torch.zeros(1, dtype=torch.long), terms,
                            torch.ones(1), lr, anneal, (rate,))
        assert m["skipped_nonfinite"] == 0.0
        for i, k in enumerate(("w", "b")):
            p = list(state.model.parameters())[i]
            np.testing.assert_allclose(t2n(p), np.asarray(jparams[k]), rtol=1e-6)
            np.testing.assert_allclose(t2n(state.ema_params[0][i]),
                                       np.asarray(jema[k]), rtol=1e-6)
            st = state.optimizer.state[p]
            adam = jstate[0]
            # the moments are summed in another order (torch lerps, optax
            # adds b * m + (1 - b) * g): a few ulps of the largest entry
            np.testing.assert_allclose(t2n(st["exp_avg"]), np.asarray(adam.mu[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(t2n(st["exp_avg_sq"]),
                                       np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-7)
    assert tl.applied_updates(state.optimizer) == 3 and state.step == 3


def test_nonfinite_skip_and_fp16_scaling(rng):
    """A non-finite gradient leaves params, optimizer state and EMA as they
    were and backs the loss scale off by 1; a finite one grows it by the
    growth rate and updates as an unscaled step would."""
    arrays = {"w": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal((3,), dtype=np.float32)}
    grads = {k: rng.standard_normal(v.shape, dtype=np.float32)
             for k, v in arrays.items()}
    lg = 20.0
    scaled = _state(arrays, lg=lg)
    plain = _state(arrays)
    _set_grads(scaled, {k: v * 2.0 ** lg for k, v in grads.items()})
    _set_grads(plain, grads)
    one = (torch.zeros(1, dtype=torch.long), {"loss": torch.ones(1)},
           torch.ones(1), 1e-3, 0, (0.9,))
    tl.apply_update(scaled, *one, fp16_scale_growth=1e-3)
    tl.apply_update(plain, *one)
    assert scaled.lg_loss_scale == pytest.approx(lg + 1e-3)
    for a, b in zip(scaled.model.parameters(), plain.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    before = [p.detach().clone() for p in scaled.model.parameters()]
    ema_before = [e.clone() for e in scaled.ema_params[0]]
    opt_before = {k: v.clone() for k, v in
                  scaled.optimizer.state[next(scaled.model.parameters())].items()}
    bad = {k: v.copy() for k, v in grads.items()}
    bad["w"][0, 0] = np.inf
    _set_grads(scaled, bad)
    m = tl.apply_update(scaled, *one, fp16_scale_growth=1e-3)
    assert m["skipped_nonfinite"] == 1.0
    assert scaled.lg_loss_scale == pytest.approx(lg + 1e-3 - 1.0)
    for p, q in zip(scaled.model.parameters(), before):
        assert torch.equal(p, q)
    for e, q in zip(scaled.ema_params[0], ema_before):
        assert torch.equal(e, q)
    after = scaled.optimizer.state[next(scaled.model.parameters())]
    for k, v in opt_before.items():
        assert torch.equal(after[k], v)
    assert scaled.step == 2


def test_microbatch_gradients_equal_full_batch(rng):
    """B = 4 in one piece against 2 microbatches of 2: the same averaged
    gradients and per-example terms."""
    ts, tcfg = tfactory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    model = SuperResModel(in_channels=1, **TINY)
    x0, low, noise = _batch(rng, (4, 2, 8, 8, 1))
    args = (model, ts, tcfg, torch.from_numpy(x0),
            {"low_res": torch.from_numpy(low)}, torch.tensor([1, 400, 2, 999]),
            torch.tensor([1.0, 0.5, 2.0, 1.0]))
    full = tl.compute_grads(*args, microbatch=0, noise=torch.from_numpy(noise))
    g_full = {n: p.grad.clone() for n, p in model.named_parameters()}
    micro = tl.compute_grads(*args, microbatch=2, noise=torch.from_numpy(noise))
    for k in full:
        torch.testing.assert_close(micro[k], full[k], rtol=1e-6, atol=1e-7)
    for n, p in model.named_parameters():
        scale = g_full[n].abs().max().item()
        assert (p.grad - g_full[n]).abs().max().item() <= 1e-5 * max(scale, 1e-12), n


def test_loss_second_moment_matches_jax():
    """The same (t, loss) sequence, duplicates within a batch included: the
    history, counts and (after warm-up) the sampling weights match."""
    T, H = 4, 2
    jstate = jres.init_loss_second_moment(T, H)
    tstate = tres.init_loss_second_moment(T, H)
    seq = [([0, 0, 1], [1.0, 2.0, 3.0]), ([2, 3, 0], [0.5, 4.0, 6.0]),
           ([1, 2, 3], [7.0, 8.0, 9.0]), ([3, 3, 3], [1.5, 2.5, 3.5])]
    for ts_, ls in seq:
        jstate = jres.update_loss_second_moment(
            jstate, jnp.asarray(ts_), jnp.asarray(ls, jnp.float32))
        tstate = tres.update_loss_second_moment(
            tstate, torch.tensor(ts_), torch.tensor(ls))
        np.testing.assert_array_equal(t2n(tstate.loss_history),
                                      np.asarray(jstate.loss_history))
        np.testing.assert_array_equal(t2n(tstate.loss_counts),
                                      np.asarray(jstate.loss_counts))
    np.testing.assert_allclose(t2n(tres.lsm_weights(tstate)),
                               np.asarray(jres._lsm_weights(jstate, 0.001)),
                               rtol=1e-6)
    t, w = tres.sample_loss_second_moment(
        tstate, 64, torch.Generator().manual_seed(0))
    p = tres.lsm_weights(tstate)
    torch.testing.assert_close(w, 1.0 / (T * p[t]))


# ------------------------------------------------------------ data


@pytest.mark.parametrize("dim,ps", [(200, 96), (130, 96), (96, 96), (40, 32),
                                    (1000, 96)])
def test_train_grid_matches_jax(dim, ps):
    assert tpatches.train_xy_starts(dim, ps) == jpatches.train_xy_starts(dim, ps)
    assert tpatches.train_z_starts(dim, ps) == jpatches.train_z_starts(dim, ps)


@pytest.fixture
def volumes(tmp_path, rng):
    d = tmp_path / "data"
    (d / "sub").mkdir(parents=True)
    ttiff.imwrite(str(d / "a.tif"),
                  rng.gamma(2.0, 0.5, (2, 36, 44, 40)).astype(np.float32))
    np.save(str(d / "sub" / "b.npy"),
            rng.gamma(2.0, 0.5, (32, 40, 33)).astype(np.float32))
    return str(d)


@pytest.mark.parametrize("random_crop", [False, True])
def test_patch_dataset_and_load_data_match_jax(volumes, random_crop):
    paths = tdata.list_image_files_recursively(volumes)
    assert paths == jdata.list_image_files_recursively(volumes)
    tds = tdata.PatchDataset(32, paths, random_crop=random_crop, seed=3)
    jds = jdata.PatchDataset(32, paths, random_crop=random_crop, seed=3)
    assert tds.patch_info == jds.patch_info and len(tds) >= len(paths)
    for i in range(len(tds)):
        (th, tc), (jh, jc) = tds[i], jds[i]
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tc["low_res"], jc["low_res"])
    kw = dict(data_dir=volumes, batch_size=2, image_size=32, seed=7,
              random_crop=random_crop)
    tgen, jgen = tdata.load_data(**kw), jdata.load_data(**kw)
    for _ in range(5):
        (th, tc), (jh, jc) = next(tgen), next(jgen)
        assert th.shape == (2, 32, 32, 32, 1)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tc["low_res"], jc["low_res"])
    first = next(tdata.prefetch(tdata.load_data(**kw)))
    np.testing.assert_array_equal(first[0], next(jdata.load_data(**kw))[0])


# ------------------------------------------------------------ checkpoints


def test_checkpoint_helpers_match_jax(tmp_path):
    names = ["model000100.pt", "model002000.pt", "ema_0.9999_002000.pt",
             "opt002000.pt", "ema_0.99_000100.pt", "notes.txt"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    d = str(tmp_path)
    for f in names + ["/x/y/model.pt", "/x/savedmodel12.pt", "model12x.pt"]:
        assert (tckpt.parse_resume_step_from_filename(f)
                == jckpt.parse_resume_step_from_filename(f)), f
    main = osp.join(d, "model002000.pt")
    for step, rate in [(2000, 0.9999), (100, 0.99), (100, 0.9999)]:
        assert (tckpt.find_ema_checkpoint(main, step, rate)
                == jckpt.find_ema_checkpoint(main, step, rate))
    for step in (2000, 100):
        assert (tckpt.find_opt_checkpoint(main, step)
                == jckpt.find_opt_checkpoint(main, step))
    assert tckpt.latest_checkpoint(d) == jckpt.latest_checkpoint(d) == main
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def _loop(model, data, **kw):
    sched, cfg = tfactory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    args = dict(model=model, sched=sched, cfg=cfg, data=data, batch_size=1,
                microbatch=-1, lr=1e-3, ema_rate="0.9,0.99", log_interval=100,
                save_interval=100, weight_decay=0.01, seed=1, device="cpu")
    args.update(kw)
    return tl.TrainLoop(**args)


def _tiny_data(rng):
    x0, low, _ = _batch(rng, (1, 2, 8, 8, 1))
    while True:
        yield x0, {"low_res": low}


def test_resume_restores_state_exactly(tmp_path, rng):
    tlogger.configure(str(tmp_path), format_strs=[])
    data = _tiny_data(rng)
    loop = _loop(SuperResModel(in_channels=1, **TINY), data)
    for _ in range(2):
        loop.run_step(*next(data))
    loop.step = 2
    paths = loop.save()
    assert [osp.basename(p) for p in paths] == [
        "model000002.pt", "ema_0.9_000002.pt", "ema_0.99_000002.pt",
        "opt000002.pt"]
    resumed = _loop(SuperResModel(in_channels=1, **TINY), data,
                    resume_checkpoint=paths[0])
    assert resumed.resume_step == 2
    for a, b in zip(loop.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    for ea, eb in zip(loop.state.ema_params, resumed.state.ema_params):
        for a, b in zip(ea, eb):
            assert torch.equal(a, b)
    sa, sb = loop.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["state"][k][name]), (k, name)
    # the next step is the same from either
    batch = next(data)
    t, w = torch.tensor([17]), torch.ones(1)
    noise = torch.from_numpy(rng.standard_normal(batch[0].shape, dtype=np.float32))
    loop.run_step(*batch, t=t, weights=w, noise=noise)
    resumed.run_step(*batch, t=t, weights=w, noise=noise)
    for a, b in zip(loop.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_port_checkpoint_serves_in_jax(tmp_path, rng):
    """A model checkpoint written by the port's trainer, read by the JAX
    package's torch importer: the same forward within 1e-4."""
    tlogger.configure(str(tmp_path), format_strs=[])
    data = _tiny_data(rng)
    loop = _loop(SuperResModel(in_channels=1, **TINY), data)
    loop.run_step(*next(data))
    path = loop.save()[0]
    params = load_torch_checkpoint(path)
    jm = JaxSuperRes(in_channels=1, **TINY)
    x = rng.standard_normal((1, 4, 16, 16, 1), dtype=np.float32)
    low = rng.standard_normal(x.shape, dtype=np.float32)
    t = np.array([321])
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                       jnp.asarray(t), low_res=jnp.asarray(low)))
    with torch.no_grad():
        got = loop.model.eval()(torch.from_numpy(x), torch.from_numpy(t),
                                low_res=torch.from_numpy(low))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(t2n(got), ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ logger


def test_logger_formats_match_jax(tmp_path):
    """The same kv sequence (means, a key that appears late, a long key)
    through both loggers: log.txt, progress.json and progress.csv agree
    byte for byte after the "Logging to" line."""
    saved = jlogger.Logger.CURRENT
    dirs = {}
    try:
        for name, lg in (("jax", jlogger), ("port", tlogger)):
            d = tmp_path / name
            lg.configure(str(d), format_strs=["log", "json", "csv"])
            lg.logkv_mean("loss", 1.5)
            lg.logkv_mean("loss", 2.0)
            lg.logkv("step", 0)
            lg.log("a line", 3)
            lg.dumpkvs()
            lg.logkvs({"step": 1, "loss": 0.25})
            lg.logkv("a_very_long_key_name_that_gets_cut_off", 1e-7)
            assert lg.getkvs()["loss"] == 0.25
            lg.dumpkvs()
            dirs[name] = d
    finally:
        jlogger.Logger.CURRENT = saved
    for fname in ("log.txt", "progress.json", "progress.csv"):
        j = (dirs["jax"] / fname).read_text().splitlines()
        t = (dirs["port"] / fname).read_text().splitlines()
        if fname == "log.txt":
            assert j[0].startswith("Logging to") and t[0].startswith("Logging to")
            j, t = j[1:], t[1:]
        assert t == j, fname


# ------------------------------------------------------------ CLI


def test_train_cli_runs_on_cpu(tmp_path, rng, capsys):
    """Three steps of the CLI on a synthetic volume pair, then the
    reference's three files at step 3 and the loss key-value lines."""
    data = tmp_path / "data"
    data.mkdir()
    ttiff.imwrite(str(data / "v.tif"),
                  rng.gamma(2.0, 0.5, (2, 32, 40, 40)).astype(np.float32))
    out = tmp_path / "run"
    train_cli.main([
        "--data_dir", str(data), "--large_size", "32", "--num_channels", "32",
        "--num_res_blocks", "1", "--learn_sigma", "True",
        "--use_scale_shift_norm", "True", "--resblock_updown", "True",
        "--attention_resolutions", "1000", "--diffusion_steps", "1000",
        "--noise_schedule", "linear", "--lr_anneal_steps", "3",
        "--use_fp16", "False",
        "--log_interval", "1", "--device", "cpu",
        "--result_folder", str(out),
    ])
    files = set(os.listdir(out))
    for name in ("model000003.pt", "ema_0.9999_000003.pt", "opt000003.pt"):
        assert name in files
    sd = torch.load(str(out / "model000003.pt"), weights_only=True)
    model = tfactory.sr_create_model(
        large_size=32, small_size=64, num_channels=32, num_res_blocks=1,
        learn_sigma=True, class_cond=False, use_checkpoint=False,
        attention_resolutions="1000", num_heads=4, num_head_channels=-1,
        num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
        resblock_updown=True, use_fp16=False)
    model.load_state_dict(sd, strict=True)
    text = capsys.readouterr().out
    for key in ("| loss ", "| mse ", "| vb ", "| grad_norm", "| step "):
        assert key in text, key
    assert "saving model at step 3" in text
