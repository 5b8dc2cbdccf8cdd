"""The port's DPM-Solver++(2M) sampler and explicit kept-timestep chains
against the JAX package (CPU, f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import diffusion as jd
from ddpm3d_tpu.training.distill import halve_timesteps
from ddpm3d_tpu_torch import diffusion as td
from ddpm3d_tpu_torch.diffusion import (
    ddim_sample_loop,
    dpm_solver_pp_sample_loop,
    process as tprocess,
)

SHAPE = (2, 4, 6, 6, 1)
T = 1000
# max |port - JAX| / max |JAX|, f32 on both sides: the same updates round
# differently by a few ulp (XLA:CPU contracts multiply-adds); unclipped, the
# x0 recovery at t ~ 999 scales the sample to ~160, so the bound is relative
DPM_TOL = 1e-5


def _cfgs():
    """(port, JAX) configs: eps prediction, learned-range variance."""
    return tuple(
        m.DiffusionConfig(m.MeanType.EPSILON, m.VarType.LEARNED_RANGE,
                          m.LossType.MSE, original_num_steps=T)
        for m in (td, jd))


def _scheds(respace):
    ts = sorted(jd.space_timesteps(T, respace))
    return tuple(m.make_spaced_schedule(m.get_named_beta_schedule("linear", T),
                                        ts) for m in (td, jd))


def _toy_torch(x, t, **kw):
    tf = t.float().reshape((-1,) + (1,) * (x.dim() - 1))
    eps = torch.tanh(x) * torch.cos(tf / 37.0) + 0.1 * torch.sin(tf / 11.0)
    return torch.cat([eps, 0.3 * torch.ones_like(x)], dim=-1)


def _toy_jax(x, t, **kw):
    tf = t.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    eps = jnp.tanh(x) * jnp.cos(tf / 37.0) + 0.1 * jnp.sin(tf / 11.0)
    return jnp.concatenate([eps, 0.3 * jnp.ones_like(x)], axis=-1)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("clip", [True, False])
def test_dpm_solver_matches_jax(order, clip):
    """The same toy model and x_T through both samplers over a spaced
    chain: the samples agree to DPM_TOL."""
    ts, js = _scheds("ddim10")
    tcfg, jcfg = _cfgs()
    x_t = np.random.default_rng(order).standard_normal(SHAPE, np.float32)
    ref = np.asarray(jd.dpm_solver_pp_sample_loop(
        jax.random.key(0), _toy_jax, js, jcfg, noise=jnp.asarray(x_t),
        clip_denoised=clip, order=order))
    got = dpm_solver_pp_sample_loop(
        _toy_torch, ts, tcfg, torch.from_numpy(x_t), clip_denoised=clip,
        order=order, device="cpu").numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=DPM_TOL * scale)


def test_dpm_order1_is_ddim():
    """Order 1 is the eta = 0 DDIM update in x0 form: the port's two
    samplers agree on the same x_T (f32 rounding of two algebraically
    equal updates)."""
    ts, _ = _scheds("ddim20")
    tcfg, _ = _cfgs()
    x_t = torch.from_numpy(
        np.random.default_rng(3).standard_normal(SHAPE, np.float32))
    a = dpm_solver_pp_sample_loop(_toy_torch, ts, tcfg, x_t, order=1,
                                  device="cpu")
    b = ddim_sample_loop(_toy_torch, ts, tcfg, eta=0.0, noise=x_t,
                         device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=DPM_TOL * b.abs().max().item())


def test_dpm_solver_checks_order_and_calls_the_model_k_times():
    ts, _ = _scheds("ddim10")
    tcfg, _ = _cfgs()
    calls = []

    def model(x, t, **kw):
        calls.append(int(t[0]))
        return _toy_torch(x, t)

    dpm_solver_pp_sample_loop(model, ts, tcfg, torch.zeros(SHAPE),
                              device="cpu")
    # the model sees the original chain's timesteps, from the top down
    assert calls == sorted(jd.space_timesteps(T, "ddim10"), reverse=True)
    with pytest.raises(ValueError, match="orders 1"):
        dpm_solver_pp_sample_loop(model, ts, tcfg, torch.zeros(SHAPE),
                                  order=3, device="cpu")


@pytest.mark.parametrize("teacher", ["8", "ddim10", "50"])
def test_explicit_chain_from_halved_file_matches_jax(tmp_path, teacher):
    """A kept-timestep file as the JAX distillation writes it (the odd
    positions of the teacher's chain, ``halve_timesteps``), read back as
    the serving CLIs read it: the port's spaced schedule equals the JAX
    package's, table by table."""
    path = str(tmp_path / "distilled_ts.npy")
    np.save(path,
            np.asarray(halve_timesteps(jd.space_timesteps(T, teacher))))
    use_ts = sorted(int(t) for t in np.load(path))
    got, ref = (m.make_spaced_schedule(m.get_named_beta_schedule("linear", T),
                                       use_ts) for m in (td, jd))
    assert got.num_timesteps == len(use_ts) == ref.num_timesteps
    for name in ref._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)
    # the model is fed the kept timesteps themselves
    tcfg, jcfg = _cfgs()
    assert tprocess.model_timesteps(
        got, tcfg, torch.arange(len(use_ts))).tolist() == use_ts
    np.testing.assert_array_equal(np.asarray(jd.model_timesteps(
        ref, jcfg, jnp.arange(len(use_ts)))), use_ts)
