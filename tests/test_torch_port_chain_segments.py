"""The port's truncated and recorded chains (``t_hi`` / ``t_lo`` /
``return_intermediates``, ``p_sample_loop_progressive``) against the JAX
package's samplers on a toy model with explicit noise (CPU, f32), and the
synthetic data of the quality tools (``make_pair``, ``make_volume``)
against the JAX tools' on the same numpy generator."""

import os.path as osp
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import diffusion as jd
from ddpm3d_tpu_torch import diffusion as td
from ddpm3d_tpu_torch.diffusion import sampling as tsamp
from ddpm3d_tpu_torch.tools import e2e_learning_check, make_synthetic_data

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
SHAPE = (2, 4, 6, 6, 1)
T = 1000
N = 10  # the respaced chain's steps
# max |port - JAX| / max |JAX| at every step, f32 on both sides: the same
# updates round differently by a few ulp (tests/test_torch_port_dpm.py)
CHAIN_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _toy_torch(x, t, **kw):
    tf = t.float().reshape((-1,) + (1,) * (x.dim() - 1))
    eps = torch.tanh(x) * torch.cos(tf / 37.0) + 0.1 * torch.sin(tf / 11.0)
    return torch.cat([eps, 0.3 * torch.ones_like(x)], dim=-1)


def _toy_jax(x, t, **kw):
    tf = t.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    eps = jnp.tanh(x) * jnp.cos(tf / 37.0) + 0.1 * jnp.sin(tf / 11.0)
    return jnp.concatenate([eps, 0.3 * jnp.ones_like(x)], axis=-1)


def _setup():
    """(port, JAX) schedules over a 10-step respacing and configs (eps,
    learned range), x_T and a stream of N step noises."""
    ts = sorted(jd.space_timesteps(T, str(N)))
    betas = jd.get_named_beta_schedule("linear", T)
    scheds = tuple(m.make_spaced_schedule(betas, ts) for m in (td, jd))
    cfgs = tuple(m.DiffusionConfig(m.MeanType.EPSILON, m.VarType.LEARNED_RANGE,
                                   m.LossType.MSE, original_num_steps=T)
                 for m in (td, jd))
    rng = np.random.default_rng(16)
    x_t = rng.standard_normal(SHAPE, np.float32)
    stream = rng.standard_normal((N,) + SHAPE, np.float32)
    return scheds, cfgs, x_t, stream


def _close(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHAIN_TOL * scale)


@pytest.mark.parametrize("use_ddim", [False, True], ids=["ddpm", "ddim"])
@pytest.mark.parametrize("t_hi,t_lo", [(None, 0), (7, 3), (N, 6), (4, 0)])
def test_segment_matches_jax(use_ddim, t_hi, t_lo):
    """A segment t_hi-1 .. t_lo from x_{t_hi} with its t_hi - t_lo stream
    entries, every step recorded: the final sample and the intermediates
    equal JAX's (``_scan_loop``) within CHAIN_TOL."""
    (ts, js), (tcfg, jcfg), x_t, stream = _setup()
    hi = N if t_hi is None else t_hi
    seg = stream[N - hi:N - t_lo]
    jloop = jd.ddim_sample_loop if use_ddim else jd.p_sample_loop
    ref, ref_ys = jloop(jax.random.key(0), _toy_jax, js, jcfg,
                        noise=jnp.asarray(x_t), noise_stream=jnp.asarray(seg),
                        t_hi=t_hi, t_lo=t_lo, return_intermediates=True)
    tloop = td.ddim_sample_loop if use_ddim else td.p_sample_loop
    got, got_ys = tloop(_toy_torch, ts, tcfg, noise=torch.from_numpy(x_t),
                        noise_stream=torch.from_numpy(seg), t_hi=t_hi,
                        t_lo=t_lo, return_intermediates=True, device="cpu")
    assert got_ys.shape == (hi - t_lo,) + SHAPE == ref_ys.shape
    _close(got.numpy(), np.asarray(ref))
    for i in range(hi - t_lo):
        _close(got_ys[i].numpy(), np.asarray(ref_ys[i]))
    np.testing.assert_array_equal(got.numpy(), got_ys[-1].numpy())


@pytest.mark.parametrize("use_ddim", [False, True], ids=["ddpm", "ddim"])
@pytest.mark.parametrize("explicit", [False, True], ids=["drawn", "stream"])
def test_two_segments_compose_bit_for_bit(use_ddim, explicit):
    """The chain in two segments (N .. 6, 6 .. 0) equals the whole chain
    bit for bit: with drawn noise (``step_noise`` keyed on (seed, id, t))
    and with the stream split at the same step; ``before_step`` and
    ``step_cb`` see the same t's in the same order."""
    (ts, _), (tcfg, _), x_t, stream = _setup()
    kw = dict(use_ddim=use_ddim, eta=0.5, seed=3, sample_ids=[4, 9],
              device="cpu")
    seen_whole, seen_parts = [], []

    def run(lo, hi, seen, noise):
        s = torch.from_numpy(stream[N - hi:N - lo]) if explicit else None
        return td.p_sample_loop(
            _toy_torch, ts, tcfg, noise=noise, noise_stream=s, t_hi=hi,
            t_lo=lo, before_step=lambda t: seen.append(("before", t)),
            step_cb=lambda t, img: seen.append(("after", t)), **kw)

    x = torch.from_numpy(x_t)
    whole = run(0, N, seen_whole, x)
    mid = run(6, N, seen_parts, x)
    both = run(0, 6, seen_parts, mid)
    assert torch.equal(whole, both)
    assert seen_whole == seen_parts
    assert [t for what, t in seen_whole if what == "before"] == list(
        range(N - 1, -1, -1))
    if not explicit:  # the default t_hi / t_lo are the whole chain
        assert torch.equal(whole, td.p_sample_loop(
            _toy_torch, ts, tcfg, noise=x, **kw))


def test_segment_errors():
    """A stream of another length than the segment raises (JAX's scan
    raises on the mismatch too); a segment outside the chain raises; an
    empty segment returns x_{t_hi} and no intermediates."""
    (ts, js), (tcfg, jcfg), x_t, stream = _setup()
    x = torch.from_numpy(x_t)
    with pytest.raises(ValueError, match="segment has 4"):
        td.p_sample_loop(_toy_torch, ts, tcfg, noise=x, t_hi=7, t_lo=3,
                         noise_stream=torch.from_numpy(stream[:5]),
                         device="cpu")
    with pytest.raises(ValueError):
        jd.p_sample_loop(jax.random.key(0), _toy_jax, js, jcfg,
                         noise=jnp.asarray(x_t), t_hi=7, t_lo=3,
                         noise_stream=jnp.asarray(stream[:5]))
    with pytest.raises(ValueError, match="outside"):
        td.p_sample_loop(_toy_torch, ts, tcfg, noise=x, t_hi=N + 1,
                         device="cpu")
    out, ys = td.p_sample_loop(_toy_torch, ts, tcfg, noise=x, t_hi=5, t_lo=5,
                               return_intermediates=True, device="cpu")
    assert torch.equal(out, x) and ys.shape == (0,) + SHAPE


def test_progressive_matches_jax():
    """``p_sample_loop_progressive`` yields every step's sample and x0
    prediction, t = N-1 .. 0, equal to JAX's generator fed the same noise
    (its ``fold_in(key, t)`` draws replayed as the port's stream), and its
    last sample is p_sample_loop's on the same stream."""
    (ts, js), (tcfg, jcfg), x_t, _ = _setup()
    key = jax.random.key(5)
    stream = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, t), SHAPE, jnp.float32))
        for t in range(N - 1, -1, -1)])
    refs = list(jd.p_sample_loop_progressive(
        key, _toy_jax, js, jcfg, noise=jnp.asarray(x_t)))
    gots = list(td.p_sample_loop_progressive(
        _toy_torch, ts, tcfg, noise=torch.from_numpy(x_t),
        noise_stream=torch.from_numpy(stream), device="cpu"))
    assert len(gots) == len(refs) == N
    for got, ref in zip(gots, refs):
        assert set(got) == {"sample", "pred_xstart"}
        _close(got["sample"].numpy(), np.asarray(ref["sample"]))
        _close(got["pred_xstart"].numpy(), np.asarray(ref["pred_xstart"]))
    assert torch.equal(gots[-1]["sample"], td.p_sample_loop(
        _toy_torch, ts, tcfg, noise=torch.from_numpy(x_t),
        noise_stream=torch.from_numpy(stream), device="cpu"))
    assert tsamp.p_sample_loop_progressive is td.p_sample_loop_progressive


def _jax_tool(name):
    """A JAX tool's module namespace (run without its __main__)."""
    return runpy.run_path(osp.join(REPO, "tools", name), run_name="tool")


@pytest.mark.parametrize("shape", [(8, 10, 12), (16, 16, 16)])
def test_synthetic_data_matches_jax(shape):
    """``make_pair`` (the quality tools' volumes) and ``make_volume`` (the
    2-channel TIFF data) equal the JAX tools' arrays for one generator
    state, and leave the generator in the same state."""
    jpair = _jax_tool("e2e_learning_check.py")["make_pair"]
    jvol = _jax_tool("make_synthetic_data.py")["make_volume"]
    for fn, ref_fn in ((e2e_learning_check.make_pair, jpair),
                       (make_synthetic_data.make_volume, jvol)):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        got, ref = fn(r1, shape), ref_fn(r2, shape)
        for g, w in zip(got, ref):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        assert r1.integers(1 << 30) == r2.integers(1 << 30)
