"""The port's fused serving path (ops/conv3d_fused.py, the fused ResBlock
branch, the CLI's DDPM3D_FUSED) against the JAX package's fused path.

On the CPU the fused wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (``conv3d_fused(...,
interpret=True)``, ``DDPM3D_FUSED=interpret``), as tests/test_conv3d_fused.py
runs it. Inputs are numpy-seeded and f32. The kernel itself is held against
the plain version on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import nn as jnn
from ddpm3d_tpu.ops.conv3d_fused import conv3d_fused as jax_conv3d_fused
from ddpm3d_tpu_torch.data import tiff_io as ttiff
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.models import nn as tnn
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import conv3d_fused as fused_ops
from ddpm3d_tpu_torch.scripts import test as cli
from ddpm3d_tpu_torch.utils.config import (
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

# f32 conv sums over 27*128 terms in another order than the interpreted
# Pallas kernel's; the stats sum 256 such outputs
CONV_RTOL, CONV_ATOL = 1e-4, 1e-4
STATS_RTOL = 1e-4
# the JAX package's own fused-vs-unfused model tolerance
# (tests/test_conv3d_fused.py:test_unet_fused_two_levels)
MODEL_RTOL, MODEL_ATOL = 1e-3, 5e-4


def _conv_data(B, seed, Cin=128, Cout=128, shape=(4, 4, 16)):
    """tests/test_conv3d_fused.py:_data, weight also in torch layout."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B,) + shape + (Cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Cin, Cout)) * 0.05).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    g = (rng.normal(size=(B, Cin)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(B, Cin)) * 0.2).astype(np.float32)
    skip = rng.normal(size=(B,) + shape + (Cout,)).astype(np.float32)
    w_torch = np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))
    return x, w, b, w_torch, g, beta, skip


@pytest.mark.parametrize("case,B,prologue,silu,use_skip", [
    ("plain_conv", 1, False, True, False),
    ("prologue_silu", 1, True, True, False),
    ("prologue_no_silu", 1, True, False, False),
    ("skip_and_stats", 1, False, True, True),
    ("batch2_per_sample_prologue", 2, True, True, True),
])
def test_conv3d_fused_plain_matches_jax(case, B, prologue, silu, use_skip):
    """The plain version against the interpreted Pallas kernel at
    (B, 4, 4, 16, 128) -> 128: output and stats, every flag it takes."""
    x, w, b, w_torch, g, beta, skip = _conv_data(B, seed=len(case))
    kw = dict(prologue_silu=silu, want_stats=True)
    jkw, tkw = dict(kw), dict(kw)
    if prologue:
        jkw.update(prologue_g=jnp.asarray(g), prologue_b=jnp.asarray(beta))
        tkw.update(prologue_g=torch.from_numpy(g),
                   prologue_b=torch.from_numpy(beta))
    if use_skip:
        jkw["skip"] = jnp.asarray(skip)
        tkw["skip"] = torch.from_numpy(skip)
    ref, ref_stats = jax_conv3d_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True, **jkw)
    out, stats = fused_ops.conv3d_fused(
        torch.from_numpy(x), torch.from_numpy(w_torch), torch.from_numpy(b),
        **tkw)
    assert out.shape == ref.shape and stats.shape == (B, 2, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=CONV_RTOL, atol=CONV_ATOL)
    # a sum's rounding error scales with the sum of its terms' magnitudes:
    # sum |y| for the first (it may cancel to near 0), sum y^2 itself for
    # the second
    scale = np.stack([np.abs(np.asarray(ref)).sum((1, 2, 3)),
                      np.asarray(ref_stats)[:, 1]], axis=1)
    err = np.abs(stats.numpy() - np.asarray(ref_stats))
    assert (err <= STATS_RTOL * scale).all(), (err / scale).max()
    # without stats the same call returns the output alone
    alone = fused_ops.conv3d_fused(
        torch.from_numpy(x), torch.from_numpy(w_torch), torch.from_numpy(b),
        **dict(tkw, want_stats=False))
    torch.testing.assert_close(alone, out, rtol=0, atol=0)


@pytest.mark.parametrize("given_stats", [False, True])
def test_groupnorm_fold_only_matches_jax(rng, given_stats):
    """GroupNorm32(fold_only=True) -> the [B, C] affine (g, b) with FiLM,
    from given per-channel sums or from x's own."""
    B, C = 2, 64
    x = rng.standard_normal((B, 3, 4, 5, C), dtype=np.float32) * 2 + 0.5
    scale = 1 + 0.1 * rng.standard_normal(C, dtype=np.float32)
    bias = 0.1 * rng.standard_normal(C, dtype=np.float32)
    fs = 0.1 * rng.standard_normal((B, C), dtype=np.float32)
    fh = 0.1 * rng.standard_normal((B, C), dtype=np.float32)
    stats = None
    if given_stats:  # sums of another tensor: the fold must use these
        other = rng.standard_normal(x.shape, dtype=np.float32)
        stats = np.stack([other.sum((1, 2, 3)), (other ** 2).sum((1, 2, 3))], 1)
    jm = jnn.GroupNorm32()
    jx = jnp.asarray(x)
    ref = jm.apply({"params": {"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)}}, jx,
                   film_scale=jnp.asarray(fs), film_shift=jnp.asarray(fh),
                   stats=None if stats is None else jnp.asarray(stats),
                   fold_only=True)
    tm = tnn.GroupNorm32(C)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale))
        tm.bias.copy_(torch.from_numpy(bias))
        got = tm(torch.from_numpy(x), film_scale=torch.from_numpy(fs),
                 film_shift=torch.from_numpy(fh),
                 stats=None if stats is None else torch.from_numpy(stats),
                 fold_only=True)
    for a, r in zip(got, ref):
        assert a.shape == (B, C) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


TWO_LEVELS = dict(  # tests/test_conv3d_fused.py:test_unet_fused_two_levels
    model_channels=128, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 1), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)


@pytest.fixture(scope="module")
def two_levels():
    """The JAX model and its params, every one replaced by seeded noise
    (the zero-init output convs would make the residual branches vacuous),
    and the inputs."""
    jm = JaxSuperRes(in_channels=1, dtype=jnp.float32, **TWO_LEVELS)
    rng = np.random.default_rng(12)
    # W = 16, 8 at the two levels: the JAX package fuses both
    x = rng.normal(size=(1, 2, 8, 16, 1)).astype(np.float32)
    low = rng.normal(size=(1, 2, 8, 16, 1)).astype(np.float32)
    params = jax.jit(lambda v: jm.init(
        jax.random.key(0), v, jnp.zeros((1,), jnp.int32), low_res=v))(
            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (1.0 if path[-1].key == "scale" else 0.0)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32), params)
    return jm, params, x, low, np.array([5], np.int32)


def _port(params, fused):
    model = SuperResModel(in_channels=1, fused=fused, **TWO_LEVELS)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _port_forward(model, x, low, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t),
                     low_res=torch.from_numpy(low)).numpy()


def test_fused_model_matches_jax_fused(monkeypatch, two_levels):
    """The port's fused SuperResModel against the JAX package's
    DDPM3D_FUSED=interpret forward, same weights (utils/convert.py): stats
    thread through same-level blocks, drop at up/down, concatenate with the
    skip's in the decoder."""
    jm, params, x, low, t = two_levels
    monkeypatch.setenv("DDPM3D_FUSED", "interpret")
    # not jitted, as tests/test_conv3d_fused.py runs it: each interpreted
    # kernel call costs ~1 s on the CPU, a jit of the whole model more
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(t), low_res=jnp.asarray(low)))
    calls = []
    plain = fused_ops.conv3d_fused_plain
    monkeypatch.setattr(fused_ops, "conv3d_fused_plain",
                        lambda *a, **k: calls.append(k) or plain(*a, **k))
    got = _port_forward(_port(params, fused=True), x, low, t)
    # 8 fused ResBlocks (encoder 2, middle 2, decoder 4), two convs each
    assert len(calls) == 2 * 8
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_fused_model_matches_unfused_and_shares_state_dict(two_levels):
    """One state dict loads into both paths with strict=True (parameter
    names and shapes do not change); the fused forward equals the unfused
    one. Training mode, remat and train-time calls take the unfused path."""
    _, params, x, low, t = two_levels
    fused, unfused = _port(params, True), _port(params, False)
    assert fused.state_dict().keys() == unfused.state_dict().keys()
    unfused.load_state_dict(fused.state_dict(), strict=True)
    ref = _port_forward(unfused, x, low, t)
    np.testing.assert_allclose(_port_forward(fused, x, low, t), ref,
                               rtol=1e-4, atol=1e-5)
    blocks = [m for m in fused.modules() if hasattr(m, "fusable")]
    assert sum(m.fusable() for m in blocks) == 8  # not the 2 up/down blocks
    fused.train()
    assert not any(m.fusable() for m in blocks)
    remat = SuperResModel(in_channels=1, fused=True, use_checkpoint=True,
                          **TWO_LEVELS)
    assert not remat.fused


def test_fused_wrapper_raises_under_autograd(two_levels):
    """No backward: a call that autograd would record raises instead of
    switching paths; under no_grad the same call runs."""
    x, w, b, w_torch, g, beta, _ = _conv_data(1, seed=3, Cin=32, Cout=32,
                                              shape=(2, 3, 4))
    w_param = torch.nn.Parameter(torch.from_numpy(w_torch))
    args = (torch.from_numpy(x), w_param, torch.from_numpy(b))
    kw = dict(prologue_g=torch.from_numpy(g), prologue_b=torch.from_numpy(beta))
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_ops.conv3d_fused(*args, **kw)
    with torch.no_grad():
        assert fused_ops.conv3d_fused(*args, **kw).shape == (1, 2, 3, 4, 32)
    _, params, xm, low, t = two_levels
    with pytest.raises(RuntimeError, match="inference-only"):
        _port(params, True)(torch.from_numpy(xm), torch.from_numpy(t),
                            low_res=torch.from_numpy(low))
    with pytest.raises(ValueError, match="together"):
        fused_ops.conv3d_fused(*args[:1], w_param.detach(),
                               prologue_g=kw["prologue_g"])


CLI_FLAGS = [  # tests/test_torch_port_pipeline.py:CLI_FLAGS
    "--large_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--learn_sigma", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--diffusion_steps", "1000", "--timestep_respacing", "2",
    "--device", "cpu",
]


def test_cli_serves_fused_under_env(tmp_path, monkeypatch):
    """DDPM3D_FUSED=1 makes the CLI build the fused model (logged) and
    serve through the fused convs; the volume equals the unfused run's."""
    args = cli.create_argparser().parse_args(CLI_FLAGS)
    model, _, _ = tfactory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()),
        fused=True)
    init_params(model, seed=2, zero_heads=False)
    n_fused = sum(m.fusable() for m in model.eval().modules()
                  if hasattr(m, "fusable"))
    ckpt = str(tmp_path / "model000010.pt")
    torch.save(model.state_dict(), ckpt)
    vol = np.random.default_rng(4).gamma(2.0, 0.5, (90, 200, 200))
    vol_path = str(tmp_path / "vol.tif")
    ttiff.imwrite(vol_path, vol.astype(np.float32))
    calls = []
    plain = fused_ops.conv3d_fused_plain
    monkeypatch.setattr(fused_ops, "conv3d_fused_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    results = {}
    for env in ("0", "1"):
        monkeypatch.setenv("DDPM3D_FUSED", env)
        out_dir = str(tmp_path / f"out{env}")
        cli.main(CLI_FLAGS + ["--base_samples", vol_path, "--model_path", ckpt,
                              "--save_dir", out_dir, "--batch_size", "18"])
        results[env] = np.load(osp.join(out_dir, "denoised_vol.npz"))["arr_0"]
        with open(osp.join(out_dir, "log.txt")) as f:
            log = f.read()
        assert ("serving path: fused" in log) == (env == "1")
        # 18 patches in one batch, 2 steps: two forwards, two convs a block
        assert len(calls) == (0 if env == "0" else 2 * 2 * n_fused)
    assert np.isfinite(results["1"]).all() and np.abs(results["1"]).max() > 0
    # the chain's x0 recovery amplifies f32 rounding (see
    # test_torch_port_pipeline.py:test_denoise_volume_matches_jax)
    np.testing.assert_allclose(results["1"], results["0"], rtol=1e-3,
                               atol=5e-3)
