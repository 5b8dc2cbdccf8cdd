"""The port's int8 calibration (the conv sites' calibration mode and the
tool ``ddpm3d_tpu_torch.tools.calibrate_int8``) and eps-scale calibration
against the JAX package, on numpy-seeded inputs (CPU: the plain paths).

The JAX side records with ``DDPM3D_INT8_CALIB=1`` (its sites sow into
``quant_calib``) and runs its own chain step (``p_sample`` /
``ddim_sample``) fed the same x_T and step noise; its eps-scale fit draws
eps from keys, which the test draws too and hands to the port."""

import functools
import json
import os.path as osp
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.diffusion import calibration as jcal
from ddpm3d_tpu.diffusion import process as jproc
from ddpm3d_tpu.diffusion import sampling as jsampling
from ddpm3d_tpu.diffusion import schedules as jsched
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.ops import quant as jquant
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch.diffusion import calibration as tcal
from ddpm3d_tpu_torch.diffusion import process as tproc
from ddpm3d_tpu_torch.diffusion import schedules as tsched
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.scripts import test as serve_cli
from ddpm3d_tpu_torch.tools import calibrate_int8 as tool

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
TINY = dict(model_channels=32, out_channels=2, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3,
            use_scale_shift_norm=True, middle_attention=False)
# a site's abs-max is recorded exactly (held bit-equal to max |x| of the
# site's hooked input); against JAX's it differs by the f32 forward's
# reordered sums up to that site, which grow with the depth (measured up to
# 1.2e-6 relative at the decoder's convs): held to the f32 forward's own
# tolerance (tests/test_torch_port_seg.py:F32_TOL)
AMAX_RTOL = 1e-5
# the tables of a 3-step chain: the chain's x feeds back, so the f32
# reorderings of each step compound over the steps
TABLE_RTOL = 1e-5
LAMBDA_TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _tiny(updown):
    """The port's tiny f32 SuperResModel with seeded params (heads too),
    the same params as a JAX tree, and inputs."""
    rng = np.random.default_rng(31)
    model = SuperResModel(in_channels=1, resblock_updown=updown, **TINY)
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    x = rng.standard_normal((1, 4, 16, 16, 1)).astype(np.float32)
    low = rng.standard_normal(x.shape).astype(np.float32)
    jm = JaxSuperRes(in_channels=1, resblock_updown=updown, **TINY)
    params = torch_state_dict_to_params(sd, wrap_superres=True)
    return model.eval(), jm, params, x, low


def _flat(tree, prefix=()):
    """A quant_calib collection -> {site: float} (tools/calibrate_int8.py's
    flatten_calib)."""
    out = {}
    for k, v in tree.items():
        if k == "act_absmax":
            out["/".join(prefix)] = float(np.asarray(v))
        else:
            out.update(_flat(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("updown", [True, False],
                         ids=["resblock_updown", "conv_resample"])
def test_calibration_mode_matches_jax_sown(updown, monkeypatch):
    """One forward in the calibration mode: every conv site's input abs-max
    (the excluded sites too; the up sites at low resolution, the
    Downsample conv included) against JAX's sown ``quant_calib``; the
    maximum is kept over calls; nothing is quantized (the forward is the
    plain one); the mode refuses int8 and fused models."""
    model, jm, params, x, low = _tiny(updown)
    t = np.array([417], np.int32)
    monkeypatch.setenv("DDPM3D_INT8_CALIB", "1")
    _, muts = jax.jit(lambda p: jm.apply(
        {"params": p}, x, t, low_res=low, mutable=["quant_calib"]))(params)
    ref = _flat(jax.device_get(muts["quant_calib"]))
    calib = quant.ActCalibration()
    model.set_calibration(calib)
    inputs = {}

    def record(mod, args):
        inputs.setdefault(mod.site, float(args[0].abs().max()))

    handles = [m.register_forward_pre_hook(record)
               for m in model.modules() if getattr(m, "site", "")]
    with torch.no_grad():
        out = model(_t(x), _t(t).long(), low_res=_t(low))
        got = calib.maxima()
        for h in handles:
            h.remove()
        second = quant.ActCalibration()
        model.set_calibration(second)
        model(_t(x) * 0.5, _t(t).long() * 2, low_res=_t(low) * 0.5)
        model.set_calibration(calib)
        model(_t(x) * 0.5, _t(t).long() * 2, low_res=_t(low) * 0.5)
        again, second = calib.maxima(), second.maxima()
        model.set_calibration(None)
        plain = model(_t(x), _t(t).long(), low_res=_t(low))
    assert sorted(got) == sorted(ref) and len(ref) > 20
    assert got == inputs
    assert "unet/in0_0" in got and "unet/head_conv" in got
    for site, m in ref.items():
        assert abs(got[site] - m) <= AMAX_RTOL * m, site
    assert again == {site: max(m, second[site]) for site, m in got.items()}
    assert again != got
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    calib.reset()
    assert calib.maxima() == {}
    with pytest.raises(ValueError, match="unquantized"):
        SuperResModel(in_channels=1, int8=quant.Int8Config(),
                      **TINY).set_calibration(quant.ActCalibration())
    with pytest.raises(ValueError, match="unfused"):
        SuperResModel(in_channels=1, fused=True,
                      **TINY).set_calibration(quant.ActCalibration())


def _jax_chain(jm, params, sampler, x_t, stream, low, respacing="3"):
    """The JAX tool's chain loop on the same draws: the sown maxima of each
    step, in chain order (t = T-1 .. 0)."""
    betas = jsched.linear_beta_schedule(1000)
    sp = jsched.make_spaced_schedule(
        betas, sorted(jsched.space_timesteps(1000, respacing)))
    cfg = jproc.DiffusionConfig(jproc.MeanType.VELOCITY,
                                jproc.VarType.LEARNED_RANGE,
                                jproc.LossType.MSE, original_num_steps=1000)

    def step(p, xx, tt, noise):
        cap = {}

        def model_fn(a, b, **kw):
            out, muts = jm.apply({"params": p}, a, b,
                                 mutable=["quant_calib"], **kw)
            cap["m"] = muts["quant_calib"]
            return out

        fn = jsampling.ddim_sample if sampler == "ddim" else jsampling.p_sample
        kw = {"eta": 0.0} if sampler == "ddim" else {}
        res = fn(jax.random.key(0), model_fn, sp, cfg, xx, tt,
                 model_kwargs={"low_res": low}, noise_override=noise, **kw)
        return res["sample"], cap["m"]

    jstep = jax.jit(step)
    x, per_step = jnp.asarray(x_t), []
    for i in reversed(range(sp.num_timesteps)):
        x, calib = jstep(params, x, jnp.full((1,), i, jnp.int32),
                         jnp.asarray(stream[i]))
        per_step.append((i, _flat(jax.device_get(calib))))
    return per_step


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_tool_tables_match_jax_chain(sampler, monkeypatch):
    """The tool's core over a 3-step chain (linear 1000, v-prediction,
    learned range, respaced) against a JAX loop of its own sampler step
    fed the same x_T and step noise: the whole-chain maxima, the per-step
    minima and the per-bin maxima (bin ``min(i * nb // n, nb - 1)``); the
    written tables follow from them as the JAX tool writes them."""
    model, jm, params, _, low = _tiny(True)
    rng = np.random.default_rng(41)
    x_t = rng.standard_normal(low.shape).astype(np.float32)
    stream = rng.standard_normal((3,) + low.shape).astype(np.float32)
    monkeypatch.setenv("DDPM3D_INT8_CALIB", "1")
    per_step = _jax_chain(jm, params, sampler, x_t, stream, low)
    sched, cfg = tool.chain_schedule("3")
    nb = 2
    amax, step_min, bins = tool.calibrate_chain(
        model, sched, cfg, [(_t(low), _t(x_t), lambda i: _t(stream[i]))],
        sampler=sampler, time_bins=nb)
    ref_amax = {s: max(m[s] for _, m in per_step) for s in per_step[0][1]}
    ref_min = {s: min(m[s] for _, m in per_step) for s in per_step[0][1]}
    assert sorted(amax) == sorted(ref_amax)
    for site in ref_amax:
        ref_bins = np.zeros(nb)
        for i, m in per_step:
            b = min(i * nb // 3, nb - 1)
            ref_bins[b] = max(ref_bins[b], m[site])
        np.testing.assert_allclose(amax[site], ref_amax[site],
                                   rtol=TABLE_RTOL, err_msg=site)
        np.testing.assert_allclose(step_min[site], ref_min[site],
                                   rtol=TABLE_RTOL, err_msg=site)
        np.testing.assert_allclose(bins[site], ref_bins, rtol=TABLE_RTOL,
                                   err_msg=site)
    out = tool.scales_json(amax, step_min, bins, 1.5, {"sampler": sampler})
    site = "unet/in1_0/in_conv"
    assert out["scales"][site] == amax[site] * 1.5 / 127.0
    assert out["scales_t"][site] == [b * 1.5 / 127.0 for b in bins[site]]
    assert out["meta"]["per_site_step_spread"][site] == (
        amax[site] / step_min[site])


def _jax_tool_meta_keys():
    """The ``meta`` keys the JAX tool writes, read from its source."""
    src = open(osp.join(REPO, "tools", "calibrate_int8.py")).read()
    start = src.index('"meta": {') + len('"meta": {')
    block = src[start:src.index("if scales_t:")]
    return re.findall(r'^\s*"(\w+)":', block, re.M)


def test_scales_file_read_by_both_packages(tmp_path, monkeypatch):
    """The tool's CLI on the CPU writes a file with every key the JAX tool
    writes; the port's readers, the serving CLI's ``--int8_scales`` and
    the JAX package's readers (static scales, per-bin tables, meta
    validation) all take it as written."""
    out = str(tmp_path / "scales.json")
    data = tool.main(["--allow_random", "--size", "8", "--respacing", "3",
                      "--time_bins", "2", "--n_volumes", "1", "--device",
                      "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(data))
    assert set(data) == {"scales", "scales_t", "meta"}
    assert list(data["meta"]) == _jax_tool_meta_keys()
    meta = data["meta"]
    assert (meta["chain_steps"], meta["time_bins"], meta["ckpt"]) == (
        3, 2, tool.RANDOM_CKPT)
    assert len(data["scales"]) == 27  # every conv site of the tiny model
    tables = quant.scale_tables(out)
    assert tables["n_bins"] == 2 and tables["chain_steps"] == 3
    assert quant.static_scales(out) == data["scales"]
    cfg = quant.Int8Config(scales=out)
    cfg.set_chain_step(2)
    assert cfg.act_scale("unet/in1_0/in_conv") == np.float32(
        data["scales_t"]["unet/in1_0/in_conv"][1])
    quant.validate_scales_file(out, model_config=dict(
        size=8, model_channels=32, num_res_blocks=1))
    args = serve_cli.create_argparser().parse_args([
        "--int8", "True", "--int8_scales", out, "--large_size", "8",
        "--num_channels", "32", "--num_res_blocks", "1",
        "--timestep_respacing", "3"])
    assert serve_cli.int8_config(args, fused=False).has_time_bins
    with pytest.raises(ValueError, match="checkpoint"):
        quant.validate_scales_file(out, model_path="ema_000100.pt")
    monkeypatch.setenv("DDPM3D_INT8_SCALES", out)
    assert jquant.static_scales() == data["scales"]
    jt = jquant.scale_tables()
    assert (jt["n_bins"], jt["chain_steps"]) == (2, 3)
    for site, row in data["scales_t"].items():
        np.testing.assert_array_equal(jt["sites"][site],
                                      np.asarray(row, np.float32))
    jquant.validate_scales_file(out, model_config=dict(
        size=8, model_channels=32, num_res_blocks=1))
    with pytest.raises(ValueError, match="checkpoint"):
        jquant.validate_scales_file(out, model_path="ema_000100.msgpack")
    with pytest.raises(ValueError, match="model_channels"):
        quant.validate_scales_file(out, model_config=dict(model_channels=64))


# eps-scale calibration: the analytic model of tests/test_calibration.py (a
# perfect eps model scaled by a known lambda(t)), in both packages
SHAPE = (2, 4, 8, 8, 1)
T = 1000


def _jax_biased(sched, x0c, lam_true):
    def model_fn(x, t, **kw):
        acp = jproc.extract(sched.alphas_cumprod, t, x.ndim)
        eps = (x - jnp.sqrt(acp) * x0c) / jnp.sqrt(1.0 - acp)
        scale = lam_true[jnp.clip(t, 0, T - 1)].reshape(
            (-1,) + (1,) * (x.ndim - 1))
        return jnp.concatenate([eps * scale, -jnp.ones_like(x)], axis=-1)
    return model_fn


def _torch_biased(sched, x0c, lam_true):
    def model_fn(x, t, **kw):
        acp = tproc.extract(sched.alphas_cumprod, t, x.dim())
        eps = (x - torch.sqrt(acp) * x0c) / torch.sqrt(1.0 - acp)
        scale = lam_true[t.clamp(0, T - 1)].reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return torch.cat([eps * scale, -torch.ones_like(x)], dim=-1)
    return model_fn


def _setups():
    jcfg = jproc.DiffusionConfig(jproc.MeanType.EPSILON,
                                 jproc.VarType.LEARNED_RANGE,
                                 jproc.LossType.MSE, original_num_steps=T)
    tcfg = tproc.DiffusionConfig(tproc.MeanType.EPSILON,
                                 tproc.VarType.LEARNED_RANGE,
                                 tproc.LossType.MSE, original_num_steps=T)
    betas = jsched.linear_beta_schedule(T)
    return (jsched.make_schedule(betas), jcfg,
            tsched.make_schedule(betas), tcfg)


def test_eps_scale_matches_jax_on_the_same_draws():
    """The lambda table against JAX's estimate_eps_scale on the same eps
    draws (JAX's key-derived draws, handed to the port), <= LAMBDA_TOL."""
    js, jcfg, ts, tcfg = _setups()
    rng = np.random.default_rng(0)
    x0c = np.clip(rng.normal(size=SHAPE) * 0.3, -1, 1).astype(np.float32)
    lam_true = (1.0 + 0.01 * np.sin(np.arange(T) / 200.0)).astype(np.float32)
    key, draws = jax.random.key(3), 2
    t_points = sorted({int(t) for t in np.linspace(0, T - 1, 17)})
    ref = jcal.estimate_eps_scale(
        key, _jax_biased(js, jnp.asarray(x0c), jnp.asarray(lam_true)), js,
        jcfg, jnp.asarray(x0c), draws=draws)
    eps = np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, 10007 * t_s + d), SHAPE, jnp.float32))
        for d in range(draws)]) for t_s in t_points])
    got = tcal.estimate_eps_scale(
        _torch_biased(ts, _t(x0c), _t(lam_true)), ts, tcfg, _t(x0c),
        draws=draws, eps=_t(eps))
    assert got.dtype == np.float32 and got.shape == (T,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LAMBDA_TOL)
    with pytest.raises(ValueError, match="eps"):
        tcal.estimate_eps_scale(
            _torch_biased(ts, _t(x0c), _t(lam_true)), ts, tcfg, _t(x0c),
            draws=3, eps=_t(eps))


def test_eps_scale_recovers_known_bias_and_corrects_it():
    """tests/test_calibration.py on the port, with a torch.Generator: the
    fit recovers an injected lambda(t) within 2e-3 at mid and high t; the
    wrapper divides the eps half by it (the corrected model is the
    unbiased one), passes the variance half through and indexes original
    timesteps, with rescale_timesteps too; it matches JAX's wrapper."""
    js, jcfg, ts, tcfg = _setups()
    rng = np.random.default_rng(1)
    x0c = _t(np.clip(rng.normal(size=SHAPE) * 0.3, -1, 1).astype(np.float32))
    lam_true = _t((1.0 + 0.02 * np.cos(np.arange(T) / 300.0))
                  .astype(np.float32))
    biased = _torch_biased(ts, x0c, lam_true)
    lam = tcal.estimate_eps_scale(biased, ts, tcfg, x0c, draws=3,
                                  generator=torch.Generator().manual_seed(5))
    for t in (300, 500, 800, 950):
        assert abs(float(lam[t]) - float(lam_true[t])) < 2e-3, t
    clean = _torch_biased(ts, x0c, torch.ones(T))
    fixed = tcal.eps_corrected_model_fn(biased, lam)
    x = _t(rng.normal(size=SHAPE).astype(np.float32))
    for t_s in (100, 500, 900):
        t = torch.full((SHAPE[0],), t_s)
        torch.testing.assert_close(fixed(x, t)[..., :1], clean(x, t)[..., :1],
                                   rtol=5e-3, atol=5e-3)
    table = np.full(T, 1.5, np.float32)
    t = torch.tensor([100, 700])
    out, raw = tcal.eps_corrected_model_fn(biased, table)(x, t), biased(x, t)
    torch.testing.assert_close(out[..., 1:], raw[..., 1:], rtol=0, atol=0)
    torch.testing.assert_close(out[..., :1], raw[..., :1] / 1.5)
    ramp = np.linspace(1.0, 2.0, T).astype(np.float32)
    jbiased = _jax_biased(js, jnp.asarray(x0c.numpy()), jnp.asarray(lam_true))
    ref = jcal.eps_corrected_model_fn(
        lambda a, b: jbiased(a, jnp.round(b).astype(jnp.int32)),
        ramp, rescale_timesteps=True, original_num_steps=T)(
            jnp.asarray(x.numpy()), jnp.asarray([100.0, 700.0]))
    got = tcal.eps_corrected_model_fn(
        lambda a, b: biased(a, b.round().long()), ramp,
        rescale_timesteps=True, original_num_steps=T)(
            x, torch.tensor([100.0, 700.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
