"""The port's int8 (W8A8) serving path and DDIM against the JAX package.

On the CPU the int8 conv runs its plain PyTorch version
(``ops/conv3d_s8.py:conv3d_s8_plain``, exact integer sums); the JAX side
runs its default XLA lowering (``DDPM3D_INT8=1``, jitted: XLA:CPU's integer
convs are slow op by op) and its Pallas kernel in interpret mode, as
tests/test_quant.py and tests/test_conv3d_s8.py run them. Inputs are
numpy-seeded. The kernel itself is held against the plain version on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import functools
import json
import os.path as osp
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.diffusion import sampling as jsampling
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu.ops import conv3d_s8 as jconv_s8
from ddpm3d_tpu.ops import phase_up as jphase
from ddpm3d_tpu.ops import quant as jquant
from ddpm3d_tpu_torch.data import tiff_io as ttiff
from ddpm3d_tpu_torch.diffusion import sampling as tsampling
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import conv3d_s8 as s8
from ddpm3d_tpu_torch.ops import phase_up, quant
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

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch_w(k):
    """(kd, kh, kw, Cin, Cout) -> the port's (Cout, Cin, kd, kh, kw)."""
    return _t(np.asarray(k).transpose(4, 3, 0, 1, 2))


# ------------------------------------------------------------ quantize ----

@pytest.mark.parametrize("case", ["batch1", "batch2", "static", "zero_sample",
                                  "saturate", "bf16"])
def test_quantize_act_matches_jax(case):
    """Bit-equal q and scales: per-sample abs-max / 127 (a division), an
    all-zero sample's scale 1, round half to even, static scales saturating
    at +-127 (never -128)."""
    rng = np.random.default_rng(1)
    B = 1 if case == "batch1" else 2
    x = (rng.standard_normal((B, 3, 5, 6, 16)) * 3).astype(np.float32)
    x[..., 0, 0, 0, :4] = [0.5, -0.5, 1.5, -2.5]  # exact halves
    static = None
    if case == "zero_sample":
        x[1] = 0
    if case in ("static", "saturate"):
        static = 0.02 if case == "static" else 0.001
    if case == "bf16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    jx = jnp.asarray(x, dtype).reshape((B * 3,) + x.shape[2:])
    jq, js = jquant.quantize_act(jx, B, static_scale=static)
    tx = _t(x).to(torch.bfloat16 if case == "bf16" else torch.float32)
    q, s = quant.quantize_act(tx, static)
    assert q.dtype == torch.int8 and s.shape == (B,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(x.shape))
    js = np.broadcast_to(np.asarray(js, np.float32).reshape(-1), (B * 3,))
    np.testing.assert_array_equal(s.numpy(), js[::3])
    if case == "saturate":
        assert q.min() == -127 and q.max() == 127
    if case == "zero_sample":
        assert s[1] == 1 and not q[1].any()


def test_quantize_kernel_matches_jax():
    """Per-output-channel scales over (Cin, kd, kh, kw), bit-equal."""
    rng = np.random.default_rng(2)
    k = rng.standard_normal((3, 3, 3, 8, 16)).astype(np.float32)
    k[..., 3] *= 100.0
    k[..., 5] = 0.0
    jq, js = jquant.quantize_kernel(jnp.asarray(k))
    q, s = quant.quantize_kernel(_torch_w(k))
    np.testing.assert_array_equal(q.numpy(), _torch_w(np.asarray(jq)).numpy())
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[5] == 1


# ----------------------------------------------------------------- conv ---

def _rand_s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_conv3d_s8_plain_matches_pallas_interpret():
    """The plain version against the Pallas kernel (interpret mode) at
    [1, 4, 4, 32, 128] -> 128 with the scale folded (s_x = 1): f32 out
    without bias bit-equal; with bias within 1 ulp (the Pallas epilogue may
    contract the multiply and add, quant.py:519-522); bf16 out bit-equal."""
    rng = np.random.default_rng(3)
    xq = _rand_s8(rng, (1, 4, 4, 32, 128))
    kq = _rand_s8(rng, (3, 3, 3, 128, 128))
    scale = rng.uniform(1e-4, 1e-2, 128).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    args = (_t(xq), _torch_w(kq), torch.ones(1), _t(scale))
    for b, dt, jdt in ((None, torch.float32, jnp.float32),
                       (bias, torch.float32, jnp.float32),
                       (None, torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jconv_s8.conv3d_s8(
            jnp.asarray(xq), jnp.asarray(kq), jnp.asarray(scale),
            None if b is None else jnp.asarray(b), out_dtype=jdt,
            interpret=True)).astype(np.float32)
        got = s8.conv3d_s8(*args, None if b is None else _t(b), dt).float()
        if b is None:
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=5e-6, atol=1e-4)


@pytest.mark.parametrize("k,cin,n,dtype", [
    pytest.param(3, 16, 24, "float32", id="3"),
    pytest.param(1, 16, 24, "float32", id="1"),
    # the model's 1x1x1 sites at their chunk counts (2 and 8 of 128
    # channels on csrc/conv1x1_s8.cu; 1024 -> 512 streams its weights)
    pytest.param(1, 256, 128, "float32", id="1-256-128-float32"),
    pytest.param(1, 256, 128, "bfloat16", id="1-256-128-bfloat16"),
    pytest.param(1, 1024, 512, "float32", id="1-1024-512-float32"),
    pytest.param(1, 1024, 512, "bfloat16", id="1-1024-512-bfloat16"),
])
def test_conv3d_int8_matches_jax_default_lowering(k, cin, n, dtype):
    """A quantized site end to end (quantize the activation per sample,
    the weight per channel, int8 conv, f32 epilogue with the bias, one
    rounding to x's dtype) against conv3d_folded_int8 (XLA's lowering: the
    JAX package runs its 1x1x1 sites there) at batch 2, dynamic scales:
    bit-equal, f32 and bf16 out."""
    rng = np.random.default_rng(4 + k + (0 if cin == 16 else cin + n))
    B, D, H, W = (2, 5, 6, 7) if cin == 16 else (2, 3, 4, 5)
    x = (rng.standard_normal((B, D, H, W, cin)) * 2).astype(np.float32)
    x[1] *= 30  # per-sample scales differ
    w = (rng.standard_normal((k, k, k, cin, n)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    xj = jnp.asarray(x.reshape((B * D, H, W, cin)), getattr(jnp, dtype))
    ref = np.asarray(jquant.conv3d_folded_int8(
        xj, jnp.asarray(w), B, bias=jnp.asarray(bias)).astype(jnp.float32))
    wq, s_w = quant.quantize_weight(_torch_w(w))
    xt = _t(np.array(xj.astype(jnp.float32)).reshape(x.shape)).to(
        getattr(torch, dtype))
    got = quant.conv3d_int8(xt, wq, s_w, _t(bias))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.reshape(B, D, H, W, n))


def test_phase_route_matches_jax():
    """The stacked phase kernels are the JAX phase kernels (bit-equal,
    combined in f32 in the same order), zero outside their window; the
    up-site conv (one launch for all phases, bias after the rounding)
    equals upsample_conv_folded_int8 plus its caller's bias add, dynamic
    at batch 2 and static, in f32 and bf16."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 3, 3, 8, 12)) * 0.1).astype(np.float32)
    jk = jphase.phase_up_kernels(jnp.asarray(w))
    tk = phase_up.phase_up_kernels(_torch_w(w))
    stacked = phase_up.stacked_phase_weight(_torch_w(w))
    assert stacked.shape == (48, 8, 3, 3, 3)
    for (a, b), ref in jk.items():
        ref_t = _torch_w(np.asarray(ref)).numpy()
        np.testing.assert_array_equal(tk[(a, b)].numpy(), ref_t)
        block = stacked[(2 * a + b) * 12:(2 * a + b + 1) * 12]
        np.testing.assert_array_equal(
            block[..., a:a + 2, b:b + 2].numpy(), ref_t)
        outside = block.clone()
        outside[..., a:a + 2, b:b + 2] = 0
        assert not outside.any()  # zeros outside the phase's window
    B, D = 2, 4
    x = rng.standard_normal((B, D, 5, 6, 8)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    wq, s_w = quant.quantize_weight(_torch_w(w), upsample=True)
    for static, dt, jdt in ((None, torch.float32, jnp.float32),
                            (0.01, torch.float32, jnp.float32),
                            (None, torch.bfloat16, jnp.bfloat16)):
        jx = jnp.asarray(x, jdt).reshape((B * D,) + x.shape[2:])
        ref = jquant.upsample_conv_folded_int8(jx, jnp.asarray(w), B,
                                               act_scale=static)
        ref = np.asarray(ref + jnp.asarray(bias).astype(ref.dtype),
                         np.float32).reshape(B, D, 10, 12, 12)
        got = quant.conv3d_int8(_t(x).to(dt), wq, s_w, _t(bias),
                                act_scale=static, upsample=True)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), ref)


# ---------------------------------------------------------------- model ---

def _tiny_cfg(updown):
    return dict(model_channels=32, out_channels=2, num_res_blocks=1,
                attention_resolutions=(), channel_mult=(1, 2), dims=3,
                use_scale_shift_norm=True, resblock_updown=updown,
                middle_attention=False)


@functools.lru_cache(maxsize=None)
def _make_tiny(updown):
    """The JAX model with every param replaced by seeded noise (heads
    included), and inputs."""
    cfg = _tiny_cfg(updown)
    jm = JaxSuperRes(in_channels=1, **cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 16, 16, 1)).astype(np.float32)
    low = rng.standard_normal((2, 4, 16, 16, 1)).astype(np.float32)
    params = jax.jit(lambda v: jm.init(
        jax.random.key(0), v, jnp.zeros((2,), jnp.int32), low_res=v))(
            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (1.0 if path[-1].key == "scale" else 0.0)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32), params)
    return dict(jm=jm, params=params, cfg=cfg, x=x, low=low,
                t=np.array([5, 900], np.int32), updown=updown)


@pytest.fixture(params=[True, False], ids=["resblock_updown", "conv_resample"])
def tiny(request):
    return _make_tiny(request.param)


@pytest.fixture
def tiny_updown():
    return _make_tiny(True)


def _port(tiny, int8):
    model = SuperResModel(in_channels=1, int8=int8, **tiny["cfg"])
    model.load_state_dict(jax_params_to_state_dict(tiny["params"]),
                          strict=True)
    return model.eval()


def _jax_forward(tiny, monkeypatch, scales=None):
    monkeypatch.setenv("DDPM3D_INT8", "1")
    if scales:
        monkeypatch.setenv("DDPM3D_INT8_SCALES", scales)
    jm = tiny["jm"]
    out = jax.jit(lambda p, a, t, lo: jm.apply({"params": p}, a, t,
                                               low_res=lo))(
        tiny["params"], jnp.asarray(tiny["x"]), jnp.asarray(tiny["t"]),
        jnp.asarray(tiny["low"]))
    return np.asarray(out)


def _port_forward(model, tiny):
    with torch.no_grad():
        return model(_t(tiny["x"]), _t(tiny["t"]).long(),
                     low_res=_t(tiny["low"])).numpy()


# An int8 network is discontinuous: the float layers between the convs
# (GroupNorm, SiLU, FiLM, the f32 input conv) round in another order in the
# two frameworks (~1e-7 relative), an activation near a rounding boundary
# then quantizes to a neighbouring int8 value, and the change spreads
# through the GroupNorms that follow (test_int8_model_is_discontinuous
# shows it on the port alone). So each quantized site is held exactly against the
# JAX function on the site's own input (SITE_RTOL: the jitted JAX epilogue
# may fuse the multiply and the bias add into one FMA, 1 ulp), and the
# whole model only loosely (MODEL_MEAN_TOL, mean |diff| / mean |ref|).
SITE_RTOL = 1e-6
MODEL_MEAN_TOL = 5e-2


def _site_io(model, tiny):
    """One forward of the port's int8 model with every quantized site's
    input, output and upsample flag captured."""
    io = []
    handles = [m.register_forward_hook(
        lambda mod, args, kwargs, out: io.append(
            (mod.site, args[0], out, bool(kwargs.get("upsample")))),
        with_kwargs=True)
        for m in model.modules() if getattr(m, "site", "") and m.int8_active()]
    out = _port_forward(model, tiny)
    for h in handles:
        h.remove()
    return out, io


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_site_fn(xf, kernel, bias, B, upsample, stride, act_scale=None):
    if upsample:
        return jquant.upsample_conv_folded_int8(
            xf, kernel, B, act_scale=act_scale) + bias.astype(xf.dtype)
    return jquant.conv3d_folded_int8(xf, kernel, B, strides_hw=stride,
                                     act_scale=act_scale, bias=bias)


def _jax_site(tiny, site, x, act_scale, upsample):
    """The JAX package's int8 function of one conv site (Conv3DFolded's int8
    branch) on the port's input x [B, D, H, W, C] (jitted once per shape
    and route)."""
    node = tiny["params"]
    for part in site.split("/"):
        node = node[part]
    B, D = x.shape[:2]
    xf = jnp.asarray(x.numpy()).reshape((B * D,) + tuple(x.shape[2:]))
    y = _jax_site_fn(xf, node["kernel"], node["bias"], B, upsample,
                     (2, 2) if site.endswith("/op") else (1, 1),
                     None if act_scale is None else jnp.float32(act_scale))
    return np.asarray(y).reshape((B, D) + y.shape[1:])


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_model_matches_jax(tiny, static, monkeypatch, tmp_path):
    """The tiny model served in int8 against the JAX package's DDPM3D_INT8=1
    forward, same weights: dynamic per-sample scales, and static per-site
    scales from a file (small enough that some activations saturate).
    Every quantized site equals the JAX function on its input, with the
    scale JAX's static_scale_for gives it; the quantized sites are JAX's
    sown sites less the excluded ones; one site takes the phase route."""
    scales = None
    if static:
        sites = sorted(m.site for m in _port(tiny, quant.Int8Config(
            exclude=())).modules() if getattr(m, "site", ""))
        rng = np.random.default_rng(12)
        table = {s: float(v) for s, v in zip(
            sites, rng.uniform(0.002, 0.02, len(sites)))}
        scales = str(tmp_path / f"scales_{tiny['updown']}.json")
        with open(scales, "w") as f:
            json.dump({"scales": table}, f)
    ref = _jax_forward(tiny, monkeypatch, scales)
    cfg = quant.Int8Config(scales=scales or "")
    got, io = _site_io(_port(tiny, cfg), tiny)
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-2
    mean_rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert mean_rel <= MODEL_MEAN_TOL, mean_rel
    assert sum(up for *_, up in io) == 1  # the one up transition
    saturated = 0
    for site, x, y, up in io:
        s = cfg.act_scale(site)
        assert s == jquant.static_scale_for(site)
        ref_y = _jax_site(tiny, site, x, s, up)
        y = y.numpy()[:, :, ::2, ::2] if site.endswith("/op") else y.numpy()
        np.testing.assert_allclose(y, ref_y, rtol=SITE_RTOL,
                                   atol=SITE_RTOL * np.abs(ref_y).max(),
                                   err_msg=site)
        if s is not None:
            saturated += int((x.abs() > 127.5 * s).sum())
    assert saturated > 0 if static else True
    quantized = [site for site, *_ in io]
    if not static:
        # the sites JAX sows under DDPM3D_INT8_CALIB=1, less the excluded
        monkeypatch.setenv("DDPM3D_INT8", "0")
        monkeypatch.setenv("DDPM3D_INT8_CALIB", "1")
        _, muts = jax.jit(lambda p, a, t, lo: tiny["jm"].apply(
            {"params": p}, a, t, low_res=lo, mutable=["quant_calib"]))(
                tiny["params"], jnp.asarray(tiny["x"]),
                jnp.asarray(tiny["t"]), jnp.asarray(tiny["low"]))
        sown = sorted("/".join(k.key for k in path[:-1]) for path, _ in
                      jax.tree_util.tree_flatten_with_path(
                          muts["quant_calib"])[0])
        assert sorted(quantized) == [
            s for s in sown if s not in ("unet/in0_0", "unet/head_conv")]


def test_int8_model_is_discontinuous(tiny_updown):
    """Why the whole int8 model is held only by MODEL_MEAN_TOL: one ulp
    on the input moves the port's own int8 output far more than the f32
    model's (which moves by rounding alone), while staying within it."""
    x = tiny_updown["x"]
    outs = {}
    for name, cfg in (("f32", None), ("int8", quant.Int8Config())):
        model = _port(tiny_updown, cfg)
        a = _port_forward(model, tiny_updown)
        b = _port_forward(model, dict(tiny_updown, x=np.nextafter(
            x, np.float32(np.inf))))
        outs[name] = np.abs(a - b).mean() / np.abs(a).mean()
    assert outs["int8"] > 100 * outs["f32"]
    assert outs["int8"] <= MODEL_MEAN_TOL


def test_int8_and_fused_exclude_each_other(tiny_updown):
    with pytest.raises(ValueError, match="exclude each other"):
        SuperResModel(in_channels=1, fused=True, int8=quant.Int8Config(),
                      **tiny_updown["cfg"])


def test_int8_refuses_training_mode(tiny_updown):
    model = _port(tiny_updown, quant.Int8Config()).train()
    with pytest.raises(RuntimeError, match="inference-only"):
        _port_forward(model, tiny_updown)


def test_excluded_sites_and_config():
    """DDPM3D_INT8_EXCLUDE's substring rule; an empty list quantizes
    every site."""
    assert quant.parse_exclude(quant.EXCLUDE_DEFAULT) == ("in0_0", "head_conv")
    assert quant.parse_exclude("") == ()
    for site in ("unet/in0_0", "unet/head_conv", "unet/out2_1/in_conv"):
        assert quant.int8_excluded(site, ("in0_0", "head_conv")) == (
            jquant.int8_excluded(site))
    assert quant.Int8Config(exclude=()).quantized("unet/in0_0")
    assert not quant.Int8Config().quantized("unet/in0_0")


# ---------------------------------------------------------------- chain ---

def _write_binned(path, sites, n_bins, chain_steps, rng, **meta):
    table = {s: [float(v) for v in rng.uniform(0.005, 0.05, n_bins)]
             for s in sites}
    with open(path, "w") as f:
        json.dump({"scales": {s: max(v) for s, v in table.items()},
                   "scales_t": table,
                   "meta": dict(time_bins=n_bins, chain_steps=chain_steps,
                                **meta)}, f)


def test_int8_chain_per_bin_scales_matches_jax(tiny_updown, monkeypatch,
                                               tmp_path):
    """A short unspaced chain (4 steps, 2 time bins) served in int8 with
    per-bin static scales, step by step against the JAX sampler with the
    JAX pipeline's scale lookup (quant_scales_collection on the model's
    timestep, the chain index here): every site reads JAX's scale at every
    step, and each step's output agrees (MODEL_MEAN_TOL: the int8 network's
    discontinuity, see above)."""
    tiny = tiny_updown
    rng = np.random.default_rng(13)
    sites = sorted(m.site for m in _port(tiny, quant.Int8Config(
        exclude=())).modules() if getattr(m, "site", ""))
    scales = str(tmp_path / "binned.json")
    _write_binned(scales, sites, 2, 4, rng)
    kw = dict(steps=4, learn_sigma=True, noise_schedule="cosine")
    js, jcfg = jfactory.create_gaussian_diffusion(**kw)
    ts, tcfg = tfactory.create_gaussian_diffusion(**kw)
    x_t = rng.standard_normal(tiny["x"].shape).astype(np.float32)
    stream = rng.standard_normal((4,) + x_t.shape).astype(np.float32)

    monkeypatch.setenv("DDPM3D_INT8", "1")
    monkeypatch.setenv("DDPM3D_INT8_SCALES", scales)
    jm = tiny["jm"]

    @jax.jit
    def jstep(params, img, t, noise, low):
        def model_fn(xx, tt, **k):
            col = jquant.quant_scales_collection(jnp.reshape(tt, (-1,))[0])
            return jm.apply({"params": params, "quant_scales": col}, xx, tt,
                            **k)
        return jsampling.p_sample(
            None, model_fn, js, jcfg, img, t, model_kwargs={"low_res": low},
            noise_override=noise)["sample"]

    ref, img = [], jnp.asarray(x_t)
    for i, t in enumerate(range(3, -1, -1)):
        img = jstep(tiny["params"], img, jnp.full((2,), t, jnp.int32),
                    jnp.asarray(stream[i]), jnp.asarray(tiny["low"]))
        ref.append(np.asarray(img))
    cfg = quant.Int8Config(scales=scales)
    model = _port(tiny, cfg)
    got = []
    with torch.no_grad():
        tsampling.p_sample_loop(
            lambda xx, tt, low_res: model(xx, tt, low_res=low_res),
            ts, tcfg, noise=_t(x_t), noise_stream=_t(stream),
            model_kwargs={"low_res": _t(tiny["low"])}, device="cpu",
            before_step=cfg.set_chain_step,
            step_cb=lambda t, img: got.append(img.numpy()))
    assert cfg.bins_used == {0, 1}
    for i, (g, r) in enumerate(zip(got, ref)):
        mean_rel = np.abs(g - r).mean() / np.abs(r).mean()
        assert mean_rel <= MODEL_MEAN_TOL, (i, mean_rel)
    for t in range(3, -1, -1):
        cfg.set_chain_step(t)
        col = jquant.quant_scales_collection(t)
        for site in sites:
            node = col
            for part in site.split("/"):
                node = node[part]
            assert cfg.act_scale(site) == float(node["act_scale"]), (t, site)


def test_respaced_chain_bins_on_chain_index(monkeypatch):
    """The intended divergence, pinned on the committed production file
    (25 bins over a 25-step respacing): the port's bins follow the chain
    index, one per step; the JAX pipeline, binning on timestep_map[i],
    puts every step but the last into bin 24."""
    fname = osp.join(REPO, "INT8_SCALES_PROD.json")
    site = "unet/in1_0/in_conv"
    sched, _ = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="25")
    tmap = sched.timestep_map.tolist()
    assert tmap[:3] == [0, 42, 83] and tmap[-1] == 999
    cfg = quant.Int8Config(scales=fname)
    table = quant.scale_tables(fname)["sites"][site]
    assert len(set(table.tolist())) == 25
    port_bins = []
    for i in range(24, -1, -1):
        cfg.set_chain_step(i)
        port_bins.append(int(np.flatnonzero(table == cfg.act_scale(site))[0]))
    assert port_bins == list(range(24, -1, -1))
    assert cfg.bins_used == set(range(25))
    monkeypatch.setenv("DDPM3D_INT8_SCALES", fname)
    jax_bins = []
    for i in range(24, -1, -1):
        col = jquant.quant_scales_collection(tmap[i])
        s = np.float32(col["unet"]["in1_0"]["in_conv"]["act_scale"])
        jax_bins.append(int(np.flatnonzero(table == s)[0]))
    assert jax_bins == [24] * 24 + [0]
    # without time scales: the whole-chain value
    flat = quant.Int8Config(scales=fname, time_scales=False)
    flat.set_chain_step(3)
    assert flat.act_scale(site) == quant.static_scales(fname)[site]


def test_missing_site_warns_and_goes_dynamic(tmp_path):
    path = str(tmp_path / "partial.json")
    with open(path, "w") as f:
        json.dump({"scales": {"unet/a": 0.1}}, f)
    cfg = quant.Int8Config(scales=path)
    assert cfg.act_scale("unet/a") == 0.1
    with pytest.warns(UserWarning, match="no entry for conv site"):
        assert cfg.act_scale("unet/b") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.act_scale("unet/b") is None  # warned once
    const = quant.Int8Config(scales="const:0.05")
    assert const.act_scale("unet/b") == 0.05 and not const.has_time_bins


# -------------------------------------------------------- scales files ---

_META = dict(sampler="ddpm", respacing="25", size=96, model_channels=128,
             channel_mult=[1, 1, 2, 3, 4], num_res_blocks=2,
             ckpt="/ckpts/ema_0.999_012000.msgpack")
_RUN = dict(model_path="/run/ema_0.999_012000.msgpack", sampler="ddpm",
            respacing="25", model_config=dict(size=96, model_channels=128,
                                              num_res_blocks=2))


@pytest.mark.parametrize("case,meta,run,expect", [
    ("match", _META, _RUN, None),
    ("no_meta", None, _RUN, "warn"),
    ("ckpt", _META, dict(_RUN, model_path="/run/other.msgpack"), "raise"),
    ("model", _META, dict(_RUN, model_config=dict(size=64)), "raise"),
    ("sampler", _META, dict(_RUN, sampler="ddim"), "warn"),
    ("respacing", _META, dict(_RUN, respacing="1000"), "warn"),
])
def test_validate_scales_file_matches_jax(tmp_path, case, meta, run, expect):
    """The port raises and warns where the JAX package does, on the same
    files and runs."""
    path = str(tmp_path / f"{case}.json")
    with open(path, "w") as f:
        json.dump({"scales": {}} if meta is None
                  else {"scales": {}, "meta": meta}, f)
    for fn in (jquant.validate_scales_file, quant.validate_scales_file):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if expect == "raise":
                with pytest.raises(ValueError):
                    fn(path, **run)
            else:
                fn(path, **run)
        assert bool(caught) == (expect == "warn"), (fn, case)


def test_validate_scales_file_stem_rule(tmp_path):
    """The port serves the .pt converted from the .msgpack the file names:
    the checkpoint compares by stem (the JAX package would raise); another
    stem still raises; const:<s> warns on both."""
    path = str(tmp_path / "s.json")
    with open(path, "w") as f:
        json.dump({"scales": {}, "meta": _META}, f)
    run = dict(_RUN, model_path="/port/ema_0.999_012000.pt")
    quant.validate_scales_file(path, **run)
    with pytest.raises(ValueError):
        jquant.validate_scales_file(path, **run)
    with pytest.raises(ValueError, match="ema_0.999_013000"):
        quant.validate_scales_file(
            path, **dict(run, model_path="/port/ema_0.999_013000.pt"))
    for fn in (jquant.validate_scales_file, quant.validate_scales_file):
        with pytest.warns(UserWarning, match="const"):
            fn("const:0.05")


# ----------------------------------------------------------------- DDIM ---

def _toy_model(xx, tt, fw):
    """The same learned-sigma model in both frameworks: eps = tanh(0.7 x +
    t / 1000), variance channel = 0.3 sin(x)."""
    t = fw.reshape(tt, (-1,) + (1,) * (xx.ndim - 1)).astype(xx.dtype) \
        if fw is jnp else tt.reshape((-1,) + (1,) * (xx.dim() - 1)).float()
    eps = fw.tanh(0.7 * xx + t / 1000.0)
    var = 0.3 * fw.sin(xx)
    return (fw.concatenate if fw is jnp else torch.cat)([eps, var], -1)


@pytest.fixture(scope="module")
def ddim_setup():
    kw = dict(steps=1000, learn_sigma=True, timestep_respacing="ddim10")
    js, jcfg = jfactory.create_gaussian_diffusion(**kw)
    ts, tcfg = tfactory.create_gaussian_diffusion(**kw)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 3, 4, 5, 1)).astype(np.float32)
    noise = rng.standard_normal((10,) + x.shape).astype(np.float32)
    return js, jcfg, ts, tcfg, x, noise


# one step's f32 math in another order: a few ulp of the O(1) values, more
# where 1/sqrt(acp) is large (t near T)
DDIM_ATOL = 1e-5


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("t", [0, 4, 9])
def test_ddim_sample_matches_jax(ddim_setup, eta, t):
    js, jcfg, ts, tcfg, x, noise = ddim_setup
    ref = jsampling.ddim_sample(
        None, lambda a, b: _toy_model(a, b, jnp), js, jcfg, jnp.asarray(x),
        jnp.full((2,), t, jnp.int32), eta=eta,
        noise_override=jnp.asarray(noise[0]))
    got = tsampling.ddim_sample(
        lambda a, b: _toy_model(a, b, torch), ts, tcfg, _t(x),
        torch.full((2,), t, dtype=torch.long), _t(noise[0]), eta=eta)
    for key in ("sample", "pred_xstart"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=DDIM_ATOL)


@pytest.mark.parametrize("t", [0, 5])
def test_ddim_reverse_sample_matches_jax(ddim_setup, t):
    js, jcfg, ts, tcfg, x, _ = ddim_setup
    ref = jsampling.ddim_reverse_sample(
        lambda a, b: _toy_model(a, b, jnp), js, jcfg, jnp.asarray(x),
        jnp.full((2,), t, jnp.int32))
    got = tsampling.ddim_reverse_sample(
        lambda a, b: _toy_model(a, b, torch), ts, tcfg, _t(x),
        torch.full((2,), t, dtype=torch.long))
    np.testing.assert_allclose(got["sample"].numpy(),
                               np.asarray(ref["sample"]), rtol=1e-5,
                               atol=DDIM_ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(ddim_setup, eta):
    """The 10-step DDIM chain with one explicit noise draw per step (used
    only where eta > 0): the JAX scan against the port's loop."""
    js, jcfg, ts, tcfg, x, noise = ddim_setup
    ref = jsampling.ddim_sample_loop(
        jax.random.key(0), lambda a, b: _toy_model(a, b, jnp), js, jcfg,
        noise=jnp.asarray(x), eta=eta, noise_stream=jnp.asarray(noise))
    got = tsampling.ddim_sample_loop(
        lambda a, b: _toy_model(a, b, torch), ts, tcfg, eta=eta,
        noise=_t(x), noise_stream=_t(noise), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ CLI ---

CLI_FLAGS = [  # tests/test_torch_port_pipeline.py:CLI_FLAGS
    "--large_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--learn_sigma", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--diffusion_steps", "1000", "--timestep_respacing", "2",
    "--device", "cpu",
]


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A tiny .pt checkpoint, a contract-shaped volume and a per-bin scales
    file for the tiny model's sites."""
    tmp = tmp_path_factory.mktemp("int8_cli")
    args = cli.create_argparser().parse_args(CLI_FLAGS)
    model, _, _ = tfactory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()),
        int8=quant.Int8Config(exclude=()))
    init_params(model, seed=2, zero_heads=False)
    ckpt = str(tmp / "model000010.pt")
    torch.save(model.state_dict(), ckpt)
    vol_path = str(tmp / "vol.tif")
    ttiff.imwrite(vol_path, np.random.default_rng(4).gamma(
        2.0, 0.5, (90, 200, 200)).astype(np.float32))
    scales = str(tmp / "binned.json")
    sites = [m.site for m in model.modules() if getattr(m, "site", "")]
    _write_binned(scales, sites, 2, 2, np.random.default_rng(5),
                  sampler="ddim", respacing="2", size=16, model_channels=32,
                  num_res_blocks=1, ckpt="model000010.msgpack")
    return dict(ckpt=ckpt, vol=vol_path, scales=scales, tmp=tmp,
                n_sites=len(sites))


def _run_cli(inp, out, *extra):
    out_dir = str(inp["tmp"] / out)
    cli.main(CLI_FLAGS + ["--base_samples", inp["vol"], "--model_path",
                          inp["ckpt"], "--save_dir", out_dir,
                          "--batch_size", "18", *extra])
    with open(osp.join(out_dir, "log.txt")) as f:
        log = f.read()
    return np.load(osp.join(out_dir, "denoised_vol.npz"))["arr_0"], log


def test_cli_serves_int8(cli_inputs, monkeypatch):
    """--int8 on the CPU: the log names the path, every quantized site runs
    the int8 conv (2 forwards x its sites), and the volume stays near the
    bf16 run's."""
    calls = []
    plain = s8.conv3d_s8_plain
    monkeypatch.setattr(s8, "conv3d_s8_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    q, log = _run_cli(cli_inputs, "int8", "--int8", "True")
    assert "serving path: int8 (W8A8) convs" in log and "dynamic" in log
    # 18 patches in one batch, 2 steps: two forwards of every site but
    # in0_0 and head_conv
    assert len(calls) == 2 * (cli_inputs["n_sites"] - 2)
    ref, _ = _run_cli(cli_inputs, "bf16")
    assert np.isfinite(q).all() and np.abs(q).max() > 0
    assert np.abs(q - ref).mean() <= 0.05 * np.abs(ref).mean()


def test_cli_int8_gates(cli_inputs, monkeypatch):
    """--int8 --use_dpm_solver and --int8 under DDPM3D_FUSED=1 refuse;
    --int8 --use_ddim refuses without per-bin scales (and with them turned
    off) and runs, warning, with them."""
    with pytest.raises(SystemExit, match="--use_dpm_solver is refused"):
        cli.main(CLI_FLAGS + ["--int8", "True", "--use_dpm_solver", "True"])
    with pytest.raises(SystemExit, match="--use_ddim is refused"):
        cli.main(CLI_FLAGS + ["--int8", "True", "--use_ddim", "True"])
    monkeypatch.setenv("DDPM3D_FUSED", "1")
    with pytest.raises(SystemExit, match="DDPM3D_FUSED=1 is refused"):
        cli.main(CLI_FLAGS + ["--int8", "True"])
    monkeypatch.delenv("DDPM3D_FUSED")
    monkeypatch.setenv("DDPM3D_INT8_NO_TIME_SCALES", "1")
    with pytest.raises(SystemExit, match="--use_ddim is refused"):
        cli.main(CLI_FLAGS + ["--int8", "True", "--use_ddim", "True",
                              "--int8_scales", cli_inputs["scales"]])
    monkeypatch.delenv("DDPM3D_INT8_NO_TIME_SCALES")
    with pytest.warns(UserWarning, match="per-time-bin scales"):
        out, log = _run_cli(cli_inputs, "ddim", "--int8", "True",
                            "--use_ddim", "True", "--int8_scales",
                            cli_inputs["scales"])
    assert "per time bin of the chain index" in log and "DDIM" in log
    assert np.isfinite(out).all()


def test_cli_ddim_matches_pipeline(cli_inputs):
    """--use_ddim (no int8) reaches the DDIM chain: the CLI's volume is the
    pipeline's DDIM volume and differs from the ancestral one."""
    ddim, log = _run_cli(cli_inputs, "ddim_bf16", "--use_ddim", "True")
    anc, _ = _run_cli(cli_inputs, "ddpm_bf16")
    assert "sampler: DDIM" in log
    assert np.isfinite(ddim).all() and not np.allclose(ddim, anc)
