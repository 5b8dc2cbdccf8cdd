"""The port's dual-branch Seg* models against the JAX package (CPU: the
kernels' plain versions), on the same numpy-seeded inputs and params, at a
tiny size (32 channels, (1, 2), 1 res block, 4 x 16 x 16): each fusion in
f32 (with the calibration mode) and bf16; the four constructors and the
reference's class-name aliases; the converter's ``encoder.`` and
``conv_down.`` keys. Int8 is in tests/test_torch_port_seg_int8.py, the
training step and the launches per forward in
tests/test_torch_port_seg_train.py: JAX's traces and compiles of the
dual-branch model dominate the time, and each file keeps a share."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import models as jmodels
from ddpm3d_tpu.utils.torch_export import (
    flax_path_to_torch_key as jax_torch_key,
)
from ddpm3d_tpu.utils.torch_export import params_to_torch_state_dict
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch import models as tmodels
from ddpm3d_tpu_torch.models import SegUNetModel
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    torch_module_to_flax_path,
)

KW = dict(in_channels=1, cond_channels=1, model_channels=32, out_channels=2,
          num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
          dims=3, use_scale_shift_norm=True, resblock_updown=True,
          middle_attention=False)
FUSIONS = ("add", "cat_conv", "midcat")
# f32: max |port - JAX| / max |JAX| (sums reordered against XLA); a
# site's recorded input abs-max against JAX's sown one, relative: the
# deep sites' inputs differ by the forward's reordered f32 sums
# (tests/test_torch_port_calibration.py:AMAX_RTOL)
F32_TOL = 1e-5
AMAX_RTOL = 1e-5
# bf16: the two packages round some layers at other points (each 1x1
# conv's product and bias: flax rounds twice, F.linear once), so the bf16
# forwards are held against the noise of JAX's own bf16 forward against its
# f32 one, as tests/test_torch_port_attention.py does
BF16_NOISE_FACTOR = 1.5


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
def _case(fusion):
    """The JAX model, seeded params (every param noise, the zero-init head
    too; GroupNorm gains near 1) made on the port's state dict and carried
    to JAX by its importer (no JAX init to compile; the structure is held
    against JAX's init in test_seg_f32_matches_jax), and inputs."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 4, 16, 16, 1)).astype(np.float32)
    low = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([5, 800], np.int32)
    model = SegUNetModel(fusion=fusion, **KW)
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    jm = jmodels.SegUNetModel(fusion=fusion, **KW)
    return jm, torch_state_dict_to_params(sd), x, low, t


@functools.lru_cache(maxsize=None)
def _jax_f32(fusion):
    """JAX's f32 forward with its sites in the calibration mode
    (DDPM3D_INT8_CALIB=1, which quantizes nothing): the output, and each
    conv site's sown input abs-max {site: float} (one trace for both)."""
    jm, params, x, low, t = _case(fusion)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDPM3D_INT8", "0")
        mp.setenv("DDPM3D_INT8_CALIB", "1")
        out, muts = jax.jit(lambda p: jm.apply(
            {"params": p}, x, t, low_res=low, mutable=["quant_calib"]))(params)
    sown = {"/".join(k.key for k in path[:-1]): float(v) for path, v in
            jax.tree_util.tree_flatten_with_path(muts["quant_calib"])[0]}
    return np.asarray(out), sown


@functools.lru_cache(maxsize=None)
def _jax_bf16(fusion):
    _, params, x, low, t = _case(fusion)
    jm = jmodels.SegUNetModel(fusion=fusion, dtype=jnp.bfloat16, **KW)
    return np.asarray(jax.jit(jm.apply)(
        {"params": params}, x, t, low_res=low), np.float32)


def _port(fusion, params, **kw):
    model = SegUNetModel(fusion=fusion, **KW, **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _port_forward(model, x, low, t):
    with torch.no_grad():
        return model(_t(x), _t(t).long(), low_res=_t(low)).float().numpy()


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seg_f32_matches_jax(fusion):
    """The f32 forward on params carried across by utils/convert.py: the
    state dict's keys and shapes are JAX's, it loads strictly, and the
    conv sites carry JAX's module paths; in the calibration mode both
    branches' sites record JAX's sown abs-maxima (AMAX_RTOL)."""
    jm, params, x, low, t = _case(fusion)
    ref, sown = _jax_f32(fusion)
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(params_to_torch_state_dict({"params": params}))
    model = _port(fusion, params)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == (
        _jax_shapes(jm, x, t, low_res=low))
    calib = quant.ActCalibration()
    model.set_calibration(calib)
    got = _port_forward(model, x, low, t)
    assert np.abs(ref).max() > 1e-1
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    maxima = calib.maxima()
    assert sorted(maxima) == sorted(sown)
    for site, m in sown.items():
        assert abs(maxima[site] - m) <= AMAX_RTOL * m, site
    sites = {m.site for m in model.modules() if getattr(m, "site", "")}
    assert {"in0_0", "encoder/in0_0", "encoder/in1_0/in_conv",
            "head_conv"} <= sites
    assert ("fuse3" in sites) == (fusion == "cat_conv")
    assert ("mid_0/skip" in sites) == (fusion == "midcat")
    assert torch_module_to_flax_path("encoder.input_blocks.3.0.skip_connection"
                                     ) == "encoder/in3_0/skip"


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seg_bf16_matches_jax_bf16(fusion):
    """The bf16 torso: the port's bf16 forward is as close to JAX's f32
    forward as JAX's bf16 one is, and the two bf16 forwards differ by no
    more than that noise; the output is in the input's dtype."""
    _, params, x, low, t = _case(fusion)
    ref32 = _jax_f32(fusion)[0]
    ref = _jax_bf16(fusion)
    model = _port(fusion, params, dtype=torch.bfloat16)
    with torch.no_grad():
        out = model(_t(x), _t(t).long(), low_res=_t(low))
    assert out.dtype == torch.float32
    out = out.numpy()
    for stat in (np.mean, np.max):
        noise = stat(np.abs(ref - ref32))
        assert noise > 0
        assert stat(np.abs(out - ref32)) <= BF16_NOISE_FACTOR * noise, stat
        assert stat(np.abs(out - ref)) <= BF16_NOISE_FACTOR * noise, stat


def _jax_shapes(module, *args, **kwargs):
    """{torch key: shape} of a JAX model's params, without computing them."""
    tree = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                              **kwargs))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(p.key for p in path)
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = (shape[::-1] if len(shape) == 2 else
                     (shape[-1], shape[-2]) + shape[:-2])
        out[jax_torch_key(names)] = shape
    return out


ALIASES = ("SegModelv2", "SegModelv2_3d_noatt", "SegModelv3",
           "SegModel_3d_noatt_midcat", "SegModelv2_6c", "SegModelv3_6c",
           "UNetModelv2", "EncoderUNetModelv2", "EncoderUNetModelv3")


@pytest.mark.parametrize("name", ALIASES)
def test_constructors_and_aliases_match_jax(name):
    """The four Seg constructors build SegUNetModel with JAX's fusion,
    dims and middle (each fusion's parameter names and shapes are held in
    test_seg_f32_matches_jax); the aliases build JAX's parameter names and
    shapes (SegModelv3_6c with a 3-channel conditioner against JAX's init,
    SegModelv2_6c against the generic model it stands for; UNetModelv2 is
    UNetModel in both packages; the encoders drop the middle and their
    final activation is their last feature)."""
    x = np.random.default_rng(4).standard_normal((1, 4, 16, 16, 1))
    x = x.astype(np.float32)
    kw = {k: v for k, v in KW.items() if k not in ("in_channels",
                                                   "cond_channels")}
    port_fn, jax_fn = getattr(tmodels, name), getattr(jmodels, name)
    want = None
    if name.startswith("Seg"):
        cond = 3 if name.endswith("_6c") else 1
        if cond == 1:
            kw["cond_channels"] = 1
        model = port_fn(in_channels=1, **kw)
        jm = jax_fn(in_channels=1, **kw)
        assert type(model) is SegUNetModel
        assert (model.fusion, model.dims) == (jm.fusion, jm.dims)
        assert not any(isinstance(m, tmodels.AttentionBlock)
                       for m in model.modules())
        if name == "SegModelv3_6c":  # the 3-channel conditioner, fuse{i}
            want = _jax_shapes(jm, x, np.array([9]),
                               low_res=np.repeat(x, 3, axis=-1))
        elif cond == 3:  # the generic model it stands for
            want = {k: tuple(v.shape) for k, v in SegUNetModel(
                in_channels=1, cond_channels=3, fusion=model.fusion,
                **kw).state_dict().items()}
    elif name == "UNetModelv2":
        kw.pop("middle_attention")
        model = port_fn(in_channels=1, **kw)
        # JAX's alias is its UNetModel, the port's is the port's, whose
        # names and shapes tests/test_torch_port_model.py holds to JAX's
        assert type(model) is tmodels.UNetModel
        assert type(jax_fn(in_channels=1, **kw)) is jmodels.UNetModel
    else:
        kw = {k: v for k, v in kw.items()
              if k not in ("middle_attention", "out_channels")}
        model = port_fn(in_channels=1, out_channels=3, **kw)
        want = _jax_shapes(jax_fn(in_channels=1, out_channels=3, **kw), x,
                           np.array([9]))
        assert not model.include_middle
        with torch.no_grad():
            feats, final = model(_t(x), torch.tensor([9]),
                                 return_features=True)
        torch.testing.assert_close(final, feats[-1], rtol=0, atol=0)
    if want is not None:
        assert {k: tuple(v.shape)
                for k, v in model.state_dict().items()} == want


def test_seg_refuses_fused_and_mixed_modes():
    """JAX never fuses a Seg model: fused=True raises, as a 2-D model
    refuses fusion; int8 and calibration exclude each other."""
    with pytest.raises(ValueError, match="never fuse"):
        SegUNetModel(fusion="add", fused=True, **KW)
    with pytest.raises(ValueError, match="fusion must be"):
        SegUNetModel(fusion="sum", **KW)
    model = SegUNetModel(fusion="add", **KW, int8=quant.Int8Config())
    with pytest.raises(ValueError, match="calibration"):
        model.set_calibration(quant.ActCalibration())
    model.set_int8(None)
    model.set_calibration(quant.ActCalibration())
    with pytest.raises(ValueError, match="exclude each other"):
        model.set_int8(quant.Int8Config())
