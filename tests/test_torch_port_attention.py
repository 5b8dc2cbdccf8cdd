"""The port's attention block and the 1-, 2- and 3-D UNets with attention
against the JAX package, on the same numpy-seeded inputs and params (CPU:
the kernels' plain versions); the fused and int8 serving paths of a 3-D
attention model; the launches per forward that chip_smoke.py pins on the
card, counted here on the plain path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import UNetModel as JaxUNet
from ddpm3d_tpu.models import unet as junet
from ddpm3d_tpu.utils.torch_export import params_to_torch_state_dict
from ddpm3d_tpu_torch.models import (
    AttentionBlock,
    ResBlock,
    SuperResModel,
    UNetModel,
)
from ddpm3d_tpu_torch.ops import conv3d as conv_ops
from ddpm3d_tpu_torch.ops import conv3d_fused as fused_ops
from ddpm3d_tpu_torch.ops import groupnorm as gn_ops
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

# f32: as tests/test_torch_port_model.py (sums reordered against XLA)
RTOL, ATOL = 1e-4, 1e-5
# bf16 attention block: the port rounds where flax does (q, k scaled in
# bf16, f32 logits and softmax, weights to bf16, each 1x1 conv's product
# then its bias), so outputs agree but for the f32 logits' summation order:
# at most one bf16 ulp at the top binade (2^-7 of max |ref|) on under 1 %
# of the elements
BF16_ULP = 2.0 ** -7
BF16_DIFFER_SHARE = 0.01
# bf16 UNets: the two packages round some layers at other points (each emb
# dense adds its bias before its one rounding to bf16, where flax rounds
# twice; the pools sum in f32), so their bf16 outputs differ by bf16
# noise: held against the noise of JAX's own bf16 forward against its f32
# one (mean |diff| and max |diff|), measured in the test; both ~2 % here
BF16_NOISE_FACTOR = 1.5
# int8: discontinuous (tests/test_torch_port_int8.py:MODEL_MEAN_TOL)
INT8_MEAN_TOL = 5e-2


def randomized(params, seed, scale=0.05):
    """Every param replaced by seeded noise (the zero-init heads too, which
    would make outputs trivially 0); GroupNorm gains near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if path[-1].key == "scale" else scale * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def jax_init(module, seed, *args, scale=0.05, **kwargs):
    params = jax.jit(lambda *a: module.init(jax.random.key(0), *a, **kwargs))(
        *args)["params"]
    return randomized(params, seed, scale)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def block_state_dict(params):
    """A bare attention block's params under the converter (as stage
    ``mid_1``), with the stage prefix cut."""
    sd = jax_params_to_state_dict({"mid_1": params})
    return {k.split(".", 2)[2]: v for k, v in sd.items()}


# ------------------------------------------------------------ AttentionBlock


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [(6, 5), (3, 4, 5)], ids=["2d", "3d"])
@pytest.mark.parametrize("new_order", [False, True], ids=["legacy", "new"])
def test_attention_block_matches_jax(new_order, tokens, dtype):
    """Both qkv layouts, over 2-D and 3-D tokens, in f32 and bf16."""
    x = np.random.default_rng(3).standard_normal((2,) + tokens + (64,))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = junet.AttentionBlock(num_heads=4, use_new_attention_order=new_order,
                              dtype=jdt)
    xj = jnp.asarray(x, jnp.float32).astype(jdt)
    params = jax_init(jm, 1, xj)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, xj), np.float32)
    block = AttentionBlock(64, num_heads=4, use_new_attention_order=new_order)
    block.load_state_dict(block_state_dict(params), strict=True)
    with torch.no_grad():
        got = block(_t(x).float().to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        diff = np.abs(got - ref)
        assert diff.max() <= BF16_ULP * np.abs(ref).max(), diff.max()
        assert (diff > 0).mean() <= BF16_DIFFER_SHARE


@pytest.mark.parametrize("new_order", [False, True], ids=["legacy", "new"])
def test_attention_block_grad_matches_jax_vjp(new_order):
    """dx and every param gradient against jax.vjp, through the recompute
    (torch.utils.checkpoint) that grad mode takes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 4, 32)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = junet.AttentionBlock(num_heads=2, use_new_attention_order=new_order)
    params = jax_init(jm, 2, jnp.asarray(x), scale=0.2)
    _, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), params,
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    block = AttentionBlock(32, num_heads=2, use_new_attention_order=new_order)
    block.load_state_dict(block_state_dict(params), strict=True)
    xt = _t(x).requires_grad_()
    block(xt).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx),
                               rtol=RTOL, atol=ATOL)
    want = block_state_dict(jax.tree_util.tree_map(np.asarray, dparams))
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# ------------------------------------------------------------ the UNets


def _unet_cfg(dims, variant):
    return dict(
        in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
        # ds 1 and 2: attention in the input, middle and output stages
        attention_resolutions=(1, 2), channel_mult=(1, 2), dims=dims,
        num_heads=2, use_scale_shift_norm=variant != "conv_resample",
        resblock_updown=variant != "conv_resample",
        use_new_attention_order=variant == "new_order",
        num_classes=10 if variant == "new_order" else None,
        middle_attention=True)


@functools.lru_cache(maxsize=None)
def _unet_case(dims, variant):
    cfg = _unet_cfg(dims, variant)
    shape = {1: (2, 16, 3), 2: (2, 8, 6, 3), 3: (1, 3, 8, 8, 3)}[dims]
    rng = np.random.default_rng(dims)
    x = rng.standard_normal(shape).astype(np.float32)
    t = np.array([7, 600][: shape[0]], np.int32)
    y = np.array([3, 9][: shape[0]], np.int32) if cfg["num_classes"] else None
    jm = JaxUNet(**cfg)
    jy = None if y is None else jnp.asarray(y)
    params = jax_init(jm, 5, jnp.asarray(x), jnp.asarray(t), y=jy)
    return cfg, x, t, y, params


def _jax_unet(cfg, params, x, t, y, dtype=jnp.float32):
    jm = JaxUNet(**cfg, dtype=dtype)
    return np.asarray(jax.jit(jm.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t),
        y=None if y is None else jnp.asarray(y)), np.float32)


def _port_unet(cfg, params, dtype=torch.float32, **kw):
    model = UNetModel(**cfg, dtype=dtype, **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _port_forward(model, x, t, y=None):
    with torch.no_grad():
        return model(_t(x), _t(t).long(),
                     y=None if y is None else _t(y).long()).float().numpy()


@pytest.mark.parametrize("dims,variant", [
    (1, "conv_resample"), (2, "resblock_updown"), (2, "new_order"),
    (3, "resblock_updown")])
def test_unet_with_attention_matches_jax(dims, variant):
    """UNetModel with attention at every stage in 1, 2 and 3 dims: the
    stride-2 conv Downsample and the Upsample conv (``conv_resample``), the
    in-block up/down with scale-shift norm, the new qkv order with class
    labels; the state dict loads strictly and names what the JAX exporter
    names."""
    cfg, x, t, y, params = _unet_case(dims, variant)
    ref = _jax_unet(cfg, params, x, t, y)
    model = _port_unet(cfg, params)
    assert set(model.state_dict()) == set(
        params_to_torch_state_dict({"params": params}))
    assert any(isinstance(m, AttentionBlock) for m in model.input_blocks[3])
    got = _port_forward(model, x, t, y)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_unet_bf16_matches_jax_bf16():
    """The bf16 torso (use_fp16) of the 2-D attention UNet against JAX's
    bf16 torso: the port's bf16 forward is as close to JAX's f32 forward as
    JAX's bf16 one is, and the two bf16 forwards differ by no more than
    that bf16 noise; the output is in the input's dtype."""
    cfg, x, t, y, params = _unet_case(2, "resblock_updown")
    ref = _jax_unet(cfg, params, x, t, y, jnp.bfloat16)
    ref32 = _jax_unet(cfg, params, x, t, y)
    model = _port_unet(cfg, params, torch.bfloat16)
    with torch.no_grad():
        out = model(_t(x), _t(t).long())
    assert out.dtype == torch.float32
    out = out.numpy()
    for stat in (np.mean, np.max):
        noise = stat(np.abs(ref - ref32))
        assert noise > 0
        assert stat(np.abs(out - ref32)) <= BF16_NOISE_FACTOR * noise, stat
        assert stat(np.abs(out - ref)) <= BF16_NOISE_FACTOR * noise, stat


SR_CFG = dict(model_channels=32, out_channels=2, num_res_blocks=1,
              attention_resolutions=(), channel_mult=(1, 2), dims=3,
              num_head_channels=16, use_scale_shift_norm=True,
              resblock_updown=True, middle_attention=True)


@functools.lru_cache(maxsize=None)
def _sr_case():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 8, 8, 1)).astype(np.float32)
    low = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([5, 900], np.int32)
    jm = JaxSuperRes(in_channels=1, **SR_CFG)
    params = jax_init(jm, 8, jnp.asarray(x), jnp.asarray(t),
                      low_res=jnp.asarray(low))
    return jm, params, x, low, t


def _port_sr(params, **kw):
    model = SuperResModel(in_channels=1, **SR_CFG, **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _sr_forward(model, x, low, t):
    with torch.no_grad():
        return model(_t(x), _t(t).long(), low_res=_t(low)).numpy()


def test_superres_with_middle_attention_matches_jax():
    """The reference's SuperResModel with middle attention (3-D, 16-channel
    heads), the model of chip_smoke.py's attention phase at a tiny size."""
    jm, params, x, low, t = _sr_case()
    ref = np.asarray(jax.jit(jm.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t),
        low_res=jnp.asarray(low)))
    model = _port_sr(params)
    assert isinstance(model.middle_block[1], AttentionBlock)
    assert model.middle_block[1].num_heads == 4
    got = _sr_forward(model, x, low, t)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ serving paths


def test_fused_attention_model_matches_unfused():
    """Served fused (the fused convs' plain path on the CPU): the attention
    drops the fused stats and the next block recomputes them; the forward
    equals the unfused one."""
    _, params, x, low, t = _sr_case()
    fused = _port_sr(params, fused=True)
    assert sum(m.fusable() for m in fused.modules()
               if isinstance(m, ResBlock)) == 8
    np.testing.assert_allclose(
        _sr_forward(fused, x, low, t), _sr_forward(_port_sr(params), x, low, t),
        rtol=RTOL, atol=ATOL)


def test_2d_model_built_fused_stays_unfused():
    """A 2-D model built with fused=True never reaches the 3-D fused kernel
    (JAX's ``_fusable`` has ``x.ndim == 5``): no block is fusable and the
    forward equals the unfused one."""
    cfg, x, t, y, params = _unet_case(2, "resblock_updown")
    fused = _port_unet(cfg, params, fused=True)
    assert fused.fused
    assert not any(m.fusable() for m in fused.modules()
                   if isinstance(m, ResBlock))
    np.testing.assert_array_equal(_port_forward(fused, x, t),
                                  _port_forward(_port_unet(cfg, params), x, t))


def test_int8_attention_model_matches_jax(monkeypatch):
    """Int8 on an attention model: the quantized sites are JAX's (the sites
    its DDPM3D_INT8_CALIB=1 forward sows: its folded 3-D convs, not the
    attention's 1-D qkv/proj) less the excluded ones, and the forward is
    JAX's DDPM3D_INT8=1 forward within the int8 tolerance. 2-D models have
    no int8 site and refuse a config."""
    jm, params, x, low, t = _sr_case()
    args = (params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(low))
    monkeypatch.setenv("DDPM3D_INT8_CALIB", "1")
    _, muts = jax.jit(lambda p, a, tt, lo: jm.apply(
        {"params": p}, a, tt, low_res=lo, mutable=["quant_calib"]))(*args)
    sown = sorted("/".join(k.key for k in path[:-1]) for path, _ in
                  jax.tree_util.tree_flatten_with_path(muts["quant_calib"])[0])
    monkeypatch.setenv("DDPM3D_INT8_CALIB", "0")
    monkeypatch.setenv("DDPM3D_INT8", "1")
    ref = np.asarray(jax.jit(lambda p, a, tt, lo: jm.apply(
        {"params": p}, a, tt, low_res=lo))(*args))
    model = _port_sr(params, int8=quant.Int8Config())
    sites = sorted(m.site for m in model.modules()
                   if getattr(m, "site", "") and m.int8_active())
    assert not any("mid_1" in s for s in sown)
    assert sites == [s for s in sown
                     if s not in ("unet/in0_0", "unet/head_conv")]
    got = _sr_forward(model, x, low, t)
    assert np.abs(got - ref).mean() <= INT8_MEAN_TOL * np.abs(ref).mean()
    cfg = _unet_cfg(2, "resblock_updown")
    with pytest.raises(ValueError, match="3-D models only"):
        UNetModel(**cfg, int8=quant.Int8Config())


# the card's launches per forward (chip_smoke.py FORWARD_LAUNCHES
# "attention" / "attention_fused"), counted on the plain path: one call of
# each wrapper where the card launches its kernel
ATTENTION_LAUNCHES = {"conv3d": 72, "conv3d_fused": 0, "gn_stats": 72,
                      "gn_apply": 72}
ATTENTION_FUSED_LAUNCHES = {"conv3d": 18, "conv3d_fused": 54, "gn_stats": 33,
                            "gn_apply": 18}


def production_attention_model(**kw):
    """test_DDPM_3d_tpu.sh's model with middle attention: 128 channels,
    (1, 1, 2, 3, 4), 2 res blocks, 64-channel heads, learned sigma."""
    return SuperResModel(
        in_channels=1, model_channels=128, out_channels=2, num_res_blocks=2,
        channel_mult=(1, 1, 2, 3, 4), num_head_channels=64,
        use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=True, **kw).eval()


def test_production_attention_model_launches(monkeypatch):
    """72/72/72 per unfused forward (the no-attention 72/71/71 plus the
    attention's GroupNorm); fused 18/54/33/18 (the no-attention 31/17 plus
    the attention's GroupNorm and the stats of the block after it)."""
    counts = {}

    def counting(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    for mod, name, key in ((conv_ops, "conv3d", "conv3d"),
                           (fused_ops, "conv3d_fused", "conv3d_fused"),
                           (gn_ops, "channel_stats", "gn_stats"),
                           (gn_ops, "gn_apply", "gn_apply")):
        monkeypatch.setattr(mod, name, counting(key, getattr(mod, name)))
    x = torch.zeros((1, 2, 16, 16, 1))
    t = torch.tensor([10])
    for fused, want in ((False, ATTENTION_LAUNCHES),
                        (True, ATTENTION_FUSED_LAUNCHES)):
        counts.update({k: 0 for k in want})
        model = production_attention_model(fused=fused)
        assert model.middle_block[1].num_heads == 8
        with torch.no_grad():
            model(x, t, low_res=x)
        assert counts == want, fused
