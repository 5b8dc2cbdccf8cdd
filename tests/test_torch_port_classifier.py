"""The port's classifier (``EncoderUNetModel`` with its four pool heads),
the image-model and classifier factories, the converter's new keys,
classifier guidance (``condition_mean``/``condition_score``, the guided
DDPM and DDIM chains) and the ``classifier_sample`` CLI against the JAX
package, on the same numpy-seeded inputs and params (CPU: the kernels'
plain versions)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.diffusion import process as jproc
from ddpm3d_tpu.diffusion import sampling as jsamp
from ddpm3d_tpu.models import EncoderUNetModel as JaxEncoder
from ddpm3d_tpu.models import UNetModel as JaxUNet
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu.utils import config as jconfig
from ddpm3d_tpu.utils.torch_export import params_to_torch_state_dict
from ddpm3d_tpu_torch.diffusion import process as tproc
from ddpm3d_tpu_torch.diffusion import sampling as tsamp
from ddpm3d_tpu_torch.models import EncoderUNetModel, UNetModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.scripts import classifier_sample as cli
from ddpm3d_tpu_torch.utils import config as tconfig
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict

# f32: as tests/test_torch_port_model.py (sums reordered against XLA)
RTOL, ATOL = 1e-4, 1e-5
# the guidance gradient: a forward and a backward through the classifier
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# a guided chain step by step: the model's 1e-4 times the x0 recovery's
# 1/sqrt(acp) gain, as tests/test_torch_port_model.py's chain
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4
# bf16 classifier: held against the noise of JAX's own bf16 forward
# against its f32 one (tests/test_torch_port_attention.py)
BF16_NOISE_FACTOR = 1.5


def randomized(params, seed, scale=0.05):
    """Every param replaced by seeded noise (the zero-init heads too);
    GroupNorm gains near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if path[-1].key == "scale" else scale * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def _t(a):
    return torch.from_numpy(np.asarray(a))


ENC = dict(in_channels=3, model_channels=32, out_channels=7,
           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_head_channels=16, use_scale_shift_norm=True,
           resblock_updown=True)


@functools.lru_cache(maxsize=None)
def _encoder(pool, dims=2, include_middle=True, shape=(2, 8, 8, 3)):
    cfg = dict(ENC, dims=dims, pool=pool, include_middle=include_middle)
    x = np.random.default_rng(dims).standard_normal(shape).astype(np.float32)
    t = np.array([40, 700], np.int32)
    jm = JaxEncoder(**cfg)
    params = jax.jit(lambda a, tt: jm.init(jax.random.key(0), a, tt))(
        jnp.asarray(x), jnp.asarray(t))["params"]
    params = randomized(params, 3, 0.1)
    return cfg, x, t, params


def _port_encoder(cfg, params, x, dtype=torch.float32):
    model = EncoderUNetModel(**cfg, dtype=dtype, image_size=x.shape[1:-1])
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _jax_logits(cfg, params, x, t, dtype=jnp.float32, **kw):
    jm = JaxEncoder(**cfg, dtype=dtype)
    return jax.jit(functools.partial(jm.apply, **kw))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t))


# ------------------------------------------------------------ the classifier


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial",
                                  "spatial_v2"])
def test_encoder_pools_match_jax(pool):
    """The 2-D encoder with each pool head; the heads' params load strictly
    under the reference names."""
    cfg, x, t, params = _encoder(pool)
    ref = np.asarray(_jax_logits(cfg, params, x, t))
    model = _port_encoder(cfg, params, x)
    head = {"adaptive": {"out.0.weight", "out.0.bias", "out.2.weight",
                         "out.2.bias"},
            "attention": {"out.0.weight", "out.0.bias",
                          "out.2.positional_embedding", "out.2.qkv_proj.weight",
                          "out.2.qkv_proj.bias", "out.2.c_proj.weight",
                          "out.2.c_proj.bias"},
            "spatial": {"out.0.weight", "out.0.bias", "out.2.weight",
                        "out.2.bias"},
            "spatial_v2": {"out.0.weight", "out.0.bias", "out.1.weight",
                           "out.1.bias", "out.3.weight", "out.3.bias"}}[pool]
    assert {k for k in model.state_dict() if k.startswith("out.")} == head
    with torch.no_grad():
        got = model(_t(x), _t(t).long()).numpy()
    assert got.shape == (2, 7) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_encoder_bf16_matches_jax_bf16():
    """The classifier's bf16 torso (classifier_use_fp16) with the attention
    pool: the port's bf16 logits are on average as close to JAX's f32 ones
    as JAX's bf16 logits are, and the two bf16 results differ by no more."""
    cfg, x, t, params = _encoder("attention")
    ref = np.asarray(_jax_logits(cfg, params, x, t, jnp.bfloat16), np.float32)
    ref32 = np.asarray(_jax_logits(cfg, params, x, t))
    with torch.no_grad():
        out = _port_encoder(cfg, params, x, torch.bfloat16)(_t(x), _t(t).long())
    assert out.dtype == torch.bfloat16  # the pool's projections' dtype
    out = out.float().numpy()
    # the mean over the 14 logits: single logits scatter (bf16 noise is not
    # the same logit by logit in the two packages)
    noise = np.abs(ref - ref32).mean()
    assert noise > 0
    assert np.abs(out - ref32).mean() <= BF16_NOISE_FACTOR * noise
    assert np.abs(out - ref).mean() <= BF16_NOISE_FACTOR * noise


def test_encoder_3d_without_middle_and_features():
    """A 3-D encoder on an anisotropic (D, H, W) = (3, 8, 8) input (the
    pool sized from the spatial shape; depth is never pooled),
    ``include_middle=False``: the logits, and ``return_features`` (each
    input stage's output and the last activation, 5-D as JAX returns
    them)."""
    cfg, x, t, params = _encoder("attention", 3, False, (2, 3, 8, 8, 3))
    ref = np.asarray(_jax_logits(cfg, params, x, t))
    ref_feats, ref_h = _jax_logits(cfg, params, x, t, return_features=True)
    model = _port_encoder(cfg, params, x)
    assert not hasattr(model, "middle_block")
    assert model.out[2].positional_embedding.shape == (64, 3 * 4 * 4 + 1)
    with torch.no_grad():
        got = model(_t(x), _t(t).long()).numpy()
        feats, h = model(_t(x), _t(t).long(), return_features=True)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert len(feats) == len(ref_feats) == 4
    for f, rf in zip(feats + [h], list(ref_feats) + [ref_h]):
        assert f.dim() == 5
        np.testing.assert_allclose(f.numpy(), np.asarray(rf),
                                   rtol=RTOL, atol=ATOL)


def test_attention_pool_refuses_other_sizes():
    cfg, x, t, params = _encoder("attention")
    model = _port_encoder(cfg, params, x)
    with pytest.raises(ValueError, match="built for 16 tokens, got 36"):
        model(torch.zeros((1, 12, 12, 3)), torch.zeros((1,), dtype=torch.long))


# ------------------------------------------------------------ factories


def _shapes(module, *args):
    tree = jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a),
                          *args)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  tree)


@pytest.mark.parametrize("which", ["model", "classifier"])
def test_factories_at_cli_defaults_match_jax_shapes(which):
    """At the classifier_sample CLI's defaults (full width), the port's
    model and classifier have JAX's parameters, name for name and shape
    for shape (shapes only: no forward)."""
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.int32)
    if which == "model":
        kw = jconfig.model_and_diffusion_defaults()
        assert tconfig.model_and_diffusion_defaults() == kw
        jm = jfactory.create_model_and_diffusion(**kw)[0]
        tm = tfactory.create_model_and_diffusion(**kw)[0]
        ref = params_to_torch_state_dict(_shapes(jm, x, t))
        assert isinstance(tm, UNetModel) and tm.dims == 2
    else:
        kw = jconfig.classifier_and_diffusion_defaults()
        assert tconfig.classifier_and_diffusion_defaults() == kw
        jm = jfactory.create_classifier_and_diffusion(**kw)[0]
        tm = tfactory.create_classifier_and_diffusion(**kw)[0]
        # the JAX exporter raises on the pool head: the port's converter
        ref = jax_params_to_state_dict(_shapes(jm, x, t))
        assert isinstance(tm, EncoderUNetModel) and tm.pool == "attention"
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in ref.items()}
    assert sum(p.numel() for p in tm.parameters()) == sum(
        v.numel() if hasattr(v, "numel") else v.size for v in ref.values())


def test_factories_tiny_and_channel_mult():
    """The factories at tiny sizes: channel_mult from the image size or the
    flag, dims and in_channels, the classifier's 64-channel heads, the
    schedules equal to JAX's."""
    for size, cm in ((64, ""), (128, ""), (32, "1,2")):
        assert tfactory._parse_channel_mult(cm, size) == \
            jfactory._parse_channel_mult(cm, size)
    with pytest.raises(ValueError, match="unsupported image size"):
        tfactory._parse_channel_mult("", 48)
    m = tfactory.create_model(32, 32, 1, channel_mult="1,2", dims=1,
                              in_channels=2, learn_sigma=True,
                              attention_resolutions="16", num_heads=2)
    assert m.dims == 1 and m.out[2].weight.shape == (4, 32, 3)
    c = tfactory.create_classifier(64, True, 64, 1, "16", True, True,
                                   "adaptive", dims=3, in_channels=1,
                                   out_channels=2)
    assert c.dtype == torch.bfloat16 and c.out[2].weight.shape == (2, 256, 1,
                                                                    1, 1)
    for kw in (dict(timestep_respacing="4"),
               dict(timestep_respacing="ddim5", learn_sigma=True)):
        args = dict(jconfig.classifier_and_diffusion_defaults(), **kw)
        js, jcfg = jfactory.create_classifier_and_diffusion(**args)[1:]
        ts, tcfg = tfactory.create_classifier_and_diffusion(**args)[1:]
        np.testing.assert_array_equal(ts.timestep_map.numpy(),
                                      np.asarray(js.timestep_map))
        assert tcfg.var_type.value == jcfg.var_type.value


def test_converter_maps_every_new_key():
    """Attention blocks under the JAX exporter's names; the heads it has no
    names for under the reference's EncoderUNetModel.out layout, the pool's
    positional embedding transposed to (C, T + 1)."""
    unet = JaxUNet(in_channels=3, model_channels=32, out_channels=3,
                   num_res_blocks=1, attention_resolutions=(2,),
                   channel_mult=(1, 2), dims=2, num_heads=2)
    tree = randomized(_shapes(unet, jnp.zeros((1, 8, 8, 3)),
                              jnp.zeros((1,), jnp.int32)), 1)
    got = jax_params_to_state_dict(tree)
    ref = params_to_torch_state_dict(tree)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert {"middle_block.1.norm.weight", "middle_block.1.qkv.weight",
            "middle_block.1.proj_out.bias"} <= set(got)
    assert got["middle_block.1.qkv.weight"].shape == (192, 64, 1)
    for pool, keys in (
            ("attention", {"head_pool/pos": "out.2.positional_embedding",
                           "head_pool/qkv/kernel": "out.2.qkv_proj.weight",
                           "head_pool/proj/bias": "out.2.c_proj.bias"}),
            ("spatial", {"sp_fc1/kernel": "out.0.weight",
                         "sp_fc2/kernel": "out.2.weight"}),
            ("spatial_v2", {"sp_fc1/bias": "out.0.bias",
                            "sp_norm/scale": "out.1.weight",
                            "sp_fc2/kernel": "out.3.weight"})):
        enc = JaxEncoder(**dict(ENC, dims=2, pool=pool))
        tree = randomized(_shapes(enc, jnp.zeros((1, 8, 8, 3)),
                                  jnp.zeros((1,), jnp.int32)), 2)
        sd = jax_params_to_state_dict(tree)
        for path, key in keys.items():
            leaf = tree
            for part in path.split("/"):
                leaf = leaf[part]
            want = np.asarray(leaf)
            want = want.T if want.ndim == 2 else want
            if want.ndim == 3:  # a 1-D conv kernel (1, in, out)
                want = want.transpose(2, 1, 0)
            np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=path)


# ------------------------------------------------------------ guidance


@pytest.fixture(scope="module")
def sched_pair():
    kw = dict(steps=1000, learn_sigma=True, timestep_respacing="3")
    return (jfactory.create_gaussian_diffusion(**kw),
            tfactory.create_gaussian_diffusion(**kw))


@pytest.mark.parametrize("which", ["mean", "score"])
def test_condition_mean_and_score_match_jax(sched_pair, which):
    """The guided mean (DDPM) and the guided x0-hat and mean (DDIM) against
    JAX's, and cond_fn sees the model's (respaced) timesteps."""
    (js, jcfg), (ts, tcfg) = sched_pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    out = {k: rng.standard_normal(x.shape).astype(np.float32)
           for k in ("mean", "pred_xstart")}
    out["variance"] = rng.uniform(1e-3, 1e-1, x.shape).astype(np.float32)
    t = np.array([0, 1, 2])
    grad = rng.standard_normal(x.shape).astype(np.float32)
    seen = []

    def jfn(xx, tt):
        seen.append(np.asarray(tt))
        return jnp.asarray(grad) * (1.0 + jnp.asarray(tt)[:, None, None, None])

    def tfn(xx, tt):
        seen.append(tt.numpy())
        return _t(grad) * (1.0 + tt[:, None, None, None])

    jf = jproc.condition_mean if which == "mean" else jproc.condition_score
    tf = tproc.condition_mean if which == "mean" else tproc.condition_score
    ref = jf(jfn, js, jcfg, {k: jnp.asarray(v) for k, v in out.items()},
             jnp.asarray(x), jnp.asarray(t))
    got = tf(tfn, ts, tcfg, {k: _t(v) for k, v in out.items()}, _t(x), _t(t))
    np.testing.assert_array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[1], np.asarray(js.timestep_map)[t])
    if which == "mean":
        ref, got = {"mean": ref}, {"mean": got}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_logp_grad(cfg, params, x, t, y, scale):
    """The JAX CLI's cond_fn: grad_x sum log_softmax(logits)[y] * scale."""
    jm = JaxEncoder(**cfg)

    def logp(xx):
        logits = jm.apply({"params": params}, xx, jnp.asarray(t))
        logprobs = jax.nn.log_softmax(logits, axis=-1)
        return jnp.sum(jnp.take_along_axis(logprobs, jnp.asarray(y)[:, None],
                                           axis=1))

    return np.asarray(jax.jit(jax.grad(logp))(jnp.asarray(x))) * scale


@pytest.mark.parametrize("dims", [2, 3])
def test_guidance_gradient_matches_jax_grad(dims):
    """``classifier_sample.guidance`` against jax.grad of the JAX CLI's
    ``logp``: the 2-D attention-pool classifier of the CLI, and a 3-D
    adaptive-pool one (its backward runs the conv dx, the GroupNorm
    backward and the attention's recompute); frozen params get no grad."""
    pool, shape = (("attention", (2, 8, 8, 3)) if dims == 2
                   else ("adaptive", (2, 3, 8, 8, 3)))
    cfg, x, t, params = _encoder(pool, dims, True, shape)
    y = np.array([2, 5])
    ref = _jax_logp_grad(cfg, params, x, t, y, 2.5)
    model = _port_encoder(cfg, params, x).requires_grad_(False)
    with torch.no_grad():  # as the guided chain calls it
        got = cli.guidance(model, _t(y).long(), 2.5)(_t(x), _t(t).long())
    assert np.abs(ref).max() > 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(ref).max())
    assert all(p.grad is None for p in model.parameters())


@functools.lru_cache(maxsize=None)
def _guided_models():
    ucfg = dict(in_channels=3, model_channels=32, out_channels=6,
                num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), dims=2, num_heads=2,
                use_scale_shift_norm=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    jm = JaxUNet(**ucfg)
    uparams = jax.jit(lambda a: jm.init(
        jax.random.key(0), a, jnp.zeros((2,), jnp.int32)))(
            jnp.asarray(x))["params"]
    uparams = randomized(uparams, 10)
    model = UNetModel(**ucfg)
    model.load_state_dict(jax_params_to_state_dict(uparams), strict=True)
    ccfg, _, _, cparams = _encoder("attention")
    classifier = _port_encoder(ccfg, cparams, x).requires_grad_(False)
    return jm, uparams, model.eval(), ccfg, cparams, classifier


@pytest.mark.parametrize("use_ddim", [False, True], ids=["ddpm", "ddim"])
def test_guided_chain_matches_jax_step_by_step(sched_pair, use_ddim):
    """Guided DDPM (condition_mean) and DDIM (condition_score) chains, 3
    steps, against JAX's p_sample_loop / ddim_sample_loop with the CLI's
    cond_fn, on the same x_T, noise stream and labels."""
    (js, jcfg), (ts, tcfg) = sched_pair
    jm, uparams, model, ccfg, cparams, classifier = _guided_models()
    jclf = JaxEncoder(**ccfg)
    rng = np.random.default_rng(12)
    shape = (2, 8, 8, 3)
    x_t = rng.standard_normal(shape).astype(np.float32)
    stream = rng.standard_normal((3,) + shape).astype(np.float32)
    y = np.array([1, 6])
    scale = 3.0

    def jcond(xx, tt, **_):
        def logp(a):
            lp = jax.nn.log_softmax(jclf.apply({"params": cparams}, a, tt), -1)
            return jnp.sum(jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1))
        return jax.grad(logp)(xx) * scale

    jloop = jsamp.ddim_sample_loop if use_ddim else jsamp.p_sample_loop
    _, ref_steps = jloop(
        jax.random.key(0), lambda a, tt, **kw: jm.apply({"params": uparams},
                                                         a, tt),
        js, jcfg, noise=jnp.asarray(x_t), noise_stream=jnp.asarray(stream),
        cond_fn=jcond, return_intermediates=True)
    got_steps = []
    with torch.no_grad():
        tsamp.p_sample_loop(
            lambda a, tt, **kw: model(a, tt), ts, tcfg, noise=_t(x_t),
            noise_stream=_t(stream), device="cpu", use_ddim=use_ddim,
            cond_fn=cli.guidance(classifier, _t(y).long(), scale),
            step_cb=lambda tt, img: got_steps.append(img.numpy()))
    assert len(got_steps) == 3
    for i, (got, ref) in enumerate(zip(got_steps, np.asarray(ref_steps))):
        np.testing.assert_allclose(got, ref, rtol=CHAIN_RTOL,
                                   atol=CHAIN_ATOL, err_msg=f"step {i}")


# ------------------------------------------------------------ the CLI

TINY_FLAGS = ["--device", "cpu", "--image_size", "64", "--num_channels", "32",
              "--num_res_blocks", "1", "--attention_resolutions", "16",
              "--classifier_width", "64", "--classifier_depth", "1",
              "--classifier_attention_resolutions", "16",
              "--timestep_respacing", "2", "--num_samples", "3",
              "--batch_size", "2"]


@pytest.mark.parametrize("use_ddim", ["False", "True"], ids=["ddpm", "ddim"])
def test_cli_writes_samples_and_labels(tmp_path, use_ddim):
    """The CLI on the CPU at a tiny size: (3, 64, 64, 3) finite samples in
    [-1, 1] and 3 labels from the seeded generator; the same flags repeat
    the same file."""
    outs = []
    for run in range(2):
        path = cli.main(TINY_FLAGS + ["--use_ddim", use_ddim, "--seed", "4",
                                      "--save_dir", str(tmp_path / str(run))])
        assert os.path.basename(path) == "samples_3x64x64x3.npz"
        outs.append(np.load(path))
    arr, labels = outs[0]["arr_0"], outs[0]["arr_1"]
    assert arr.shape == (3, 64, 64, 3) and np.isfinite(arr).all()
    assert np.abs(arr).max() <= 1.0 + 1e-6
    gen = torch.Generator().manual_seed(4)
    want = torch.cat([torch.randint(0, 1000, (2,), generator=gen)
                      for _ in range(2)])[:3]
    np.testing.assert_array_equal(labels, want.numpy())
    np.testing.assert_array_equal(arr, outs[1]["arr_0"])


def test_cli_flags_match_jax_cli():
    """The JAX CLI's flags and defaults, plus --device."""
    import importlib.util
    import os.path as osp

    spec = importlib.util.spec_from_file_location(
        "jax_classifier_sample", osp.join(osp.dirname(__file__), "..",
                                          "scripts", "classifier_sample.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    ref = vars(jcli.create_argparser().parse_args([]))
    got = vars(cli.create_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == ref


@pytest.mark.parametrize("mode", ["1", "sim"])
def test_cli_refuses_int8(monkeypatch, capsys, mode):
    """The CLI has no int8 flag: with the JAX CLI's int8 switch
    (``DDPM3D_INT8``) in the environment too, asking for int8 as the
    serving CLI does is a parser error, before any model is built."""
    monkeypatch.setenv("DDPM3D_INT8", mode)
    with pytest.raises(SystemExit) as exc:
        cli.main(TINY_FLAGS + ["--int8", "True"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --int8" in capsys.readouterr().err


def test_f32_convs_and_guidance_run_without_tf32(monkeypatch):
    """A 2-D f32 conv runs with cuDNN's TF32 off whatever the global flag
    says, and puts the flag back; the guidance gradient's backward, which
    runs outside the conv's forward, is under the same guard."""
    from ddpm3d_tpu_torch.models.nn import ConvNd

    seen = []
    conv2d = torch.nn.functional.conv2d

    def probe(*a, **k):
        seen.append(("conv", torch.backends.cudnn.allow_tf32))
        return conv2d(*a, **k)

    class Backward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("backward", torch.backends.cudnn.allow_tf32))
            return g

    monkeypatch.setattr(torch.nn.functional, "conv2d", probe)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    conv = ConvNd(2, 3, 4, 3)
    torch.nn.init.normal_(conv.weight)

    def classifier(x, t):
        return conv(Backward.apply(x)).mean(dim=(1, 2))

    x = torch.randn(2, 6, 6, 3)
    with torch.no_grad():
        conv(x)
    assert seen == [("conv", False)] and torch.backends.cudnn.allow_tf32
    grad = cli.guidance(classifier, torch.tensor([1, 3]), 1.0)(x, None)
    assert grad.shape == x.shape and bool(grad.abs().max() > 0)
    assert seen[1:] == [("conv", False), ("backward", False)]
    assert torch.backends.cudnn.allow_tf32


# one guided step at the CLI defaults, counted on the plain path: one call
# of each wrapper where the card launches its kernel (chip_smoke.py
# GUIDED_LAUNCHES pins the same on the card)
GUIDED_LAUNCHES = {"denoiser_forward": {"gn_stats": 56, "gn_apply": 56},
                   "classifier_forward_backward": {"gn_stats": 41,
                                                   "gn_apply": 41}}


def test_guided_step_launches_at_cli_defaults(monkeypatch):
    """The default 2-D UNet's 56 GroupNorms a forward (its convs,
    attention and denses are PyTorch calls) and the classifier's 41 under
    the guidance gradient (the GN backward is plain torch)."""
    from ddpm3d_tpu_torch.ops import groupnorm as gn_ops

    counts = {}

    def counting(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(gn_ops, "channel_stats",
                        counting("gn_stats", gn_ops.channel_stats))
    monkeypatch.setattr(gn_ops, "gn_apply",
                        counting("gn_apply", gn_ops.gn_apply))
    model = tfactory.create_model_and_diffusion(
        **tconfig.model_and_diffusion_defaults())[0].eval()
    classifier = tfactory.create_classifier(
        **tconfig.classifier_defaults()).eval().requires_grad_(False)
    x = torch.zeros((1, 64, 64, 3))
    t = torch.tensor([10])
    got = {}
    counts.update(gn_stats=0, gn_apply=0)
    with torch.no_grad():
        model(x, t)
    got["denoiser_forward"] = dict(counts)
    counts.update(gn_stats=0, gn_apply=0)
    cli.guidance(classifier, torch.tensor([5]), 1.0)(x, t)
    got["classifier_forward_backward"] = dict(counts)
    assert got == GUIDED_LAUNCHES
