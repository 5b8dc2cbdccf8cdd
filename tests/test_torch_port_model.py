"""The port's schedules, process math, weight conversion, UNet forward and
sampling chain against the JAX package, on the same numpy-seeded inputs
(f32, CPU: the kernels' plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.diffusion import process as jproc
from ddpm3d_tpu.diffusion import sampling as jsamp
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu.models import nn as jnn
from ddpm3d_tpu.utils.torch_export import params_to_torch_state_dict
from ddpm3d_tpu_torch.diffusion import process as tproc
from ddpm3d_tpu_torch.diffusion import sampling as tsamp
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.models import nn as tnn
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

TINY = dict(
    model_channels=32,
    out_channels=2,
    num_res_blocks=1,
    attention_resolutions=(),
    channel_mult=(1, 2),
    dims=3,
    use_scale_shift_norm=True,
    resblock_updown=True,
    middle_attention=False,
)
# f32 forward through ~10 conv/GN layers, sums reordered against XLA
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5


def randomized_jax_params(model, x_shape, seed):
    """Init, then replace EVERY param (including the zero-init output convs,
    which would make both outputs exactly 0) with seeded noise."""
    x0 = jnp.zeros(x_shape)
    init = jax.jit(lambda x: model.init(
        jax.random.key(0), x, jnp.zeros((x_shape[0],), jnp.int32), low_res=x))
    params = init(x0)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":  # GroupNorm gains
            return 1.0 + 0.1 * noise
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(fill, params)


def port_model(params, **cfg):
    model = SuperResModel(in_channels=1, **cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    jm = JaxSuperRes(in_channels=1, **TINY)
    params = randomized_jax_params(jm, (1, 4, 16, 16, 1), seed=1)
    return jm, params, port_model(params, **TINY)


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("noise_schedule", ["linear", "cosine"])
@pytest.mark.parametrize("respacing", ["", "25", "ddim10", "10,5"])
def test_schedules_equal_exactly(noise_schedule, respacing):
    kw = dict(steps=1000, learn_sigma=True, noise_schedule=noise_schedule,
              timestep_respacing=respacing)
    js, jcfg = jfactory.create_gaussian_diffusion(**kw)
    ts, tcfg = tfactory.create_gaussian_diffusion(**kw)
    for name in js._fields:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=name)
    assert tcfg.mean_type.value == jcfg.mean_type.value
    assert tcfg.var_type.value == jcfg.var_type.value
    assert tcfg.original_num_steps == jcfg.original_num_steps


@pytest.mark.parametrize("mean_type", list(jproc.MeanType))
@pytest.mark.parametrize("var_type", list(jproc.VarType))
def test_p_mean_variance_all_modes(rng, mean_type, var_type):
    steps = 1000
    js, _ = jfactory.create_gaussian_diffusion(steps=steps, timestep_respacing="10")
    ts, _ = tfactory.create_gaussian_diffusion(steps=steps, timestep_respacing="10")
    jcfg = jproc.DiffusionConfig(mean_type, var_type, original_num_steps=steps)
    tcfg = tproc.DiffusionConfig(
        tproc.MeanType(mean_type.value), tproc.VarType(var_type.value),
        original_num_steps=steps)
    learned = var_type in (jproc.VarType.LEARNED, jproc.VarType.LEARNED_RANGE)
    x = rng.standard_normal((3, 2, 3, 4, 1), dtype=np.float32)
    out = rng.uniform(-1, 1, (3, 2, 3, 4, 2 if learned else 1)).astype(np.float32)
    t = np.array([0, 4, 9])
    seen_t = []

    def jfn(xx, tt):
        seen_t.append(np.asarray(tt))
        return jnp.asarray(out)

    def tfn(xx, tt):
        seen_t.append(tt.numpy())
        return torch.from_numpy(out)

    ref = jproc.p_mean_variance(jfn, js, jcfg, jnp.asarray(x), jnp.asarray(t))
    got = tproc.p_mean_variance(tfn, ts, tcfg, torch.from_numpy(x),
                                torch.from_numpy(t))
    np.testing.assert_array_equal(seen_t[0], seen_t[1])  # original-chain t
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 500, 999])
    ref = np.asarray(jnn.timestep_embedding(jnp.asarray(t), dim))
    got = tnn.timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-6)


def test_weight_conversion_matches_exporter(tiny):
    _, params, model = tiny
    ref = params_to_torch_state_dict({"params": params})
    got = jax_params_to_state_dict({"params": params})
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(model.state_dict()) == set(got)  # loaded with strict=True


def test_param_count_matches_jax_production_wiring():
    """The production wiring (channel_mult (1,1,2,3,4), 2 res blocks,
    learned sigma, resblock up/down) at a narrow width: same parameter count
    and the same names and shapes as the JAX factory's model."""
    kw = dict(large_size=96, small_size=64, num_channels=32, num_res_blocks=2,
              learn_sigma=True, class_cond=False, use_checkpoint=False,
              attention_resolutions="1000", num_heads=1, num_head_channels=64,
              num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
              resblock_updown=True, use_fp16=True)
    jm = jfactory.sr_create_model(**kw)
    x0 = jax.ShapeDtypeStruct((1, 4, 16, 16, 1), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jm.init(jax.random.key(0), x, jnp.zeros((1,), jnp.int32),
                          low_res=x), x0)["params"]
    ref = params_to_torch_state_dict(
        {"params": jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)})
    tm = tfactory.sr_create_model(**kw)
    assert tm.dtype == torch.bfloat16
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == {k: v.shape for k, v in ref.items()}
    assert sum(p.numel() for p in tm.parameters()) == sum(
        v.size for v in ref.values())


@pytest.mark.parametrize("variant", ["production", "conv_resample"])
def test_forward_matches_jax(rng, tiny, variant):
    """SuperResModel forward, all params randomized. ``conv_resample``
    exercises the Downsample/Upsample conv blocks and the additive
    (non-scale-shift) timestep conditioning."""
    if variant == "production":
        jm, params, model = tiny
        shape = (2, 8, 16, 16, 1)
    else:
        cfg = dict(TINY, resblock_updown=False, use_scale_shift_norm=False)
        jm = JaxSuperRes(in_channels=1, **cfg)
        params = randomized_jax_params(jm, (1, 4, 8, 8, 1), seed=2)
        model = port_model(params, **cfg)
        shape = (1, 5, 8, 6, 1)
    x = rng.standard_normal(shape, dtype=np.float32)
    low = rng.standard_normal(shape, dtype=np.float32)
    t = np.array([3, 11][: shape[0]])
    ref = np.asarray(jax.jit(jm.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t),
        low_res=jnp.asarray(low)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    low_res=torch.from_numpy(low)).numpy()
    assert np.abs(ref).max() > 1e-3  # non-trivial output
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_bf16_torso_forward_runs(rng, tiny):
    """use_fp16: bf16 torso, f32 head; output in the input's dtype."""
    _, params, _ = tiny
    model = port_model(params, **dict(TINY, dtype=torch.bfloat16))
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 1), dtype=np.float32))
    with torch.no_grad():
        out = model(x, torch.tensor([5]), low_res=x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# ---------------------------------------------------------------- chain


def test_three_step_chain_matches_jax_step_by_step(rng, tiny):
    jm, params, model = tiny
    js, jcfg = jfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="3")
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="3")
    shape = (2, 4, 8, 8, 1)
    x_t = rng.standard_normal(shape, dtype=np.float32)
    stream = rng.standard_normal((3,) + shape, dtype=np.float32)
    low = rng.standard_normal(shape, dtype=np.float32)

    _, ref_steps = jsamp.p_sample_loop(
        jax.random.key(0),
        lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw),
        js, jcfg, noise=jnp.asarray(x_t), noise_stream=jnp.asarray(stream),
        model_kwargs={"low_res": jnp.asarray(low)}, return_intermediates=True)
    got_steps = []
    with torch.no_grad():
        final = tsamp.p_sample_loop(
            lambda x, t, **kw: model(x, t, **kw), ts, tcfg,
            noise=torch.from_numpy(x_t), noise_stream=torch.from_numpy(stream),
            model_kwargs={"low_res": torch.from_numpy(low)}, device="cpu",
            step_cb=lambda t, img: got_steps.append(img.numpy()))
    assert len(got_steps) == 3
    for i, (got, ref) in enumerate(zip(got_steps, np.asarray(ref_steps))):
        # model error (1e-4 rel) times the x0 recovery's 1/sqrt(acp) gain
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(final.numpy(), got_steps[-1])


def test_drawn_noise_is_keyed_per_sample():
    """Without explicit noise each sample's draws depend on (seed, id, t)
    only: sample 1 of a batch equals that id drawn alone."""
    both = tsamp.step_noise(7, [0, 1], 5, (2, 3), torch.device("cpu"))
    alone = tsamp.step_noise(7, [1], 5, (2, 3), torch.device("cpu"))
    torch.testing.assert_close(both[1], alone[0], rtol=0, atol=0)
    other_t = tsamp.step_noise(7, [1], 4, (2, 3), torch.device("cpu"))
    assert not torch.equal(alone, other_t)
