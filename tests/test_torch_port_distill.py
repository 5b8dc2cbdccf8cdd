"""The port's progressive distillation against the JAX package's
(``ddpm3d_tpu/training/distill.py``) on the same numpy-seeded inputs (f32,
CPU: the kernels' plain versions behind the same autograd Functions the
card runs).

Covers the halving ladder and the schedules, the two-step targets and the
losses for every mean type with fixed and learned sigma, the student's
gradients through the tiny model against ``jax.grad``, one full step (AdamW,
EMA, the non-finite skip) against the JAX step, the phases of
``progressive_distill``, and the distill CLI whose chain files the serving
CLI reads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm3d_tpu.diffusion import process as jproc
from ddpm3d_tpu.diffusion import schedules as jsched
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.training import distill as jd
from ddpm3d_tpu_torch.data import tiff_io as ttiff
from ddpm3d_tpu_torch.diffusion import process as tproc
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.scripts import distill as distill_cli
from ddpm3d_tpu_torch.scripts import test as serve_cli
from ddpm3d_tpu_torch.training import distill as td
from ddpm3d_tpu_torch.training import train_loop as tl
from ddpm3d_tpu_torch.utils import logger as tlogger
from ddpm3d_tpu_torch.utils.config import (
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict

TINY = dict(
    model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 2), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)
BETAS = jsched.get_named_beta_schedule("linear", 1000)
CHAIN = sorted(jsched.space_timesteps(1000, "8"))  # the teacher's 8 steps
# the x0 target divides by alpha'' - (sig''/sig) alpha: f32 differences in
# the teacher's two steps are amplified, so relative to the largest entry
TARGET_TOL = 1e-4
# whole-model gradients as in tests/test_torch_port_train.py: per tensor,
# max |diff| <= GRAD_TOL * max(max |ref|, ZERO_GRAD_FLOOR * largest)
GRAD_TOL = 1e-4
ZERO_GRAD_FLOOR = 1e-3
MEAN_TYPES = [jproc.MeanType.EPSILON, jproc.MeanType.VELOCITY,
              jproc.MeanType.START_X]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite runs several workers on shared
    cores, where more threads only contend (a CPU distill step and serving
    run took 43 s at 8 threads against 9 s at 2 on a loaded box)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t2n(t):
    return t.detach().numpy()


def _cfgs(mean_type, learned):
    var = (jproc.VarType.LEARNED_RANGE if learned
           else jproc.VarType.FIXED_LARGE)
    jcfg = jproc.DiffusionConfig(mean_type=mean_type, var_type=var,
                                 loss_type=jproc.LossType.MSE,
                                 original_num_steps=1000)
    tcfg = tproc.DiffusionConfig(
        mean_type=tproc.MeanType(mean_type.value),
        var_type=tproc.VarType(var.value), loss_type=tproc.LossType.MSE,
        original_num_steps=1000)
    return jcfg, tcfg


def _scheds(chain=CHAIN):
    return jd.distill_schedules(BETAS, chain), td.distill_schedules(BETAS, chain)


def _toy(a, learned, lib):
    """An analytic denoiser: tanh(a x + 1e-3 t) (and 0.3 a x - 0.2 as the
    variance channel), in jax.numpy or torch."""
    def fn(x, t, **kw):
        tt = (t.astype(jnp.float32) if lib is jnp else t.float()).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        out = lib.tanh(a * x + 1e-3 * tt)
        if learned:
            var = 0.3 * a * x - 0.2
            out = (jnp.concatenate([out, var], -1) if lib is jnp
                   else torch.cat([out, var], -1))
        return out
    return fn


# ------------------------------------------------------------ the ladder


@pytest.mark.parametrize("chain", [list(range(16)), CHAIN, [0, 5, 9, 15],
                                   [1, 2, 3]])
def test_halving_and_schedules_match_jax(chain):
    if len(chain) % 2:
        for halve in (jd.halve_timesteps, td.halve_timesteps):
            with pytest.raises(ValueError, match="must be even"):
                halve(chain)
        return
    assert td.halve_timesteps(chain) == jd.halve_timesteps(chain)
    (jt, js, jts), (tt, ts, tts) = _scheds(chain)
    assert tts == jts
    for ref, got in ((jt, tt), (js, ts)):
        for f in ("alphas_cumprod", "alphas_cumprod_prev",
                  "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "betas", "posterior_log_variance_clipped"):
            np.testing.assert_allclose(t2n(getattr(got, f)),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-6, err_msg=f)
        np.testing.assert_array_equal(t2n(got.timestep_map),
                                      np.asarray(ref.timestep_map))


def test_ladder_validated_before_training():
    """12 -> 6 -> 3 is odd before 2: both raise JAX's message before any
    phase runs (no model is touched)."""
    kw = dict(target_steps=2, steps_per_phase=1,
              start_use_timesteps=list(range(0, 1000, 84)))  # 12 steps
    msgs = []
    for gen in (jd.progressive_distill(None, None, BETAS, None, iter(()), **kw),
                td.progressive_distill(None, BETAS, None, iter(()), **kw)):
        with pytest.raises(ValueError) as e:
            next(gen)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "odd chain length 3" in msgs[0]


# ------------------------------------------------------------ targets, losses


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_distill_targets_match_jax(rng, mean_type, learned):
    """The two-step x0 target from an analytic teacher at student steps 0
    (predecessor acp 1), 2 and 3 (the chain's top), and its conversion to
    the model's parameterization."""
    (jt, js, _), (tt, ts, _) = _scheds()
    jcfg, tcfg = _cfgs(mean_type, learned)
    x_t = rng.standard_normal((3, 2, 4, 4, 1), dtype=np.float32)
    i = np.array([0, 2, 3])
    ref = jd.distill_targets(
        jax.random.key(0), _toy(0.7, learned, jnp), jt, js, jcfg,
        jnp.asarray(x_t), jnp.asarray(i))
    got = td.distill_targets(_toy(0.7, learned, torch), tt, ts, tcfg,
                             torch.from_numpy(x_t), torch.from_numpy(i))
    for r, g in ((ref, got), (
            jd.target_to_model_space(js, mean_type, jnp.asarray(x_t),
                                     jnp.asarray(i), ref),
            td.target_to_model_space(ts, tcfg.mean_type,
                                     torch.from_numpy(x_t),
                                     torch.from_numpy(i), got))):
        r = np.asarray(r)
        err = np.abs(t2n(g) - r).max()
        assert err <= TARGET_TOL * np.abs(r).max(), (err, np.abs(r).max())


@pytest.mark.parametrize("mean_type,learned,vb_weight", [
    (jproc.MeanType.EPSILON, False, 0.0),
    (jproc.MeanType.VELOCITY, True, 0.0),
    (jproc.MeanType.VELOCITY, True, 0.5),
    (jproc.MeanType.START_X, True, 0.1),
])
def test_distill_losses_match_jax(rng, mean_type, learned, vb_weight):
    """mse, vb and loss per example, student and teacher two analytic
    models, on the same i and noise: rtol 1e-5."""
    (jt, js, _), (tt, ts, _) = _scheds()
    jcfg, tcfg = _cfgs(mean_type, learned)
    x0 = np.clip(rng.standard_normal((3, 2, 4, 4, 1)), -1, 1).astype(np.float32)
    noise = rng.standard_normal(x0.shape, dtype=np.float32)
    i = np.array([0, 1, 3])

    def model_apply(variables, x, t, **kw):
        return _toy(variables["params"], learned, jnp)(x, t)

    ref = jd.distill_losses(
        jax.random.key(0), 0.9, 0.7, model_apply, jt, js, jcfg,
        jnp.asarray(x0), jnp.asarray(i), noise=jnp.asarray(noise),
        vb_weight=vb_weight)
    got = td.distill_losses(
        _toy(0.9, learned, torch), _toy(0.7, learned, torch), tt, ts, tcfg,
        torch.from_numpy(x0), torch.from_numpy(i),
        noise=torch.from_numpy(noise), vb_weight=vb_weight)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


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


def _port_model(params):
    model = SuperResModel(in_channels=1, **TINY)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def test_student_gradients_match_jax_grad(rng):
    """The tiny SuperResModel as teacher and (perturbed) student, v-space
    with learned sigma and a VLB term: the mean loss and every student
    gradient against jax.grad of JAX's distill_losses."""
    jm = JaxSuperRes(in_channels=1, **TINY)
    teacher = _random_jax_params(jm, (1, 4, 16, 16, 1), seed=5)
    student = jax.tree_util.tree_map(
        lambda p, q: p + q, teacher, _random_jax_params(
            jm, (1, 4, 16, 16, 1), seed=6))
    (jt, js, _), (tt, ts, _) = _scheds()
    jcfg, tcfg = _cfgs(jproc.MeanType.VELOCITY, True)
    x0 = np.clip(rng.standard_normal((2, 4, 16, 16, 1)), -1, 1).astype(
        np.float32)
    low = rng.standard_normal(x0.shape, dtype=np.float32)
    noise = rng.standard_normal(x0.shape, dtype=np.float32)
    i = np.array([1, 3])

    def jax_loss(p):
        terms = jd.distill_losses(
            jax.random.key(0), p, teacher, jm.apply, jt, js, jcfg,
            jnp.asarray(x0), jnp.asarray(i),
            model_kwargs={"low_res": jnp.asarray(low)},
            noise=jnp.asarray(noise), vb_weight=0.5)
        return jnp.mean(terms["loss"])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(student)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          ref_grads))
    s_model, t_model = _port_model(student), _port_model(teacher)
    t_model.requires_grad_(False)
    loss = torch.mean(td.distill_losses(
        s_model, t_model, tt, ts, tcfg, torch.from_numpy(x0),
        torch.from_numpy(i), model_kwargs={"low_res": torch.from_numpy(low)},
        noise=torch.from_numpy(noise), vb_weight=0.5)["loss"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in s_model.named_parameters()}
    assert sorted(grads) == sorted(ref)
    assert all(p.grad is None for p in t_model.parameters())
    floor = ZERO_GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        err = np.abs(t2n(grads[name]) - r).max()
        assert err <= GRAD_TOL * max(np.abs(r).max(), floor), (
            f"{name}: max |diff| {err} vs max |ref| {np.abs(r).max()}")


# ------------------------------------------------------------ the step


class _Toy(torch.nn.Module):
    """The analytic student tanh(w x + b + 1e-3 t) with parameters w, b."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x, t, **kw):
        tt = t.float().reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.tanh(self.w * x + self.b + 1e-3 * tt)


def test_distill_step_matches_jax_step(rng):
    """Two steps of JAX's make_distill_step (optax.adamw with weight decay,
    EMA 0.9) against distill_step on the same i and noise (drawn from the
    JAX step's keys): student, EMA and Adam moments within 1e-6, metrics
    within rtol 1e-5; then a batch with a NaN: skipped in both, nothing
    moves."""
    (jt, js, _), (tt, ts, _) = _scheds()
    jcfg, tcfg = _cfgs(jproc.MeanType.VELOCITY, False)
    lr, wd, rate = 1e-2, 0.05, 0.9
    init = {"w": np.array([0.8], np.float32), "b": np.array([0.1], np.float32)}
    teacher = {"w": jnp.asarray([0.7]), "b": jnp.asarray([0.0])}

    def model_apply(variables, x, t, **kw):
        p = variables["params"]
        tt_ = t.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.tanh(p["w"] * x + p["b"] + 1e-3 * tt_)

    opt = optax.adamw(lr, weight_decay=wd)
    step_fn = jax.jit(jd.make_distill_step(model_apply, jt, js, jcfg, opt,
                                           ema_rate=rate))
    jstudent = {k: jnp.asarray(v) for k, v in init.items()}
    jema = dict(jstudent)
    jopt = opt.init(jstudent)

    model = _Toy(init["w"], init["b"])
    params = list(model.parameters())
    state = tl.TrainState(step=0, model=model,
                          optimizer=tl.make_optimizer(params, lr, wd),
                          ema_params=[[p.detach().clone() for p in params]])
    t_model = _Toy(np.array([0.7], np.float32), np.zeros(1, np.float32))
    t_model.requires_grad_(False)
    key = jax.random.key(3)
    N = js.num_timesteps
    for step in range(3):
        x0 = np.clip(rng.standard_normal((2, 2, 3, 3, 1)), -1, 1).astype(
            np.float32)
        if step == 2:
            x0[0, 0, 0, 0, 0] = np.nan
        jopt, jstudent, jema, jm = step_fn(
            jopt, jstudent, jema, teacher, jnp.asarray(x0), {}, key, step)
        # the JAX step's own draws of i and the noise
        t_key, l_key = jax.random.split(jax.random.fold_in(key, step))
        i = np.asarray(jax.random.randint(t_key, (2,), 0, N, dtype=jnp.int32))
        noise = np.asarray(jax.random.normal(jax.random.split(l_key)[1],
                                             x0.shape))
        before = [p.detach().clone() for p in params]
        m = td.distill_step(
            state, t_model, tt, ts, tcfg, torch.from_numpy(x0), {},
            torch.from_numpy(i).long(), torch.from_numpy(noise), lr=lr,
            ema_rate=rate)
        assert float(m["skipped_nonfinite"]) == float(jm["skipped_nonfinite"])
        if step == 2:
            assert m["skipped_nonfinite"] == 1.0
            for p, q in zip(params, before):
                assert torch.equal(p, q)
        else:
            for k in ("loss", "mse", "grad_norm"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=1e-5, err_msg=k)
        adam = jopt[0]
        for j, k in enumerate(("w", "b")):
            np.testing.assert_allclose(t2n(params[j]), np.asarray(jstudent[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(t2n(state.ema_params[0][j]),
                                       np.asarray(jema[k]), rtol=1e-6,
                                       atol=1e-7)
            st = state.optimizer.state[params[j]]
            np.testing.assert_allclose(t2n(st["exp_avg"]),
                                       np.asarray(adam.mu[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(t2n(st["exp_avg_sq"]),
                                       np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-9)
    assert tl.applied_updates(state.optimizer) == 2


# ------------------------------------------------------------ phases, CLI


def _tiny_data(seed):
    rng = np.random.default_rng(seed)
    while True:
        x0 = np.clip(rng.standard_normal((1, 2, 4, 4, 1)), -1, 1).astype(
            np.float32)
        yield x0, {"low_res": rng.standard_normal(x0.shape).astype(np.float32)}


def test_progressive_distill_two_phases(tmp_path, monkeypatch):
    """8 -> 4 -> 2 at 2 steps a phase with an EMA: JAX's ladder; each phase
    returns its EMA (not its student), moved from its teacher, and teaches
    the next phase."""
    tlogger.configure(str(tmp_path), format_strs=[])
    _, tcfg = _cfgs(jproc.MeanType.EPSILON, True)
    seen = []
    phase = td.distill_phase

    def spy(teacher, student, *a, **kw):
        before = {k: v.clone() for k, v in teacher.state_dict().items()}
        out = phase(teacher, student, *a, **kw)
        seen.append((before, {k: v.detach().clone() for k, v in
                              td.unwrap(student).state_dict().items()}))
        return out

    monkeypatch.setattr(td, "distill_phase", spy)
    model = SuperResModel(in_channels=1, **TINY)
    init_params(model, seed=3, zero_heads=False)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    phases = list(td.progressive_distill(
        model, BETAS, tcfg, _tiny_data(1), target_steps=2,
        steps_per_phase=2, start_use_timesteps=CHAIN, lr=1e-3,
        ema_rate=0.5, device="cpu"))
    assert [ts for _, ts in phases] == [
        jd.halve_timesteps(CHAIN), jd.halve_timesteps(
            jd.halve_timesteps(CHAIN))]
    teacher = first
    for (weights, _), (taught_by, student) in zip(phases, seen):
        assert sorted(weights) == sorted(teacher)
        for k in weights:
            assert torch.equal(taught_by[k], teacher[k])
        assert any(not torch.equal(weights[k], teacher[k]) for k in weights)
        assert any(not torch.equal(weights[k], student[k]) for k in weights)
        teacher = weights
    for k, v in model.state_dict().items():  # left with the last result
        assert torch.equal(v, phases[-1][0][k])


DISTILL_FLAGS = [
    "--num_channels", "32", "--num_res_blocks", "1", "--learn_sigma", "True",
    "--use_scale_shift_norm", "True", "--resblock_updown", "True",
    "--attention_resolutions", "1000", "--diffusion_steps", "1000",
    "--noise_schedule", "linear", "--use_fp16", "False", "--device", "cpu",
]


def test_distill_cli_writes_chains_that_serve(tmp_path, rng):
    """The distill CLI on a synthetic pair (32^3 patches, 4 -> 2, one
    step): the .pt and the _ts.npy of the phase, the kept steps of JAX's
    ladder; the .pt loads strict=True and the serving CLI runs it on its
    --timesteps_file chain with DDIM. (The loop over phases is
    test_progressive_distill_two_phases'.)"""
    data = tmp_path / "data"
    data.mkdir()
    ttiff.imwrite(str(data / "v.tif"),
                  rng.gamma(2.0, 0.5, (2, 32, 40, 40)).astype(np.float32))
    args = distill_cli.create_argparser().parse_args(
        DISTILL_FLAGS + ["--large_size", "32"])
    model, _, _ = tfactory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(model, seed=2, zero_heads=False)
    teacher = str(tmp_path / "model000100.pt")
    torch.save(model.state_dict(), teacher)
    out = tmp_path / "run"
    distill_cli.main(DISTILL_FLAGS + [
        "--large_size", "32", "--data_dir", str(data), "--model_path",
        teacher, "--result_folder", str(out), "--start_respacing", "4",
        "--target_steps", "2", "--steps_per_phase", "1"])
    assert sorted(os.listdir(out)) == [
        "distilled_2steps.pt", "distilled_2steps_ts.npy", "log.txt",
        "progress.csv"]
    np.testing.assert_array_equal(
        np.load(str(out / "distilled_2steps_ts.npy")),
        jd.halve_timesteps(sorted(jsched.space_timesteps(1000, "4"))))
    log = (out / "log.txt").read_text()
    assert ("sample with --timesteps_file "
            f"{out / 'distilled_2steps_ts.npy'}") in log
    sd = torch.load(str(out / "distilled_2steps.pt"), weights_only=True)
    model.load_state_dict(sd, strict=True)
    vol = str(tmp_path / "vol.tif")
    ttiff.imwrite(vol, rng.gamma(2.0, 0.5, (90, 200, 200)).astype(np.float32))
    served = tmp_path / "served"
    serve_cli.main(DISTILL_FLAGS + [
        "--large_size", "16", "--base_samples", vol, "--batch_size", "18",
        "--model_path", str(out / "distilled_2steps.pt"), "--use_ddim",
        "True", "--timesteps_file", str(out / "distilled_2steps_ts.npy"),
        "--save_dir", str(served)])
    served_log = (served / "log.txt").read_text()
    assert "sampler: DDIM (eta 0.0), 2-step explicit chain" in served_log
    result = np.load(str(served / "denoised_vol.npz"))["arr_0"]
    assert result.shape == (200, 200, 90) and np.isfinite(result).all()
