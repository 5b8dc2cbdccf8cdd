"""The port's whole-volume pipeline, CLI and package boundary against the
JAX package (CPU, f32, tiny model)."""

import ast
import copy
import functools
import importlib.util
import json
import os
import os.path as osp
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import diffusion as jdiffusion
from ddpm3d_tpu.data import patches as jpatches
from ddpm3d_tpu.data import tiff_io as jtiff
from ddpm3d_tpu.inference import denoise_volume as jax_denoise_volume
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.models import factory as jfactory
from ddpm3d_tpu.parallel import make_mesh
from ddpm3d_tpu.training.distill import halve_timesteps
from ddpm3d_tpu.utils import torch_export as jtorch_export
from ddpm3d_tpu.utils.config import args_to_dict as jargs_to_dict
from ddpm3d_tpu.utils.config import (
    sr_model_and_diffusion_defaults as jsr_defaults,
)
from ddpm3d_tpu_torch import resolve_device
from ddpm3d_tpu_torch.data import patches as tpatches
from ddpm3d_tpu_torch.data import tiff_io as ttiff
from ddpm3d_tpu_torch.diffusion import p_sample_loop, p_sample_loop_progressive
from ddpm3d_tpu_torch.inference import denoise_patches, denoise_volume
from ddpm3d_tpu_torch.models import SuperResModel, factory as tfactory
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.parallel import make_mesh as tmake_mesh
from ddpm3d_tpu_torch.scripts import classifier_sample as classifier_cli
from ddpm3d_tpu_torch.scripts import test as cli
from ddpm3d_tpu_torch.scripts import distill as distill_cli
from ddpm3d_tpu_torch.scripts import evaluate as evaluate_cli
from ddpm3d_tpu_torch.scripts import train as train_cli
from ddpm3d_tpu_torch.tools import calibrate_int8 as calibrate_cli
from ddpm3d_tpu_torch.tools import (
    e2e_learning_check,
    respacing_debug,
    respacing_study,
    seg_int8_check,
    volume_quality,
)
from ddpm3d_tpu_torch.training import TrainLoop, distill_phase, progressive_distill
from ddpm3d_tpu_torch.utils.config import (
    args_to_dict,
    sr_model_and_diffusion_defaults,
)
from ddpm3d_tpu_torch.utils import logger as tlogger
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
TINY = dict(
    model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 2), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)


@pytest.mark.parametrize("dim,ps,n", [(200, 96, 3), (144, 96, 2), (40, 16, 3),
                                      (96, 96, 1)])
def test_patch_grid_matches_jax(dim, ps, n):
    assert tpatches.test_xy_starts(dim, ps, n) == jpatches.test_xy_starts(dim, ps, n)
    assert tpatches.test_z_starts(dim, ps) == jpatches.test_z_starts(dim, ps)


def test_extract_and_blend_match_jax(rng):
    vol = rng.standard_normal((20, 30, 28), dtype=np.float32)
    grid = tpatches.patch_grid(tpatches.test_xy_starts(30, 16, 3),
                               tpatches.test_xy_starts(28, 16, 2),
                               tpatches.test_z_starts(20, 16))
    assert grid == jpatches.patch_grid(jpatches.test_xy_starts(30, 16, 3),
                                       jpatches.test_xy_starts(28, 16, 2),
                                       jpatches.test_z_starts(20, 16))
    p = tpatches.extract_patches_zxy(vol, grid, 16)
    np.testing.assert_array_equal(p, jpatches.extract_patches_zxy(vol, grid, 16))
    np.testing.assert_array_equal(tpatches.hann_window_3d(16),
                                  jpatches.hann_window_3d(16))
    pxyz = np.transpose(p, (0, 2, 3, 1))
    ref = jpatches.blend_patches_hann(pxyz, grid, (30, 28, 20), 16)
    got = tpatches.blend_patches_hann(pxyz, grid, (30, 28, 20), 16)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (got[ref == 0] == 0).all()  # zero-weight voxels stay 0
    ref_c, unc = jpatches.blend_patches_count(pxyz, grid, (30, 28, 20), 16)
    got_c, unc_t = tpatches.blend_patches_count(pxyz, grid, (30, 28, 20), 16)
    np.testing.assert_array_equal(got_c, ref_c)
    assert unc == unc_t


def test_tiff_roundtrip_with_jax_writer(tmp_path, rng):
    vol = rng.standard_normal((3, 5, 7)).astype(np.float32)
    jtiff._imwrite_builtin(str(tmp_path / "j.tif"), vol)
    np.testing.assert_array_equal(ttiff.imread(str(tmp_path / "j.tif")), vol)
    stack = rng.integers(0, 999, (2, 3, 4, 5)).astype(np.uint16)
    ttiff.imwrite(str(tmp_path / "t.tif"), stack)
    np.testing.assert_array_equal(jtiff._imread_builtin(str(tmp_path / "t.tif")),
                                  stack)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxSuperRes(in_channels=1, **TINY)
    x0 = jnp.zeros((1, 4, 16, 16, 1))
    params = jax.jit(lambda x: jm.init(
        jax.random.key(0), x, jnp.zeros((1,), jnp.int32), low_res=x))(x0)["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (1.0 if path[-1].key == "scale" else 0.0)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32), params)
    model = SuperResModel(in_channels=1, **TINY)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jm, params, model.eval()


def test_denoise_volume_matches_jax(tiny, rng):
    """Explicit x_T and per-step noise for every patch: the blended volume
    equals the JAX pipeline's."""
    jm, params, model = tiny
    kw = dict(steps=1000, learn_sigma=True, timestep_respacing="2")
    js, jcfg = jfactory.create_gaussian_diffusion(**kw)
    ts, tcfg = tfactory.create_gaussian_diffusion(**kw)
    vol = rng.gamma(2.0, 0.5, (12, 24, 24)).astype(np.float32)
    P, T = 4, 2  # 2 x 2 patches of 16^3, Z covered by one
    x_t = rng.standard_normal((P, 16, 16, 16), dtype=np.float32)
    stream = rng.standard_normal((P, T, 16, 16, 16), dtype=np.float32)
    ref, ref_stats = jax_denoise_volume(
        jax.random.key(0), jm.apply, params, js, jcfg, vol, patch_size=16,
        num_xy_patches=2, mesh=make_mesh(), noise=x_t, noise_stream=stream)
    got, stats = denoise_volume(
        model, ts, tcfg, vol, patch_size=16, num_xy_patches=2, batch_size=3,
        noise=x_t, noise_stream=stream, log=lambda _: None, device="cpu")
    assert got.shape == ref.shape == (24, 24, 12)
    assert np.abs(ref).max() > 1e-2
    # chain level: the x0 recovery at t=999 multiplies the model's f32
    # rounding differences by sqrt(1/acp - 1) ~ 158 (the repo's parity
    # harness holds chains to 5e-3 for the same reason); nearly every voxel
    # still agrees to 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-3)
    assert np.mean(np.abs(got - ref) <= 1e-4) > 0.99
    assert stats["noise_reduction_pct"] == pytest.approx(
        ref_stats["noise_reduction_pct"], rel=1e-3)


def _small_volume(rng):
    """A (12, 24, 24) volume: 2 x 2 patches of 16^3."""
    return rng.gamma(2.0, 0.5, (12, 24, 24)).astype(np.float32)


def test_dpm_volume_matches_jax(tiny, rng):
    """DPM-Solver++(2M) from the same x_T through both pipelines: the
    blended volumes agree at test_denoise_volume_matches_jax's tolerances
    (both orders against JAX's sampler: tests/test_torch_port_dpm.py)."""
    jm, params, model = tiny
    kw = dict(steps=1000, learn_sigma=True, timestep_respacing="ddim4")
    js, jcfg = jfactory.create_gaussian_diffusion(**kw)
    ts, tcfg = tfactory.create_gaussian_diffusion(**kw)
    vol = _small_volume(rng)
    x_t = rng.standard_normal((4, 16, 16, 16), dtype=np.float32)
    ref, _ = jax_denoise_volume(
        jax.random.key(0), jm.apply, params, js, jcfg, vol, patch_size=16,
        num_xy_patches=2, mesh=make_mesh(), noise=x_t, use_dpm_solver=True)
    got, _ = denoise_volume(
        model, ts, tcfg, vol, patch_size=16, num_xy_patches=2, batch_size=3,
        noise=x_t, use_dpm_solver=True, log=lambda _: None, device="cpu")
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-3)
    assert np.mean(np.abs(got - ref) <= 1e-4) > 0.99


def test_dpm_order1_volume_is_ddim(tiny, rng):
    """Order 1 through the pipeline is its eta = 0 DDIM chain on the same
    x_T (f32 rounding of equal updates, amplified as in the JAX
    comparison); order 2 is another sampler."""
    _, _, model = tiny
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="ddim4")
    vol = _small_volume(rng)
    x_t = rng.standard_normal((4, 16, 16, 16), dtype=np.float32)
    run = functools.partial(denoise_volume, model, ts, tcfg, vol, noise=x_t,
                            patch_size=16, num_xy_patches=2,
                            log=lambda _: None, device="cpu")
    dpm1, ddim = run(use_dpm_solver=True, dpm_order=1)[0], run(use_ddim=True)[0]
    np.testing.assert_allclose(dpm1, ddim, rtol=1e-3, atol=5e-3)
    assert np.mean(np.abs(dpm1 - ddim) <= 1e-4) > 0.99
    assert not np.allclose(run(use_dpm_solver=True)[0], ddim, atol=1e-3)


def test_dpm_refuses_noise_stream_and_int8(tiny, rng):
    """use_dpm_solver with a per-step noise stream or an int8 model raises
    (the JAX pipeline runs the stochastic chain, or DPM in int8)."""
    _, _, model = tiny
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="2")
    vol = _small_volume(rng)
    x_t = np.zeros((4, 16, 16, 16), np.float32)
    kw = dict(patch_size=16, num_xy_patches=2, log=lambda _: None,
              device="cpu", use_dpm_solver=True)
    with pytest.raises(ValueError, match="x_T only"):
        denoise_volume(model, ts, tcfg, vol, noise=x_t,
                       noise_stream=np.zeros((4, 2, 16, 16, 16), np.float32),
                       **kw)
    with pytest.raises(ValueError, match="x_T only"):
        denoise_volume(model, ts, tcfg, vol,
                       noise_stream=cli.torch_noise_provider(1, 16, 2), **kw)
    int8 = copy.deepcopy(model)
    int8.set_int8(quant.Int8Config())
    with pytest.raises(ValueError, match="int8 model is refused"):
        denoise_volume(int8, ts, tcfg, vol, **kw)


def test_denoise_volume_batch_invariant(tiny, rng):
    """Drawn noise is keyed by (seed, patch index, t): one patch per batch
    and two per batch give the same volume. (The CPU's matmuls round
    differently at another batch size, amplified as in the JAX comparison
    above; the kernels' own batch invariance is exact and is checked on the
    card.)"""
    _, _, model = tiny
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="2")
    vol = rng.gamma(2.0, 0.5, (12, 24, 24)).astype(np.float32)
    outs = [denoise_volume(model, ts, tcfg, vol, seed=3, patch_size=16,
                           num_xy_patches=2, batch_size=b,
                           log=lambda _: None, device="cpu")[0]
            for b in (1, 2)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=5e-3)
    assert np.mean(np.abs(outs[0] - outs[1]) <= 1e-4) > 0.99
    again, _ = denoise_volume(model, ts, tcfg, vol, seed=4, patch_size=16,
                              num_xy_patches=2, batch_size=2,
                              log=lambda _: None, device="cpu")
    assert not np.allclose(again, outs[0])  # the seed matters


CLI_FLAGS = [
    "--large_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--learn_sigma", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--diffusion_steps", "1000", "--timestep_respacing", "2",
    "--device", "cpu",
]


def test_cli_runs_on_cpu(tmp_path, rng):
    """The port's CLI end to end on a contract-shaped volume with a tiny
    .pt checkpoint: random-but-seeded weights, all 18 patches in one batch,
    the reference's torch noise order."""
    args = cli.create_argparser().parse_args(CLI_FLAGS)
    model, _, _ = tfactory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(model, seed=2, zero_heads=False)
    ckpt = str(tmp_path / "model000010.pt")
    torch.save(model.state_dict(), ckpt)
    vol = rng.gamma(2.0, 0.5, (90, 200, 200)).astype(np.float32)
    vol_path = str(tmp_path / "vol.tif")
    ttiff.imwrite(vol_path, vol)
    out_dir = str(tmp_path / "out")
    cli.main(CLI_FLAGS + [
        "--base_samples", vol_path, "--model_path", ckpt,
        "--save_dir", out_dir, "--batch_size", "18",
        "--torch_noise_seed", "10",
    ])
    result = np.load(osp.join(out_dir, "denoised_vol.npz"))["arr_0"]
    assert result.shape == (200, 200, 90)
    assert np.isfinite(result).all() and np.abs(result).max() > 0
    tif = ttiff.imread(osp.join(out_dir, "denoised_vol.tif"))
    np.testing.assert_array_equal(tif, result.transpose(2, 0, 1))


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A contract-shaped volume (200 x 200 x 90: 18 patches of 16^3) and a
    tiny model's ``.pt``, exported from seeded JAX params with the JAX
    package's exporter; both CLIs load the same file."""
    tmp = tmp_path_factory.mktemp("cli")
    args = cli.create_argparser().parse_args(CLI_FLAGS)
    jm, _, _ = jfactory.sr_create_model_and_diffusion(
        **jargs_to_dict(args, jsr_defaults().keys()))
    x0 = jnp.zeros((1, 8, 16, 16, 1))
    params = jax.jit(lambda x: jm.init(
        jax.random.key(0), x, jnp.zeros((1,), jnp.int32), low_res=x))(x0)["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (1.0 if path[-1].key == "scale" else 0.0)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32), params)
    ckpt = str(tmp / "model000010.pt")
    jtorch_export.save_torch_checkpoint(params, ckpt)
    vol = str(tmp / "vol.tif")
    ttiff.imwrite(vol, rng.gamma(2.0, 0.5, (90, 200, 200)).astype(np.float32))
    ts = str(tmp / "distilled_2steps_ts.npy")
    np.save(ts, np.asarray(halve_timesteps(jdiffusion.space_timesteps(
        1000, "4"))))
    return dict(ckpt=ckpt, vol=vol, ts=ts, tmp=tmp)


def _port_cli(case, out, *flags):
    cli.main(CLI_FLAGS + ["--base_samples", case["vol"], "--model_path",
                          case["ckpt"], "--save_dir", out, *flags])
    log = open(osp.join(out, "log.txt")).read()
    return np.load(osp.join(out, "denoised_vol.npz"))["arr_0"], log


def _jax_cli(monkeypatch, case, out, *flags):
    # the JAX CLI builds its checkpoint's target tree by an eager init, one
    # XLA:CPU compile per op (about a minute for this model); the same init
    # under jit gives the same tree in seconds, and the CLI then loads the
    # checkpoint's values into it
    init = JaxSuperRes.init
    monkeypatch.setattr(JaxSuperRes, "init", lambda self, key, *a, **kw:
                        jax.jit(lambda k: init(self, k, *a, **kw))(key))
    spec = importlib.util.spec_from_file_location(
        "ddpm3d_scripts_test_parity", osp.join(REPO, "scripts", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["test.py"] + CLI_FLAGS[:-2] + [
        "--platform", "cpu", "--base_samples", case["vol"], "--model_path",
        case["ckpt"], "--save_dir", out, *flags])
    mod.main()
    return np.load(osp.join(out, "denoised_vol.npz"))["arr_0"]


@pytest.mark.parametrize("chain", ["respacing", "timesteps_file"])
def test_cli_matches_jax_cli(cli_case, monkeypatch, chain):
    """Both serving CLIs on the same volume, checkpoint and
    ``--torch_noise_seed`` (the reference's torch draw order), on the
    ``--timestep_respacing 2`` chain or an explicit 2-step chain that
    ``halve_timesteps`` wrote: the blended volumes agree at
    test_denoise_volume_matches_jax's tolerances."""
    flags = ["--torch_noise_seed", "10"]
    if chain == "timesteps_file":
        flags += ["--timesteps_file", cli_case["ts"]]
    out = str(cli_case["tmp"] / chain)
    # one JAX call of 3 x 8 patches over the 8 CPU devices; 6 per batch here
    ref = _jax_cli(monkeypatch, cli_case, out + "_jax", *flags,
                   "--batch_size", "3")
    got, log = _port_cli(cli_case, out, *flags, "--batch_size", "6")
    assert got.shape == ref.shape == (200, 200, 90)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-3)
    assert np.mean(np.abs(got - ref) <= 1e-4) > 0.99
    if chain == "timesteps_file":
        assert (f"using explicit 2-step chain from {cli_case['ts']}" in log
                and "2-step explicit chain" in log)


def test_cli_dpm_solver_on_cpu(cli_case, tmp_path):
    """--use_dpm_solver reaches the DPM-Solver++(2M) chain: the CLI's volume
    is the pipeline's, drawn from the same seed."""
    got, log = _port_cli(cli_case, str(tmp_path), "--use_dpm_solver", "True",
                         "--timestep_respacing", "ddim4", "--batch_size", "6")
    assert "sampler: DPM-Solver++(2M), 4-step chain" in log
    args = cli.create_argparser().parse_args(CLI_FLAGS)
    model, _, _ = tfactory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    model.load_state_dict(torch.load(cli_case["ckpt"]), strict=True)
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="ddim4")
    ref, _ = denoise_volume(
        model.eval(), ts, tcfg, ttiff.imread(cli_case["vol"]), seed=10,
        patch_size=16, batch_size=6, use_dpm_solver=True,
        log=lambda _: None, device="cpu")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("extra", [
    [], ["--use_ddim", "True"], ["--use_ddim", "True", "--binned"],
    ["--binned"]], ids=["plain", "ddim", "ddim-binned", "binned"])
def test_cli_refuses_int8_dpm(tmp_path, extra):
    """--int8 --use_dpm_solver is refused whatever --use_ddim says, also
    with per-time-bin scales (the JAX gate lets --use_ddim with bins
    through)."""
    scales = str(tmp_path / "scales.json")
    with open(scales, "w") as f:
        json.dump({"scales": {"unet/out0_0": 0.02},
                   "scales_t": {"unet/out0_0": [0.01, 0.02]},
                   "meta": {"time_bins": 2, "chain_steps": 2}}, f)
    if "--binned" in extra:
        extra = [e for e in extra if e != "--binned"] + ["--int8_scales",
                                                         scales]
    with pytest.raises(SystemExit, match="--use_dpm_solver is refused"):
        cli.main(CLI_FLAGS + ["--int8", "True", "--use_dpm_solver", "True",
                              *extra])


def test_cli_refuses_noise_seed_with_dpm():
    with pytest.raises(SystemExit, match="--torch_noise_seed with "
                                         "--use_dpm_solver is refused"):
        cli.main(CLI_FLAGS + ["--torch_noise_seed", "3", "--use_dpm_solver",
                              "True"])


def test_entry_points_never_fall_back_to_cpu(monkeypatch, tiny):
    """With no card, the CLIs (classifier_sample, the int8 calibration tool
    and evaluate among them), the quality tools, the sampler (its
    segments and progressive generator too), the pipeline (under a mesh
    too), make_mesh, the trainer
    (with a named sampler and a blob checkpoint directory too), a trace of
    the card and the distiller raise unless the caller
    asks for the CPU; a model on another device than the chain's is
    refused, not moved."""
    _, _, model = tiny
    ts, tcfg = tfactory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="2")
    vol = np.ones((12, 24, 24), np.float32)
    grid = dict(patch_size=16, num_xy_patches=2, log=lambda _: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(CLI_FLAGS[:-2] + ["--base_samples", "x.tif"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_sample_loop(lambda x, t, **kw: x, ts, tcfg, shape=(1, 4, 4, 4, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_sample_loop(lambda x, t, **kw: x, ts, tcfg, shape=(1, 4, 4, 4, 1),
                      t_hi=1, return_intermediates=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(p_sample_loop_progressive(lambda x, t, **kw: x, ts, tcfg,
                                       shape=(1, 4, 4, 4, 1)))
    for tool, argv in ((e2e_learning_check, []), (respacing_study, []),
                       (respacing_debug, []), (seg_int8_check, []),
                       (volume_quality, ["--eval_low_dir", "a",
                                         "--eval_clean_dir", "b",
                                         "--model_path", "m.pt"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise_volume(model, ts, tcfg, vol, **grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmake_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmake_mesh(n_spatial=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise_patches(model, ts, tcfg, vol[None, :, :16, :16],
                        mesh=tmake_mesh(device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--data_dir", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(model=model, sched=ts, cfg=tcfg, data=iter(()), batch_size=1,
                  microbatch=-1, lr=1e-4, ema_rate="0.9999", log_interval=1,
                  save_interval=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(model=model, sched=ts, cfg=tcfg, data=iter(()), batch_size=1,
                  microbatch=-1, lr=1e-4, ema_rate="0.9999", log_interval=1,
                  save_interval=1, schedule_sampler="loss-second-moment",
                  resume_checkpoint="mem://never/written/model000001.pt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlogger.start_trace(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlogger.start_trace()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distill_cli.main(["--data_dir", "unused", "--model_path", "x.pt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classifier_cli.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_cli.main(["--allow_random"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_cli.main(["--reference", "a.npy", "--test", "b.npy"])
    student = copy.deepcopy(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distill_phase(model, student, np.linspace(1e-4, 2e-2, 1000),
                      [0, 999], tcfg, iter(()), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(progressive_distill(model, np.linspace(1e-4, 2e-2, 1000), tcfg,
                                 iter(()), target_steps=1, steps_per_phase=1,
                                 start_use_timesteps=[0, 999]))
    assert next(model.parameters()).device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    elsewhere = SuperResModel(in_channels=1, **TINY).to("meta")
    with pytest.raises(RuntimeError, match="parameters are on meta"):
        denoise_volume(elsewhere, ts, tcfg, vol, device="cpu", **grid)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _code_strings(path):
    """The string constants of a source file that are not docstrings."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_port_imports_no_jax():
    """ddpm3d_tpu_torch, chip_smoke.py and spatial_split_study.py import no
    jax, flax,
    ddpm3d_tpu or the repository's tools/ (only the tests import both), and
    name no path or module of ddpm3d_tpu outside docstrings (the native
    tier builds its own copy of the C++ source)."""
    files = [osp.join(REPO, "chip_smoke.py"),
             osp.join(REPO, "spatial_split_study.py")]
    for root, _, names in os.walk(osp.join(REPO, "ddpm3d_tpu_torch")):
        files += [osp.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    assert osp.join(REPO, "ddpm3d_tpu_torch", "scripts",
                    "classifier_sample.py") in files
    for tool in ("calibrate_int8", "make_synthetic_data", "e2e_learning_check",
                 "respacing_study", "respacing_debug", "volume_quality",
                 "seg_int8_check"):
        assert osp.join(REPO, "ddpm3d_tpu_torch", "tools",
                        f"{tool}.py") in files
    for new in (("native", "__init__.py"), ("utils", "blobio.py"),
                ("parallel", "mesh.py"), ("parallel", "spatial.py")):
        assert osp.join(REPO, "ddpm3d_tpu_torch", *new) in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "ddpm3d_tpu",
                               "tools"), (
                f"{osp.relpath(path, REPO)} imports {mod}")
        # no path or module name into the JAX package outside docstrings;
        # chip_smoke's "replaces" labels (file:line of a TPU kernel) aside
        for value in _code_strings(path):
            if path.endswith("chip_smoke.py") and re.fullmatch(
                    r"ddpm3d_tpu/[\w/]+\.py:\d+", value):
                continue
            assert not re.search(r"(^|[^\w])ddpm3d_tpu([/.\\]|$)", value), (
                f"{osp.relpath(path, REPO)} names {value!r}")
    for root, _, names in os.walk(osp.join(REPO, "ddpm3d_tpu_torch")):
        for n in names:
            if n.endswith((".cu", ".cuh", ".cpp", ".h")):
                for line in open(osp.join(root, n)):
                    assert not (line.lstrip().startswith("#include")
                                and "ddpm3d_tpu/" in line), (n, line)
    # the native tier builds its own copy of the C++ source
    from ddpm3d_tpu_torch import native

    assert native.SRC == osp.join(REPO, "ddpm3d_tpu_torch", "native",
                                  "ddpm3d_native.cpp")
    assert native.BUILD_DIR == osp.join(REPO, "ddpm3d_tpu_torch", "_build")
