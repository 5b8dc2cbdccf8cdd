"""The port's quality tools (``ddpm3d_tpu_torch/tools``) on the CPU at tiny
sizes: the respacing study's per-setting sampler against the JAX
package's DDIM and DPM-Solver++ loops on converted parameters and one x_T,
the volume harness's coverage and region PSNR against the JAX tool's, and
a short run of each tool (exit 0, the JAX tools' JSON keys, nothing
written under the repository)."""

import contextlib
import functools
import io
import json
import os
import os.path as osp
import runpy
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import diffusion as jd
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch.data import tiff_io
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models.factory import sr_create_model
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.tools import (
    e2e_learning_check,
    make_synthetic_data,
    respacing_debug,
    respacing_study,
    seg_int8_check,
    volume_quality,
)

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
SR = dict(in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
          attention_resolutions=(), channel_mult=(1, 2), dims=3,
          use_scale_shift_norm=True, resblock_updown=True,
          middle_attention=False)
# a chain step by step: the f32 model's 1e-4 (sums reordered against XLA)
# times the x0 recovery's 1/sqrt(acp) gain (tests/test_torch_port_model.py)
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4
# the JAX tools' output keys (tools/e2e_learning_check.py:160-183,
# tools/respacing_study.py:371-384 with the projection column renamed,
# tools/seg_int8_check.py:150-157, 238-246)
E2E_KEYS = ["first_loss", "last_loss", "psnr_noisy_db", "ssim_noisy",
            "ema_rate", "train_steps", "train_time_s", "psnr_raw_db",
            "ssim_raw", "psnr_ema_db", "ssim_ema", "psnr_avg4_db",
            "ssim_avg4"]
ROW_KEYS = ["setting", "steps", "psnr_vs_clean_db", "psnr_vs_clean_db_std",
            "ssim_vs_clean", "ssim_vs_clean_std", "psnr_vs_ddpm1000_db",
            "ssim_vs_ddpm1000", "n_chains", "projected_volume_s",
            "row_wall_s"]
SEG_KEYS = ["psnr_noisy", "psnr_fp", "psnr_int8", "delta_db",
            "psnr_fp_vs_int8", "train_s"]
ENC_KEYS = ["top1_agreement", "max_logit_drift", "mean_logit_drift",
            "acc_fp", "acc_int8", "n_probes", "train_s"]
REPO_OUTPUTS = ("RESPACING.json", "SEG_INT8.json", "VOLUME_QUALITY.json")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The tool runs with tmp_path as its temp dir (its default outputs)
    and working directory; afterwards nothing of the repository's top
    level, its tools or its JSON artifacts changed."""
    def snapshot():
        top = sorted(os.listdir(REPO))
        tools = sorted(n for n in os.listdir(osp.join(
            REPO, "ddpm3d_tpu_torch", "tools")) if n != "__pycache__")
        return top, tools, [os.stat(osp.join(REPO, n)).st_mtime_ns
                            for n in REPO_OUTPUTS]

    before = snapshot()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    assert snapshot() == before


def _quiet(fn, *args):
    """fn(*args) with its stdout captured; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# --------------------------------------------------- the study vs JAX


@functools.lru_cache(maxsize=None)
def _tiny():
    """A tiny f32 SuperResModel with seeded params (the port's state dict,
    carried to JAX), a conditioner and x_T."""
    rng = np.random.default_rng(40)
    model = SuperResModel(**SR)
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    low = rng.standard_normal((1, 4, 8, 8, 1)).astype(np.float32)
    x_t = rng.standard_normal(low.shape).astype(np.float32)
    # the JAX SuperResModel wraps its UNet as ``unet``
    return model.eval(), {"unet": torch_state_dict_to_params(sd)}, low, x_t


@pytest.mark.parametrize("sampler", ["ddim", "dpm2m"])
def test_study_setting_matches_jax(sampler):
    """The study's ``ddim10`` and ``dpm2m10`` rows (``sample_setting``: the
    linear 1000-step schedule respaced by DDIM's stride, eps prediction,
    learned range) from one x_T: JAX's ``ddim_sample_loop`` (eta 0) and
    ``dpm_solver_pp_sample_loop`` (order 2) on the same parameters; both
    deterministic given x_T."""
    model, params, low, x_t = _tiny()
    betas = respacing_study.linear_beta_schedule(respacing_study.T)
    cfg = respacing_study.DiffusionConfig(
        respacing_study.MeanType.EPSILON, respacing_study.VarType.LEARNED_RANGE,
        respacing_study.LossType.MSE, original_num_steps=1000)
    with torch.no_grad():
        got = respacing_study.sample_setting(
            model, betas, cfg, "ddim10", sampler, torch.from_numpy(low),
            torch.from_numpy(x_t), device="cpu").numpy()
    jm = JaxSuperRes(**SR)
    js = jd.make_spaced_schedule(
        jd.linear_beta_schedule(1000),
        sorted(jd.space_timesteps(1000, "ddim10")))
    jcfg = jd.DiffusionConfig(jd.MeanType.EPSILON, jd.VarType.LEARNED_RANGE,
                              jd.LossType.MSE, original_num_steps=1000)
    fn = lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw)  # noqa: E731
    kw = dict(noise=jnp.asarray(x_t), model_kwargs={"low_res": jnp.asarray(low)})
    if sampler == "ddim":
        ref = jd.ddim_sample_loop(jax.random.key(7), fn, js, jcfg, eta=0.0, **kw)
    else:
        ref = jd.dpm_solver_pp_sample_loop(jax.random.key(7), fn, js, jcfg,
                                           order=2, **kw)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_study_settings_table_is_jax():
    """The 13 rows, their respacings and samplers, in the JAX tool's order;
    the int8 study refuses DPM-Solver++ rows (serving refuses them)."""
    table = respacing_study.settings_table()
    assert [n for n, *_ in table] == [
        "ddpm1000", "ddpm250", "ddpm100", "ddpm50", "ddpm25", "ddim250",
        "ddim100", "ddim50", "ddim25", "ddim10", "dpm2m50", "dpm2m25",
        "dpm2m10"]
    assert table[0][1] == "1000" and table[1][1] == "250"
    assert table[5][1:] == ("ddim250", "ddim") and table[-1][1:] == (
        "ddim10", "dpm2m")
    with pytest.raises(SystemExit, match="inference-only"):
        respacing_study.main(["--int8", "--device", "cpu"])


# ------------------------------------------------- the volume harness


def test_coverage_and_region_psnr_match_jax():
    """The seam / interior split and the region PSNR of the JAX tool."""
    ns = runpy.run_path(osp.join(REPO, "tools", "volume_quality.py"),
                        run_name="tool")
    for shape, p in (((100, 200, 200), 96), ((90, 200, 200), 16)):
        np.testing.assert_array_equal(
            volume_quality.coverage_mask(shape, p, 3),
            ns["coverage_mask"](shape, p, 3))
    rng = np.random.default_rng(3)
    a, b = rng.random((6, 7, 8)), rng.random((6, 7, 8))
    mask = rng.random((6, 7, 8)) > 0.5
    assert volume_quality.region_psnr(a, b, mask, 1.0) == ns["region_psnr"](
        a, b, mask, 1.0)
    assert volume_quality.region_psnr(a, b, mask & False, 1.0) is None
    assert volume_quality.parse_config("ddim25:int8@4", 8) == (
        "ddim", 25, "int8", 4)
    with pytest.raises(ValueError, match="bad config"):
        volume_quality.parse_config("dpm25:bf16", 8)


# ------------------------------------------------------- tiny runs


def test_make_synthetic_data_cli(in_tmp):
    """Two 2-channel volumes through the port's TIFF writer, read back as
    written (the JAX tool's arrays: tests/test_torch_port_chain_segments)."""
    paths, _ = _quiet(make_synthetic_data.main,
                      ["syn", "--volumes", "2", "--shape", "4", "6", "8",
                       "--seed", "3"])
    rng = np.random.default_rng(3)
    for p in paths:
        assert p.startswith("syn") and osp.exists(in_tmp / p)
        np.testing.assert_array_equal(
            tiff_io.imread(str(in_tmp / p)),
            make_synthetic_data.make_volume(rng, (4, 6, 8)))


def test_e2e_learning_check_cpu(in_tmp):
    """The check at a tiny size: it runs, prints the JAX tool's JSON keys
    and its verdict, and exits 0 only on a pass."""
    rc, text = _quiet(e2e_learning_check.main, [
        "--device", "cpu", "--steps", "3", "--size", "8", "--batch", "2",
        "--diffusion_steps", "8", "--sample_respace", "ddim4"])
    result = json.loads([ln for ln in text.splitlines()
                         if ln.startswith("{")][-1])
    assert list(result) == E2E_KEYS
    passed = "E2E LEARNING CHECK: PASS" in text
    assert passed or "E2E LEARNING CHECK: FAIL" in text
    assert rc == (0 if passed else 1)
    assert all(np.isfinite(v) for v in result.values())


def test_respacing_study_and_debug_cpu(in_tmp, monkeypatch):
    """The study trains, saves its EMA .pt under the temp dir and writes
    its JSON there (rows with JAX's keys, the measured step time as the
    flagship's); it reloads the .pt in int8, and to distill it (the
    teacher's and the student's DDIM rows); respacing_debug reads the
    default checkpoint (its chains shortened) and fills every section."""
    base = ["--device", "cpu", "--size", "8", "--batch", "2", "--n_eval", "1"]
    result, _ = _quiet(respacing_study.main, base + [
        "--train_steps", "2", "--settings", "ddim10,dpm2m10"])
    ckpt = in_tmp / "respacing_ckpt.pt"
    assert ckpt.exists() and (in_tmp / "RESPACING.json").exists()
    rows = result["rows"]
    assert [r["setting"] for r in rows] == ["ddim10", "dpm2m10"]
    for r in rows:
        assert all(k in r for k in ROW_KEYS) and np.isfinite(r["ms_per_step"])
    assert np.isfinite(result["protocol"]["flagship_per_step_ms"])
    assert "measured" in result["protocol"]["per_step_ms_source"]
    assert result["protocol"]["train_steps_this_run"] == 2
    q, _ = _quiet(respacing_study.main, base + [
        "--int8", "--load_ckpt", str(ckpt), "--settings", "ddim10",
        "--per_step_ms", "50", "--out", "int8.json"])
    assert q["protocol"]["int8"] == "int8" and q["protocol"][
        "flagship_per_step_ms"] == 50.0
    assert q["rows"][0]["projected_volume_s"] == round(10 * 50 / 1000 * 18, 1)
    d, _ = _quiet(respacing_study.main, base + [
        "--load_ckpt", str(ckpt), "--settings", "ddim10", "--distill_target",
        "2", "--distill_start", "4", "--distill_steps_per_phase", "1",
        "--out", "distill.json"])
    assert [r["setting"] for r in d["rows"]] == [
        "ddim10", "teacher4-ddim", "dist2-ddim"]
    assert d["protocol"]["distill"]["target"] == 2
    monkeypatch.setattr(respacing_debug, "T_POINTS", (5, 990))
    monkeypatch.setattr(respacing_debug, "CHAINS", (
        ("ddpm10", "10", False), ("ddim10", "ddim10", True)))
    monkeypatch.setattr(respacing_debug, "TRUNCATED", (3, 6))
    debug, text = _quiet(respacing_debug.main, ["--device", "cpu",
                                                "--size", "8"])
    assert [r["t"] for r in debug["teacher"]] == [5, 990]
    assert sorted(debug["chains"]) == ["ddim10", "ddpm10"]
    assert sorted(debug["truncated"]) == ["3", "6"]
    for section in ("chains", "truncated"):
        for r in debug[section].values():
            assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
    assert "t0=   6" in text


def test_volume_quality_cpu(in_tmp, monkeypatch):
    """The harness on a study-shaped checkpoint through the serving CLI
    (a subprocess) on two 90 x 200 x 200 volumes at 16^3 patches, int8,
    one step: outputs of the input's shape, both volumes' walls parsed
    from the CLI's multi-volume lines, the JAX tool's result keys; a
    --score_only rerun resumes from the TIFFs and samples nothing."""
    # the serving CLI's process takes two threads, as this file's tests
    # do: by default it takes every core the suite's workers share
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    vol = make_synthetic_data.make_volume(np.random.default_rng(0),
                                          (90, 200, 200))
    for sub, ch in (("low", 0), ("clean", 1)):
        os.makedirs(sub)
        for name in ("a.tif", "b.tif"):
            tiff_io.imwrite(osp.join(sub, name), vol[ch])
    model = sr_create_model(
        large_size=16, small_size=16, num_channels=32, num_res_blocks=1,
        learn_sigma=True, class_cond=False, use_checkpoint=False,
        attention_resolutions="1000", num_heads=4, num_head_channels=64,
        num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
        resblock_updown=True, use_fp16=True)
    torch.save(model.state_dict(), "m.pt")
    argv = ["--eval_low_dir", "low", "--eval_clean_dir", "clean",
            "--model_path", "m.pt", "--patch_size", "16", "--num_channels",
            "32", "--num_res_blocks", "1", "--predict_v", "False",
            "--device", "cpu"]
    out, _ = _quiet(volume_quality.main, argv + ["--configs", "ddpm1:int8@2"])
    assert (in_tmp / "VOLUME_QUALITY.json").exists()
    res = out["results"]
    row = res["ddpm1:int8"]
    assert row["n_volumes"] == 2
    for k in ("psnr_db", "ssim", "psnr_interior_db", "psnr_seam_db",
              "seam_minus_interior_db", "n_volumes"):
        assert k in row and k in res["noisy_input"]
    assert row["sampling_wall_s_mean"] > 0
    with open(in_tmp / "volume_quality" / "ddpm1_int8" / "walls.json") as f:
        walls = json.load(f)
    assert sorted(walls) == ["a", "b"]
    den = tiff_io.imread(str(in_tmp / "volume_quality" / "ddpm1_int8" /
                             "denoised_a.tif"))
    assert den.shape == (90, 200, 200) and np.isfinite(den).all()
    assert out["protocol"]["pipeline"].startswith(
        "python -m ddpm3d_tpu_torch.scripts.test")
    again, text = _quiet(volume_quality.main, argv + [
        "--configs", "ddpm1:int8@2,ddpm2:bf16@1", "--score_only"])
    # (no seam at 16^3 patches on 200 voxels: NaN rows, compared as JSON)
    assert json.dumps(again["results"]["ddpm1:int8"]) == json.dumps(row)
    assert "ddpm2:bf16" not in again["results"]
    assert "no volumes scored" in text


def test_seg_int8_check_cpu(in_tmp):
    """Each fusion and the encoder at a tiny size: rows with the JAX
    tool's keys, finite, the JSON under the temp dir."""
    out, _ = _quiet(seg_int8_check.main, [
        "--device", "cpu", "--steps", "1", "--size", "8", "--n_eval", "1",
        "--respace", "2", "--batch", "2"])
    assert sorted(out["fusions"]) == ["add", "cat_conv", "midcat"]
    for row in out["fusions"].values():
        assert list(row) == SEG_KEYS
        assert all(np.isfinite(v) for v in row.values())
    assert list(out["encoder"]) == ENC_KEYS
    assert out["encoder"]["n_probes"] == 3
    with open(in_tmp / "SEG_INT8.json") as f:
        assert json.load(f)["encoder"] == out["encoder"]
