"""The port's volume metrics and evaluate CLI against the JAX package's
(``ddpm3d_tpu/utils/metrics.py``, ``scripts/evaluate.py``) on numpy-seeded
volumes, and the new entry points' refusal to fall back to the CPU."""

import contextlib
import io
import json
import os.path as osp
import runpy
import sys

import numpy as np
import pytest
import torch

from ddpm3d_tpu.utils import metrics as jmetrics
from ddpm3d_tpu_torch.data import tiff_io
from ddpm3d_tpu_torch.scripts import evaluate
from ddpm3d_tpu_torch.tools import calibrate_int8
from ddpm3d_tpu_torch.utils import metrics


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
# float64 in both packages: the same formulas, summed in other orders
METRIC_TOL = 1e-10
CLI_TOL = 1e-9


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=shape)
    return x, np.clip(x + rng.normal(0, 0.1, shape), 0, 1)


# the arrays of each case; "thin_*" have an axis of 3 voxels or fewer
# (the 7-wide window's pad is wider than the axis: np.pad reflects again,
# and repeats the one value of a 1-voxel axis), "blank" a constant
# reference (data_range None is 0: psnr is -inf)
SHAPES = {"2d": (12, 12), "2d_ragged": (9, 13), "3d": (10, 12, 14),
          "3d_small": (7, 8, 9), "thin_3": (3, 16, 16), "thin_2": (2, 20, 20),
          "thin_1": (1, 12, 12), "blank": (6, 8, 10)}


def _close(got, want, tol):
    """Within tol relative (at least absolute), or the same infinity."""
    if np.isinf(want):
        return got == want
    return abs(got - want) <= tol * max(1.0, abs(want))


@pytest.mark.parametrize("data_range", [None, 1.0])
@pytest.mark.parametrize("case", list(SHAPES))
def test_metrics_match_jax(case, data_range):
    """psnr, ssim (reflect-padded 7-wide box, n / (n - 1)) and
    volume_report in 2-D and 3-D, on numpy arrays and float64 tensors."""
    shape = SHAPES[case]
    x, y = _pair(shape, len(shape) * 10 + shape[0])
    if case == "blank":
        x = np.full(shape, 0.5)
    ref = jmetrics.volume_report(x, y, data_range)
    got = metrics.volume_report(x, y, data_range)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert _close(got[k], v, METRIC_TOL), k
    assert abs(metrics.ssim(torch.from_numpy(x), torch.from_numpy(y),
                            data_range) - ref["ssim"]) <= METRIC_TOL
    want = jmetrics.psnr(x, y, data_range)
    got_psnr = metrics.psnr(x, y, data_range)
    assert (got_psnr == want if np.isinf(want) else
            abs(got_psnr - want) <= METRIC_TOL * abs(ref["psnr_db"]))
    assert metrics.psnr(x, x) == float("inf")
    if case != "blank":  # 0 / 0 in both packages
        np.testing.assert_allclose(metrics.ssim(x, x), 1.0, atol=1e-12)


def test_box_filter_matches_jax():
    """The reflect padding of the box filter (F.pad "reflect" = np.pad
    "reflect": the edge not repeated), on every axis of a 3-D array."""
    x = np.random.default_rng(5).standard_normal((8, 9, 10))
    np.testing.assert_allclose(
        metrics._uniform_filter(torch.from_numpy(x), 7).numpy(),
        jmetrics._uniform_filter(x, 7), rtol=0, atol=METRIC_TOL)


def _jax_cli(argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["evaluate.py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(osp.join(REPO, "scripts", "evaluate.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _port_cli(argv, capsys):
    evaluate.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    """The CLI against scripts/evaluate.py on the same files: a .tif
    reference against a denoised .npz ((H, W, Z), the auto layout), a .tif,
    and .npy with --data_range and an explicit layout; one JSON line each,
    equal within CLI_TOL; a shape mismatch exits in both."""
    clean, noisy = _pair((6, 20, 24), 9)
    clean, noisy = clean.astype(np.float32), noisy.astype(np.float32)
    ref_tif, test_tif = str(tmp_path / "clean.tif"), str(tmp_path / "n.tif")
    tiff_io.imwrite(ref_tif, clean)
    tiff_io.imwrite(test_tif, noisy)
    test_npz = str(tmp_path / "denoised.npz")
    np.savez(test_npz, noisy.transpose(1, 2, 0))
    ref_npy, test_npy = str(tmp_path / "c.npy"), str(tmp_path / "n.npy")
    np.save(ref_npy, clean)
    np.save(test_npy, noisy)
    cases = [["--reference", ref_tif, "--test", test_npz],
             ["--reference", ref_tif, "--test", test_tif],
             ["--reference", ref_npy, "--test", test_npy, "--data_range",
              "2.0", "--test_layout", "zhw"]]
    for argv in cases:
        ref = _jax_cli(argv)
        got = _port_cli(argv, capsys)
        assert set(got) == set(ref) and got["shape"] == ref["shape"]
        for k in ("psnr_db", "ssim", "mae", "rmse"):
            assert abs(got[k] - ref[k]) <= CLI_TOL * max(1.0, abs(ref[k])), (
                argv, k)
    bad = ["--reference", ref_tif, "--test", test_npz, "--test_layout", "zhw"]
    with pytest.raises(SystemExit, match="shape mismatch"):
        _jax_cli(bad)
    with pytest.raises(SystemExit, match="shape mismatch"):
        evaluate.main(bad + ["--device", "cpu"])


def test_new_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Without a card, the evaluate CLI and the calibration tool raise
    unless asked for the CPU, and run when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = str(tmp_path / "a.npy")
    np.save(a, np.ones((4, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--reference", a, "--test", a])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_int8.main(["--allow_random"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_int8.main(["--allow_random", "--platform", "gpu"])
    with pytest.raises(SystemExit, match="--load_ckpt"):
        calibrate_int8.main(["--device", "cpu"])
    assert evaluate.main(["--reference", a, "--test", a, "--device",
                          "cpu"])["mae"] == 0.0
