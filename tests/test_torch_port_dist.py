"""The port's multi-GPU patch split, run on the CPU: gloo process groups of
1, 2 and 3 ranks (subprocesses, one thread each, batch 1 per rank) sample
the same volume bit for bit; each rank samples the patches of its slice
under their global indices; only rank 0 logs and writes. And the serving
CLI under ``torchrun`` with 2 ranks.

Run as a script, this file is one rank of such a group (the environment
variables of ``torchrun`` name it) and writes its report under the
directory it is given.
"""

import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
WORLDS = (1, 2, 3)  # 4 patches: 3 ranks hold 2, 1 and 1 (and pad to 2)
TIMEOUT_S = 240
CLI_FLAGS = [
    "--large_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--learn_sigma", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--diffusion_steps", "1000", "--timestep_respacing", "2",
    "--device", "cpu", "--batch_size", "1",
]


def _worker(out_dir: str) -> None:
    """One rank: the same tiny model, volume and seeds on every rank; the
    DDPM chain with drawn noise, DPM-Solver++, and the reference's torch
    noise stream, each through denoise_volume; save_outputs into a
    directory of the rank's own."""
    import torch

    torch.set_num_threads(1)
    from ddpm3d_tpu_torch.inference import pipeline
    from ddpm3d_tpu_torch.models import SuperResModel
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.parallel import destroy, maybe_initialize_distributed
    from ddpm3d_tpu_torch.scripts.test import torch_noise_provider

    rank, world_size = maybe_initialize_distributed("cpu")
    model = SuperResModel(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(), channel_mult=(1, 2), dims=3,
        use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False)
    init_params(model, seed=2, zero_heads=False)
    model.eval()
    ids = {}

    def record(fn, key, arg):
        def wrapped(*a, **kw):
            ids.setdefault(key, []).append(list(kw[arg] if arg in kw else a[1]))
            return fn(*a, **kw)
        return wrapped

    pipeline.p_sample_loop = record(pipeline.p_sample_loop, "chain",
                                    "sample_ids")
    pipeline.step_noise = record(pipeline.step_noise, "x_t", "sample_ids")
    vol = np.random.default_rng(0).gamma(2.0, 0.5, (8, 12, 12)).astype(
        np.float32)  # 2 x 2 patches of 8^3
    grid = dict(patch_size=8, num_xy_patches=2, batch_size=1, device="cpu",
                seed=3)
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="2")
    dpm_sched, _ = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="ddim3")
    results = {
        "ddpm": pipeline.denoise_volume(model, sched, cfg, vol, **grid)[0],
        "dpm": pipeline.denoise_volume(model, dpm_sched, cfg, vol,
                                       use_dpm_solver=True, **grid)[0],
        "stream": pipeline.denoise_volume(
            model, sched, cfg, vol,
            noise_stream=torch_noise_provider(5, 8, 2), **grid)[0],
    }
    pipeline.save_outputs(osp.join(out_dir, f"r{rank}"), "vol.tif",
                          results["ddpm"], log=print)
    np.savez(osp.join(out_dir, f"report{rank}.npz"), world=world_size,
             chain_ids=np.asarray(ids.get("chain", []), dtype=object),
             x_t_ids=np.asarray(ids.get("x_t", []), dtype=object),
             **{k: v for k, v in results.items() if v is not None})
    destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _finish(procs):
    """(returncode, stdout, stderr) of each process; kills them all if one
    fails or the time runs out, so that no rank waits on a collective
    forever."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, out, err))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group at once: {world size: [(returncode, output, report)]
    by rank}, and the 2-rank torchrun CLI's (returncode, output, save_dir)
    beside the single-process CLI's volume."""
    tmp = tmp_path_factory.mktemp("dist")
    launched = {}
    for w in WORLDS:
        out = tmp / f"w{w}"
        out.mkdir()
        port = str(_free_port())
        launched[w] = (str(out), [subprocess.Popen(
            [sys.executable, __file__, str(out)], cwd=REPO,
            env=_env(RANK=str(r), WORLD_SIZE=str(w), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(w)])
    cli_case = _cli_inputs(tmp)
    cli_dir = str(tmp / "cli2")
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ddpm3d_tpu_torch.scripts.test",
         *CLI_FLAGS, "--base_samples", cli_case["vol"], "--model_path",
         cli_case["ckpt"], "--save_dir", cli_dir],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    cli_case["single"] = _single_process_cli(tmp, cli_case)
    groups = {}
    for w, (out, procs) in launched.items():
        groups[w] = [(rc, stdout, err, np.load(
            osp.join(out, f"report{r}.npz"), allow_pickle=True)
            if rc == 0 else None)
            for r, (rc, stdout, err) in enumerate(_finish(procs))]
        groups[w].append(out)
    (cli_rc, cli_out, _), = _finish([cli_proc])
    return dict(groups=groups, cli=(cli_rc, cli_out, cli_dir), **cli_case)


def _cli_inputs(tmp):
    """A contract-shaped volume (18 patches of 16^3) and a tiny model's
    .pt."""
    import torch

    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.models import factory
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.scripts import test as cli
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict,
        sr_model_and_diffusion_defaults,
    )

    args = cli.create_argparser().parse_args(CLI_FLAGS)
    model, _, _ = factory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(model, seed=4, zero_heads=False)
    ckpt = str(tmp / "model000001.pt")
    torch.save(model.state_dict(), ckpt)
    vol = str(tmp / "vol.tif")
    tiff_io.imwrite(vol, np.random.default_rng(1).gamma(
        2.0, 0.5, (90, 200, 200)).astype(np.float32))
    return dict(vol=vol, ckpt=ckpt)


def _single_process_cli(tmp, case) -> str:
    """The CLI's volume without torchrun (one thread, batch 1)."""
    import torch

    from ddpm3d_tpu_torch.scripts import test as cli

    out = str(tmp / "cli1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main(CLI_FLAGS + ["--base_samples", case["vol"], "--model_path",
                              case["ckpt"], "--save_dir", out])
    finally:
        torch.set_num_threads(threads)
    return osp.join(out, "denoised_vol.npz")


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_give_bit_equal_volumes(runs, world):
    """1, 2 and 3 ranks: the same volumes bit for bit, for the drawn DDPM
    chain, DPM-Solver++ and the torch noise stream (a rank's provider draws
    and drops the patches before its slice)."""
    ranks = runs["groups"][world][:-1]
    for rc, stdout, err, _ in ranks:
        assert rc == 0, stdout + err
    ref = runs["groups"][1][0][3]
    rank0 = ranks[0][3]
    for key in ("ddpm", "dpm", "stream"):
        assert rank0[key].shape == (12, 12, 8)
        assert np.isfinite(rank0[key]).all()
        np.testing.assert_array_equal(rank0[key], ref[key], err_msg=key)
    # other ranks return no volume
    for *_, report in ranks[1:]:
        assert not {"ddpm", "dpm", "stream"} & set(report.files)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_sample_global_patch_ids(runs, world):
    """Rank r of W samples the r-th of W contiguous slices of the 4 patches
    (sizes within one of each other) under their global indices; the pad
    rows are not sampled."""
    slices = {1: [[0, 1, 2, 3]], 2: [[0, 1], [2, 3]], 3: [[0, 1], [2], [3]]}
    for rank, (*_, report) in enumerate(runs["groups"][world][:-1]):
        batches = [[i] for i in slices[world][rank]]
        # DDPM twice (drawn noise, the stream); DPM draws x_T per batch
        assert [list(b) for b in report["chain_ids"]] == batches * 2
        assert [list(b) for b in report["x_t_ids"]] == batches


@pytest.mark.parametrize("world", WORLDS)
def test_only_rank_0_logs_and_writes(runs, world):
    """save_outputs writes on rank 0 only, and only rank 0 prints the
    pipeline's log lines (stdout)."""
    group = runs["groups"][world]
    out = group[-1]
    assert osp.exists(osp.join(out, "r0", "denoised_vol.npz"))
    assert "Patch grid" in group[0][1]
    for rank in range(1, world):
        assert not osp.exists(osp.join(out, f"r{rank}"))
        assert group[rank][1] == "", group[rank][1]


def test_cli_under_torchrun_on_two_ranks(runs):
    """``torchrun --nproc_per_node 2`` of the serving CLI on the CPU (gloo):
    one set of outputs, written and logged by rank 0, equal to the
    single-process CLI's volume bit for bit."""
    rc, out, save_dir = runs["cli"]
    assert rc == 0, out
    assert sorted(os.listdir(save_dir)) == [
        "denoised_vol.npz", "denoised_vol.tif", "log.txt", "progress.csv"]
    log = open(osp.join(save_dir, "log.txt")).read()
    assert "patch split over 2 ranks (gloo), batch 1 per rank" in log
    assert log.count("Patch grid") == 1
    got = np.load(osp.join(save_dir, "denoised_vol.npz"))["arr_0"]
    np.testing.assert_array_equal(got, np.load(runs["single"])["arr_0"])


def test_maybe_initialize_distributed_without_torchrun(monkeypatch):
    """No torchrun variables: no process group, world (0, 1), and the
    gather hands back its input."""
    import torch

    from ddpm3d_tpu_torch import parallel

    monkeypatch.delenv("RANK", raising=False)
    assert parallel.maybe_initialize_distributed("cpu") == (0, 1)
    assert parallel.world() == (0, 1)
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.all_gather_rows(x) is x
    assert [parallel.pad_to_multiple(n, 3) for n in (1, 3, 4, 18)] == [
        3, 3, 6, 18]


if __name__ == "__main__":
    _worker(sys.argv[1])
