"""The port's data-parallel training and distillation on the CPU: a gloo
process group of 2 ranks (subprocesses, one thread each) against one
process on the same global batches and seeds, and the 2-rank all-reduced
gradients against ``jax.grad`` on the JAX package's 2-device mesh. Then
the training CLI and the distill CLI under ``torchrun --nproc_per_node 2``.

Run as a script, this file is one rank of such a group (the environment
variables of ``torchrun`` name it): it runs every scenario of
:func:`scenarios` and writes its report under the directory it is given.
The test process runs the same scenarios alone for the reference.
"""

import csv
import itertools
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
TIMEOUT_S = 300
# 64 channels at every level: two per GroupNorm group, so no conv bias has
# a gradient that is zero in exact arithmetic (one channel per group would
# leave it rounding noise, whose sign AdamW turns into a full-size step)
TINY = dict(
    model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(2, 2), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)
SAMPLE = (2, 4, 4, 1)  # D, H, W, C
CHAIN = [0, 143, 285, 428, 571, 714, 856, 999]  # space_timesteps(1000, "8")
# the all-reduced gradients: per tensor max |diff| <= GRAD_TOL * max(max
# |ref|, ZERO_GRAD_FLOOR * the model's largest), as in the train tests
GRAD_TOL = 1e-4
ZERO_GRAD_FLOOR = 1e-3
# two ranks against one process, in the space of the update: the norm of
# the difference of the two runs' parameters over the norm of one
# process's update from the shared initial weights, at most UPDATE_TOL; and
# no entry off by more than one AdamW step (LR) per step. The gradients
# agree to f32 summation order (1e-7), but AdamW's step lr * m / (sqrt(v) +
# 1e-8) of an entry whose gradient is near 1e-8, or whose two gradients
# cancel in m, turns on their last bits (measured: update ratio 1e-3 with
# batch-1 pieces, 8e-7 without; up to two full steps in single entries).
# Wrong rows or a missing all-reduce give a ratio of order 1; a wrong
# gradient scale, which AdamW hides, shows in the gradient and grad_norm
# checks.
UPDATE_TOL = 1e-2
LR = 1e-3
CLI_FLAGS = [
    "--large_size", "32", "--num_channels", "32", "--num_res_blocks", "1",
    "--learn_sigma", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--diffusion_steps", "1000", "--noise_schedule", "linear",
    "--use_fp16", "False", "--device", "cpu",
]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite runs several workers on shared
    cores, where more threads only contend (a CPU distill step and serving
    run took 43 s at 8 threads against 9 s at 2 on a loaded box)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batches(seed, n, batch):
    rng = np.random.default_rng(seed)
    return [(np.clip(rng.standard_normal((batch,) + SAMPLE), -1, 1).astype(
        np.float32), rng.standard_normal((batch,) + SAMPLE).astype(np.float32))
        for _ in range(n)]


def _rows(a, rank, world):
    from ddpm3d_tpu_torch.parallel import rank_rows

    return rank_rows(torch.as_tensor(a), rank, world)


def _data(batches, rank, world):
    for x, low in itertools.cycle(batches):
        yield _rows(x, rank, world).numpy(), {
            "low_res": _rows(low, rank, world).numpy()}


def scenarios(tmp, rank, world):
    """Every scenario on this rank (a process group of ``world`` ranks, or
    none at world 1); returns the report."""
    from ddpm3d_tpu_torch.diffusion import get_named_beta_schedule
    from ddpm3d_tpu_torch.models import SuperResModel
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.parallel import data_parallel, unwrap
    from ddpm3d_tpu_torch.training import TrainLoop, distill_phase
    from ddpm3d_tpu_torch.training import train_loop as tl
    from ddpm3d_tpu_torch.utils import logger

    init = torch.load(osp.join(tmp, "init.pt"), weights_only=True)

    def model():
        m = SuperResModel(in_channels=1, **TINY)
        m.load_state_dict(init, strict=True)
        return m

    def out_dir(name):
        d = osp.join(tmp, f"{name}_w{world}_r{rank}")
        logger.configure(d, format_strs=["log", "csv"] if rank == 0 else [])
        return d

    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, timestep_respacing="10")
    loop_kw = dict(sched=sched, cfg=cfg, lr=LR, ema_rate="0.9",
                   log_interval=1, weight_decay=0.01, device="cpu")
    rep = {}

    # 3 steps of the loop with the loss-second-moment sampler, saving at
    # steps 0 and 2; the rows that reach the update half are recorded
    train_dir = out_dir("train")
    seen = []
    update = tl.apply_update
    tl.apply_update = lambda state, t, terms, *a, **k: (
        seen.append((t.clone(), terms["loss"].clone()))
        or update(state, t, terms, *a, **k))
    try:
        loop = TrainLoop(
            model=model(), data=_data(_batches(1, 3, 4), rank, world),
            batch_size=4, microbatch=-1, save_interval=2,
            schedule_sampler="loss-second-moment", lr_anneal_steps=3, seed=1,
            **loop_kw)
        loop.run_loop()
    finally:
        tl.apply_update = update
    rep.update(
        train_params=loop.model.state_dict(),
        train_ema=loop.ema_state_dicts()["0.9"],
        train_hist=loop.state.sampler_state.loss_history,
        train_counts=loop.state.sampler_state.loss_counts,
        train_t=torch.stack([t for t, _ in seen]),
        train_loss=torch.stack([loss for _, loss in seen]),
        train_dir=train_dir, train_files=sorted(os.listdir(train_dir)))

    # microbatch 1 of the global batch 4: 2 pieces per rank, 4 alone
    out_dir("micro")
    loop = TrainLoop(model=model(), data=iter(()), batch_size=4, microbatch=1,
                     save_interval=100, seed=2, **loop_kw)
    for x, low in _batches(2, 2, 4):
        loop.run_step(_rows(x, rank, world).numpy(),
                      {"low_res": _rows(low, rank, world).numpy()})
    rep["micro_params"] = loop.model.state_dict()

    # one distillation phase (8 -> 4) at global batch 2, 2 steps
    distill_dir = out_dir("distill")
    weights, s_ts = distill_phase(
        model(), SuperResModel(in_channels=1, **TINY),
        get_named_beta_schedule("linear", 1000), CHAIN, cfg,
        _data(_batches(3, 2, 2), rank, world), steps=2, lr=LR, seed=3,
        log_every=1, device="cpu")
    rep.update(distill_weights=weights, distill_ts=s_ts,
               distill_dir=distill_dir)

    # the all-reduced gradients of one step with explicit t and noise
    full, full_cfg = create_gaussian_diffusion(steps=1000, learn_sigma=True)
    x, low, noise, t = _grad_inputs()
    wrapped = data_parallel(model(), torch.device("cpu"))
    tl.compute_grads(
        wrapped, full, full_cfg, _rows(x, rank, world),
        {"low_res": _rows(low, rank, world)}, _rows(t, rank, world),
        torch.ones(2 // world), noise=_rows(noise, rank, world))
    rep["grads"] = {n: p.grad.clone()
                    for n, p in unwrap(wrapped).named_parameters()}

    rep["gathered"] = logger.gather_weighted_means(
        {"a": 1.0 + rank, "b": 10.0 * rank + 0.5}, {"a": 1 + rank, "b": 2})
    try:
        TrainLoop(model=model(), data=iter(()), batch_size=3, microbatch=-1,
                  save_interval=1, **loop_kw)
        rep["raise"] = ""
    except ValueError as e:
        rep["raise"] = str(e)
    return rep


def _grad_inputs():
    rng = np.random.default_rng(7)
    x = np.clip(rng.standard_normal((2,) + SAMPLE), -1, 1).astype(np.float32)
    low = rng.standard_normal(x.shape).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return x, low, noise, np.array([3, 870])


def _worker(tmp: str) -> None:
    torch.set_num_threads(1)
    from ddpm3d_tpu_torch.parallel import destroy, maybe_initialize_distributed

    rank, world = maybe_initialize_distributed("cpu")
    try:
        torch.save(scenarios(tmp, rank, world),
                   osp.join(tmp, f"report{rank}.pt"))
    finally:
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
    """(returncode, output) of each process; kills them all if one fails or
    the time runs out, so that no rank waits on a collective forever."""
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, out))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _torchrun(module, *flags):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *flags],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _jax_params():
    """Random params of the JAX model (numpy leaves), made from a seed."""
    import jax
    import jax.numpy as jnp

    from ddpm3d_tpu.models import SuperResModel as JaxSuperRes

    jm = JaxSuperRes(in_channels=1, **TINY)
    x0 = jnp.zeros((1,) + SAMPLE)
    params = jax.jit(lambda x: jm.init(
        jax.random.key(0), x, jnp.zeros((1,), jnp.int32), low_res=x))(x0)
    rng = np.random.default_rng(5)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if path[-1].key == "scale" else 0.05 * noise

    return jm, jax.tree_util.tree_map_with_path(fill, params["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank group's reports and outputs, the single process's report,
    and the two CLIs under torchrun (started together, awaited last)."""
    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.models import factory
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.scripts import distill as distill_cli
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict,
        sr_model_and_diffusion_defaults,
    )
    from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict

    tmp = str(tmp_path_factory.mktemp("ddp"))
    jm, params = _jax_params()
    torch.save(jax_params_to_state_dict(params), osp.join(tmp, "init.pt"))
    port = str(_free_port())
    ranks = [subprocess.Popen(
        [sys.executable, __file__, tmp], cwd=REPO,
        env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    data = osp.join(tmp, "data")
    os.makedirs(data)
    for i in range(2):  # the loader shards files: one per rank
        tiff_io.imwrite(osp.join(data, f"pair{i}.tif"),
                        np.random.default_rng(i).gamma(
                            2.0, 0.5, (2, 32, 40, 40)).astype(np.float32))
    args = distill_cli.create_argparser().parse_args(CLI_FLAGS)
    teacher, _, _ = factory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(teacher, seed=4, zero_heads=False)
    torch.save(teacher.state_dict(), osp.join(tmp, "teacher.pt"))
    clis = {
        "train": _torchrun(
            "ddpm3d_tpu_torch.scripts.train", *CLI_FLAGS, "--data_dir", data,
            "--batch_size", "2", "--lr_anneal_steps", "2", "--log_interval",
            "1", "--result_folder", osp.join(tmp, "train_cli")),
        "distill": _torchrun(
            "ddpm3d_tpu_torch.scripts.distill", *CLI_FLAGS, "--data_dir",
            data, "--batch_size", "2", "--model_path",
            osp.join(tmp, "teacher.pt"), "--start_respacing", "4",
            "--target_steps", "2", "--steps_per_phase", "1",
            "--result_folder", osp.join(tmp, "distill_cli")),
    }

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = scenarios(tmp, 0, 1)
    finally:
        torch.set_num_threads(threads)
    group = []
    for r, (rc, out) in enumerate(_finish(ranks)):
        assert rc == 0, f"rank {r}:\n{out}"
        group.append(torch.load(osp.join(tmp, f"report{r}.pt"),
                                weights_only=True))
    cli = {name: _finish([p])[0] for name, p in clis.items()}
    return dict(tmp=tmp, group=group, single=single, cli=cli, jm=jm,
                params=params)


def _close(got, ref, init, what, steps):
    diff = upd = 0.0
    for k, r in ref.items():
        d = (got[k] - r).double()
        assert d.abs().max().item() <= LR * steps, (
            f"{what} {k}: max |diff| {d.abs().max().item()}")
        diff += float((d ** 2).sum())
        upd += float(((r - init[k]).double() ** 2).sum())
    assert diff ** 0.5 <= UPDATE_TOL * upd ** 0.5, (what, diff, upd)


def _init(runs):
    return torch.load(osp.join(runs["tmp"], "init.pt"), weights_only=True)


def _progress(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_loop_two_ranks_match_one_process(runs):
    """3 steps at global batch 4, loss-second-moment sampler, EMA 0.9: the
    params and EMA of either rank within UPDATE_TOL of one process's; the t
    rows bit-equal; the sampler state bit-equal on both ranks and to replaying
    the gathered (t, loss) rows in rank order, its counts bit-equal to one
    process's and its losses within rtol 1e-5; rank 0 logs one process's
    quartile table (rtol 1e-5)."""
    from ddpm3d_tpu_torch.training import resample

    single, init = runs["single"], _init(runs)
    for rep in runs["group"]:
        _close(rep["train_params"], single["train_params"], init, "params", 3)
        _close(rep["train_ema"], single["train_ema"], init, "EMA", 3)
        assert torch.equal(rep["train_t"], single["train_t"])
        assert torch.equal(rep["train_counts"], single["train_counts"])
        assert torch.equal(rep["train_hist"], runs["group"][0]["train_hist"])
    rep = runs["group"][0]
    assert rep["train_t"].shape == (3, 4)
    state = resample.init_loss_second_moment(10)
    for t, loss in zip(rep["train_t"], rep["train_loss"]):
        state = resample.update_loss_second_moment(state, t, loss)
    assert torch.equal(state.loss_history, rep["train_hist"])
    assert torch.equal(state.loss_counts, rep["train_counts"])
    torch.testing.assert_close(rep["train_hist"], single["train_hist"],
                               rtol=1e-5, atol=1e-7)
    got = _progress(osp.join(rep["train_dir"], "progress.csv"))
    ref = _progress(osp.join(single["train_dir"], "progress.csv"))
    assert len(got) == len(ref) == 3 and sorted(got[0]) == sorted(ref[0])
    for g, r in zip(got, ref):
        assert g["step"] == r["step"] and g["samples"] == r["samples"]
        for k in r:
            if r[k]:
                np.testing.assert_allclose(float(g[k]), float(r[k]),
                                           rtol=1e-5, atol=1e-8, err_msg=k)
    assert [int(g["samples"]) for g in got] == [4, 8, 12]


def test_microbatches_under_ddp_match_one_process(runs):
    """Microbatch 1 at global batch 4 (2 pieces per rank, one all-reduce):
    the params of 2 steps within UPDATE_TOL of one process's 4 pieces."""
    for rep in runs["group"]:
        _close(rep["micro_params"], runs["single"]["micro_params"],
               _init(runs), "params", 2)


def test_distill_phase_two_ranks_match_one_process(runs):
    """One phase 8 -> 4, 2 steps at global batch 2: the student of either
    rank within UPDATE_TOL of one process's, the same kept steps, and
    rank 0's logged loss (the weighted mean over the ranks) that of one
    process."""
    single = runs["single"]
    for rep in runs["group"]:
        _close(rep["distill_weights"], single["distill_weights"],
               _init(runs), "student", 2)
        assert rep["distill_ts"] == single["distill_ts"] == CHAIN[1::2]
    got = _progress(osp.join(runs["group"][0]["distill_dir"], "progress.csv"))
    ref = _progress(osp.join(single["distill_dir"], "progress.csv"))
    assert len(got) == len(ref) == 2
    # the first step from the same weights; the second from weights within
    # UPDATE_TOL
    for g, r, rtol in zip(got, ref, (1e-5, 1e-3)):
        for k in ("distill/loss", "distill/mse", "distill/grad_norm"):
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=rtol,
                                       err_msg=k)


def test_only_rank_0_writes(runs):
    """Rank 0 writes the checkpoints of steps 0 and 2 and the logs; rank
    1's directory stays empty. The saved model loads strict=True into a
    plain model (no DDP prefix)."""
    from ddpm3d_tpu_torch.models import SuperResModel

    r0, r1 = runs["group"]
    assert r0["train_files"] == [
        "ema_0.9_000000.pt", "ema_0.9_000002.pt", "log.txt",
        "model000000.pt", "model000002.pt", "opt000000.pt", "opt000002.pt",
        "progress.csv"]
    assert r1["train_files"] == []
    assert os.listdir(r1["distill_dir"]) == []
    sd = torch.load(osp.join(r0["train_dir"], "model000002.pt"),
                    weights_only=True)
    SuperResModel(in_channels=1, **TINY).load_state_dict(sd, strict=True)


def test_allreduced_grads_match_jax_mesh(runs):
    """The hybrid loss (MSE + learned-range vb) of a global batch of 2 with
    explicit t and noise: each rank's all-reduced gradients against
    jax.grad of the global mean loss on the JAX package's 2-device mesh."""
    import jax
    import jax.numpy as jnp

    from ddpm3d_tpu.diffusion import losses as jloss
    from ddpm3d_tpu.models import factory as jfactory
    from ddpm3d_tpu.parallel import make_mesh, replicate, shard_batch
    from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict

    jm = runs["jm"]
    js, jcfg = jfactory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    mesh = make_mesh(n_data=2)

    def loss(p, x, low, noise, t):
        terms = jloss.training_losses(
            jax.random.key(0),
            lambda xx, tt, **kw: jm.apply({"params": p}, xx, tt, **kw),
            js, jcfg, x, t, model_kwargs={"low_res": low}, noise=noise)
        return jnp.mean(terms["loss"])

    batch = shard_batch(mesh, tuple(jnp.asarray(a) for a in _grad_inputs()))
    grads = jax.jit(jax.grad(loss))(replicate(mesh, runs["params"]), *batch)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    floor = ZERO_GRAD_FLOOR * max(r.abs().max().item() for r in ref.values())
    for rep in runs["group"]:
        assert sorted(rep["grads"]) == sorted(ref)
        for name, r in ref.items():
            err = (rep["grads"][name] - r).abs().max().item()
            assert err <= GRAD_TOL * max(r.abs().max().item(), floor), (
                f"{name}: max |diff| {err} vs max |ref| "
                f"{r.abs().max().item()}")


def test_gather_weighted_means_matches_jax(runs, monkeypatch):
    """Both ranks' gather_weighted_means against the JAX package's formula
    on the two ranks' (value x count, count) rows, run through its own
    function with its all-gather given those rows."""
    import jax
    from jax.experimental import multihost_utils

    from ddpm3d_tpu.utils import logger as jlogger

    kvs = [({"a": 1.0 + r, "b": 10.0 * r + 0.5}, {"a": 1 + r, "b": 2})
           for r in range(2)]
    rows = []
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda v: rows.append(v) or np.stack([v, v]))
    for kv, counts in kvs:
        jlogger.gather_weighted_means(kv, counts)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda v: np.stack(rows))
    ref = jlogger.gather_weighted_means(*kvs[0])
    for rep in runs["group"]:
        assert rep["gathered"].keys() == ref.keys()
        for k in ref:
            assert rep["gathered"][k] == pytest.approx(ref[k], rel=1e-15)
    assert runs["single"]["gathered"] == kvs[0][0]


def test_batch_must_split_over_ranks(runs):
    """A global batch of 3 on 2 ranks raises (JAX would silently run on
    gcd(3, 2) = 1 device); one process takes it."""
    for rep in runs["group"]:
        assert "global batch 3 does not split over 2 ranks" in rep["raise"]
    assert runs["single"]["raise"] == ""


def test_train_cli_under_torchrun(runs):
    """The training CLI on 2 gloo ranks: one set of checkpoints and logs
    from rank 0, the global batch's sample count, a .pt that loads
    strict=True."""
    from ddpm3d_tpu_torch.models import factory
    from ddpm3d_tpu_torch.scripts import train as train_cli
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict,
        sr_model_and_diffusion_defaults,
    )

    rc, out = runs["cli"]["train"]
    assert rc == 0, out
    d = osp.join(runs["tmp"], "train_cli")
    assert sorted(os.listdir(d)) == [
        "ema_0.9999_000000.pt", "ema_0.9999_000002.pt", "log.txt",
        "model000000.pt", "model000002.pt", "opt000000.pt", "opt000002.pt",
        "progress.csv"]
    log = open(osp.join(d, "log.txt")).read()
    assert "data parallel over 2 ranks (gloo), global batch 2, 1 per rank" in log
    assert log.count("creating model...") == 1
    assert [int(r["samples"]) for r in _progress(osp.join(d, "progress.csv"))] \
        == [2, 4]
    args = train_cli.create_argparser().parse_args(
        CLI_FLAGS + ["--data_dir", "unused"])
    model, _, _ = factory.sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    model.load_state_dict(torch.load(osp.join(d, "model000002.pt"),
                                     weights_only=True), strict=True)


def test_distill_cli_under_torchrun(runs):
    """The distill CLI on 2 gloo ranks, 4 -> 2: rank 0 writes the .pt and
    the kept steps of JAX's ladder once, and logs once."""
    from ddpm3d_tpu.diffusion import space_timesteps
    from ddpm3d_tpu.training.distill import halve_timesteps

    rc, out = runs["cli"]["distill"]
    assert rc == 0, out
    d = osp.join(runs["tmp"], "distill_cli")
    assert sorted(os.listdir(d)) == [
        "distilled_2steps.pt", "distilled_2steps_ts.npy", "log.txt",
        "progress.csv"]
    np.testing.assert_array_equal(
        np.load(osp.join(d, "distilled_2steps_ts.npy")),
        halve_timesteps(sorted(space_timesteps(1000, "4"))))
    log = open(osp.join(d, "log.txt")).read()
    assert "data parallel over 2 ranks (gloo), global batch 2, 1 per rank" in log
    assert log.count("distillation complete") == 1


def test_ddp_path_never_falls_back(monkeypatch, tmp_path):
    """Under torchrun's variables without a card, a CUDA run raises before
    joining a group; a model for the card refuses a gloo group (and one on
    the CPU an NCCL group is never built: no fallback either way)."""
    import torch.distributed as dist

    from ddpm3d_tpu_torch.models import SuperResModel
    from ddpm3d_tpu_torch.parallel import (
        data_parallel,
        destroy,
        maybe_initialize_distributed,
    )

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maybe_initialize_distributed("cuda")
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        model = SuperResModel(in_channels=1, **TINY)
        with pytest.raises(RuntimeError, match="needs a nccl process group"):
            data_parallel(model, torch.device("cuda", 0))
        wrapped = data_parallel(model, torch.device("cpu"))
        assert type(wrapped).__name__ == "DistributedDataParallel"
        assert data_parallel(wrapped, torch.device("cpu")) is wrapped
        del wrapped
    finally:
        destroy()


if __name__ == "__main__":
    _worker(sys.argv[1])
