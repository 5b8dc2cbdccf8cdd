"""Blob IO, checkpoints on blob stores, the logger's TensorBoard format,
levels, profile scopes and traces, and the named schedule sampler of the
port, against the JAX package's where it has the same thing.

* ``utils/blobio.py``: local (atomic replace), ``mem://``, ``file://``,
  ``gs://``'s error without a client library, a registered scheme, and
  ``join`` / ``dirname`` equal to JAX's;
* a ``TrainLoop`` saved to and resumed from ``mem://``: parameters, EMA
  and optimizer state bit-equal to the same run on a local directory;
* ``tensorboard`` scalars read back with TensorBoard's ``EventAccumulator``
  equal to what the JAX package's format wrote for the same dumps;
* levels, the tabular aliases, ``profile_kv`` / ``profile`` and a
  ``torch.profiler`` trace directory;
* ``create_named_schedule_sampler`` against JAX's on the same t draws.
"""

import builtins
import json
import os
import os.path as osp
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.training import resample as jres
from ddpm3d_tpu.utils import blobio as jblobio
from ddpm3d_tpu.utils import logger as jlogger
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory as tfactory
from ddpm3d_tpu_torch.training import create_named_schedule_sampler
from ddpm3d_tpu_torch.training import train_loop as tl
from ddpm3d_tpu_torch.training.resample import lsm_weights
from ddpm3d_tpu_torch.utils import blobio
from ddpm3d_tpu_torch.utils import checkpoint as tckpt
from ddpm3d_tpu_torch.utils import logger as tlogger


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def restore_loggers():
    """Both packages' current loggers as they were before the test."""
    saved = jlogger.Logger.CURRENT, tlogger.Logger.CURRENT
    yield
    for lg in (jlogger.Logger.CURRENT, tlogger.Logger.CURRENT):
        if lg is not None and lg not in saved:
            lg.close()
    jlogger.Logger.CURRENT, tlogger.Logger.CURRENT = saved


# ------------------------------------------------------------ blobio


def test_mem_store_roundtrip():
    blobio.write_bytes("mem://bucket/a/b.bin", b"hello")
    blobio.write_bytes("mem://bucket/a/c/d.bin", b"x")
    assert blobio.exists("mem://bucket/a/b.bin")
    assert not blobio.exists("mem://bucket/a/nothing")
    assert blobio.read_bytes("mem://bucket/a/b.bin") == b"hello"
    assert blobio.listdir("mem://bucket/a") == ["b.bin", "c"]
    assert blobio.isdir("mem://bucket/a") and not blobio.isdir("mem://empty")
    with pytest.raises(FileNotFoundError):
        blobio.read_bytes("mem://bucket/missing")
    # the port's store is its own: nothing shows in the JAX package's
    assert not jblobio.exists("mem://bucket/a/b.bin")


def test_local_write_is_atomic_and_makes_dirs(tmp_path):
    p = str(tmp_path / "sub" / "deeper" / "x.bin")
    blobio.write_bytes(p, b"data")
    blobio.write_bytes(p, b"data2")
    assert blobio.read_bytes(p) == b"data2"
    assert os.listdir(osp.dirname(p)) == ["x.bin"]  # no temporary left
    assert blobio.exists(p) and blobio.isdir(str(tmp_path / "sub"))
    assert blobio.listdir(str(tmp_path / "sub")) == ["deeper"]
    assert blobio.listdir(str(tmp_path / "none")) == []


def test_file_scheme_strips_prefix(tmp_path):
    url = f"file://{tmp_path}/sub/x.bin"
    blobio.write_bytes(url, b"abc")
    assert (tmp_path / "sub" / "x.bin").read_bytes() == b"abc"
    assert blobio.read_bytes(url) == b"abc" and blobio.exists(url)
    assert blobio.listdir(f"file://{tmp_path}/sub") == ["x.bin"]


def test_unknown_scheme_and_registered_scheme():
    with pytest.raises(ValueError, match="unknown blob scheme"):
        blobio.read_bytes("s3+missing://x/y")

    class Dict(blobio._Backend):
        def __init__(self):
            self.d = {}

        def read(self, path):
            return self.d[path]

        def write(self, path, data):
            self.d[path] = data

        def exists(self, path):
            return path in self.d

        def listdir(self, path):
            return sorted(k.rsplit("/", 1)[1] for k in self.d)

    blobio.register_scheme("dicttest", Dict())
    try:
        blobio.write_bytes("dicttest://b/k", b"v")
        assert blobio.read_bytes("dicttest://b/k") == b"v"
        assert blobio.listdir("dicttest://b") == ["k"]
    finally:
        blobio._SCHEMES.pop("dicttest")


def test_gs_scheme_clear_error(monkeypatch):
    real_import = builtins.__import__

    def blocked(name, *a, **kw):
        if name.startswith("etils") or name.startswith("google"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    for mod in list(sys.modules):
        if mod.startswith("etils") or mod.startswith("google.cloud"):
            monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setattr(builtins, "__import__", blocked)
    for call in (lambda: blobio.read_bytes("gs://bucket/missing"),
                 lambda: blobio.write_bytes("gs://bucket/x", b"1"),
                 lambda: blobio.exists("gs://bucket/x")):
        with pytest.raises(RuntimeError, match="gs:// paths need"):
            call()


@pytest.mark.parametrize("path", [
    "/a/b/model000002.pt", "rel/x.pt", "mem://run/a/model000002.pt",
    "gs://bucket/run/opt.pt", "file:///tmp/r/m.pt", "mem://run"])
def test_join_and_dirname_match_jax(path):
    assert blobio.dirname(path) == jblobio.dirname(path)
    for parts in (("x.pt",), ("sub/", "/y.pt")):
        assert blobio.join(path, *parts) == jblobio.join(path, *parts)


def test_checkpoint_files_on_mem_store():
    d = "mem://ckpts/run1"
    sd = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    written = tckpt.save_train_checkpoint(
        d, 42, sd, {"0.9999": {"w": torch.ones(2, 3)}}, {"state": {}})
    assert written == [f"{d}/model000042.pt", f"{d}/ema_0.9999_000042.pt",
                       f"{d}/opt000042.pt"]
    latest = tckpt.latest_checkpoint(d)
    assert latest == written[0]
    assert tckpt.parse_resume_step_from_filename(latest) == 42
    assert torch.equal(tckpt.load(latest)["w"], sd["w"])
    assert tckpt.find_ema_checkpoint(latest, 42, "0.9999") == written[1]
    assert tckpt.find_opt_checkpoint(latest, 42) == written[2]
    assert tckpt.find_opt_checkpoint(latest, 41) is None
    from ddpm3d_tpu_torch.utils.convert import load_checkpoint

    assert torch.equal(load_checkpoint(latest)["w"], sd["w"])


# ------------------------------------------------------------ TrainLoop

TINY = dict(
    model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 2), dims=3,
    use_scale_shift_norm=True, resblock_updown=True, middle_attention=False,
)


def _loop(data, **kw):
    sched, cfg = tfactory.create_gaussian_diffusion(steps=1000,
                                                    learn_sigma=True)
    args = dict(model=SuperResModel(in_channels=1, **TINY), sched=sched,
                cfg=cfg, data=data, batch_size=1, microbatch=-1, lr=1e-3,
                ema_rate="0.9,0.99", log_interval=100, save_interval=100,
                weight_decay=0.01, seed=1, device="cpu",
                schedule_sampler="loss-second-moment")
    args.update(kw)
    return tl.TrainLoop(**args)


def _data(seed):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal((1, 2, 8, 8, 1)), -1, 1).astype(
        np.float32)
    low = rng.standard_normal(x0.shape, dtype=np.float32)
    while True:
        yield x0, {"low_res": low}


def _state(loop):
    opt = loop.state.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in loop.model.parameters()],
            [[e.clone() for e in ema] for ema in loop.state.ema_params],
            {(k, n): v.clone() for k, st in opt.items()
             for n, v in st.items()})


def _assert_equal_states(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for ea, eb in zip(a[1], b[1]):
        for x, y in zip(ea, eb):
            assert torch.equal(x, y)
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_train_loop_on_mem_store_equals_local(tmp_path, restore_loggers,
                                              monkeypatch):
    tlogger.configure(str(tmp_path / "logs"), format_strs=[])
    runs = {}
    for name, where in (("local", str(tmp_path / "ckpt")),
                        ("mem", "mem://trainloop/run")):
        # checkpoints go to the logger's directory, here on either store
        monkeypatch.setattr(tlogger, "get_dir", lambda where=where: where)
        data = _data(3)
        loop = _loop(data)
        for _ in range(2):
            loop.run_step(*next(data))
        loop.step = 2
        paths = loop.save()
        assert [osp.basename(p) for p in paths] == [
            "model000002.pt", "ema_0.9_000002.pt", "ema_0.99_000002.pt",
            "opt000002.pt"]
        assert all(p.startswith(where) for p in paths)
        resumed = _loop(data, resume_checkpoint=paths[0])
        auto = _loop(data, auto_resume=True)
        assert resumed.resume_step == auto.resume_step == 2
        _assert_equal_states(_state(loop), _state(resumed))
        _assert_equal_states(_state(loop), _state(auto))
        # one more step, the same t and noise, from the saved and resumed
        batch = next(data)
        t, w = torch.tensor([17]), torch.ones(1)
        noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
            batch[0].shape, dtype=np.float32))
        resumed.run_step(*batch, t=t, weights=w, noise=noise)
        runs[name] = (_state(loop), _state(resumed), paths)
    _assert_equal_states(runs["local"][0], runs["mem"][0])
    _assert_equal_states(runs["local"][1], runs["mem"][1])
    for lp, mp in zip(runs["local"][2], runs["mem"][2]):
        assert blobio.read_bytes(lp) == blobio.read_bytes(mp)
    # the memory run wrote nothing to the disk but the logs
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "logs"]
    assert os.listdir(tmp_path / "logs") == []


# ------------------------------------------------------------ logger


def _dump_sequence(lg):
    lg.logkv_mean("loss", 1.5)
    lg.logkv_mean("loss", 2.0)
    lg.logkv("step", 0)
    lg.logkv("note", "text")  # not a scalar: left out of TensorBoard
    lg.dumpkvs()
    lg.record_tabular("step", 1)
    lg.record_tabular("loss", 0.25)
    lg.logkv("grad_norm", np.float32(3.5))
    lg.dump_tabular()


def _scalars(d):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(d)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(tmp_path, monkeypatch,
                                       restore_loggers):
    """``DDPM_LOG_FORMAT=tensorboard`` (the variable both loggers read):
    the port's SummaryWriter events read back equal to the JAX format's."""
    monkeypatch.setenv("DDPM_LOG_FORMAT", "tensorboard")
    got = {}
    for name, lg in (("jax", jlogger), ("port", tlogger)):
        d = tmp_path / name
        lg.configure(str(d))
        _dump_sequence(lg)
        lg.Logger.CURRENT.close()
        got[name] = _scalars(str(d / "tb"))
    assert got["port"] == got["jax"]
    assert got["port"] == {"loss": [(1, 1.75), (2, 0.25)],
                           "step": [(1, 0.0), (2, 1.0)],
                           "grad_norm": [(2, 3.5)]}


def test_tensorboard_raises_without_the_package(tmp_path, monkeypatch):
    """The port has no silent writer: without ``tensorboard`` the format
    raises (the JAX package's writes nothing)."""
    real_import = builtins.__import__

    def blocked(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", blocked)
    with pytest.raises(ImportError):
        tlogger.make_output_format("tensorboard", str(tmp_path))


def test_levels_and_aliases_match_jax(tmp_path, restore_loggers):
    texts = {}
    for name, lg in (("jax", jlogger), ("port", tlogger)):
        d = tmp_path / name
        lg.configure(str(d), format_strs=["log"])
        lg.debug("a debug line")
        lg.info("an info line", 1)
        lg.set_level(lg.DEBUG)
        lg.debug("a debug line, shown")
        lg.set_level(lg.WARN)
        lg.info("an info line, hidden")
        lg.warn("a warning")
        lg.error("an error", 2)
        lg.record_tabular("x", 1.0)
        assert lg.dump_tabular() == {"x": 1.0}
        lg.set_level(lg.DISABLED)
        lg.logkv("y", 2.0)
        assert lg.dump_tabular() == {}
        lg.error("not even an error")
        lg.Logger.CURRENT.close()
        texts[name] = (d / "log.txt").read_text().splitlines()[1:]
    assert texts["port"] == texts["jax"]
    assert texts["port"][:4] == ["an info line 1", "a debug line, shown",
                                 "a warning", "an error 2"]


def test_profile_kv_and_decorator(restore_loggers, tmp_path):
    tlogger.configure(str(tmp_path), format_strs=[])

    @tlogger.profile("decorated")
    def work():
        time.sleep(0.02)
        return 7

    with tlogger.profile_kv("scope"):
        time.sleep(0.02)
    with tlogger.profile_kv("scope"):
        time.sleep(0.01)
    assert work() == 7
    kvs = dict(tlogger.getkvs())
    assert sorted(kvs) == ["wait_decorated", "wait_scope"]
    assert 0.03 <= kvs["wait_scope"] < 1.0
    assert 0.02 <= kvs["wait_decorated"] < 1.0
    assert tlogger.dumpkvs()["wait_scope"] == kvs["wait_scope"]


def test_trace_directory_is_written(restore_loggers, tmp_path):
    tlogger.configure(str(tmp_path), format_strs=[])
    with pytest.raises(RuntimeError, match="no trace is running"):
        tlogger.stop_trace()
    d = tlogger.start_trace(device="cpu")
    assert d == str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="already running"):
        tlogger.start_trace(device="cpu")
    x = torch.randn(64, 64)
    (x @ x).relu_().sum()
    tlogger.stop_trace()
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(osp.join(d, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    other = tlogger.start_trace(str(tmp_path / "elsewhere"), "cpu")
    tlogger.stop_trace()
    assert os.listdir(other)


# ------------------------------------------------------------ sampler


def test_named_sampler_matches_jax():
    T, B = 6, 8
    with pytest.raises(NotImplementedError):
        create_named_schedule_sampler("nope", T)
    with pytest.raises(NotImplementedError):
        jres.create_named_schedule_sampler("nope", T)
    # uniform: no state, unit weights, the update leaves the state
    init, sample, update = create_named_schedule_sampler("uniform", T)
    jinit, jsample, jupdate = jres.create_named_schedule_sampler("uniform", T)
    assert init is None and jinit is None
    t, w = sample(torch.Generator().manual_seed(0), init, B)
    jt, jw = jsample(jres.jax.random.PRNGKey(0), jinit, B)
    assert t.shape == (B,) and ((t >= 0) & (t < T)).all()
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert update(None, t, w) is None and jupdate(None, jt, jw) is None
    # loss-second-moment: the same (t, loss) draws through both updates,
    # then the weights of JAX's sampled t from the port's state
    init, sample, update = create_named_schedule_sampler(
        "loss-second-moment", T)
    jstate, jsample, jupdate = jres.create_named_schedule_sampler(
        "loss-second-moment", T)
    state = init
    rng = np.random.default_rng(0)
    for i in range(12):
        ts = rng.integers(0, T, B)
        losses = rng.uniform(0.1, 2.0, B).astype(np.float32)
        state = update(state, torch.from_numpy(ts), torch.from_numpy(losses))
        jstate = jupdate(jstate, jnp.asarray(ts), jnp.asarray(losses))
        np.testing.assert_array_equal(state.loss_history.numpy(),
                                      np.asarray(jstate.loss_history))
        np.testing.assert_array_equal(state.loss_counts.numpy(),
                                      np.asarray(jstate.loss_counts))
        jt, jw = jsample(jres.jax.random.PRNGKey(i), jstate, B)
        p = lsm_weights(state)
        np.testing.assert_allclose(
            (1.0 / (T * p[torch.from_numpy(np.array(jt))])).numpy(),
            np.asarray(jw), rtol=1e-6)
        t, w = sample(torch.Generator().manual_seed(i), state, B)
        torch.testing.assert_close(w, 1.0 / (T * p[t]))
    assert bool((state.loss_counts == 10).all())  # warmed up: not uniform
