"""The port's spatial mesh axis on the CPU: one patch's H (the volume's X)
split over gloo ranks (subprocesses, two torch threads each), with the conv
halo exchange, GroupNorm sums over the group and the int8 abs-max over it,
through SuperResModel and the dual-branch Seg models.

Groups of 2 ranks (mesh (1, 2)), 3 (mesh (1, 3)) and 4 (mesh (2, 2)) run
the scenarios of :func:`_worker` at once; the JAX side (its
``denoise_patches`` under ``make_mesh(n_data=4, n_spatial=2)`` on the 8
virtual CPU devices, SuperResModel and each Seg model) runs in the test
process meanwhile. Run as a script, this file is one rank of such a group
and writes its report under the directory it is given.
"""

import os
import os.path as osp
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ddpm3d_tpu import diffusion as jdiffusion
from ddpm3d_tpu import models as jmodels
from ddpm3d_tpu.inference import denoise_patches as jax_denoise_patches
from ddpm3d_tpu.models import SuperResModel as JaxSuperRes
from ddpm3d_tpu.parallel import make_mesh as jax_make_mesh
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch import diffusion as tdiffusion
from ddpm3d_tpu_torch import models as tmodels
from ddpm3d_tpu_torch.inference import denoise_patches
from ddpm3d_tpu_torch.models import SuperResModel, UNetModel
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.models.seg import SegUNetModel
from ddpm3d_tpu_torch.models.unet import EncoderUNetModel
from ddpm3d_tpu_torch.ops import groupnorm as gn_ops
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.parallel import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    SpatialGroup,
    allowed_spatial,
    check_spatial_split,
    make_mesh,
    shard_batch,
)
from ddpm3d_tpu_torch.utils import tracing

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
TIMEOUT_S = 240
# tests/test_parallel.py:test_denoise_patches_sharded's model, patches and
# schedule (a 4-step chain whose x0 recovery amplifies nothing)
TINY = dict(model_channels=32, out_channels=2, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3,
            use_scale_shift_norm=True, resblock_updown=True,
            middle_attention=False)
P, Z, X, Y = 5, 4, 16, 16
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5  # tests/test_parallel.py:141
# the sharded forward against the unsharded one, max |diff| / max |ref|:
# the GroupNorm sums are added in another order (per rank, then over the
# group), which moves f32 results by summation order alone; int8 flips a
# few quantization steps on those differences (INT8_FORWARD_TOL of
# chip_smoke.py). In bf16 the same order flips roundings that later layers
# carry: this tiny random model moves by 1.1 % (mean) when one GroupNorm's
# sums move by 1e-7, and its bf16 forward lies 1.5 % from its f32 one, so a
# bf16 forward is held to that distance (bf16's own noise on this model),
# itself held under a fixed ceiling ("bf16") so that a drift in the
# reference shows; a wrong halo or sum moves it by far more
TOL = {"f32": 1e-5, "int8": 0.15, "bf16": 2e-2}
# (world size, n_data, n_spatial) of each group
GROUPS = {2: (1, 2), 3: (1, 3), 4: (2, 2)}
CALLS = ("halo", "all_reduce_sum", "all_reduce_max", "all_gather_h")
# the forwards each group checks (its model variants' keyword arguments)
VARIANTS = {
    "unfused_f32": {}, "unfused_bf16": dict(dtype=torch.bfloat16),
    "fused_f32": dict(fused=True),
    "attention_f32": dict(attention_resolutions=(2,), middle_attention=True,
                          num_heads=2),
    "int8_dynamic": dict(int8=quant.Int8Config(exclude=())),
    "int8_static": dict(int8=quant.Int8Config(scales="const:0.02")),
}
# the Seg models under a group: each fusion (a 1-channel conditioner) and
# a 6-channel alias (its 3-channel conditioner), at TINY's widths
SEG_FUSIONS = ("add", "cat_conv", "midcat")
SEG_MODELS = SEG_FUSIONS + ("SegModelv2_6c",)
# the forwards each Seg model checks at 2 and 3 ranks: f32, bf16, int8 with
# dynamic scales as the Seg models serve it (the input convs and the head
# excluded); the additive model also with attention in both branches (2
# ranks)
SEG_VARIANTS = {"f32": {}, "bf16": dict(dtype=torch.bfloat16),
                "int8_dynamic": dict(int8=quant.Int8Config())}
SEG_ATTENTION = dict(attention_resolutions=(2,), num_heads=2)
# a Seg model's bf16 sharded forward against its unsharded one: within this
# factor of the unsharded forward's own noise (every GroupNorm's sums one
# f32 ulp larger: the shards' sums differ from the unsharded ones by their
# order, a few ulps either way), which stays under the ceiling (these tiny
# random dual-branch models read 1.3-2.0 % at 2 and 3 ranks; the sharded
# forwards 1.2-1.8 %, up to 1.12 times the noise)
SEG_NOISE_FACTOR = 2.0
SEG_BF16_NOISE_CEILING = 3e-2
# the patches of the Seg models' chains against JAX (one batch a rank)
SEG_P = 2
# (world size, model, variant) of every Seg forward the groups check
SEG_CASES = ([(w, n, v) for w in (2, 3) for n in SEG_MODELS
              for v in SEG_VARIANTS] + [(2, "add", "attention_f32")])


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests (the suite's workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _seeded(model, seed: int):
    """``model`` with a seeded state dict (GroupNorm gains near 1, every
    other tensor small noise, heads too); returns (model in eval mode, the
    state dict as numpy arrays)."""
    rng = np.random.default_rng(seed)
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval(), sd


def _tiny(seed: int = 7, **kw):
    return _seeded(SuperResModel(in_channels=1, **dict(TINY, **kw)), seed)


def _seg_cond(name: str) -> int:
    """The conditioner's channels of a Seg model of SEG_MODELS."""
    return 1 if name in SEG_FUSIONS else 3


def _seg_tiny(name: str, seed: int = 17, **kw):
    """A Seg model of SEG_MODELS at TINY's widths, seeded as :func:`_seeded`:
    a fusion of SegUNetModel, or the alias of that name."""
    kw = dict(TINY, in_channels=1, **kw)
    model = (SegUNetModel(cond_channels=1, fusion=name, **kw)
             if name in SEG_FUSIONS else getattr(tmodels, name)(**kw))
    assert model.encoder.input_blocks[0][0].weight.shape[1] == _seg_cond(
        name)
    return _seeded(model, seed)


def _chain():
    """The 4-step schedule and learned-range config of the JAX test, in
    the port's types."""
    sched = tdiffusion.make_schedule(np.linspace(1e-4, 0.02, 4))
    cfg = tdiffusion.DiffusionConfig(
        tdiffusion.MeanType.EPSILON, tdiffusion.VarType.LEARNED_RANGE,
        tdiffusion.LossType.MSE, original_num_steps=4)
    return sched, cfg


def _chain_inputs():
    """Patches, x_T and a 4-step noise stream of the JAX comparison."""
    rng = np.random.default_rng(11)
    low = rng.standard_normal((P, Z, X, Y)).astype(np.float32)
    x_t = rng.standard_normal((P, Z, X, Y)).astype(np.float32)
    stream = rng.standard_normal((P, 4, Z, X, Y)).astype(np.float32)
    return low, x_t, stream


def _seg_patches(name: str) -> np.ndarray:
    """The conditioner patches of a Seg model's JAX comparison: the chain's
    first SEG_P [Z, X, Y] at one channel, else [SEG_P, Z, X, Y, C] of
    their own."""
    cond = _seg_cond(name)
    if cond == 1:
        return _chain_inputs()[0][:SEG_P]
    rng = np.random.default_rng(12)
    return rng.standard_normal((SEG_P, Z, X, Y, cond)).astype(np.float32)


# ---------------------------------------------------------------- ranks --

def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _collectives(group: SpatialGroup, mesh: Mesh) -> dict:
    """The group's four operations against slices of whole tensors that
    every rank makes from the same seeds."""
    g = torch.Generator().manual_seed(3)
    whole = torch.randn((2, 3, 6 * mesh.n_spatial, 5, 4), generator=g)
    h, s = 6, mesh.spatial_index
    local = whole[:, :, s * h:(s + 1) * h]
    xh, (lo, hi) = group.halo(local)
    mine = [torch.randn((2, 2, 3), generator=torch.Generator().manual_seed(
        100 + r)) for r in range(mesh.n_spatial)]
    return {
        "halo_equal": bool(torch.equal(
            xh, whole[:, :, s * h - lo:(s + 1) * h + hi])),
        "halo_sides": np.asarray([lo, hi]),
        "gather_equal": bool(torch.equal(group.all_gather_h(local), whole)),
        "sum_equal": bool(torch.allclose(group.all_reduce_sum(mine[s]),
                                         sum(mine), rtol=1e-6, atol=1e-6)),
        "max_equal": bool(torch.equal(group.all_reduce_max(mine[s]),
                                      torch.stack(mine).amax(0))),
        "input_kept": bool(torch.equal(mine[s], torch.randn(
            (2, 2, 3), generator=torch.Generator().manual_seed(100 + s)))),
    }


def _sharded(module, group, mesh, x, **kw):
    """``module`` on this rank's H rows of x under ``group``, gathered
    back to the whole."""
    module.spatial = group
    try:
        with torch.no_grad():
            out = module(shard_batch(mesh, x, 2), **kw)
    finally:
        module.spatial = None
    return group.all_gather_h(out)


def _ops(group: SpatialGroup, mesh: Mesh) -> dict:
    """The sharded conv (f32, bf16, the int8 up route), fused conv with a
    skip and GroupNorm (full and folded) against the unsharded port on the
    same whole input; the int8 site's scales recorded on both."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3

    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 12, 10, 16), generator=g)
    out = {}
    conv = Conv3x3x3(16, 8).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.1)
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.1)
    for name, dt in (("conv_f32", torch.float32), ("conv_bf16",
                                                   torch.bfloat16)):
        with torch.no_grad():
            ref = conv(x.to(dt))
        out[name] = _rel(_sharded(conv, group, mesh, x.to(dt)), ref)
    # the int8 up route: the phase conv on the low-resolution x, haloed
    conv.int8, conv.site = quant.Int8Config(exclude=()), "up"
    scales = []
    real = quant.quantize_act

    def record(x, static_scale=None, spatial=None):
        q, s = real(x, static_scale, spatial)
        scales.append(s)
        return q, s

    quant.quantize_act = record
    try:
        with torch.no_grad():
            ref = conv(x, upsample=True)
        got = _sharded(conv, group, mesh, x, upsample=True)
    finally:
        quant.quantize_act = real
        conv.int8 = None
    out["int8_up_equal"] = bool(torch.equal(got, ref))
    out["int8_up_shape"] = np.asarray(got.shape)
    out["int8_up_scale_equal"] = bool(torch.equal(scales[0], scales[1]))
    # the fused conv: prologue, skip, no stats under the group
    pg = torch.rand((2, 16), generator=g) + 0.5
    pb = torch.randn((2, 16), generator=g) * 0.1
    skip = torch.randn((2, 3, 12, 10, 8), generator=g)
    with torch.no_grad():
        ref = conv(x, fused=True, prologue_g=pg, prologue_b=pb, skip=skip)
    conv.spatial = group
    try:
        with torch.no_grad():
            got = conv(shard_batch(mesh, x, 2), fused=True, prologue_g=pg,
                       prologue_b=pb, skip=shard_batch(mesh, skip, 2))
    finally:
        conv.spatial = None
    out["fused_conv"] = _rel(group.all_gather_h(got), ref)
    gn = GroupNorm32(16, num_groups=4).eval()
    fs, fh = torch.randn((2, 16), generator=g), torch.randn((2, 16),
                                                            generator=g)
    with torch.no_grad():
        ref = gn(x, film_scale=fs, film_shift=fh, apply_silu=True)
        ref_fold = gn(x, film_scale=fs, film_shift=fh, fold_only=True)
    out["gn"] = _rel(_sharded(gn, group, mesh, x, film_scale=fs,
                              film_shift=fh, apply_silu=True), ref)
    gn.spatial = group
    with torch.no_grad():
        fold = gn(shard_batch(mesh, x, 2), film_scale=fs, film_shift=fh,
                  fold_only=True)
    gn.spatial = None
    out["gn_fold"] = max(_rel(a, b) for a, b in zip(fold, ref_fold))
    return out


def _sharded_forward(model, group: SpatialGroup, mesh: Mesh, x, t, low,
                     name: str, exact: bool = False) -> dict:
    """``model`` on this rank's rows of x and low under ``group`` against
    its unsharded forward (``fwd_<name>``), with the collectives the
    sharded forward called (``calls_<name>``) and, in int8, every site's
    local abs-max and scale (``sites_<name>``); with ``exact``, each int8
    site run unsharded on its gathered input against its gathered output
    (``exact_<name>``: [sites checked, sites unequal])."""
    from ddpm3d_tpu_torch.models.nn import Conv1x1x1, Conv3x3x3

    with torch.no_grad():
        ref = model(x, t, low_res=low)
    record, caught = [], []
    real = quant.quantize_act

    def recording(x, static_scale=None, spatial=None):
        record.append(torch.linalg.vector_norm(
            x.reshape(x.shape[0], -1), float("inf"), dim=1,
            dtype=torch.float32))
        q, s = real(x, static_scale, spatial)
        record.append(s)
        return q, s

    def catch(mod, args, kwargs, y):
        caught.append((mod, args[0], bool(kwargs.get("upsample")), y))

    hooks = [m.register_forward_hook(catch, with_kwargs=True)
             for m in model.modules() if exact
             and isinstance(m, (Conv3x3x3, Conv1x1x1)) and m.int8_active()]
    quant.quantize_act = recording
    model.set_spatial(group)
    before = tracing.counters("spatial.")
    try:
        with torch.no_grad():
            got = model(shard_batch(mesh, x, 2), t,
                        low_res=shard_batch(mesh, low, 2))
    finally:
        quant.quantize_act = real
        model.set_spatial(None)
        for h in hooks:
            h.remove()
    after = tracing.counters("spatial.")
    out = {f"calls_{name}": np.asarray([
        after.get(f"spatial.{k}", 0) - before.get(f"spatial.{k}", 0)
        for k in CALLS]),
        f"fwd_{name}": _rel(group.all_gather_h(got), ref)}
    if record:
        out[f"sites_{name}"] = torch.stack(record).numpy()
    if exact:
        unequal = 0
        for mod, xin, up, y in caught:
            with torch.no_grad():
                xw = group.all_gather_h(xin)
                yw = mod(xw, upsample=True) if up else mod(xw)
            unequal += not torch.equal(yw, group.all_gather_h(y))
        out[f"exact_{name}"] = np.asarray([len(caught), unequal])
    return out


def _forwards(group: SpatialGroup, mesh: Mesh) -> dict:
    """Model variants, sharded against unsharded on one input; the int8
    ones also record every site's local abs-max and scale."""
    g = torch.Generator().manual_seed(9)
    n_s = mesh.n_spatial
    x = torch.randn((1, 4, 8 * n_s, 16, 1), generator=g)
    low = torch.randn(x.shape, generator=g)
    t = torch.tensor([2])
    # the wider group checks the plain model alone
    variants = VARIANTS if n_s == 2 else {"unfused_f32": {}}
    out = {}
    for name, kw in variants.items():
        model, _ = _tiny(**kw)
        out.update(_sharded_forward(model, group, mesh, x, t, low, name))
        if kw.get("dtype") == torch.bfloat16:
            with torch.no_grad():
                out[f"noise_{name}"] = _rel(
                    model(x, t, low_res=low), _tiny()[0](x, t, low_res=low))
    return out


def _seg_forwards(group: SpatialGroup, mesh: Mesh) -> dict:
    """Each Seg model of SEG_MODELS in each SEG_VARIANTS variant (and the
    additive one with attention, at 2 ranks), sharded against unsharded on
    one input, int8 sites checked exactly (:func:`_sharded_forward`); the
    keys end in ``seg_<model>_<variant>``."""
    g = torch.Generator().manual_seed(19)
    x = torch.randn((1, 4, 8 * mesh.n_spatial, 16, 1), generator=g)
    t = torch.tensor([3])
    out = {}
    for name in SEG_MODELS:
        low = torch.randn(x.shape[:-1] + (_seg_cond(name),), generator=g)
        variants = dict(SEG_VARIANTS)
        if name == "add" and mesh.n_spatial == 2:
            variants["attention_f32"] = SEG_ATTENTION
        for variant, kw in variants.items():
            model, _ = _seg_tiny(name, **kw)
            key = f"seg_{name}_{variant}"
            out.update(_sharded_forward(model, group, mesh, x, t, low, key,
                                        exact=variant.startswith("int8")))
            if variant == "bf16":
                out[f"noise_{key}"] = _one_ulp_noise(model, x, t, low)
    return out


def _one_ulp_noise(model, x, t, low) -> float:
    """The unsharded forward's own noise: its distance from itself with
    every GroupNorm's sums one f32 ulp larger."""
    real = gn_ops.channel_stats
    with torch.no_grad():
        ref = model(x, t, low_res=low)
        gn_ops.channel_stats = lambda v: real(v) * (1 + 2.0 ** -23)
        try:
            return _rel(model(x, t, low_res=low), ref)
        finally:
            gn_ops.channel_stats = real


def _worker(out_dir: str) -> None:
    """One rank: every scenario of its group's mesh; the report goes to
    ``report{rank}.npz``."""
    torch.set_num_threads(2)
    from ddpm3d_tpu_torch.parallel import destroy, maybe_initialize_distributed

    rank, world_size = maybe_initialize_distributed("cpu")
    n_data, n_spatial = GROUPS[world_size]
    report = {}
    if world_size == 3:
        try:
            make_mesh(n_spatial=2, device="cpu")
        except ValueError as e:
            report["indivisible_w"] = str(e)
    mesh = make_mesh(n_data=n_data, n_spatial=n_spatial, device="cpu")
    group = mesh.spatial
    report.update(_collectives(group, mesh))
    report["ranks"] = np.asarray(group.ranks)
    sched, cfg = _chain()
    model, _ = _tiny()
    low, x_t, stream = _chain_inputs()
    kw = dict(device="cpu", batch_size=2)
    if world_size == 3:
        report.update(_forwards(group, mesh))
        report.update(_seg_forwards(group, mesh))
    elif world_size == 2:
        report.update(_ops(group, mesh))
        report.update(_forwards(group, mesh))
        report.update(_seg_forwards(group, mesh))
        report["jax_parity"] = denoise_patches(
            model, sched, cfg, low, noise=x_t, noise_stream=stream,
            mesh=mesh, **kw)
        for name in SEG_MODELS:
            report[f"jax_parity_seg_{name}"] = denoise_patches(
                _seg_tiny(name)[0], sched, cfg, _seg_patches(name),
                noise=x_t[:SEG_P], noise_stream=stream[:SEG_P], mesh=mesh,
                **kw)
        try:
            denoise_patches(model, sched, cfg, low[:, :, :14], mesh=mesh,
                            **kw)
        except ValueError as e:
            report["indivisible_h"] = str(e)
    # drawn noise: the spatial mesh against the data split of the same
    # world (every rank samples whole patches), and the DPM chain's x_T;
    # 12 rows split over 2 and 3 ranks, batch 1 as every split has it
    split = make_mesh(device="cpu")
    for name, extra in (("ddpm", {}), ("dpm", dict(use_dpm_solver=True))):
        for key, m in (("drawn", mesh), ("split", split)):
            report[f"{key}_{name}"] = denoise_patches(
                model, sched, cfg, low[:, :, :12], seed=4, mesh=m,
                device="cpu", **extra)
    report["spatial_detached"] = model.spatial is None
    np.savez(osp.join(out_dir, f"report{rank}.npz"), **report)
    destroy()


# ---------------------------------------------------------- the groups --

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finish(procs):
    """The return code of each process; kills them all if one fails or the
    time runs out, so that no rank waits on a collective forever."""
    results = []
    try:
        for p in procs:
            results.append(p.wait(timeout=TIMEOUT_S))
            if results[-1] != 0:
                break
    finally:
        _kill(procs)
    return results


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_chain(apply, params, low):
    """JAX's denoise_patches on a (4, 2) mesh of the 8 virtual devices, on
    the 4-step schedule, x_T and noise stream the ranks use (the first of
    them, one a patch of ``low``)."""
    sched = jdiffusion.make_schedule(np.linspace(1e-4, 0.02, 4))
    cfg = jdiffusion.DiffusionConfig(
        jdiffusion.MeanType.EPSILON, jdiffusion.VarType.LEARNED_RANGE,
        jdiffusion.LossType.MSE, original_num_steps=4)
    _, x_t, stream = _chain_inputs()
    n = low.shape[0]
    mesh = jax_make_mesh(n_data=4, n_spatial=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDPM3D_INT8", "0")
        return jax_denoise_patches(jax.random.key(1), apply, params, sched,
                                   cfg, low, mesh=mesh, noise=x_t[:n],
                                   noise_stream=stream[:n])


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """{world size: (report directory, its ranks' processes)}, every group
    started at once; their output goes to ``rank<r>.log`` there. Any rank
    still running at the module's end is killed."""
    tmp = tmp_path_factory.mktemp("spatial")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    groups = {}
    try:
        for w in GROUPS:
            out = tmp / f"w{w}"
            out.mkdir()
            port = str(_free_port())
            procs = []
            groups[w] = (out, procs)
            for r in range(w):
                with open(out / f"rank{r}.log", "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, __file__, str(out)], cwd=REPO,
                        env=dict(env, RANK=str(r), WORLD_SIZE=str(w),
                                 LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                                 MASTER_PORT=port),
                        stdout=log, stderr=subprocess.STDOUT))
        yield groups
    finally:
        for _, procs in groups.values():
            _kill(procs)


@pytest.fixture(scope="module")
def jax_volume(launched):
    """JAX's denoise_patches of the SuperResModel on the params, x_T and
    noise stream the ranks use (while the ranks run)."""
    _, sd = _tiny()
    jm = JaxSuperRes(in_channels=1, **TINY)
    params = torch_state_dict_to_params(sd, wrap_superres=True)
    return _jax_chain(jm.apply, params, _chain_inputs()[0])


@pytest.fixture(scope="module")
def jax_seg_volumes(launched):
    """{Seg model: JAX's denoise_patches of it} (:func:`_jax_chain`), on
    the ports' seeded params carried to JAX by its importer. JAX's
    pipeline takes 1-channel conditioner patches: a C-channel conditioner
    goes in with its channels laid along Z, [P, C * Z, X, Y] (X, the
    sharded axis, untouched), and the model's apply lays them back."""
    volumes = {}
    for name in SEG_MODELS:
        _, sd = _seg_tiny(name)
        kw = dict(TINY, in_channels=1)
        jm = (jmodels.SegUNetModel(cond_channels=1, fusion=name, **kw)
              if name in SEG_FUSIONS else getattr(jmodels, name)(**kw))
        low, apply, cond = _seg_patches(name), jm.apply, _seg_cond(name)
        if cond > 1:
            low = np.concatenate(list(np.moveaxis(low, -1, 0)), axis=1)

            def apply(variables, x, t, low_res, jm=jm, cond=cond):
                b, cz, h, w, _ = low_res.shape
                c = low_res.reshape(b, cond, cz // cond, h, w)
                return jm.apply(variables, x, t,
                                low_res=jax.numpy.moveaxis(c, 1, -1))

        volumes[name] = _jax_chain(apply, torch_state_dict_to_params(sd),
                                   low)
    return volumes


@pytest.fixture(scope="module")
def runs(launched, jax_volume, jax_seg_volumes):
    """{world size: [report of each rank]}, read once every rank is done
    (the JAX chains, which the comparisons need, run in this process
    meanwhile)."""
    reports = {}
    for w, (out, procs) in launched.items():
        for r, rc in enumerate(_finish(procs)):
            assert rc == 0, (out / f"rank{r}.log").read_text()
        reports[w] = [dict(np.load(out / f"report{r}.npz"))
                      for r in range(w)]
    return reports


def test_port_matches_jax_under_spatial_mesh(runs, jax_volume):
    """The port's denoise_patches on 2 gloo ranks, make_mesh(n_data=1,
    n_spatial=2), against JAX's on make_mesh(n_data=4, n_spatial=2): same
    params, x_T and noise stream, JAX's own tolerance."""
    assert jax_volume.shape == (P, Z, X, Y)
    assert np.abs(jax_volume).max() > 1e-2
    for report in runs[2]:
        np.testing.assert_allclose(report["jax_parity"], jax_volume,
                                   rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("name", SEG_MODELS)
def test_seg_port_matches_jax_under_spatial_mesh(runs, jax_seg_volumes,
                                                 name):
    """Each Seg fusion and a 6-channel alias (a 3-channel conditioner,
    whose channels the ranks slice by X rows alone): the port's
    denoise_patches on 2 gloo ranks, make_mesh(1, 2), against JAX's on
    make_mesh(4, 2) with the same params, x_T and noise stream, JAX's own
    tolerance."""
    ref = jax_seg_volumes[name]
    assert ref.shape == (SEG_P, Z, X, Y)
    assert np.abs(ref).max() > 1e-2
    for report in runs[2]:
        np.testing.assert_allclose(report[f"jax_parity_seg_{name}"], ref,
                                   rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_collectives_match_slices_of_the_whole(runs, world):
    """halo gives each rank's rows with a neighbour plane on each side that
    has one (none at the group's edges); all_gather_h, the sums and maxima
    equal those of the whole; reductions leave their input as it was."""
    n_data, n_spatial = GROUPS[world]
    for rank, report in enumerate(runs[world]):
        s = rank % n_spatial
        assert list(report["ranks"]) == list(range(
            rank - s, rank - s + n_spatial))
        assert list(report["halo_sides"]) == [int(s > 0),
                                              int(s < n_spatial - 1)]
        for key in ("halo_equal", "gather_equal", "sum_equal", "max_equal",
                    "input_kept"):
            assert report[key], (rank, key)


@pytest.mark.parametrize("op", ["conv_f32", "conv_bf16", "fused_conv", "gn",
                                "gn_fold"])
def test_sharded_ops_match_unsharded(runs, op):
    """Each rank's conv (halo, SAME padding, crop), fused conv (its skip
    padded, no stats) and GroupNorm (full and folded, sums over the group)
    on its rows, gathered: the unsharded port's result."""
    # one bf16 rounding apart where the f32 sums differ in order
    tol = 2.0 ** -8 if op.endswith("bf16") else TOL["f32"]
    for report in runs[2]:
        assert float(report[op]) <= tol, (op, float(report[op]))


def test_sharded_int8_up_route_is_exact(runs):
    """The int8 up site (the phase conv on the low-resolution x, haloed
    there, 2 up-resolution rows cropped a side): bit-equal to the
    unsharded site, with the same dynamic scale (the group's abs-max)."""
    for report in runs[2]:
        assert list(report["int8_up_shape"]) == [2, 3, 24, 20, 8]
        assert report["int8_up_equal"]
        assert report["int8_up_scale_equal"]


@pytest.mark.parametrize("world,variant", [
    (2, "unfused_f32"), (2, "unfused_bf16"), (2, "fused_f32"),
    (2, "attention_f32"), (2, "int8_dynamic"), (2, "int8_static"),
    (3, "unfused_f32")])
def test_sharded_model_matches_unsharded(runs, world, variant):
    """The whole SuperResModel with its H split over the group: unfused
    (f32, bf16), fused, middle attention, int8 with dynamic and static
    scales, and the plain model over 3 ranks, against the unsharded port
    on the same input."""
    for report in runs[world]:
        rel = float(report[f"fwd_{variant}"])
        tol = (float(report[f"noise_{variant}"]) if variant.endswith("bf16")
               else TOL["int8" if variant.startswith("int8") else "f32"])
        assert rel <= tol, (variant, rel, tol)
        if variant.endswith("bf16"):
            assert tol <= TOL["bf16"], (variant, "bf16 noise", tol)


@pytest.mark.parametrize("world,name,variant", SEG_CASES)
def test_sharded_seg_matches_unsharded(runs, world, name, variant):
    """Each Seg model with its H split over the group (both branches, the
    fusion and the skips on the same rows) against the unsharded port on
    the same input: f32 to summation order, bf16 within SEG_NOISE_FACTOR
    times its own one-ulp noise (itself under SEG_BF16_NOISE_CEILING), int8
    within INT8's bound (each site exact:
    test_seg_int8_sites_exact_under_spatial); the additive model with
    attention in both branches at 2 ranks."""
    key = f"seg_{name}_{variant}"
    for report in runs[world]:
        rel = float(report[f"fwd_{key}"])
        if variant == "bf16":
            noise = float(report[f"noise_{key}"])
            assert noise <= SEG_BF16_NOISE_CEILING, (key, "noise", noise)
            tol = SEG_NOISE_FACTOR * noise
        else:
            tol = TOL["int8" if variant.startswith("int8") else "f32"]
        assert rel <= tol, (key, rel, tol)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", SEG_MODELS)
def test_seg_int8_sites_exact_under_spatial(runs, world, name):
    """Every int8 site of a Seg model under the group (both branches, the
    cat_conv fusion's 1x1 convs, midcat's 2C -> C skip): its output on the
    ranks, gathered, bit-equal to the unsharded site on the gathered
    input; its dynamic scale, on every rank, the scale of that whole input
    (the max of the ranks' abs-maxima)."""
    from ddpm3d_tpu_torch.ops.quant import _abs_max_scale

    key = f"seg_{name}_int8_dynamic"
    model, _ = _seg_tiny(name, **SEG_VARIANTS["int8_dynamic"])
    n_sites = sum(m.int8_active() for m in model._sites())
    assert n_sites > 0
    sites = [r[f"sites_{key}"] for r in runs[world]]
    want = _abs_max_scale(torch.from_numpy(
        np.maximum.reduce([s[0::2] for s in sites]))).numpy()
    for report, s in zip(runs[world], sites):
        assert list(report[f"exact_{key}"]) == [n_sites, 0]
        assert s.shape == (2 * n_sites, 1)
        np.testing.assert_array_equal(s[1::2], want)


@pytest.mark.parametrize("world,name,variant", SEG_CASES)
def test_seg_spatial_calls_per_forward(runs, world, name, variant):
    """The collectives of one Seg forward, on every rank alike: a halo per
    3x3x3 conv and a sum per GroupNorm of both branches, a max per
    dynamically quantized site (the 1x1 fusion and skip sites among them),
    a gather per attention block, nothing else."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3
    from ddpm3d_tpu_torch.models.unet import AttentionBlock

    kw = SEG_ATTENTION if variant == "attention_f32" else SEG_VARIANTS[
        variant]
    model, _ = _seg_tiny(name, **kw)
    mods = list(model.modules())
    want = [sum(isinstance(m, Conv3x3x3) for m in mods),
            sum(isinstance(m, GroupNorm32) for m in mods),
            sum(m.int8_active() for m in model._sites()),
            sum(isinstance(m, AttentionBlock) for m in mods)]
    assert want[3] == (4 if variant == "attention_f32" else 0)
    for report in runs[world]:
        assert list(report[f"calls_seg_{name}_{variant}"]) == want


@pytest.mark.parametrize("variant", ["int8_dynamic", "int8_static"])
def test_int8_site_scales_are_the_groups(runs, variant):
    """Every int8 site's activation scale: with dynamic scales, bit-equal on
    every rank to the scale of the whole input (the max of the ranks'
    local abs-maxima, which a max gives in any order); static, the file's."""
    from ddpm3d_tpu_torch.ops.quant import _abs_max_scale

    sites = [r[f"sites_{variant}"] for r in runs[2]]
    model, _ = _tiny(**VARIANTS[variant])
    n_sites = sum(m.int8_active() for m in model._sites())
    amax = np.maximum.reduce([s[0::2] for s in sites])
    want = (_abs_max_scale(torch.from_numpy(amax)).numpy()
            if variant == "int8_dynamic"
            else np.full_like(amax, 0.02, dtype=np.float32))
    for s in sites:
        assert s.shape == (2 * n_sites, 1)
        np.testing.assert_array_equal(s[1::2], want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spatial_calls_per_forward(runs, variant):
    """The collectives of one forward, on every rank alike: a halo per
    3x3x3 conv, a sum per GroupNorm (a fused ResBlock's folds among them),
    a max per dynamically quantized site, a gather per attention block."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3
    from ddpm3d_tpu_torch.models.unet import AttentionBlock

    model, _ = _tiny(**VARIANTS[variant])
    mods = list(model.modules())
    dynamic = model.int8 is not None and not model.int8.scales
    want = [sum(isinstance(m, Conv3x3x3) for m in mods),
            sum(isinstance(m, GroupNorm32) for m in mods),
            sum(m.int8_active() for m in model._sites()) if dynamic else 0,
            sum(isinstance(m, AttentionBlock) for m in mods)]
    for report in runs[2]:
        assert list(report[f"calls_{variant}"]) == want


@pytest.mark.parametrize("world", [2, 3, 4])
def test_drawn_noise_matches_data_split(runs, world):
    """Seeded chains (DDPM, and DPM-Solver++ from a drawn x_T) under the
    spatial mesh against the same world's data split: each rank draws the
    whole patch's noise and keeps its rows, so the volumes agree to the
    f32 summation order of the GroupNorm sums; the data groups of (2, 2)
    give (1, 2)'s volume bit for bit. The model leaves the call without a
    group."""
    for report in runs[world]:
        assert report["spatial_detached"]
        for name in ("ddpm", "dpm"):
            got, ref = report[f"drawn_{name}"], report[f"split_{name}"]
            assert got.shape == (P, Z, 12, Y)
            np.testing.assert_allclose(got, ref, rtol=JAX_RTOL,
                                       atol=JAX_ATOL)
    for name in ("ddpm", "dpm"):
        np.testing.assert_array_equal(runs[4][0][f"drawn_{name}"],
                                      runs[2][0][f"drawn_{name}"])


def test_indivisible_world_and_height_raise(runs):
    """3 ranks do not make spatial groups of 2; 14 rows do not split over
    2 ranks into whole pairs (the model pools H once), and the message
    names the sizes that do."""
    assert "3 ranks do not split" in str(runs[3][0]["indivisible_w"])
    msg = str(runs[2][0]["indivisible_h"])
    assert "H = 14" in msg and "allowed sizes: [1, 7]" in msg


def test_make_mesh_without_a_process_group():
    """One process: a (1, 1) mesh whose group of one changes nothing; a
    spatial axis or a data axis of 2 raises."""
    mesh = make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_spatial, mesh.data_index,
            mesh.spatial_index) == (1, 1, 0, 0)
    assert mesh.axis_names == (DATA_AXIS, SPATIAL_AXIS) == ("data",
                                                            "spatial")
    assert mesh.shape == {"data": 1, "spatial": 1}
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh(n_spatial=2, device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 1\) mesh needs 2 ranks"):
        make_mesh(n_data=2, device="cpu")


def test_shard_batch_takes_rows_and_h_slice():
    """shard_batch: the data group's equal rows, then the spatial slice of
    the axis given, for tensors and arrays."""
    mesh = Mesh(2, 2, 1, SpatialGroup([2, 3], 1), torch.device("cpu"))
    x = np.arange(4 * 2 * 8 * 3).reshape(4, 2, 8, 3)
    np.testing.assert_array_equal(shard_batch(mesh, x), x[2:4])
    np.testing.assert_array_equal(shard_batch(mesh, x, spatial_dim=2),
                                  x[2:4, :, 4:8])
    assert torch.equal(shard_batch(mesh, torch.from_numpy(x), 2),
                       torch.from_numpy(x[2:4, :, 4:8]))
    with pytest.raises(ValueError):
        shard_batch(mesh, x[:3])


def test_group_of_one_is_the_identity():
    """A spatial group of one rank returns every input itself, calls no
    collective (no process group exists here) and leaves the model
    unsharded."""
    group = SpatialGroup([0], 0)
    before = tracing.counters("spatial.")
    x = torch.randn((1, 2, 4, 3, 2))
    assert group.halo(x) == (x, (0, 0))
    assert group.halo(x)[0] is x
    assert group.all_reduce_sum(x) is x and group.all_reduce_max(x) is x
    assert group.all_gather_h(x) is x
    assert tracing.counters("spatial.") == before
    model, _ = _tiny()
    model.set_spatial(group)
    assert model.spatial is None
    assert all(getattr(m, "spatial", None) is None for m in model.modules())


def test_spatial_serving_refusals():
    """Under a group of several ranks: training, the standalone encoder,
    1-D/2-D models and the calibration mode are refused; an H that does not
    pool down evenly raises in the forward; GroupNorm over a group raises
    under autograd. Every Seg model and alias is admitted in eval mode (its
    encoder branch with it), and refuses training, the calibration mode and
    an uneven H as SuperResModel does; the encoder under a group returns
    its features alone."""
    group = SpatialGroup([0, 1], 0)  # refused before any collective
    model, _ = _tiny()
    model.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        model.set_spatial(group)
    model.eval().set_spatial(group)
    model.train()
    x = torch.zeros((1, 4, 8, 16, 1))
    with pytest.raises(RuntimeError, match="inference-only"):
        model(x, torch.tensor([1]), low_res=x)
    model.eval()
    odd = torch.zeros((1, 4, 3, 16, 1))
    with pytest.raises(ValueError, match="multiple of 2"):
        model(odd, torch.tensor([1]), low_res=odd)
    with pytest.raises(ValueError, match="calibration"):
        model.set_calibration(quant.ActCalibration())
    model.set_spatial(None)
    model.set_calibration(quant.ActCalibration())
    with pytest.raises(ValueError, match="calibration"):
        model.set_spatial(group)
    enc = EncoderUNetModel(in_channels=1, model_channels=32, out_channels=2,
                           num_res_blocks=1, channel_mult=(1, 2)).eval()
    with pytest.raises(ValueError, match="heads pool over the whole patch"):
        enc.set_spatial(group)
    names = ("SegModelv2", "SegModelv2_3d_noatt", "SegModelv3",
             "SegModel_3d_noatt_midcat", "SegModelv2_6c", "SegModelv3_6c")
    for name in names:
        cond = {} if name.endswith("_6c") else dict(cond_channels=1)
        seg = getattr(tmodels, name)(
            in_channels=1, model_channels=32, out_channels=2,
            num_res_blocks=1, channel_mult=(1, 2), **cond).eval()
        assert seg.spatial_multiple == seg.encoder.spatial_multiple == 2
        seg.set_spatial(group)
        assert seg.encoder.spatial is group
        assert all(m.spatial is group for m in seg.encoder.modules()
                   if isinstance(m, GroupNorm32))
        assert all(m.spatial is group for m in seg._sites())
        cond = seg.encoder.input_blocks[0][0].weight.shape[1]
        low = torch.zeros((1, 4, 3, 16, cond))
        with pytest.raises(ValueError, match="multiple of 2"):
            seg(odd, torch.tensor([1]), low_res=low)
        seg.train()
        with pytest.raises(RuntimeError, match="inference-only"):
            seg(x, torch.tensor([1]), low_res=low)
        with pytest.raises(RuntimeError, match="inference-only"):
            seg.set_spatial(group)
        seg.eval()
        with pytest.raises(ValueError, match="calibration"):
            seg.set_calibration(quant.ActCalibration())
        with pytest.raises(RuntimeError, match="return_features=True"):
            seg.encoder(low, torch.tensor([1]))
        seg.set_spatial(None)
        assert seg.encoder.spatial is None
    seg.set_calibration(quant.ActCalibration())
    with pytest.raises(ValueError, match="calibration"):
        seg.set_spatial(group)
    flat = UNetModel(in_channels=1, model_channels=32, out_channels=2,
                     num_res_blocks=1, channel_mult=(1, 2), dims=2).eval()
    with pytest.raises(ValueError, match="3-D"):
        flat.set_spatial(group)
    gn = GroupNorm32(8, num_groups=4)
    gn.spatial = group
    gx = torch.randn((1, 4, 8), requires_grad=True)
    for fold_only in (False, True):
        with pytest.raises(RuntimeError, match="forward-only"):
            gn(gx, fold_only=fold_only)


def test_allowed_spatial_sizes():
    """The production patch (96 rows, 4 H downsamplings): 1, 2, 3 or 6
    ranks; any other size raises naming them."""
    assert allowed_spatial(96, 16) == [1, 2, 3, 6]
    check_spatial_split(96, 6, 16)
    with pytest.raises(ValueError, match=r"allowed sizes: \[1, 2, 3, 6\]"):
        check_spatial_split(96, 4, 16)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm"])
def test_spatial_axis_of_one_is_todays_path(sampler):
    """mesh=None and a (1, 1) mesh give the volume of the patch-by-patch
    chains that the pipeline ran before it had a mesh, bit for bit."""
    sched, cfg = _chain()
    model, _ = _tiny()
    low = _chain_inputs()[0][:3]
    kw = dict(use_dpm_solver=sampler == "dpm")
    none = denoise_patches(model, sched, cfg, low, seed=4, batch_size=2,
                           device="cpu", **kw)
    one = denoise_patches(model, sched, cfg, low, seed=4, batch_size=2,
                          device="cpu",
                          mesh=make_mesh(n_spatial=1, device="cpu"), **kw)
    ref = []
    with torch.inference_mode():
        for lo in (0, 2):
            ids = range(lo, min(3, lo + 2))
            c = torch.from_numpy(low[lo:lo + 2][..., None])

            def fn(x, t, low_res):
                return model(x, t, low_res=low_res).float()

            if sampler == "dpm":
                x_t = tdiffusion.sampling.step_noise(
                    4, ids, tdiffusion.sampling.XT_STEP, c.shape[1:], "cpu")
                img = tdiffusion.dpm_solver_pp_sample_loop(
                    fn, sched, cfg, x_t, model_kwargs={"low_res": c},
                    device="cpu")
            else:
                img = tdiffusion.p_sample_loop(
                    fn, sched, cfg, shape=c.shape, model_kwargs={
                        "low_res": c}, seed=4, sample_ids=ids, device="cpu")
            ref.append(img[..., 0])
    ref = torch.cat(ref).numpy()
    np.testing.assert_array_equal(none, ref)
    np.testing.assert_array_equal(one, ref)


def test_step_noise_window_is_a_slice_of_the_whole():
    """A spatial rank's step noise: the whole patch's draw, its rows."""
    from ddpm3d_tpu_torch.diffusion.sampling import step_noise

    whole = step_noise(3, [4, 9], 17, (4, 12, 5, 1), "cpu")
    part = step_noise(3, [4, 9], 17, (4, 4, 5, 1), "cpu",
                      ((4, 12, 5, 1), 4, 8))
    assert torch.equal(part, whole[:, :, 4:8])


if __name__ == "__main__":
    _worker(sys.argv[1])
