"""Where a GroupNorm's fold runs, on the CPU (``ddpm3d_tpu_torch/ops/
groupnorm.py``): the fold of a GroupNorm's sums into its [B, C] affine runs
in K1 on the card (``route.gn_fold.k1``), in a launch of its own for sums
handed in (``route.gn_fold.launch``) and in torch ops on the CPU
(``route.gn_fold.torch``). On the CPU every GroupNorm of a model counts one
torch fold and nothing else; ``group_norm``'s forward and backward are the
plain composition they were (K1's sums, ``fold_gn_affine``, the apply); the
FiLM rows a fold takes as they are or copies. The card's routes are held
to these by ``tests/test_torch_port_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from ddpm3d_tpu_torch import ops
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.ops import groupnorm as gn

TINY = dict(model_channels=32, out_channels=2, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3,
            use_scale_shift_norm=True, resblock_updown=True,
            middle_attention=False)


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _folds():
    return ops.fold_counts()


@pytest.mark.parametrize("fused", [False, True])
def test_a_cpu_forward_folds_every_groupnorm_in_torch(fused):
    """One forward of a tiny SuperResModel: a torch fold per GroupNorm
    call (fused: per fold_only call, from the fused conv's stats or x's
    own), no fold launched, and the counts reset with the launches."""
    torch.manual_seed(0)
    model = SuperResModel(in_channels=1, fused=fused, **TINY).eval()
    calls = []
    handles = [m.register_forward_hook(lambda *a: calls.append(1))
               for m in model.modules() if isinstance(m, GroupNorm32)]
    x = torch.randn((1, 4, 8, 8, 1))
    with torch.no_grad():
        model(x, torch.tensor([3]), low_res=x)
    for h in handles:
        h.remove()
    assert len(calls) > 0
    assert _folds() == {"k1": 0, "launch": 0, "torch": len(calls)}
    assert ops.launch_counts()["gn_fold"] == 0
    ops.reset_launch_counts()
    assert _folds() == {"k1": 0, "launch": 0, "torch": 0}


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_group_norm_is_the_plain_composition(film, silu, dtype):
    """group_norm on the CPU equals K1's plain sums -> fold_gn_affine ->
    the plain apply bit for bit, with and without autograd, and counts one
    torch fold a call."""
    g = torch.Generator().manual_seed(3)
    B, C = 2, 64
    x = (torch.randn((B, 3, 4, 5, C), generator=g) * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn((C,), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    emb = 0.1 * torch.randn((B, 2 * C), generator=g)
    fs, fh = emb.chunk(2, dim=-1) if film else (None, None)
    xr = x.reshape(B, -1, C)
    gg, bb = gn.fold_gn_affine(gn.channel_stats_plain(xr), xr.shape[1],
                               scale, bias, film_scale=fs, film_shift=fh)
    want = gn.gn_apply_plain(xr, gg, bb, silu).reshape(x.shape)
    with torch.no_grad():
        got = gn.group_norm(x, scale, bias, film_scale=fs, film_shift=fh,
                            apply_silu=silu)
    assert torch.equal(got, want)
    graded = gn.group_norm(x, scale.requires_grad_(), bias, film_scale=fs,
                           film_shift=fh, apply_silu=silu)
    assert graded.grad_fn is not None and torch.equal(graded.detach(), want)
    assert _folds() == {"k1": 0, "launch": 0, "torch": 2}


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_cpu_group_norm_backward_matches_autograd(film, silu):
    """The closed-form backward (moments from the CPU's fold) against
    autograd through F.group_norm with the same FiLM and SiLU, in f32."""
    g = torch.Generator().manual_seed(4)
    B, C = 2, 64
    x = torch.randn((B, 3, 4, 5, C), generator=g) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn((C,), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    fs = 0.1 * torch.randn((B, C), generator=g) if film else None
    fh = 0.1 * torch.randn((B, C), generator=g) if film else None
    dy = torch.randn(x.shape, generator=g)
    leaves = [t for t in (x, scale, bias, fs, fh) if t is not None]

    def plain(x, scale, bias, fs, fh):
        h = F.group_norm(x.movedim(-1, 1), 32, scale, bias, 1e-5).movedim(
            1, -1)
        if fs is not None:
            shape = (B, 1, 1, 1, C)
            h = h * (1 + fs.reshape(shape)) + fh.reshape(shape)
        return F.silu(h) if silu else h

    ins = [t.clone().requires_grad_() for t in leaves]
    kw = dict(zip(("film_scale", "film_shift"), ins[3:]))
    out = gn.group_norm(*ins[:3], apply_silu=silu, **kw)
    got = torch.autograd.grad(out, ins, dy)
    ref_ins = [t.clone().requires_grad_() for t in leaves]
    ref_out = plain(*ref_ins[:3], *(ref_ins[3:] or (None, None)))
    want = torch.autograd.grad(ref_out, ref_ins, dy)
    assert (out - ref_out).abs().max() <= 1e-5 * ref_out.abs().max()
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_cpu_folds_of_sums_and_of_x():
    """fold_stats on sums handed in and stats_and_fold on x give what
    fold_gn_affine and gn_moments give, with the sums written out when
    asked; each counts one torch fold."""
    g = torch.Generator().manual_seed(5)
    B, N, C = 2, 60, 96
    x = torch.randn((B, N, C), generator=g) * 3 + 1
    scale = 1 + 0.1 * torch.randn((C,), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    fs, fh = (0.1 * torch.randn((B, 2 * C), generator=g)).chunk(2, dim=-1)
    stats = gn.channel_stats_plain(x)
    want = gn.fold_gn_affine(stats, N, scale, bias, film_scale=fs,
                             film_shift=fh)
    mean_c, rstd_c = gn.gn_moments(stats, N)
    out = torch.empty((B, 2, C))
    for got in (gn.fold_stats(stats, N, scale, bias, film_scale=fs,
                              film_shift=fh),
                gn.stats_and_fold(x, scale, bias, film_scale=fs,
                                  film_shift=fh, moments=True, stats=out)):
        for a, b in zip(got, want + (mean_c, rstd_c)):
            assert torch.equal(a, b)
    assert torch.equal(out, stats)
    assert _folds() == {"k1": 0, "launch": 0, "torch": 2}


def test_film_rows_are_taken_as_they_are():
    """A chunk of the embedding's [B, 2C] output reaches the fold as it is,
    its row stride 2C; other layouts and dtypes are copied to contiguous
    f32 rows."""
    B, C = 2, 64
    dev = torch.device("cpu")
    emb = torch.randn((B, 2 * C))
    fs, fh = emb.chunk(2, dim=-1)
    got = gn._film(fs, fh, B, C, dev)
    assert got[0] is fs and got[1] is fh and got[2] == 2 * C
    assert gn._film(None, None, B, C, dev) == (None, None, C)
    assert gn._film(fs[:1], None, 1, C, dev)[2] == C  # one row
    for a, b in ((fs.bfloat16(), fh), (fs, fh.contiguous()),
                 (fs[:1].expand(B, C), None), (fs.t().contiguous().t(), fh)):
        s, h, stride = gn._film(a, b, B, C, dev)
        assert stride == C and s.is_contiguous() and s.dtype == torch.float32
        assert torch.equal(s, a.float())
        if b is not None:
            assert torch.equal(h, b) and h.stride() == (C, 1)


def test_fold_refuses_more_groups_than_it_keeps():
    C = 2 * gn.MAX_FOLD_GROUPS
    with pytest.raises(ValueError, match="at most"):
        gn._fold_args(torch.ones(C), torch.zeros(C), None, None, C, 1e-5,
                      1.0, 1, C, torch.device("cpu"), (0, 0, 0, 0))
    args, _ = gn._fold_args(torch.ones(C), torch.zeros(C), None, None,
                            gn.MAX_FOLD_GROUPS, 1e-5, 2.0, 1, C,
                            torch.device("cpu"), (0, 0, 0, 0))
    assert args[4:8] == (C, gn.MAX_FOLD_GROUPS, 2.0, 1e-5)
    assert args[8:] == (None,) * 4


def test_card_fold_refuses_a_graph_it_would_lose():
    """The card's folds record no autograd graph: with grad enabled an
    input that wants a gradient is refused, under no_grad nothing is."""
    C = 64
    scale = torch.ones(C, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        gn._no_grad_wanted("fold_stats", torch.zeros((1, 2, C)), scale,
                           torch.zeros(C), None, None)
    gn._no_grad_wanted("fold_stats", torch.zeros((1, 2, C)),
                       scale.detach(), torch.zeros(C), None, None)
    with torch.no_grad():
        gn._no_grad_wanted("fold_stats", torch.zeros((1, 2, C)), scale,
                           torch.zeros(C), None, None)


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("sums", [False, True])
def test_fold_out_is_one_allocation_of_disjoint_parts(moments, sums):
    """A fold's outputs on the card are [B, C] views of one f32
    allocation, followed by room for K1's [B, 2, C] sums when asked;
    their addresses do not overlap."""
    B, C = 2, 96
    views, ptrs, sums_ptr = gn._fold_out(B, C, moments, sums,
                                         torch.device("cpu"))
    k = 4 if moments else 2
    assert all(v.shape == (B, C) and v.dtype == torch.float32
               and v.is_contiguous() for v in views[:k])
    assert views[k:] == (None,) * (4 - k)
    assert ptrs[k:] == (0,) * (4 - k)
    step = B * C * 4
    assert [p - ptrs[0] for p in ptrs[:k]] == [i * step for i in range(k)]
    assert [v.data_ptr() for v in views[:k]] == list(ptrs[:k])
    assert sums_ptr == ptrs[0] + k * step
    base = views[0].untyped_storage()
    assert base.nbytes() == (k + 2 * sums) * step
