"""GroupNorm (+FiLM)(+SiLU) over channels-last activations.

Counterpart of ``ddpm3d_tpu/ops/groupnorm.py:fused_group_norm_silu`` and its
two Pallas TPU kernels (``_stats_kernel``, ``_apply_kernel``), with the
model path's semantics (``ddpm3d_tpu/models/nn.py:group_norm_f32``): f32
statistics, variance ``max(E[x^2] - mean^2, 0)``, FiLM ``(1 + scale)`` gain
and shift folded into one per-channel affine, result cast back to x's dtype.

Two Hopper kernels in ``csrc/groupnorm.cu``, both bound by bytes:
  * K1 (:func:`channel_stats`) -> per-(batch, channel) (sum x, sum x^2)
    [B, 2, C], one launch: row-split partials finished by the last block of
    each column slice (a ticket on a counter), in a fixed order
    (:func:`stats_plan`). Asked to (:func:`stats_and_fold`), the block that
    finishes a batch row's last slice (a second ticket) also folds the
    row's sums into the [B, C] f32 affine (g, b): the fold of
    :func:`fold_gn_affine`, on the card, operation for operation;
  * K2 (:func:`gn_apply`) -> ``silu?(x * g + b)`` with that (g, b).
Sums K1 did not make (a spatial group's all-reduced sums, the fused conv's
stats) are folded by the same device routine in a launch of its own
(:func:`fold_stats`). Where the program's folds ran is counted, by
:data:`FOLD_ROUTES`: ``route.gn_fold.k1`` (in K1), ``launch.gn_fold`` (the
launch of its own) and ``route.gn_fold.torch`` (torch ops, on the CPU).

Each public function takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises).

:func:`group_norm` is differentiable (:class:`GroupNormFunction`): forward
is K1 with its fold -> K2, two launches and no PyTorch op between them,
and the backward is the closed form of ``ddpm3d_tpu/models/nn.py:
_make_gn_custom`` in torch tensor ops (the JAX package has no Pallas kernel
for it). It saves x and the [B, C] mean and rstd (K1 writes them beside
the affine), not the output, and recomputes the SiLU input elementwise.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..utils import tracing
from . import _build

NORM_GROUPS = 32


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype == torch.bfloat16:
        return 1
    if x.dtype == torch.float32:
        return 0
    raise TypeError(f"GroupNorm kernels take bf16 or f32, got {x.dtype}")


STATS_THREADS = 256   # threads per stats block (csrc/groupnorm.cu kThreads)
STATS_LANES = 16      # 16-byte vectors per column slice (kLanes)
STATS_SPLITS = 256    # row splits per volume at large N
MAX_FOLD_GROUPS = 1024  # groups the fold takes (kMaxGroups)
# where a fold of sums into the affine ran (ops.fold_counts)
FOLD_ROUTES = ("k1", "launch", "torch")


def rows_per_split(n: int) -> int:
    """Rows summed by one block of the stats pass: about STATS_SPLITS
    splits of at least 32 rows. A function of N only, so the partial sums,
    and hence the statistics, do not depend on the batch."""
    return max(32, -(-n // STATS_SPLITS))


@functools.lru_cache(maxsize=256)
def stats_plan(n: int, c: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(rows per split, splits S, column slices CS) of one stats launch over
    [B, n, c] in ``dtype``: the grid is (S, CS, B)."""
    v = 8 if dtype == torch.bfloat16 else 4
    rows = rows_per_split(n)
    return rows, -(-n // rows), -(-c // (STATS_LANES * v))


def channel_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, 2, C] f32 (sum x, sum x^2) over N."""
    xf = x.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


# the stats kernel's scratch per (device, stream): the ticket counters
# (zeroed once; every launch leaves them 0, so a launch needs no memset) and
# the partial sums; launches on one stream run in order
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as a pointer."""
    if _raw_stream is not None:
        return _raw_stream(x.get_device())
    return torch.cuda.current_stream(x.device).cuda_stream


def _stats_scratch(device: torch.device, stream: int, n_tickets: int,
                   n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ticket counters, partials) of at least the sizes given."""
    key = (device.index if device.index is not None else
           torch.cuda.current_device(), stream)
    ticket, part = _scratch.get(key, (None, None))
    if ticket is None or ticket.numel() < n_tickets:
        ticket = torch.zeros((max(n_tickets, 64),), dtype=torch.int32,
                             device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty((n_part,), dtype=torch.float32, device=device)
    _scratch[key] = (ticket, part)
    return ticket, part


def _f32_on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t as contiguous f32 on ``device``: itself when it already is."""
    if (t.dtype is torch.float32 and t.device == device
            and t.is_contiguous()):
        return t
    return t.to(device=device, dtype=torch.float32).contiguous()


def _film(film_scale: Optional[torch.Tensor],
          film_shift: Optional[torch.Tensor], B: int, C: int,
          device: torch.device):
    """(film_scale, film_shift, row stride) as the fold reads them: f32
    [B, C] rows of unit channel stride on ``device``. A chunk of the
    embedding's [B, 2C] output is taken as it is; anything else is copied."""
    given = [t for t in (film_scale, film_shift) if t is not None]
    if not given:
        return None, None, C
    if not (all(t.dtype is torch.float32 and t.device == device
                and t.shape == (B, C) and t.stride(1) == 1
                and (B == 1 or t.stride(0) >= C) for t in given)
            and len({t.stride(0) for t in given}) == 1):
        film_scale, film_shift = (
            None if t is None else
            t.to(device=device, dtype=torch.float32).expand(B, C).contiguous()
            for t in (film_scale, film_shift))
        given = [t for t in (film_scale, film_shift) if t is not None]
    return film_scale, film_shift, given[0].stride(0) if B > 1 else C


def _fold_args(scale, bias, film_scale, film_shift, num_groups, eps, n,
               B, C, device, out: Tuple[int, int, int, int]):
    """The fold's arguments of gn_stats_launch / gn_fold_launch, and the
    tensors they point into (kept alive over the launch); ``out`` the
    addresses of g, b, mean, rstd (0 for none)."""
    if num_groups > MAX_FOLD_GROUPS:
        raise ValueError(f"the fold takes at most {MAX_FOLD_GROUPS} groups, "
                         f"got {num_groups}")
    gamma, beta = _f32_on(scale, device), _f32_on(bias, device)
    fs, fh, stride = _film(film_scale, film_shift, B, C, device)
    args = (gamma.data_ptr(), beta.data_ptr(),
            None if fs is None else fs.data_ptr(),
            None if fh is None else fh.data_ptr(), stride, num_groups,
            float(n), float(eps)) + tuple(p or None for p in out)
    return args, (gamma, beta, fs, fh)


# the fold's arguments of gn_stats_launch for K1 alone (gamma null: no fold)
NO_FOLD = (None,) * 4 + (0, 0, 0.0, 0.0) + (None,) * 4


def _k1(x: torch.Tensor, stats_ptr: int, fold_args=None) -> None:
    """One K1 launch over x [B, N, C] on the card: its sums to
    ``stats_ptr`` and, with ``fold_args``, the fold."""
    code = _dtype_code(x)
    B, N, C = x.shape
    rows, S, CS = stats_plan(N, C, x.dtype)
    v = 8 if code == 1 else 4
    stream = _stream(x)
    ticket, part = _stats_scratch(x.device, stream, B * CS + B,
                                  B * CS * S * 2 * STATS_LANES * v)
    err = _build.fn("gn_stats_launch")(
        x.data_ptr(), part.data_ptr(), ticket.data_ptr(), stats_ptr,
        B, N, C, rows, code, *(fold_args or NO_FOLD), stream)
    _build.check(err, "gn_stats_launch")
    tracing.count("launch.gn_stats")
    if fold_args:
        tracing.count("route.gn_fold.k1")


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) (sum x, sum x^2) of x [B, N, C] as [B, 2, C] f32."""
    if x.device.type == "cpu":
        return channel_stats_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"channel_stats: unsupported device {x.device}")
    x = x.contiguous()
    B, N, C = x.shape
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    _k1(x, stats.data_ptr())
    return stats


def gn_moments(
    stats: torch.Tensor,
    n_spatial: int,
    num_groups: int = NORM_GROUPS,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel group mean and rstd, [B, C] f32 each, from per-channel
    sums [B, 2, C]; variance ``max(E[x^2] - mean^2, 0)``."""
    B, _, C = stats.shape
    cg = C // num_groups
    n = n_spatial * cg
    s1 = stats[:, 0].reshape(B, num_groups, cg).sum(-1)
    s2 = stats[:, 1].reshape(B, num_groups, cg).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return (mean.repeat_interleave(cg, dim=-1),
            torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1))


def gn_affine(
    mean_c: torch.Tensor,
    rstd_c: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    film_scale: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-(batch, channel) affine (g, b), [B, C] f32, with ``x * g +
    b`` equal to the normalized, FiLM'd x (``nn.py:_gn_affine``)."""
    g = scale.float()[None] * rstd_c
    b = bias.float()[None] - mean_c * g
    if film_scale is not None:
        fs = 1.0 + film_scale.float()
        g = g * fs
        b = b * fs
    if film_shift is not None:
        b = b + film_shift.float()
    return g, b


# (g, b, mean_c, rstd_c) of a fold, [B, C] f32 each
Folded = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]


def _fold_torch(stats, n_spatial, scale, bias, num_groups, eps, film_scale,
                film_shift) -> Folded:
    """The fold in torch ops (``gn_moments``, ``gn_affine``), on any
    device: (g, b, mean_c, rstd_c)."""
    with tracing.span("ddpm.gn.fold"):
        mean_c, rstd_c = gn_moments(stats, n_spatial, num_groups, eps)
        g, b = gn_affine(mean_c, rstd_c, scale, bias, film_scale, film_shift)
    return g, b, mean_c, rstd_c


def fold_gn_affine(
    stats: torch.Tensor,
    n_spatial: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = NORM_GROUPS,
    eps: float = 1e-5,
    film_scale: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm (+FiLM) into one per-channel affine (g, b), [B, C] f32,
    from per-channel sums [B, 2, C] (``ddpm3d_tpu/models/nn.py:
    fold_gn_affine``): ``x * g + b`` equals the normalized, FiLM'd x. Torch
    ops on any device: the CPU's fold, and the card's fold's reference."""
    return _fold_torch(stats, n_spatial, scale, bias, num_groups, eps,
                       film_scale, film_shift)[:2]


def _no_grad_wanted(where: str, *ts: Optional[torch.Tensor]) -> None:
    """The card's fold records no autograd graph: refuse inputs whose
    gradient would be lost."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{where} on the card has no backward: call it under "
            "torch.no_grad() or torch.inference_mode(), or use group_norm")


def _fold_out(B: int, C: int, moments: bool, sums: bool,
              device: torch.device):
    """One f32 allocation for a fold on the card: the [B, C] views (g, b,
    mean_c, rstd_c) (mean_c and rstd_c None without ``moments``) and
    their addresses (0 for none), then, with ``sums``, the address of
    [B, 2, C] more for K1's sums."""
    k = 4 if moments else 2
    out = torch.empty(((k + 2 * sums) * B * C,), dtype=torch.float32,
                      device=device)
    ptr, step = out.data_ptr(), B * C * 4
    views = out[:k * B * C].view(k, B, C).unbind(0) + (None,) * (4 - k)
    return (views, tuple(ptr + i * step if i < k else 0 for i in range(4)),
            ptr + k * step)


def fold_stats(
    stats: torch.Tensor,
    n_spatial: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = NORM_GROUPS,
    eps: float = 1e-5,
    film_scale: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
    moments: bool = False,
) -> Folded:
    """(g, b, mean_c, rstd_c) of sums [B, 2, C] made elsewhere (a spatial
    group's all-reduced sums, the fused conv's stats), as
    :func:`fold_gn_affine` computes them: on the card one launch of the fold
    alone (mean_c and rstd_c None unless ``moments``; no autograd), on the
    CPU torch ops."""
    if stats.device.type == "cpu":
        tracing.count("route.gn_fold.torch")
        return _fold_torch(stats, n_spatial, scale, bias, num_groups, eps,
                           film_scale, film_shift)
    if stats.device.type != "cuda":
        raise RuntimeError(f"fold_stats: unsupported device {stats.device}")
    _no_grad_wanted("fold_stats", stats, scale, bias, film_scale, film_shift)
    B, _, C = stats.shape
    with tracing.span("ddpm.gn.fold"):
        stats = _f32_on(stats, stats.device)
        views, out, _ = _fold_out(B, C, moments, False, stats.device)
        args, _keep = _fold_args(
            scale, bias, film_scale, film_shift, num_groups, eps,
            n_spatial * (C // num_groups), B, C, stats.device, out)
        err = _build.fn("gn_fold_launch")(
            stats.data_ptr(), B, C, *args, _stream(stats))
        _build.check(err, "gn_fold_launch")
    tracing.count("launch.gn_fold")
    return views


def stats_and_fold(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = NORM_GROUPS,
    eps: float = 1e-5,
    film_scale: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
    moments: bool = False,
    stats: Optional[torch.Tensor] = None,
) -> Folded:
    """(g, b, mean_c, rstd_c) of GroupNorm(+FiLM) over x [B, N, C] from x's
    own sums: on the card K1 with its fold, one launch (mean_c and rstd_c
    None unless ``moments``; ``stats``, a contiguous [B, 2, C] f32 tensor,
    receives the sums if given; no autograd); on the CPU
    :func:`channel_stats` and torch ops."""
    if x.device.type == "cpu":
        st = channel_stats(x)
        if stats is not None:
            stats.copy_(st)
        tracing.count("route.gn_fold.torch")
        return _fold_torch(st, x.shape[1], scale, bias, num_groups, eps,
                           film_scale, film_shift)
    if x.device.type != "cuda":
        raise RuntimeError(f"stats_and_fold: unsupported device {x.device}")
    _no_grad_wanted("stats_and_fold", x, scale, bias, film_scale, film_shift)
    x = x.contiguous()
    B, N, C = x.shape
    if stats is not None and (
            stats.shape != (B, 2, C) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be a contiguous [{B}, 2, {C}] f32 "
                         f"tensor on {x.device}")
    views, out, sums = _fold_out(B, C, moments, stats is None, x.device)
    args, _keep = _fold_args(scale, bias, film_scale, film_shift, num_groups,
                             eps, N * (C // num_groups), B, C, x.device, out)
    _k1(x, sums if stats is None else stats.data_ptr(), args)
    return views


def gn_apply_plain(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, apply_silu: bool
) -> torch.Tensor:
    """silu?(x * g + b) in f32 for x [B, N, C], (g, b) [B, C]; x's dtype out."""
    h = x.float() * g[:, None, :] + b[:, None, :]
    if apply_silu:
        h = h * torch.sigmoid(h)
    return h.to(x.dtype)


def gn_apply(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, apply_silu: bool
) -> torch.Tensor:
    """silu?(x * g + b) over x [B, N, C] with per-(batch, channel) f32
    affine (g, b) [B, C] (a fold's output is taken as it is, anything else
    copied to that layout); the result has x's dtype."""
    if x.device.type == "cpu":
        return gn_apply_plain(x, g, b, apply_silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"gn_apply: unsupported device {x.device}")
    code = _dtype_code(x)
    x = x.contiguous()
    B, N, C = x.shape
    if g.shape != (B, C) or b.shape != (B, C):
        raise ValueError(f"affine must be [{B}, {C}], got {tuple(g.shape)}")
    g, b = _f32_on(g, x.device), _f32_on(b, x.device)
    y = torch.empty_like(x)
    err = _build.fn("gn_apply_launch")(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), B, N, C,
        int(apply_silu), code, _stream(x))
    _build.check(err, "gn_apply_launch")
    tracing.count("launch.gn_apply")
    return y


def group_norm_backward(
    do: torch.Tensor,
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    film_scale: Optional[torch.Tensor],
    film_shift: Optional[torch.Tensor],
    mean_c: torch.Tensor,
    rstd_c: torch.Tensor,
    num_groups: int,
    apply_silu: bool,
):
    """Closed-form VJP of GroupNorm(+FiLM)(+SiLU) over x [B, N, C]
    (``nn.py:_make_gn_custom`` bwd): one reduction pass for the per-channel
    P = sum(dy), Q = sum(dy * x), per-group scalars from P, Q and the saved
    stats, then one elementwise pass for dx. Returns (dx in x's dtype,
    d_scale, d_bias, d_film_scale or None, d_film_shift or None)."""
    B, N, C = x.shape
    cg = C // num_groups
    n = N * cg
    f = (1.0 + film_scale.float() if film_scale is not None
         else torch.ones((B, C), dtype=torch.float32, device=x.device))
    A = scale.float()[None] * f
    gg = A * rstd_c
    xf = x.float()
    dy = do.float()
    if apply_silu:
        bb = bias.float()[None] * f - mean_c * gg
        if film_shift is not None:
            bb = bb + film_shift.float()
        y = xf * gg[:, None] + bb[:, None]
        sig = torch.sigmoid(y)
        # d silu(y) / dy = sig * (1 + y * (1 - sig))
        dy = dy * (sig * (1.0 + y * (1.0 - sig)))
        del y, sig
    P = dy.sum(1)
    Q = (dy * xf).sum(1)
    R_c = rstd_c * (Q - mean_c * P)                # sum(dy * xhat)
    SA = (A * P).reshape(B, num_groups, cg).sum(-1)
    SB = (A * Q).reshape(B, num_groups, cg).sum(-1)
    mean_g = mean_c[:, ::cg]
    rstd_g = rstd_c[:, ::cg]
    d_rstd = SB - mean_g * SA
    d_var = -0.5 * rstd_g ** 3 * d_rstd
    d_mean = -rstd_g * SA - 2.0 * mean_g * d_var
    c1 = (d_mean / n).repeat_interleave(cg, dim=-1)
    c2 = (d_var / n).repeat_interleave(cg, dim=-1)
    dx = (dy * gg[:, None] + c1[:, None] + 2.0 * xf * c2[:, None]).to(x.dtype)
    d_scale = (f * R_c).sum(0).to(scale.dtype)
    d_bias = (f * P).sum(0).to(bias.dtype)
    d_fs = d_fh = None
    if film_scale is not None:
        d_fs = (scale.float()[None] * R_c
                + bias.float()[None] * P).to(film_scale.dtype)
    if film_shift is not None:
        d_fh = P.to(film_shift.dtype)
    return dx, d_scale, d_bias, d_fs, d_fh


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm(+FiLM)(+SiLU) of x [B, N, C]: forward K1 with its fold ->
    K2, backward :func:`group_norm_backward`."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps,
                apply_silu):
        g, b, mean_c, rstd_c = stats_and_fold(
            x, scale, bias, num_groups, eps, film_scale, film_shift,
            moments=True)
        ctx.save_for_backward(x, scale, bias, film_scale, film_shift,
                              mean_c, rstd_c)
        ctx.num_groups = num_groups
        ctx.apply_silu = apply_silu
        return gn_apply(x, g, b, apply_silu)

    @staticmethod
    def backward(ctx, do):
        x, scale, bias, fs, fh, mean_c, rstd_c = ctx.saved_tensors
        grads = group_norm_backward(
            do, x, scale, bias, fs, fh, mean_c, rstd_c, ctx.num_groups,
            ctx.apply_silu)
        return grads + (None, None, None)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = NORM_GROUPS,
    eps: float = 1e-5,
    film_scale: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of x [B, ..., C], computed in
    f32 and cast back to x's dtype, with optional FiLM (film_*: [B, C]) and
    SiLU folded into the normalize pass. Differentiable in x, scale, bias
    and the FiLM terms."""
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    y = GroupNormFunction.apply(
        x.reshape(B, -1, C), scale, bias, film_scale, film_shift,
        num_groups, eps, apply_silu)
    return y.reshape(x.shape)
