"""GroupNorm (+FiLM)(+SiLU) over channels-last activations.

Counterpart of ``ddpm3d_tpu/ops/groupnorm.py:fused_group_norm_silu`` and its
two Pallas TPU kernels (``_stats_kernel``, ``_apply_kernel``), with the
model path's semantics (``ddpm3d_tpu/models/nn.py:group_norm_f32``): f32
statistics, variance ``max(E[x^2] - mean^2, 0)``, FiLM ``(1 + scale)`` gain
and shift folded into one per-channel affine, result cast back to x's dtype.

Two Hopper kernels in ``csrc/groupnorm.cu``, both bound by bytes:
  * :func:`channel_stats` -> per-(batch, channel) (sum x, sum x^2) [B, 2, C],
    one launch: row-split partials finished by the last block of each
    column slice (a ticket on a counter), in a fixed order (:func:`stats_plan`);
  * :func:`gn_apply` -> ``silu?(x * g + b)`` with [B, C] f32 (g, b).
Between them, :func:`fold_gn_affine` turns the [B, C] sums into (g, b).

Each public function takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises).

:func:`group_norm` is differentiable (:class:`GroupNormFunction`): forward
is K1 -> fold -> K2, and the backward is the closed form of
``ddpm3d_tpu/models/nn.py:_make_gn_custom`` in torch tensor ops (the JAX
package has no Pallas kernel for it). It saves x and the [B, C] mean and
rstd, not the output, and recomputes the SiLU input elementwise.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

NORM_GROUPS = 32

# kernel launches on the main path (see ops.launch_counts)
stats_launches = 0
apply_launches = 0


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype == torch.bfloat16:
        return 1
    if x.dtype == torch.float32:
        return 0
    raise TypeError(f"GroupNorm kernels take bf16 or f32, got {x.dtype}")


STATS_THREADS = 256   # threads per stats block (csrc/groupnorm.cu kThreads)
STATS_LANES = 16      # 16-byte vectors per column slice (kLanes)
STATS_SPLITS = 256    # row splits per volume at large N


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
# (zeroed once; every launch leaves them 0, so a launch needs no memset)
# and the partial sums; launches on one stream run in order
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


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


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) (sum x, sum x^2) of x [B, N, C] as [B, 2, C] f32."""
    global stats_launches
    if x.device.type == "cpu":
        return channel_stats_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"channel_stats: unsupported device {x.device}")
    code = _dtype_code(x)
    x = x.contiguous()
    B, N, C = x.shape
    rows, S, CS = stats_plan(N, C, x.dtype)
    v = 8 if code == 1 else 4
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ticket, part = _stats_scratch(x.device, stream, B * CS,
                                  B * CS * S * 2 * STATS_LANES * v)
    err = _build.fn("gn_stats_launch")(
        x.data_ptr(), part.data_ptr(), ticket.data_ptr(), stats.data_ptr(),
        B, N, C, rows, code, stream,
    )
    _build.check(err, "gn_stats_launch")
    stats_launches += 1
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
    fold_gn_affine``): ``x * g + b`` equals the normalized, FiLM'd x."""
    mean_c, rstd_c = gn_moments(stats, n_spatial, num_groups, eps)
    return gn_affine(mean_c, rstd_c, scale, bias, film_scale, film_shift)


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
    affine (g, b) [B, C]; the result has x's dtype."""
    global apply_launches
    if x.device.type == "cpu":
        return gn_apply_plain(x, g, b, apply_silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"gn_apply: unsupported device {x.device}")
    code = _dtype_code(x)
    x = x.contiguous()
    B, N, C = x.shape
    g = g.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    if g.shape != (B, C) or b.shape != (B, C):
        raise ValueError(f"affine must be [{B}, {C}], got {tuple(g.shape)}")
    y = torch.empty_like(x)
    err = _build.fn("gn_apply_launch")(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), B, N, C,
        int(apply_silu), code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "gn_apply_launch")
    apply_launches += 1
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
    """GroupNorm(+FiLM)(+SiLU) of x [B, N, C]: forward K1 -> fold -> K2,
    backward :func:`group_norm_backward`."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps,
                apply_silu):
        stats = channel_stats(x)
        mean_c, rstd_c = gn_moments(stats, x.shape[1], num_groups, eps)
        g, b = gn_affine(mean_c, rstd_c, scale, bias, film_scale, film_shift)
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
