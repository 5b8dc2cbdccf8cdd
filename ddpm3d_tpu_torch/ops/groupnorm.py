"""GroupNorm (+FiLM)(+SiLU) over channels-last activations.

Counterpart of ``ddpm3d_tpu/ops/groupnorm.py:fused_group_norm_silu`` and its
two Pallas TPU kernels (``_stats_kernel``, ``_apply_kernel``), with the
model path's semantics (``ddpm3d_tpu/models/nn.py:group_norm_f32``): f32
statistics, variance ``max(E[x^2] - mean^2, 0)``, FiLM ``(1 + scale)`` gain
and shift folded into one per-channel affine, result cast back to x's dtype.

Two Hopper kernels in ``csrc/groupnorm.cu``, both bound by bytes:
  * :func:`channel_stats` -> per-(batch, channel) (sum x, sum x^2) [B, 2, C];
  * :func:`gn_apply` -> ``silu?(x * g + b)`` with [B, C] f32 (g, b).
Between them, :func:`fold_gn_affine` turns the [B, C] sums into (g, b).

Each public function takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def rows_per_split(n: int) -> int:
    """Rows summed by one block of the stats pass. A function of N only, so
    the partial sums, and hence the statistics, do not depend on the batch."""
    return max(64, -(-n // 1024))


def channel_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, 2, C] f32 (sum x, sum x^2) over N."""
    xf = x.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


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
    rows = rows_per_split(N)
    S = -(-N // rows)
    part = torch.empty((B, S, 2, C), dtype=torch.float32, device=x.device)
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    err = _build.fn("gn_stats_launch")(
        x.data_ptr(), part.data_ptr(), stats.data_ptr(), B, N, C, rows, code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "gn_stats_launch")
    stats_launches += 1
    return stats


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
    B, _, C = stats.shape
    cg = C // num_groups
    n = n_spatial * cg
    s1 = stats[:, 0].reshape(B, num_groups, cg).sum(-1)
    s2 = stats[:, 1].reshape(B, num_groups, cg).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    mean_c = mean.repeat_interleave(cg, dim=-1)
    rstd_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    g = scale.float()[None] * rstd_c
    b = bias.float()[None] - mean_c * g
    if film_scale is not None:
        fs = 1.0 + film_scale.float()
        g = g * fs
        b = b * fs
    if film_shift is not None:
        b = b + film_shift.float()
    return g, b


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
    SiLU folded into the normalize pass."""
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    x3 = x.reshape(B, -1, C)
    stats = channel_stats(x3)
    g, b = fold_gn_affine(
        stats, x3.shape[1], scale, bias, num_groups, eps,
        film_scale=film_scale, film_shift=film_shift,
    )
    return gn_apply(x3, g, b, apply_silu).reshape(x.shape)
