"""Frozen copy of the W8A8 serving rules the port states, for the plain
reference: which conv sites are quantized, the static per-time-bin scale of
a site, the symmetric rounding of activations and weights, the phase
kernels of an up-sampling site, and the exact integer convolution.

Nothing here imports the program. ``qmax`` is 127 for int8; the int4
control of the benchmark passes 7 and widens each static scale by 127 / 7,
so it clips at the same range with 18 times coarser steps.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

INT8_QMAX = 127
INT4_QMAX = 7


def excluded(site: str, patterns: Sequence[str]) -> bool:
    """A site stays in bf16 / f32 when its path contains a pattern."""
    return any(p in site for p in patterns)


def time_bin(step: int, n_bins: int, chain_steps: int) -> int:
    """The bin of chain index ``step`` (the respaced step the sampler runs)."""
    return min(max(step * n_bins // chain_steps, 0), n_bins - 1)


class StaticScales:
    """Per-site, per-time-bin activation scales of a calibration file."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        meta = data["meta"]
        self.n_bins = int(meta["time_bins"])
        self.chain_steps = int(meta["chain_steps"])
        self.tables: Dict[str, np.ndarray] = {
            k: np.asarray(v, np.float32) for k, v in data["scales_t"].items()}

    def scale(self, site: str, step: int) -> float:
        return float(self.tables[site][time_bin(step, self.n_bins,
                                                self.chain_steps)])


def quantize_act(x: torch.Tensor, scale: float, qmax: int = INT8_QMAX):
    """``clip(round_half_even(f32(x) / scale), -qmax, qmax)`` per sample
    with one static scale; returns (q as f32 integers, s [B] f32). The
    divisor is a tensor, so the quotient is a true division."""
    B = x.shape[0]
    s = torch.full((B,), scale * INT8_QMAX / qmax, dtype=torch.float32,
                   device=x.device)
    q = x.float() / s.reshape((B,) + (1,) * (x.dim() - 1))
    return torch.clamp(torch.round(q), -qmax, qmax), s


def quantize_weight(w: torch.Tensor, qmax: int = INT8_QMAX):
    """Symmetric per-output-channel weights: (q f32 integers, s_w [N])."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    s_w = torch.where(amax > 0, amax / torch.full_like(amax, float(qmax)),
                      torch.ones_like(amax))
    q = torch.round(w / s_w.reshape((-1,) + (1,) * (w.dim() - 1)))
    return torch.clamp(q, -qmax, qmax), s_w


# phase merge of kernel rows (and columns) for output parity a = 0 and 1:
# a = 0 reads offsets {-1, 0} with taps (w0, w1 + w2), a = 1 reads {0, +1}
# with (w0 + w1, w2), each embedded in a zero 3-wide window
_PHASE = (np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0], [0.0, 0.0, 0.0]]),
          np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]))


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (4 Cout, Cin, 3, 3, 3) f32: the four phase
    kernels of ``conv3x3x3(nearest_up2_HW(x))`` on the low-resolution grid,
    phase p = 2a + b at rows p Cout .. (p + 1) Cout, rows merged first."""
    w = w.float()
    out = []
    for a in (0, 1):
        for b in (0, 1):
            r = torch.as_tensor(_PHASE[a], dtype=torch.float32, device=w.device)
            c = torch.as_tensor(_PHASE[b], dtype=torch.float32, device=w.device)
            by_row = torch.einsum("ru,oikuv->oikrv", r, w)
            out.append(torch.einsum("cv,oikrv->oikrc", c, by_row))
    return torch.cat(out)


def interleave(y: torch.Tensor) -> torch.Tensor:
    """[B, D, H, W, 4 C] phases -> [B, D, 2H, 2W, C], out[2i+a, 2j+b] =
    phase (a, b) at (i, j)."""
    B, D, H, W, n = y.shape
    c = n // 4
    y = y.reshape(B, D, H, W, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return y.reshape(B, D, 2 * H, 2 * W, c)


# rows of one im2col block on the card: [rows, 27 Cin] int8 stays < 2 GB
_ROWS = 1 << 18


def int_conv(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer sums of a stride-1 SAME conv: ``q`` [B, D, H, W, Cin]
    and ``wq`` (N, Cin, k, k, k), both holding integers in [-127, 127].
    Returns f64 on the CPU (every partial sum an integer below 2^53) and
    int32 on the card (im2col blocks through ``torch._int_mm``)."""
    k = wq.shape[-1]
    if q.device.type == "cpu":
        y = F.conv3d(q.double().permute(0, 4, 1, 2, 3), wq.double(),
                     padding=k // 2)
        return y.permute(0, 2, 3, 4, 1)
    B, D, H, W, C = q.shape
    N = wq.shape[0]
    qi = q.to(torch.int8)
    # taps in (kd, kh, kw) order, channels innermost: the weight's order
    wmat = wq.to(torch.int8).permute(0, 2, 3, 4, 1).reshape(N, -1).t()
    if k == 1:
        return torch._int_mm(qi.reshape(-1, C), wmat).reshape(B, D, H, W, N)
    p = F.pad(qi, (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.empty((B, D, H, W, N), dtype=torch.int32, device=q.device)
    d_rows = max(1, _ROWS // (H * W))
    for b in range(B):
        for d0 in range(0, D, d_rows):
            d1 = min(D, d0 + d_rows)
            cols = torch.stack([p[b, d0 + i:d1 + i, j:j + H, l:l + W]
                                for i in range(3) for j in range(3)
                                for l in range(3)], dim=3)
            out[b, d0:d1] = torch._int_mm(
                cols.reshape(-1, 27 * C), wmat).reshape(d1 - d0, H, W, N)
    return out


def int_site(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             scale: float, upsample: bool, qmax: int = INT8_QMAX
             ) -> torch.Tensor:
    """A quantized conv site on bf16 ``x`` [B, D, H, W, Cin]: activation
    quantized per sample with the static ``scale``, weight per output
    channel (per phase on an up site), exact integer sums, then
    ``acc * (s_x * s_w) + bias`` in f32 rounded once to x's dtype; an up
    site interleaves the rounded phases and adds the bias after, in x's
    dtype."""
    q, s_x = quantize_act(x, scale, qmax)
    w = phase_weights(weight) if upsample else weight
    wq, s_w = quantize_weight(w, qmax)
    acc = int_conv(q, wq)
    y = acc.float() * (s_x[:, None, None, None, None] * s_w.float())
    if not upsample:
        return (y + bias.float()).to(x.dtype)
    return interleave(y.to(x.dtype)) + bias.to(x.dtype)


class SiteQuant:
    """What the reference serves each conv site with: ``qmax`` 127 (int8)
    or 7 (the int4 control), the static scales, the excluded sites, and the
    chain step that picks the bin (set before each step)."""

    def __init__(self, scales: StaticScales, exclude: Sequence[str],
                 qmax: int = INT8_QMAX):
        self.scales = scales
        self.exclude = tuple(exclude)
        self.qmax = qmax
        self.step: Optional[int] = None

    def quantized(self, site: str) -> bool:
        return not excluded(site, self.exclude)

    def conv(self, site: str, x, weight, bias, upsample: bool = False):
        return int_site(x, weight, bias, self.scales.scale(site, self.step),
                        upsample, self.qmax)
