"""Phase decomposition of ``conv3x3(nearest_up2_HW(x))``.

Port of ``ddpm3d_tpu/ops/phase_up.py:phase_up_kernels``: on the upsampled
grid, output (2i + a, 2j + b) reads a 2x2 low-resolution neighbourhood
with the kernel's rows and columns merged pairwise,

    phase a = 0: [w0 @ i-1, (w1 + w2) @ i]
    phase a = 1: [(w0 + w1) @ i, w2 @ i+1]

(the same for columns); depth taps pass through. The int8 up sites quantize
these phase kernels, not the 3x3 taps (``ops/quant.py:
upsample_conv_folded_int8``). Weights are in the port's torch layout
(Cout, Cin, kd, kh, kw).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# phase combination matrices: A_0 merges kernel row taps (1, 2), A_1 merges
# (0, 1) — from floor((2i + a + u) / 2), u in {-1, 0, 1}
_A = (
    np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]]),  # a = 0: taps at {i-1, i}
    np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),  # a = 1: taps at {i, i+1}
)


def _combine(weight: torch.Tensor, rows: np.ndarray,
             cols: np.ndarray) -> torch.Tensor:
    """K[o, i, k, r, c] = sum_{u, v} rows[r, u] cols[c, v] w[o, i, k, u, v]
    in f32, rows merged first, then columns: the order in which the JAX
    package's einsum adds the taps, so both round alike."""
    w = weight.float()
    rows_t = torch.as_tensor(rows, dtype=torch.float32, device=w.device)
    cols_t = torch.as_tensor(cols, dtype=torch.float32, device=w.device)
    by_row = torch.einsum("ru,oikuv->oikrv", rows_t, w)
    return torch.einsum("cv,oikrv->oikrc", cols_t, by_row)


def phase_up_kernels(
        weight: torch.Tensor) -> Dict[Tuple[int, int], torch.Tensor]:
    """(Cout, Cin, kd, 3, 3) -> {(a, b): (Cout, Cin, kd, 2, 2)} phase
    kernels in f32."""
    if tuple(weight.shape[3:]) != (3, 3):
        raise ValueError("the phase decomposition needs a 3x3 HW kernel")
    return {(a, b): _combine(weight, _A[a], _A[b])
            for a in (0, 1) for b in (0, 1)}


def stacked_phase_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kd, 3, 3) -> (4 * Cout, Cin, kd, 3, 3) f32: phase (a, b)
    at rows p * Cout .. (p + 1) * Cout, p = 2a + b, each 2x2 phase kernel
    inside a zero 3x3 window at rows a..a+1 and columns b..b+1 (phase a = 0
    reads offsets {-1, 0}, a = 1 reads {0, +1}). A SAME 3x3 conv of the
    low-resolution input with it computes the four phases at once."""
    # the same combination with the 2x3 matrices embedded in 3x3 ones: the
    # phase taps land at their offsets and the rest stays exactly 0
    emb = []
    for a in (0, 1):
        e = np.zeros((3, 3))
        e[a:a + 2] = _A[a]
        emb.append(e)
    return torch.cat([_combine(weight, emb[a], emb[b])
                      for a in (0, 1) for b in (0, 1)])


def phase_window_mask(cout: int) -> torch.Tensor:
    """(4 * Cout, 1, 1, 3, 3) f32: 1 where :func:`stacked_phase_weight` may
    be non-zero (phase p = 2a + b: rows a..a+1, columns b..b+1 of its zero
    3x3 window), 0 where it is exactly 0. The int8 kernel's phase tiles run
    only those taps (``ops/conv3d_s8.py:s8_tap_mask``)."""
    mask = torch.zeros((4, cout, 1, 1, 3, 3))
    for p in range(4):
        a, b = divmod(p, 2)
        mask[p, :, :, :, a:a + 2, b:b + 2] = 1.0
    return mask.reshape(4 * cout, 1, 1, 3, 3)
