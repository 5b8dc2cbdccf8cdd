"""Volume quality metrics: PSNR, SSIM, MAE and RMSE.

Port of ``ddpm3d_tpu/utils/metrics.py``, in torch float64 on the tensors'
device (numpy arrays go to the CPU). SSIM is the Wang et al. form with a
uniform window, reflect padding and the sample covariance (n / (n - 1)),
for 2-D and 3-D arrays alike.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

Array = Union[np.ndarray, torch.Tensor]


def _f64(a: Array, device=None) -> torch.Tensor:
    t = torch.as_tensor(a)
    return t.to(device=device or t.device, dtype=torch.float64)


def psnr(reference: Array, test: Array,
         data_range: Optional[float] = None) -> float:
    """Peak signal-to-noise ratio in dB (``data_range`` defaults to the
    reference's max - min)."""
    ref = _f64(reference)
    tst = _f64(test, ref.device)
    if data_range is None:
        data_range = float(ref.max() - ref.min())
    mse = float(torch.mean((ref - tst) ** 2))
    if mse == 0:
        return float("inf")
    if data_range == 0:  # np.log10(0): a blank reference scores -inf
        return float("-inf")
    return 10.0 * math.log10(data_range ** 2 / mse)


def _reflect_index(n: int, lo: int, hi: int,
                   device: torch.device) -> torch.Tensor:
    """The source index of each voxel of an axis of ``n`` padded by ``lo``
    and ``hi`` as ``np.pad(mode="reflect")`` pads it: the edge not
    repeated, reflected again where the pad is wider than the axis, and the
    one value repeated on an axis of length 1."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box filter of any rank: each axis reflect-padded
    (:func:`_reflect_index`) and averaged by a cumulative sum."""
    lo = size // 2
    hi = size - 1 - lo
    for axis in range(x.dim()):
        xm = x.movedim(axis, -1)
        shape = xm.shape
        xp = xm.index_select(-1, _reflect_index(shape[-1], lo, hi, x.device))
        c = F.pad(torch.cumsum(xp, dim=-1), (1, 0))
        x = ((c[..., size:] - c[..., :-size]) / size).reshape(shape)
        x = x.movedim(-1, axis)
    return x


def ssim(reference: Array, test: Array, data_range: Optional[float] = None,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity, the mean over the volume."""
    x = _f64(reference)
    y = _f64(test, x.device)
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    if data_range is None:
        data_range = float(x.max() - x.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _uniform_filter(x, win_size)
    mu_y = _uniform_filter(y, win_size)
    mu_xx = _uniform_filter(x * x, win_size)
    mu_yy = _uniform_filter(y * y, win_size)
    mu_xy = _uniform_filter(x * y, win_size)

    n = win_size ** x.dim()
    cov_norm = n / (n - 1)
    var_x = cov_norm * (mu_xx - mu_x * mu_x)
    var_y = cov_norm * (mu_yy - mu_y * mu_y)
    cov_xy = cov_norm * (mu_xy - mu_x * mu_y)

    num = (2 * mu_x * mu_y + c1) * (2 * cov_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return float(torch.mean(num / den))


def volume_report(reference: Array, test: Array,
                  data_range: Optional[float] = None) -> dict:
    """{psnr_db, ssim, mae, rmse} of ``test`` against ``reference``."""
    ref = _f64(reference)
    tst = _f64(test, ref.device)
    diff = ref - tst
    return {
        "psnr_db": psnr(ref, tst, data_range),
        "ssim": ssim(ref, tst, data_range),
        "mae": float(torch.mean(torch.abs(diff))),
        "rmse": float(torch.sqrt(torch.mean(diff ** 2))),
    }
