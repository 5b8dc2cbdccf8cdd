"""The port's kernel modules (ddpm3d_tpu_torch.ops) against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that version against the JAX functions the TPU kernels compute, on the
same numpy-seeded inputs, in f32. The kernels themselves are held against
the plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.models import nn as jnn
from ddpm3d_tpu.ops.conv3d_mxu import _xla_conv3d, conv3d_mxu
from ddpm3d_tpu.ops.groupnorm import fused_group_norm_silu
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import groupnorm as gn


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

# f32 sums over up to 27*128 terms in another order than XLA's
CONV_RTOL, CONV_ATOL = 1e-5, 1e-5
GN_RTOL, GN_ATOL = 1e-5, 1e-5


def _conv_inputs(rng, shape, cout):
    cin = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout), dtype=np.float32)
         / np.sqrt(27 * cin)).astype(np.float32)  # DHWIO, as JAX stores it
    b = rng.standard_normal((cout,), dtype=np.float32)
    w_torch = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    return x, w, b, w_torch


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 6, 7, 16), 8),     # odd, non-square volume
    ((1, 4, 8, 8, 2), 16),     # Cin = 2: the input conv
    ((1, 4, 8, 8, 16), 2),     # Cout = 2: the head conv
    ((1, 3, 3, 3, 32), 32),    # smaller than the 3x3x3 window's reach
])
def test_conv3d_plain_matches_xla_conv(rng, shape, cout):
    x, w, b, w_torch = _conv_inputs(rng, shape, cout)
    ref = np.asarray(_xla_conv3d(jnp.asarray(x), jnp.asarray(w))) + b
    out = cv.conv3d(torch.from_numpy(x), w_torch, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_conv3d_plain_matches_pallas_kernel_interpreted(rng):
    """The TPU kernel itself (interpret mode) at a tiny 128-channel shape."""
    x, w, b, w_torch = _conv_inputs(rng, (1, 2, 4, 8, 128), 128)
    ref = np.asarray(conv3d_mxu(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), interpret=True))
    out = cv.conv3d(torch.from_numpy(x), w_torch, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_conv3d_bf16_plain_rounds_once(rng):
    """bf16 in, bf16 out: the plain version (and the kernel) sums bf16
    products in f32, adds the f32 bias and rounds once."""
    x, w, b, w_torch = _conv_inputs(rng, (1, 4, 6, 6, 16), 8)
    xb = torch.from_numpy(x).bfloat16()
    out = cv.conv3d(xb, w_torch, torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    ref = cv.conv3d(xb.float(), w_torch.bfloat16().float(), torch.from_numpy(b))
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)


def test_conv3d_packed_layout(rng):
    """pack_weight gives the kernel's [27, Cout, Cin] tap-major layout."""
    _, w, _, w_torch = _conv_inputs(rng, (1, 1, 1, 1, 5), 3)
    packed = cv.pack_weight(w_torch, torch.float32)
    assert packed.shape == (27, 3, 5)
    np.testing.assert_array_equal(
        packed.numpy(), w.reshape(27, 5, 3).transpose(0, 2, 1))


def _emulate_head(x, packed, bias, sms):
    """csrc/conv3d_head.cu's walk on the CPU: each block of ``head_block``
    walks its D segment plane by plane (up or down), adds each plane into
    the three rolling output planes it feeds (only those in the segment),
    with the weight read from ``pack_weight_head``'s [Cin/4, 27, 4, Cout]
    layout, and stores the finished plane with the bias."""
    B, D, H, W, cin = x.shape
    cout = packed.shape[3]
    th, tw = cv.head_tile(cout)
    n_h, n_w, nseg = cv.head_plan(D, H, W, cout, sms)
    # zero padding: one voxel before, up to a whole window after
    xp = torch.zeros((B, D, n_h * th + 2, n_w * tw + 2, cin))
    xp[:, :, 1:H + 1, 1:W + 1] = x
    w_tap = packed.transpose(1, 2).reshape(cin, 27, cout)  # [ci][tap][co]
    y = torch.full((B, D, H, W, cout), float("nan"))
    for q in range(B * nseg * n_h * n_w):
        b, d0, d1, h0, w0, up = cv.head_block(q, B, D, H, W, cout, sms)
        acc = [torch.zeros((th, tw, cout)) for _ in range(3)]
        for st in range(d1 - d0 + 2):
            p = d0 - 1 + st if up else d1 - st
            if 0 <= p < D:
                plane = xp[b, p, h0:h0 + th + 2, w0:w0 + tw + 2]
                for sl in range(3):
                    if not d0 <= (p - 1 + sl if up else p + 1 - sl) < d1:
                        continue
                    kd = 2 - sl if up else sl
                    for kh in range(3):
                        for kw in range(3):
                            acc[sl] += (plane[kh:kh + th, kw:kw + tw]
                                        @ w_tap[:, 9 * kd + 3 * kh + kw])
            out = p - 1 if up else p + 1
            if d0 <= out < d1:
                hh, ww = min(th, H - h0), min(tw, W - w0)
                y[b, out, h0:h0 + hh, w0:w0 + ww] = acc[0][:hh, :ww] + bias
            acc = [acc[1], acc[2], torch.zeros_like(acc[0])]
    return y


def _im2col_f32_narrow(x):
    """[B, D, H, W, 2] -> [B*D*H*W, 54] rows, column k = 2 * tap + ci (the
    f32 narrow kernel's gathered A tile), zero outside the volume."""
    B, D, H, W, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps, dim=-2).reshape(-1, 54)


@pytest.mark.parametrize("sms", [132, 1])  # 1: segments of many planes
@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 16), 2),      # ragged volume, 2 batches
    ((1, 6, 35, 6, 40), 4),     # two H windows, W = 6, Cin not a chunk multiple
    ((1, 4, 8, 8, 128), 2),     # the head's width
])
def test_pack_weight_head_walk_matches_xla_conv(rng, shape, cout, sms):
    """The head kernel's D walk and rolling planes over pack_weight_head's
    layout equal the plain conv and the JAX package's XLA conv (which the
    JAX head conv runs)."""
    x, w, b, w_torch = _conv_inputs(rng, shape, cout)
    packed = cv.pack_weight_head(w_torch)
    assert tuple(packed.shape) == (shape[-1] // 4, 27, 4, cout)
    assert cv.pack_weight_kernel(w_torch, torch.float32).shape == packed.shape
    got = _emulate_head(torch.from_numpy(x), packed, torch.from_numpy(b), sms)
    ref = np.asarray(_xla_conv3d(jnp.asarray(x), jnp.asarray(w))) + b
    plain = cv.conv3d_plain(torch.from_numpy(x), w_torch, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=CONV_RTOL, atol=CONV_ATOL)


@pytest.mark.parametrize("shape,cout", [
    ((1, 4, 8, 8, 2), 128),     # the head's dx width
    ((2, 3, 5, 7, 2), 130),     # ragged Cout past one 128-column tile
])
def test_pack_weight_f32_narrow_im2col_matches_xla_conv(rng, shape, cout):
    """The f32 narrow kernel's arithmetic: the gathered [rows, 54] tile
    times pack_weight_f32_narrow's [Cout, 54] weight, plus the bias."""
    x, w, b, w_torch = _conv_inputs(rng, shape, cout)
    packed = cv.pack_weight_f32_narrow(w_torch)
    assert tuple(packed.shape) == (cout, cv.F32_NARROW_K)
    assert cv.pack_weight_kernel(w_torch, torch.float32).shape == packed.shape
    got = (_im2col_f32_narrow(torch.from_numpy(x)) @ packed.t()
           + torch.from_numpy(b)).reshape(shape[:-1] + (cout,))
    ref = np.asarray(_xla_conv3d(jnp.asarray(x), jnp.asarray(w))) + b
    plain = cv.conv3d_plain(torch.from_numpy(x), w_torch, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_head_dx_on_its_route_matches_jax_vjp(rng):
    """The head's dx (dy [.., 2] -> 128): pack_weight_dx packs the flipped,
    swapped weight for the f32 narrow route, and the kernel's im2col
    arithmetic on it equals jax.vjp of the XLA conv with respect to x (the
    JAX package's head gradient) and the plain dx."""
    import jax

    x, w, _, w_torch = _conv_inputs(rng, (2, 4, 6, 5, 128), 2)
    dy = rng.standard_normal((2, 4, 6, 5, 2), dtype=np.float32)
    assert cv.conv3d_route(dy.shape, torch.float32, 128) == "f32_narrow"
    packed = cv.pack_weight_dx(w_torch, torch.float32)
    assert tuple(packed.shape) == (128, cv.F32_NARROW_K)
    got = (_im2col_f32_narrow(torch.from_numpy(dy)) @ packed.t()).reshape(
        x.shape)
    _, vjp = jax.vjp(lambda v: _xla_conv3d(v, jnp.asarray(w)), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(dy))[0])
    plain = cv.conv3d_dx(torch.from_numpy(dy), w_torch)
    np.testing.assert_allclose(got.numpy(), ref, rtol=CONV_RTOL, atol=CONV_ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)


@pytest.mark.parametrize("dhw", [
    (96, 96, 96), (96, 48, 48), (96, 24, 24), (96, 12, 12), (96, 6, 6),
    (8, 32, 32), (5, 7, 3), (1, 1, 1),
])
def test_conv3d_tiles_fit_the_kernel(dhw):
    td, th, tw = cv.pick_tile(*dhw)
    assert td * th * tw <= cv.MAX_ROWS
    assert (td + 2) * (th + 2) * (tw + 2) <= cv.MAX_HALO
    assert td <= dhw[0] and th <= dhw[1] and tw <= dhw[2]


def test_conv3d_rejects_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on the card
    raises instead of running the plain version."""
    x = torch.empty((1, 2, 2, 2, 4), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        cv.conv3d(x, torch.empty((4, 4, 3, 3, 3), device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        gn.channel_stats(x.reshape(1, 8, 4))


def _gn_inputs(rng, B, C, film):
    x = (rng.standard_normal((B, 3, 4, 5, C), dtype=np.float32) * 2 + 0.5)
    scale = 1 + 0.1 * rng.standard_normal((C,), dtype=np.float32)
    bias = 0.1 * rng.standard_normal((C,), dtype=np.float32)
    fs = fh = None
    if film:
        fs = 0.3 * rng.standard_normal((B, C), dtype=np.float32)
        fh = 0.3 * rng.standard_normal((B, C), dtype=np.float32)
    return x, scale, bias, fs, fh


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True), (True, True)])
def test_group_norm_matches_model_path(rng, C, film, silu):
    x, scale, bias, fs, fh = _gn_inputs(rng, 2, C, film)
    ref = jnn.group_norm_f32(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        film_scale=_j(fs), film_shift=_j(fh), apply_silu=silu)
    out = gn.group_norm(_t(x), _t(scale), _t(bias), film_scale=_t(fs),
                        film_shift=_t(fh), apply_silu=silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=GN_RTOL, atol=GN_ATOL)


@pytest.mark.parametrize("C", [64, 128])
def test_group_norm_matches_ops_library_entry(rng, C):
    """ops/groupnorm.py:fused_group_norm_silu (its CPU path) on [B, N, C]."""
    x, scale, bias, fs, fh = _gn_inputs(rng, 2, C, True)
    x3 = x.reshape(2, -1, C)
    ref = fused_group_norm_silu(jnp.asarray(x3), jnp.asarray(scale),
                                jnp.asarray(bias), _j(fs), _j(fh))
    out = gn.group_norm(_t(x3), _t(scale), _t(bias), film_scale=_t(fs),
                        film_shift=_t(fh), apply_silu=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=GN_RTOL, atol=GN_ATOL)


def test_gn_stats_and_fold_match_jax(rng):
    x, scale, bias, fs, fh = _gn_inputs(rng, 2, 64, True)
    st = gn.channel_stats(_t(x).reshape(2, -1, 64))
    st_ref = np.array(jnn.channel_stats(jnp.asarray(x)))
    np.testing.assert_allclose(st.numpy(), st_ref, rtol=1e-6, atol=1e-4)
    g, b = gn.fold_gn_affine(torch.from_numpy(st_ref), 60, _t(scale),
                             _t(bias), film_scale=_t(fs), film_shift=_t(fh))
    g_ref, b_ref = jnn.fold_gn_affine(
        jnp.asarray(st_ref), 60, jnp.asarray(scale), jnp.asarray(bias),
        film_scale=_j(fs), film_shift=_j(fh))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-6,
                               atol=1e-7)


def test_gn_variance_clamp():
    """A constant group: E[x^2] - mean^2 can round below 0; the model path
    clamps it (the Pallas stats fold does not)."""
    x = torch.full((1, 16, 32), 3.1, dtype=torch.float32)
    out = gn.group_norm(x, torch.ones(32), torch.zeros(32))
    assert torch.isfinite(out).all()
