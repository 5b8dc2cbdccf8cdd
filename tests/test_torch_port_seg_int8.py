"""The port's Seg* models served in int8 against the JAX package (CPU:
the int8 conv's plain version, exact integer sums; JAX's XLA int8 path,
jitted), each fusion at the tiny size of tests/test_torch_port_seg.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddpm3d_tpu.ops import quant as jquant
from ddpm3d_tpu_torch.ops import quant
from test_torch_port_seg import (  # noqa: F401
    FUSIONS, _case, _jax_f32, _port, _port_forward, _two_threads)

# int8: an int8 network is discontinuous (tests/test_torch_port_int8.py:
# the float layers round in another order in the two packages, an
# activation near a rounding boundary quantizes to the next int8 value and
# the change spreads through the GroupNorms after it). The dual branch runs
# twice the quantized depth of the SuperResModel there, and the two int8
# forwards differ by as much as int8 differs from f32 (measured 0.05-0.08
# mean relative against 0.06-0.09). So the 1x1 sites the fusions add
# (fuse{i}, the middle skip) are held exactly against the
# JAX function on their own input (SITE_RTOL: the jitted JAX epilogue may
# fuse the multiply and the bias add into one FMA, 1 ulp), and the whole
# model against the quantization noise of JAX's own int8 forward against
# its f32 one (mean |diff|), by INT8_NOISE_FACTOR
INT8_NOISE_FACTOR = 1.5
SITE_RTOL = 1e-6
EXCLUDED = ("in0_0", "head_conv")


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_site_fn(xf, kernel, bias, B):
    return jquant.conv3d_folded_int8(xf, kernel, B, bias=bias)


def _fusion_site(site):
    """A 1x1 site of the fusion: ``fuse{i}`` (2C -> C), the middle skip."""
    return site.startswith("fuse") or site == "mid_0/skip"


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seg_int8_matches_jax(fusion, monkeypatch):
    """Int8 on both branches: the quantized sites are JAX's sown sites less
    the default exclusions (whose ``in0_0`` also drops ``encoder/in0_0``,
    the Cin = 1 conv); each fusion site (``fuse{i}``, the middle skip: the
    1x1 shapes the Seg family adds; the encoder's are the main branch's
    convs, held exactly in tests/test_torch_port_int8.py) equals the JAX
    function on its own input; the forward is JAX's DDPM3D_INT8=1 forward
    within the int8 noise."""
    jm, params, x, low, t = _case(fusion)
    ref32, sown = _jax_f32(fusion)
    sown = sorted(sown)
    monkeypatch.setenv("DDPM3D_INT8", "1")
    ref = np.asarray(jax.jit(lambda p, a, tt, lo: jm.apply(
        {"params": p}, a, tt, low_res=lo))(params, x, t, low))
    model = _port(fusion, params, int8=quant.Int8Config())
    io = []
    handles = [m.register_forward_hook(
        lambda mod, args, kwargs, out: io.append(
            (mod.site, args[0], out, bool(kwargs.get("upsample")))),
        with_kwargs=True)
        for m in model.modules() if _fusion_site(getattr(m, "site", ""))]
    got = _port_forward(model, x, low, t)
    for h in handles:
        h.remove()
    sites = sorted(m.site for m in model.modules()
                   if getattr(m, "site", "") and m.int8_active())
    assert "encoder/in0_0" in sown and "encoder/in1_0/in_conv" in sites
    assert sites == [s for s in sown if not quant.int8_excluded(s, EXCLUDED)]
    assert np.isfinite(got).all()
    noise = np.abs(ref - ref32).mean()
    assert 0 < np.abs(got - ref).mean() <= INT8_NOISE_FACTOR * noise
    assert np.abs(got - ref32).mean() <= INT8_NOISE_FACTOR * noise
    assert sorted(site for site, *_ in io) == [s for s in sown
                                               if _fusion_site(s)]
    for site, xin, y, up in io:
        node = params
        for part in site.split("/"):
            node = node[part]
        assert not up  # resblock_updown: no phase-route site here
        B, D = xin.shape[:2]
        xf = jnp.asarray(xin.numpy()).reshape((B * D,) + tuple(xin.shape[2:]))
        ref_y = np.asarray(_jax_site_fn(xf, node["kernel"], node["bias"], B))
        np.testing.assert_allclose(
            y.numpy(), ref_y.reshape(y.shape), rtol=SITE_RTOL,
            atol=SITE_RTOL * np.abs(ref_y).max(), err_msg=site)
