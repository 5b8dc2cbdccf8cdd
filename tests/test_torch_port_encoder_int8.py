"""The standalone ``EncoderUNetModel`` served in int8 against the JAX
package's encoder under ``DDPM3D_INT8=1`` (CPU: the int8 conv's plain
version, exact integer sums; JAX's XLA int8 path, jitted), and the
quantized weight cache across training and ``set_int8``, at the size of
``tools/seg_int8_check.py``'s classifier (32 channels, (1, 2), one res
block, the adaptive pool) on a 4 x 8 x 8 input."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddpm3d_tpu.models.unet import EncoderUNetModel as JaxEncoder
from ddpm3d_tpu.ops import quant as jquant
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch.models import EncoderUNetModel
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.training.train_loop import make_optimizer

KW = dict(in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
          attention_resolutions=(), channel_mult=(1, 2),
          use_scale_shift_norm=True, resblock_updown=True, pool="adaptive")
EXCLUDED = ("in0_0", "head_conv")
# a site on its own input against the JAX function: the jitted JAX epilogue
# may fuse the multiply and the bias add into one FMA, 1 ulp
# (tests/test_torch_port_seg_int8.py)
SITE_RTOL = 1e-6
# the int8 encoder's last activation against JAX's int8 one, by the noise
# of JAX's own int8 forward against its f32 one (mean |diff|): an int8
# network is discontinuous, and the two packages' float layers round in
# other orders (tests/test_torch_port_int8.py)
INT8_NOISE_FACTOR = 1.5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case():
    """Seeded params made on the port's state dict (every param noise,
    GroupNorm gains near 1) and carried to JAX by its importer, and
    inputs."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 4, 8, 8, 1)).astype(np.float32)
    t = np.array([50, 700], np.int32)
    model = EncoderUNetModel(**KW)
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    return sd, torch_state_dict_to_params(sd), x, t


def _port(sd, **kw):
    model = EncoderUNetModel(**KW, **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def _jax_features(params, x, t, mp, mode):
    """JAX's last activation (return_features) under DDPM3D_INT8=``mode``
    and its sown sites (the calibration mode sows every conv site)."""
    mp.setenv("DDPM3D_INT8", mode)
    mp.setenv("DDPM3D_INT8_CALIB", "1" if mode == "0" else "0")
    jm = JaxEncoder(**KW)
    (_, h), muts = jax.jit(lambda p: jm.apply(
        {"params": p}, x, t, return_features=True,
        mutable=["quant_calib"]))(params)
    sown = sorted("/".join(k.key for k in path[:-1]) for path, _ in
                  jax.tree_util.tree_flatten_with_path(
                      muts.get("quant_calib", {}))[0])
    return np.asarray(h, np.float32), sown


def _jax_site_fn(xf, kernel, bias, B):
    """JAX's int8 site, op by op: jitted, XLA turns the scales' division
    by 127 into a multiply by its reciprocal (1 ulp off), which can round
    a weight to the neighbouring int8 value (measured at mid_0/out_conv)."""
    return jquant.conv3d_folded_int8(xf, kernel, B, bias=bias)


def test_encoder_int8_matches_jax(monkeypatch):
    """``EncoderUNetModel(int8=Int8Config())``: its quantized sites are
    JAX's sown conv sites less the default exclusions (``in0_0``; the
    head's conv is a plain 1x1 conv in both packages), under the flax
    names the scales files key; each site equals the JAX int8 conv on its
    own input; the last activation is JAX's DDPM3D_INT8=1 one within the
    int8 noise; the logits are finite."""
    sd, params, x, t = _case()
    ref32, sown = _jax_features(params, x, t, monkeypatch, "0")
    ref, _ = _jax_features(params, x, t, monkeypatch, "1")
    model = _port(sd, int8=quant.Int8Config())
    sites = sorted(m.site for m in model.modules()
                   if getattr(m, "site", "") and m.int8_active())
    assert "in0_0" in sown and "mid_2/out_conv" in sites
    assert sites == [s for s in sown if not quant.int8_excluded(s, EXCLUDED)]
    io = []
    handles = [m.register_forward_hook(
        lambda mod, args, out: io.append((mod.site, args[0], out)))
        for m in model.modules() if getattr(m, "site", "") in sites]
    with torch.no_grad():
        _, h = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                     return_features=True)
        logits = model(torch.from_numpy(x), torch.from_numpy(t).long())
    for hd in handles:
        hd.remove()
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()
    got = h.float().numpy()
    noise = np.abs(ref - ref32).mean()
    assert 0 < np.abs(got - ref).mean() <= INT8_NOISE_FACTOR * noise
    assert sorted({s for s, *_ in io}) == sites
    for site, xin, y in io:
        node = params
        for part in site.split("/"):
            node = node[part]
        B, D = xin.shape[:2]
        xf = jnp.asarray(xin.numpy()).reshape((B * D,) + tuple(xin.shape[2:]))
        ref_y = np.asarray(_jax_site_fn(xf, node["kernel"], node["bias"], B))
        np.testing.assert_allclose(
            y.numpy(), ref_y.reshape(y.shape), rtol=SITE_RTOL,
            atol=SITE_RTOL * np.abs(ref_y).max(), err_msg=site)


def test_int8_weights_rebuilt_after_training_and_set_int8():
    """The tool trains in float and switches int8 on and off per
    evaluation: after an optimizer step, and after weights written through
    ``.data`` (which keeps the parameter's version) followed by
    ``set_int8``, the int8 logits equal those of a fresh model built from
    the same weights; a stale quantized weight would differ silently."""
    sd, _, x, t = _case()
    xs, ts = torch.from_numpy(x), torch.from_numpy(t).long()
    cfg = quant.Int8Config()

    def fresh_logits(model):
        ref = _port({k: v.numpy() for k, v in model.state_dict().items()},
                    int8=cfg)
        with torch.no_grad():
            return ref(xs, ts)

    model = _port(sd, int8=cfg)
    with torch.no_grad():
        before = model(xs, ts)
    model.set_int8(None)
    model.train()
    opt = make_optimizer(list(model.parameters()), 1e-2, 0.0)
    loss = F.cross_entropy(model(xs, ts).float(), torch.tensor([0, 1]))
    loss.backward()
    opt.step()
    model.eval()
    model.set_int8(cfg)
    with torch.no_grad():
        after = model(xs, ts)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh_logits(model))
    with torch.no_grad():
        for p in model.parameters():
            p.data.mul_(1.5)  # no version bump through .data
    model.set_int8(None)
    model.set_int8(cfg)
    with torch.no_grad():
        rescaled = model(xs, ts)
    assert not torch.equal(rescaled, after)
    assert torch.equal(rescaled, fresh_logits(model))


def test_encoder_int8_guards():
    """Int8 is inference-only: a forward in train() mode or one recording
    gradients raises; a 2-D encoder given int8 raises, as the UNet does;
    int8 and the calibration mode exclude each other."""
    sd, _, x, t = _case()
    model = _port(sd, int8=quant.Int8Config())
    xs, ts = torch.from_numpy(x), torch.from_numpy(t).long()
    model.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        model(xs, ts)
    model.eval()
    with pytest.raises(RuntimeError, match="inference-only"):
        model(xs.requires_grad_(True), ts)
    with pytest.raises(ValueError, match="3-D models only"):
        EncoderUNetModel(**dict(KW, dims=2), int8=quant.Int8Config())
    with pytest.raises(ValueError, match="without int8"):
        model.set_calibration(quant.ActCalibration())
    model.set_int8(None)
    calib = quant.ActCalibration()
    model.set_calibration(calib)
    with torch.no_grad():
        model(xs, ts)
    assert sorted(calib.maxima()) == sorted(
        m.site for m in model.modules() if getattr(m, "site", ""))
