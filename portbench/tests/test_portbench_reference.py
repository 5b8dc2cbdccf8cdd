"""The plain reference against the port at a tiny size on the CPU (the
reference itself imports nothing of the port; these tests do)."""

import numpy as np
import pytest
import torch

from harness.weights import make_weights
from reference import diffusion as D
from reference import quant as Q
from reference import superres as R

SCALES = __import__("os").path.join(
    __import__("os").path.dirname(__import__("os").path.dirname(
        __import__("os").path.abspath(__file__))), "configs",
    "INT8_SCALES_PROD.json")
TINY = R.Arch(32, (1, 1, 2, 3, 4), 2)
# the draw's rules without the learned variance's further scale
RULES = R.weight_rules({"in_channels": 1, "learn_sigma": False})


def port_model(fp16=True, int8=None, size=16, ch=32):
    from ddpm3d_tpu_torch.models.factory import sr_create_model

    return sr_create_model(size, size, ch, 2, True, False, False, "1000", 1,
                           64, -1, True, 0.0, True, fp16, int8=int8).eval()


def inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 16, 16, 16, 1, generator=g),
            torch.randn(2, 16, 16, 16, 1, generator=g), torch.tensor([10, 900]))


def test_parameter_shapes_match_the_port_at_production_size():
    m = port_model(size=96, ch=128)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == R.param_shapes(R.Arch(128, (1, 1, 2, 3, 4), 2))
    assert sum(np.prod(s) for s in shapes.values()) == 206964610


@pytest.mark.parametrize("fp16,tol", [(False, 1e-4), (True, 3e-2)])
def test_forward_matches_the_port(fp16, tol):
    p = make_weights(R.param_shapes(TINY), 123456789012, "cpu", RULES)
    m = port_model(fp16)
    m.load_state_dict(p)
    x, low, t = inputs()
    with torch.no_grad():
        a = m(x, t, low_res=low).float()
        b = R.SuperRes(TINY, p, torch.bfloat16 if fp16 else torch.float32)(
            x, t, low)
    assert float((a - b).norm() / b.norm()) < tol


def test_every_int8_site_equals_the_port_on_its_input():
    from ddpm3d_tpu_torch.ops.quant import Int8Config

    p = make_weights(R.param_shapes(TINY), 42, "cpu", RULES)
    cfg = Int8Config(scales=SCALES)
    cfg.set_chain_step(17)
    m = port_model(int8=cfg)
    m.load_state_dict(p)
    scales = Q.StaticScales(SCALES)
    seen = []

    def hook(mod, args, kwargs, out):
        if mod.int8_active():
            up = kwargs.get("upsample", False)
            r = Q.int_site(args[0], mod.weight, mod.bias,
                           scales.scale(mod.site, 17), up)
            seen.append(bool(torch.equal(out, r)))

    for mod in m.modules():
        if type(mod).__name__ in ("Conv3x3x3", "Conv1x1x1"):
            mod.register_forward_hook(hook, with_kwargs=True)
    x, low, t = inputs(1)
    with torch.no_grad():
        m(x, t, low_res=low)
    assert len(seen) == 88 and all(seen)


def test_phase_weights_and_interleave_match_the_port():
    from ddpm3d_tpu_torch.ops.conv3d_s8 import interleave_phases
    from ddpm3d_tpu_torch.ops.phase_up import stacked_phase_weight

    w = torch.randn(8, 16, 3, 3, 3)
    assert torch.equal(Q.phase_weights(w), stacked_phase_weight(w))
    y = torch.randn(2, 3, 4, 5, 4 * 8)
    assert torch.equal(Q.interleave(y), interleave_phases(y))


def test_static_bins_and_rounding_match_the_port():
    from ddpm3d_tpu_torch.ops.quant import Int8Config, quantize_act
    from ddpm3d_tpu_torch.ops.quant import time_bin as port_bin

    cfg = Int8Config(scales=SCALES)
    s = Q.StaticScales(SCALES)
    for step in (0, 3, 12, 24):
        cfg.set_chain_step(step)
        assert s.scale("unet/in5_0/in_conv", step) == cfg.act_scale(
            "unet/in5_0/in_conv")
        assert Q.time_bin(step, 25, 25) == port_bin(step, 25, 25)
    x = (torch.randn(2, 4, 4, 4, 8) * 3).to(torch.bfloat16)
    q, sx = Q.quantize_act(x, 0.021)
    pq, psx = quantize_act(x, 0.021)
    assert torch.equal(q.to(torch.int8), pq) and torch.equal(sx, psx)


def test_chain_tables_and_step_match_the_port():
    from ddpm3d_tpu_torch.diffusion import sampling
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion

    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing="25")
    tab = D.chain_tables(1000, "25")
    assert torch.equal(tab["timestep_map"], sched.timestep_map)
    assert torch.equal(tab["coef1"], sched.posterior_mean_coef1)
    assert torch.equal(tab["post_log_var"], sched.posterior_log_variance_clipped)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 4, 4, 1, generator=g)
    out = torch.randn(2, 4, 4, 4, 2, generator=g)
    for i in (24, 7, 0):
        noise = D.step_noise(99, [0, 1], i, x.shape[1:], "cpu")
        assert torch.equal(noise, sampling.step_noise(
            99, [0, 1], i, x.shape[1:], torch.device("cpu")))
        want = sampling.p_sample(lambda *a, **k: out, sched, cfg, x,
                                 torch.full((2,), i), noise)["sample"]
        got = D.ancestral_step(tab, out, x, i, noise)
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_exact_integer_conv():
    g = torch.Generator().manual_seed(5)
    q = torch.randint(-127, 128, (1, 3, 4, 5, 16), generator=g).float()
    w = torch.randint(-127, 128, (8, 16, 3, 3, 3), generator=g).float()
    got = Q.int_conv(q, w)
    want = torch.nn.functional.conv3d(q.double().permute(0, 4, 1, 2, 3),
                                      w.double(), padding=1)
    assert torch.equal(got, want.permute(0, 2, 3, 4, 1))
