"""A run, with the look for a card skipped, sound and with the timed path
broken underneath: sound it is correct, broken it is not. The faults a
serving cell at batch 1 can have: a step that returns its state unchanged;
an answer altered where it is produced; one conv site's output off by 1 %;
and on the int8 path a wrong time bin (every site reads the scales of a
neighbouring chain step) and one site quantized with a wrong scale. (A
one-card cell has no exchange between cards to leave out, and a batch of
one no half to leave out.)

On the CPU the cells run at a toy size. The toy model's numbers are not
the card's (a 32-channel model at 16^3 amplifies a last-bit difference
more), so there the check holds them to limits of the toy's own, about
twice what sound toy runs read. On the card (``-m cuda``) each cell runs at
its own size and load and is held to its own limits; ``-s`` prints the
readings."""

import contextlib
import time

import pytest
import torch

import limits
from harness.check import is_correct

CELLS = ["superres_prod.ddpm25_b1", "superres_prod_int8.ddpm25_b1"]
TINY_LIMITS = {  # sound toy runs: bf16 0.012 / 0.015 / 0.0017, int8 0.08 /
    # 0.0005 / 0 (out, step, site)
    "superres_prod.ddpm25_b1": {"start_max_abs": 0.0, "out_rel_l2": 0.03,
                                "step_rel_l2": 0.05, "site_rel_l2": 0.004},
    "superres_prod_int8.ddpm25_b1": {"start_max_abs": 0.0, "out_rel_l2": 0.25,
                                     "step_rel_l2": 0.2, "site_rel_l2": 0.004},
}
SEED = 2 ** 33 + 5
# the site the one-site faults break: mid-pyramid, int8 on the int8 path
SITE = "unet/in4_0/out_conv"
FAULTS = ["state_returned", "answer_altered", "site_output_off",
          "wrong_bin", "site_misquantized"]
INT8_ONLY = ("wrong_bin", "site_misquantized")


@contextlib.contextmanager
def planted(fault, monkeypatch):
    """Yields the ``fault(k, out)`` a run takes (or None), with the program
    broken as ``fault`` says."""
    from ddpm3d_tpu_torch.diffusion import sampling
    from ddpm3d_tpu_torch.models import nn as port_nn
    from ddpm3d_tpu_torch.ops.quant import Int8Config

    wrap = None
    if fault == "state_returned":
        monkeypatch.setattr(sampling, "p_sample", lambda fn, s, c, x, t,
                            noise, **kw: {"sample": x, "pred_xstart": x})
    elif fault == "answer_altered":
        def wrap(k, out):
            out = out.copy()
            out[0, : out.shape[1] // 2] += 0.5
            return out
    elif fault == "site_output_off":
        forward = port_nn.Conv3x3x3.forward

        def off(self, x, *a, **kw):
            y = forward(self, x, *a, **kw)
            return y * 1.01 if self.site == SITE else y

        monkeypatch.setattr(port_nn.Conv3x3x3, "forward", off)
    elif fault == "wrong_bin":
        set_step = Int8Config.set_chain_step

        def neighbour(self, step):
            n = self._tables["chain_steps"] if self._tables else 0
            if step is not None and n > 1:
                step = step + 1 if step % 2 == 0 and step + 1 < n else step - 1
            set_step(self, step)

        monkeypatch.setattr(Int8Config, "set_chain_step", neighbour)
    elif fault == "site_misquantized":
        act_scale = Int8Config.act_scale

        def scale(self, site):
            s = act_scale(self, site)
            return s * 1.25 if site == SITE and s is not None else s

        monkeypatch.setattr(Int8Config, "act_scale", scale)
    yield wrap


def run(name, device, fault=None, monkeypatch=None, tiny=True):
    cell, cfg = limits.cell_and_config(name, tiny=tiny)
    if tiny:
        cell["params"].update(trace_calls=1, check_calls=1, check_from=1)
        cell["limits"] = TINY_LIMITS[name]
    drv = limits.driver(cell)
    with planted(fault, monkeypatch) as wrap:
        res = drv.run(cell, cfg, SEED, 0.0, False, device,
                      time.perf_counter(), fault=wrap)
    print(name, fault, res["compared"])
    return is_correct(res["compared"]) and not res["failed"], res["compared"]


def cases():
    return [(c, f) for c in CELLS for f in FAULTS
            if f not in INT8_ONLY or "int8" in c]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, compared = run(name, torch.device("cpu"))
    assert ok, compared


@pytest.mark.parametrize("name,fault", cases())
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    ok, compared = run(name, torch.device("cpu"), fault, monkeypatch)
    assert not ok, compared


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_at_cell_size_is_correct(name, cuda_device):
    ok, compared = run(name, cuda_device, tiny=False)
    assert ok, compared


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", cases())
def test_fault_at_cell_size_makes_the_run_incorrect(name, fault, monkeypatch,
                                                    cuda_device):
    ok, compared = run(name, cuda_device, fault, monkeypatch, tiny=False)
    assert not ok, compared
