"""What a serving driver is built from: the program and the reference of a
configuration, found by the names it gives (``programs/<model>.py``,
``reference/<reference>.py``) and the sampler its mix names
(``samplers/<sampler>.py``); the step clock, the trace ranges, the capture
of the checked calls, and the judge.

The check follows each checked call's chain step by step from the state the
program reached, and at one step of each checked call, drawn from the seed,
it also judges every conv site alone: the program's output on a few planes
against the reference's site on the program's own input there.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import manifest
from .traffic import ServeTraffic
from .weights import make_weights
from reference import diffusion as ref_diffusion
from reference import quant as ref_quant

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV_MODULES = ("Conv3x3x3", "Conv1x1x1")
NORM_MODULES = ("GroupNorm32",)


def weight_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 7]).generate_state(2, np.uint64)[0]
               >> 1)


def sampler(params: dict):
    """The sampler module a mix names."""
    return manifest.module(PORTBENCH, "samplers", params["sampler"])


class StepClock:
    """Each forward's host time (pre-hook to post-hook) and, on the card, a
    CUDA event at its end; ``end_call`` turns one chain's events into its
    step intervals."""

    def __init__(self, model: torch.nn.Module, cuda: bool):
        self.cuda = cuda
        self.ends: List = []
        self.host_ms: List[float] = []
        self.step_ms: List[float] = []
        self.count_host = True
        self._t0 = 0.0
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self._t0 = time.perf_counter()

    def _post(self, module, args, out):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)
        else:
            self.ends.append(time.perf_counter())
        if self.count_host:
            self.host_ms.append((time.perf_counter() - self._t0) * 1e3)

    def end_call(self, keep: bool = True) -> None:
        if keep:
            for a, b in zip(self.ends, self.ends[1:]):
                self.step_ms.append(a.elapsed_time(b) if self.cuda
                                    else (b - a) * 1e3)
        self.ends = []

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class RangeHooks:
    """``pb.forward``, ``pb.conv`` and ``pb.gn`` ranges around the model's
    forward, its conv site modules and its GroupNorm modules."""

    def __init__(self, model: torch.nn.Module):
        self.handles = []
        self._open: Dict[int, object] = {}
        for m in model.modules():
            name = type(m).__name__
            label = ("pb.forward" if m is model else
                     "pb.conv" if name in CONV_MODULES else
                     "pb.gn" if name in NORM_MODULES else None)
            if label is None:
                continue
            self.handles.append(m.register_forward_pre_hook(
                lambda mod, args, label=label: self._enter(mod, label)))
            self.handles.append(m.register_forward_hook(
                lambda mod, args, out: self._exit(mod)))

    def _enter(self, mod, label):
        rf = torch.profiler.record_function(label)
        rf.__enter__()
        self._open[id(mod)] = rf

    def _exit(self, mod):
        self._open.pop(id(mod)).__exit__(None, None, None)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def build_program(cfg: dict, device, control: Optional[str] = None):
    """The configuration's program model (``programs/<model>.py``) on
    ``device``, in eval mode, its parameters checked against the
    reference's names and shapes."""
    prog = manifest.module(PORTBENCH, "programs", cfg["model"])
    model = prog.build(cfg, device, control)
    shapes = manifest.reference(cfg).shapes(cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if got != shapes:
        raise RuntimeError("the program's parameters differ from the "
                           "configuration's: "
                           + str(sorted(set(got) ^ set(shapes))[:5]))
    return model.eval()


def seed_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's weights (:mod:`.weights`), drawn on ``device``."""
    ref = manifest.reference(cfg)
    return make_weights(ref.shapes(cfg), weight_seed(seed), device,
                        ref.weight_rules(cfg))


def load_weights(model: torch.nn.Module, cfg: dict, seed: int, device) -> None:
    model.load_state_dict(seed_weights(cfg, seed, device))


def schedules(cfg: dict, params: dict):
    """The program's schedule of the mix's respacing, of its warm-up
    respacing, and its process config."""
    from ddpm3d_tpu_torch.models import factory

    def make(respacing):
        return factory.create_gaussian_diffusion(
            steps=cfg["diffusion_steps"], learn_sigma=cfg["learn_sigma"],
            noise_schedule=cfg["noise_schedule"],
            timestep_respacing=respacing)

    sched, dcfg = make(params["respacing"])
    warm, _ = make(params["warmup_respacing"])
    return sched, warm, dcfg


def run_call(model, sched, dcfg, traffic: ServeTraffic, k: int, device,
             params: dict) -> np.ndarray:
    """Call ``k`` of the mix through the port's entry; -> [n, Z, X, Y]."""
    from ddpm3d_tpu_torch.inference.pipeline import denoise_patches

    low, x_T, seed = traffic.call(k)
    return denoise_patches(model, sched, dcfg, low, seed=seed,
                           batch_size=traffic.batch,
                           clip_denoised=params["clip_denoised"],
                           noise=x_T, device=device,
                           **sampler(params).entry_kwargs(params))


def site_plan(params: dict, seed: int, calls: List[int],
              steps: int) -> Dict[int, dict]:
    """Per checked call, the forward (0 the chain's first) at which every
    conv site is judged alone, and the first of the ``site_rows`` output
    planes (D) judged there, drawn from the seed."""
    rows = params.get("site_rows", 0)
    if not rows:
        return {}
    rng = np.random.default_rng(np.random.SeedSequence([seed, 13]))
    return {k: {"forward": int(rng.integers(steps)),
                "d0": int(rng.integers(params["patch"] - rows + 1)),
                "rows": rows} for k in calls}


class Capture:
    """The input and output of every forward of the calls being checked
    (clones on the device, taken in the model's own hooks; no copy to the
    host, so the chain is never held up): ``traj[k]`` holds call k's
    ``xs`` (the state each step starts from) and ``outs`` (the model's
    outputs), and, once the call returned, ``final``. At the forward that
    ``plan`` names for a call, each conv site's input planes (with a halo
    plane a side for a 3x3x3 site) and output planes go to ``sites``."""

    def __init__(self, model: torch.nn.Module,
                 plan: Optional[Dict[int, dict]] = None):
        self.active: Optional[int] = None
        self.traj: Dict[int, dict] = {}
        self.plan = plan or {}
        self._forward = -1
        self._pending: Dict[int, dict] = {}
        self._model = model
        self._site_handles: List = []
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]

    def start(self, k: Optional[int]) -> None:
        """Capture call ``k`` (None: none). The site hooks are on only
        during a call that the plan names, so no other call pays for
        them."""
        self.active = k
        self._forward = -1
        for h in self._site_handles:
            h.remove()
        self._site_handles = []
        if k not in self.plan:
            return
        for name, m in self._model.named_modules():
            if type(m).__name__ in CONV_MODULES and getattr(m, "site", ""):
                self._site_handles += [
                    m.register_forward_pre_hook(
                        lambda mod, a, kw, name=name: self._site_in(
                            mod, name, a, kw), with_kwargs=True),
                    m.register_forward_hook(self._site_out)]

    def _pre(self, module, args):
        if self.active is not None:
            self._forward += 1
            self.traj.setdefault(self.active, {"xs": [], "outs": [],
                                               "sites": []})[
                "xs"].append(args[0].detach().clone())

    def _post(self, module, args, out):
        if self.active is not None:
            self.traj[self.active]["outs"].append(out.detach().clone())

    def _at_plan(self) -> Optional[dict]:
        p = self.plan.get(self.active) if self.active is not None else None
        return p if p is not None and p["forward"] == self._forward else None

    def _site_in(self, mod, name, args, kwargs):
        p = self._at_plan()
        if p is None:
            return
        x = args[0]
        halo = 0 if type(mod).__name__ == "Conv1x1x1" else 1
        lo = max(0, p["d0"] - halo)
        hi = min(x.shape[1], p["d0"] + p["rows"] + halo)
        self._pending[id(mod)] = {
            "name": name, "site": mod.site, "up": bool(kwargs.get("upsample")),
            "forward": self._forward, "lo": lo, "d0": p["d0"],
            "rows": p["rows"], "x": x[:, lo:hi].detach().clone()}

    def _site_out(self, mod, args, out):
        rec = self._pending.pop(id(mod), None)
        if rec is not None:
            rec["y"] = out[:, rec["d0"]:rec["d0"] + rec["rows"]].detach().clone()
            self.traj[self.active]["sites"].append(rec)

    def remove(self) -> None:
        self.start(None)
        for h in self.handles:
            h.remove()


def reference_net(cfg: dict, seed: int, device, qmax: Optional[int] = None):
    """The plain reference of the configuration (``reference/<name>.py``)
    on a fresh draw of the run's weights, and its quantizer (None for a
    bf16 configuration). ``qmax`` 7 serves every quantized site in int4
    (the int8 cell's control)."""
    p = seed_weights(cfg, seed, device)
    quant = None
    if cfg.get("int8"):
        q = cfg["int8"]
        quant = ref_quant.SiteQuant(ref_quant.StaticScales(q["scales_path"]),
                                    q["exclude"], qmax or ref_quant.INT8_QMAX)
    elif qmax is not None:
        raise ValueError("a bf16 configuration has no int8 reference")
    return manifest.reference(cfg).build(cfg, p, quant), quant


def _inputs(traffic: ServeTraffic, k: int, device):
    low, x_T, call_seed = traffic.call(k)
    c = torch.from_numpy(np.ascontiguousarray(low[..., None])).to(device)
    return c, x_T, call_seed


def reference_trajectories(cfg: dict, params: dict, traffic: ServeTraffic,
                           calls: List[int], seed: int, device,
                           qmax: Optional[int] = None) -> Dict[int, dict]:
    """The reference's own chains of ``calls`` as trajectories (the int8
    cell's control puts the int4 reference in the program's place)."""
    net, quant = reference_net(cfg, seed, device, qmax)
    smp = sampler(params)
    tab = smp.tables(cfg, params)
    out = {}
    with torch.inference_mode():
        for k in calls:
            c, x_T, call_seed = _inputs(traffic, k, device)
            tj = {"xs": [], "outs": [], "sites": []}

            def on_step(i, x, o, tj=tj):
                tj["xs"].append(x.clone())
                tj["outs"].append(o.clone())

            def before(i):
                if quant is not None:
                    quant.step = i

            x = torch.from_numpy(np.ascontiguousarray(x_T[..., None])).to(device)
            y = ref_diffusion.sample_chain(
                net, tab, x, c, call_seed, range(len(x_T)),
                clip=params["clip_denoised"], before_step=before,
                on_step=on_step, step=smp.step, noisy=smp.STEP_NOISE)
            tj["final"] = y[..., 0].cpu().numpy()
            out[k] = tj
    return out


def judge(cfg: dict, params: dict, traffic: ServeTraffic,
          trajs: Dict[int, dict], calls: List[int], seed: int,
          device, sites_expected: int = 0) -> Dict[str, float]:
    """Follow each checked call's chain step by step from the state the
    program reached: at every step the reference's model output at the
    program's x_i against the program's, and the reference's step from x_i
    (same step noise) against the program's x_(i-1) (the next step's
    input, or the patch the entry returned). The start is the harness's
    x_T. With ``sites_expected`` (the conv sites of a forward), every
    captured site's output planes against the reference's site on the
    program's own input planes, at the chain step of its forward. Worst
    over steps, sites and patches; inf where a call, a step or a site is
    missing."""
    net, quant = reference_net(cfg, seed, device)
    smp = sampler(params)
    tab = {k: v.to(device) for k, v in smp.tables(cfg, params).items()}
    T = len(tab["timestep_map"])
    worst = {"start_max_abs": 0.0, "out_rel_l2": 0.0, "step_rel_l2": 0.0}
    if sites_expected:
        worst["site_rel_l2"] = 0.0
    inf = {k: math.inf for k in worst}

    def rel(a, b):
        d = (a.float() - b.float()).reshape(a.shape[0], -1)
        r = b.float().reshape(b.shape[0], -1).norm(dim=1).clamp_min(1e-30)
        v = (d.norm(dim=1) / r).max()
        return float(v) if torch.isfinite(v) else math.inf

    with torch.inference_mode():
        for k in calls:
            tj = trajs.get(k)
            if (tj is None or len(tj["xs"]) != T or len(tj["outs"]) != T
                    or tj.get("final") is None):
                return inf
            c, x_T, call_seed = _inputs(traffic, k, device)
            n = len(x_T)
            x0 = tj["xs"][0][..., 0].float().cpu().numpy()
            if x0.shape != x_T.shape:
                return inf
            worst["start_max_abs"] = max(worst["start_max_abs"],
                                         float(np.abs(x0 - x_T).max()))
            final = torch.from_numpy(
                np.ascontiguousarray(tj["final"][..., None])).to(device)
            for j, i in enumerate(range(T - 1, -1, -1)):
                x = tj["xs"][j].float()
                if quant is not None:
                    quant.step = i
                ro = net(x, tab["timestep_map"][i].expand(n), c)
                worst["out_rel_l2"] = max(worst["out_rel_l2"],
                                          rel(tj["outs"][j], ro))
                noise = (ref_diffusion.step_noise(call_seed, range(n), i,
                                                  x.shape[1:], device)
                         if smp.STEP_NOISE else None)
                r_next = smp.step(tab, ro, x, i, noise,
                                  params["clip_denoised"])
                nxt = tj["xs"][j + 1] if j + 1 < T else final
                if nxt.shape != r_next.shape:
                    return inf
                worst["step_rel_l2"] = max(worst["step_rel_l2"],
                                           rel(nxt, r_next))
            if not sites_expected:
                continue
            if len(tj.get("sites", [])) != sites_expected:
                return inf
            for s in tj["sites"]:
                if quant is not None:
                    quant.step = T - 1 - s["forward"]
                ry = net.site(s["name"], s["site"], s["x"], s["up"])
                off = s["d0"] - s["lo"]
                ry = ry[:, off:off + s["rows"]]
                if ry.shape != s["y"].shape:
                    return inf
                worst["site_rel_l2"] = max(worst["site_rel_l2"],
                                           rel(s["y"], ry))
    return worst
