#!/usr/bin/env python3
"""The readings a serving cell's limits are set from: for each seed, the
sound program's numbers and its control's, at the cell's own size and load
(the calls a run checks, at its batch and chain), in one process.

    python3 portbench/limits.py --workload <cell> --seeds 1 2 3 ...

The control is the cell's ``control`` entry: ``program_int8_dynamic`` (a
bf16 cell: the program with its own int8 path on, dynamic scales, the same
weights), or ``reference_int4`` (an int8 cell: the plain reference with
every quantized site in int4, put in the program's place: its own chains,
and each conv site on the program's captured input). One JSON line
a seed: ``{"seed", "calls", "program": {...}, "control": {...}}``. The
benchmark's own runs never run this. ``--device cpu`` with ``--tiny``
rehearses it at a toy size.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TINY = {"large_size": 16, "small_size": 16, "num_channels": 32}
TINY_PARAMS = {"volume": [20, 24, 24], "patch": 16, "xy_patches": 2,
               "respacing": "3", "warmup_respacing": "2"}


def cell_and_config(name: str, tiny: bool):
    from harness import manifest

    bench = manifest.load_benchmark(ROOT)
    cell = manifest.workload(HERE, bench, name)
    cfg = manifest.config(HERE, cell["config"])
    if tiny:
        cfg.update(TINY)
        cell["params"].update(TINY_PARAMS)
    return cell, cfg


def driver(cell: dict):
    from harness import manifest

    return manifest.module(HERE, "drivers", cell["driver"])


def program_trajectories(model, cfg, cell, traffic, calls, seed,
                         device) -> dict:
    """The program's chains of ``calls``, captured as a run captures them."""
    from harness import serve

    params = cell["params"]
    sched, _, dcfg = serve.schedules(cfg, params)
    capture = serve.Capture(model, serve.site_plan(params, seed, calls,
                                                   sched.num_timesteps))
    try:
        for k in calls:
            capture.start(k)
            out = serve.run_call(model, sched, dcfg, traffic, k, device,
                                 params)
            capture.traj.setdefault(k, {"xs": [], "outs": [],
                                        "sites": []})["final"] = out
    finally:
        capture.start(None)
        capture.remove()
    return capture.traj


def readings_for_seed(cell: dict, cfg: dict, seed: int, device,
                      program, control_program=None,
                      with_control: bool = True) -> dict:
    """The program's and (``with_control``) the control's numbers on
    ``seed``'s check calls."""
    import torch

    from harness import serve
    from harness.traffic import ServeTraffic

    params = cell["params"]
    drv = driver(cell)
    n_sites = drv.sites_per_forward(cfg, params)
    traffic = ServeTraffic(params, seed, device)
    calls = drv.check_calls(params, seed)
    serve.load_weights(program, cfg, seed, device)
    trajs = program_trajectories(program, cfg, cell, traffic, calls, seed,
                                 device)
    out = {"seed": seed, "calls": calls,
           "program": serve.judge(cfg, params, traffic, trajs, calls, seed,
                                  device, n_sites)}
    if not with_control:
        return out
    if cell["control"]["kind"] == "program_int8_dynamic":
        serve.load_weights(control_program, cfg, seed, device)
        control = program_trajectories(control_program, cfg, cell, traffic,
                                       calls, seed, device)
    else:  # reference_int4: its own chains; each site on the program's input
        control = serve.reference_trajectories(cfg, params, traffic, calls,
                                               seed, device, qmax=7)
        int4, quant4 = serve.reference_net(cfg, seed, device, qmax=7)
        T = len(control[calls[0]]["xs"])
        with torch.inference_mode():
            for k in calls:
                for s in trajs[k]["sites"]:
                    quant4.step = T - 1 - s["forward"]
                    off = s["d0"] - s["lo"]
                    y = int4.site(s["name"], s["site"], s["x"], s["up"])
                    control[k]["sites"].append(
                        dict(s, y=y[:, off:off + s["rows"]]))
        del int4
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["control"] = serve.judge(cfg, params, traffic, control, calls, seed,
                                 device, n_sites)
    del trajs, control
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch

    from harness import serve

    device = torch.device(args.device)
    cell, cfg = cell_and_config(args.workload, args.tiny)
    program = serve.build_program(cfg, device)
    control_program = None
    if cell["control"]["kind"] == "program_int8_dynamic":
        control_program = serve.build_program(cfg, device, "int8_dynamic")
    n_ctl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        row = readings_for_seed(cell, cfg, seed, device, program,
                                control_program, with_control=i < n_ctl)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
