#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It measures ``ddpm3d_tpu_torch`` (the PyTorch/CUDA port) only. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number the check compared, beside its limit); the
last lines of standard error repeat the numbers compared. Exit codes: 0 a
result was printed; 3 no CUDA device or fewer than the cell asks for; 4 a
module of JAX or of the JAX package was loaded; 5 the program is not in
this checkout; 1 any other failure. Only codes 0 print a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, HERE)
    from harness import guard, manifest, report

    bench = manifest.load_benchmark(ROOT)
    cell = manifest.workload(HERE, bench, args.workload)
    cfg = manifest.config(HERE, cell["config"])
    # every cache of the program at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

    import torch

    startup = {"import_s": time.perf_counter() - T_START}
    if not torch.cuda.is_available():
        return fail(3, "no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(3, f"{cell['name']} needs {cell['chips']} cards, "
                       f"{torch.cuda.device_count()} found")
    sys.path.insert(0, ROOT)
    try:
        import ddpm3d_tpu_torch
    except ImportError as e:
        return fail(5, f"the program is not in this checkout ({e})")
    if not os.path.abspath(ddpm3d_tpu_torch.__file__).startswith(ROOT + os.sep):
        return fail(5, "ddpm3d_tpu_torch was loaded from outside the checkout")

    driver = manifest.module(HERE, "drivers", cell["driver"])
    device = torch.device("cuda", 0)
    torch.cuda.init()
    startup["cuda_init_s"] = time.perf_counter() - T_START - startup["import_s"]
    res = driver.run(cell, cfg, args.seed, args.seconds, bool(args.trace),
                     device, T_START, startup)
    found = guard.forbidden_modules()
    if found:
        return fail(4, "modules of JAX or the JAX package were loaded: "
                       + ", ".join(found))
    line = report.result_line(bench, HERE, cell, res, bool(args.trace),
                              device)
    for row in report.compared_lines(line["compared"]):
        print(row, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
