"""On-card study of the bf16 conv kernel ``ddpm3d_tpu_torch/csrc/conv3d_sm90.cu``.

Run from the repository root on a machine with one NVIDIA H100:

    python3 conv3d_sm90_study.py [--against OTHER.cu]

Builds the committed source and three ablations of it with nvcc (into
``chiprun_out/conv3d_sm90_study/``), and ``--against`` another version of
the source (same C entry point) for an A/B in one run on one card, then
times each at main-path shapes beside ``F.conv3d``, after warming the card:
  * ``base``      — the kernel as committed;
  * ``noweights`` — the weight ring is filled once, later taps reuse stale
    tiles (no L2 -> SM weight traffic after the first kStages loads);
  * ``nohalo``    — the two halo stages are filled once, later chunks and
    tiles reuse them (no halo traffic);
  * ``nostore``   — the epilogue stages the output tile in shared memory
    but stores nothing to device memory.
The ablations compute wrong results (their error is printed); they show
what each part of the kernel costs. Then both tile sizes (256-row and
128-row instances) at the small volumes. One JSON line per shape, times in
ms (CUDA events over 20 launches, three rounds), then the rate of one
8192^3 bf16 matrix product (the card's practical peak at its power limit),
the card's name, power limit and SM clock. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ddpm3d_tpu_torch.ops import _build  # noqa: E402
from ddpm3d_tpu_torch.ops import conv3d as cv  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "conv3d_sm90_study")
H100_BF16_FLOPS = 989e12

W_LOAD = """          mbar_expect_tx(m.wfull(st), kWBytes);
          tma_load_3d(m.w_at(st), &tm_w, m.wfull(st), c * kBK, t.n0, tap);"""
H_LOAD = """  mbar_expect_tx(m.hfull(st), s.halo_tx);
  tma_load_5d(m.halo_at(st), tm_x, m.hfull(st), c * kBK, t.w0 - 1, t.h0 - 1,
              t.d0 - 1, t.b);"""
STORE = "if (r >= rows || col >= s.Cout) continue;"


def variants(src: str, against: str = None) -> dict:
    for part in (W_LOAD, H_LOAD, STORE):
        if part not in src:
            raise SystemExit(f"source changed, ablation anchor missing:\n{part}")
    extra = {} if against is None else {"against": against}
    return {
        "base": src,
        "noweights": src.replace(W_LOAD, "if (nw < kStages) {\n" + W_LOAD
                                 + "\n} else { mbar_arrive(m.wfull(st)); }"),
        "nohalo": src.replace(H_LOAD, "if (n < 2) {\n" + H_LOAD
                              + "\n} else { mbar_arrive(m.hfull(st)); }"),
        "nostore": src.replace(STORE, STORE.replace(
            ")", " || acc[0][0] != 1.2345e-30f)", 1)),
        **extra,
    }


def build(src: str, against: str = None) -> dict:
    """{variant: ctypes function}; prints each build's ptxas lines."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants(src, against).items():
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas[{name}]: {line.strip()}")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}")
        fn = ctypes.CDLL(so).conv3d_sm90_launch
        fn.argtypes = _build._SIGNATURES["conv3d_sm90_launch"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, x, wp, b, tile):
    B, D, H, W, cin = x.shape
    y = torch.empty((B, D, H, W, wp.shape[1]), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(), B, D, H,
             W, cin, wp.shape[1], *tile, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_sm90_launch")
    return y


def time_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def inputs(gen, shape, cout):
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda") \
        * (27 * cin) ** -0.5
    b = torch.randn((cout,), generator=gen, device="cuda")
    return x, w, b


def study(fns, gen, shape, cout, tiles, names) -> dict:
    x, w, b = inputs(gen, shape, cout)
    wp = cv.pack_weight(w, torch.bfloat16)
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    xn, wd, bd = x.permute(0, 4, 1, 2, 3), w.bfloat16(), b.bfloat16()
    flops = 2.0 * 27 * shape[-1] * cout * x[..., 0].numel()
    line = dict(shape=list(shape), cout=cout,
                bound_ms=flops / H100_BF16_FLOPS * 1e3,
                library_ms=[time_ms(lambda: F.conv3d(xn, wd, bd, padding=1))])
    for _ in range(3):
        for tile in tiles:
            for name in names:
                key = name if len(tiles) == 1 else f"{name}{list(tile)}"
                y = launch(fns[name], x, wp, b, tile)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max() / ref.float().abs().max()
                line[key + "_rel_err"] = err.item()
                line.setdefault(key, []).append(
                    time_ms(lambda: launch(fns[name], x, wp, b, tile)))
    line["library_ms"].append(time_ms(lambda: F.conv3d(xn, wd, bd, padding=1)))
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another version of the source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv3d_sm90_study: no CUDA device available")
    torch.backends.cudnn.allow_tf32 = False
    against = None
    if args.against:
        with open(args.against) as f:
            against = f.read()
    with open(os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc",
                           "conv3d_sm90.cu")) as f:
        fns = build(f.read(), against)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w, _ = inputs(gen, (1, 96, 96, 96, 128), 128)
    for _ in range(50):  # warm the card to its loaded clock
        F.conv3d(x.permute(0, 4, 1, 2, 3), w.bfloat16(), padding=1)
    torch.cuda.synchronize()
    for shape, cout in (((1, 96, 96, 96, 128), 128),
                        ((1, 96, 96, 96, 256), 128),
                        ((1, 96, 24, 24, 256), 256)):
        print(json.dumps(study(fns, gen, shape, cout,
                               [cv.pick_tile_sm90(*shape[1:4])], list(fns))),
              flush=True)
    for shape, cout in (((1, 96, 12, 12, 768), 384),
                        ((1, 96, 12, 12, 256), 256),
                        ((1, 96, 6, 6, 1024), 512),
                        ((1, 96, 6, 6, 512), 512)):
        tiles = [cv.pick_tile_sm90(*shape[1:4], rows) for rows in (256, 128)]
        line = study(fns, gen, shape, cout, tiles,
                     [n for n in ("base", "against") if n in fns])
        line["chosen"] = list(cv.sm90_tile(*shape[:4], cout))
        print(json.dumps(line), flush=True)
    # the card's practical bf16 rate under this power limit: one large
    # square matrix product (cuBLAS), the yardstick for "share of peak"
    a = torch.randn((8192, 8192), device="cuda").bfloat16()
    ms = time_ms(lambda: a @ a)
    print(json.dumps({"matmul_8192_bf16_ms": ms,
                      "tflops": 2 * 8192 ** 3 / ms / 1e9}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
