"""On-card study of the port's conv kernels: the bf16 K3
``ddpm3d_tpu_torch/csrc/conv3d_sm90.cu``, with ``--s8`` the int8 K5
``ddpm3d_tpu_torch/csrc/conv3d_s8.cu``, with ``--head`` the f32 head conv
and its dx ``ddpm3d_tpu_torch/csrc/conv3d_head.cu``, with ``--f32`` the f32
torso conv, its fused instance and its dx ``ddpm3d_tpu_torch/csrc/
conv3d_f32.cu``.

Run from the repository root on a machine with one NVIDIA H100:

    python3 conv3d_sm90_study.py [--against OTHER.cu]
    python3 conv3d_sm90_study.py --s8 [--against OTHER_S8.cu]
    python3 conv3d_sm90_study.py --head [--against OLD_CONV3D.cu]
    python3 conv3d_sm90_study.py --f32 [--against OLD_CONV3D.cu]
    python3 conv3d_sm90_study.py --fused [--against OLD_CONV3D.cu]
                                         [--against-gn OLD_GROUPNORM.cu]

Writes the committed source's ablations (and ``--against`` another version
of the source, same C entry point, for an A/B in one run on one card) to
``chiprun_out/conv3d_sm90_study/``, builds them in parallel with the
package's builder (``ddpm3d_tpu_torch/ops/_build.py``), then
times each at main-path shapes beside a library call, after warming the
card. The bf16 kernel, beside ``F.conv3d``:
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
the card's name, power limit and SM clock.

With ``--s8`` the int8 kernel, bit-equality to its plain version checked
for every variant that computes the function:
  * ``base``       — the kernel as committed;
  * ``all_taps``   — built with ``-DCONV3D_S8_ALL_TAPS``: the phase tiles run
    all 27 taps (their zero weights included), the parent's work;
  * ``thread_stores`` — built with ``-DCONV3D_S8_THREAD_STORES``: the
    epilogue's threads store the output instead of TMA;
  * ``noweights``, ``nohalo``, ``nostore`` — as above; ``noepilogue`` also
    skips the dequantize and staging;
  * ``against``    — another version of the source, e.g. the previous K5,
    run on the previous kernel's own tiles (``ops/conv3d.py:pick_tile``,
    at most 128 rows);
at the 3x3x3 sites beside the bf16 K3 on the conv int8 replaces, the 1x1
sites beside ``torch._int_mm``, and the rate of one 8192^3 ``torch._int_mm``.

With ``--head`` the f32 kernels at the head's shapes, checked against the
plain version (f32, 1e-5): the forward [1,96^3,128] -> 2 as committed at
its D-segment count (``ops/conv3d.py:head_plan``) and at others, then
``nomath`` (staging only), ``nostage`` (math on the first two staged
chunks only), ``chunk8`` (8-channel chunks: 32 bytes of each voxel per
load), ``chunk8_stages3`` / ``chunk8_stages4`` (the same with a 3- or
4-chunk ring), ``stages3`` (a 3-chunk ring of 16-channel chunks: one
block per SM) and ``r8`` (8 outputs per thread along W, a 32-wide
window), beside
``F.conv3d`` f32 and ``--against`` (a previous ``csrc/conv3d.cu``, whose
Cout <= 8 instance carried the head); the dx dy [1,96^3,2] -> 128 as
committed, ``nostore``, ``nogather`` (the A tile gathered for a block's
first tile only) and ``t256`` (256-thread blocks, two per SM), beside cuDNN's data gradient,
``F.conv3d`` on the flipped weight and the general f32 kernel
(``csrc/conv3d_f32.cu``, ``general``), and a plain 453 MB ``fill_`` (the
bytes the dx writes); then the card's FFMA rate alone (independent register
chains, no memory traffic), the practical ceiling of both kernels.

With ``--f32`` the f32 torso conv at [1,96^3,128] -> 128: the plain
instance, the fused one (prologue, skip and stats on) and the dx (dy 128
-> 128), each as committed, as ``nomath`` (``-DCONV3D_F32_NO_MATH``: the
staging, transposes and epilogue alone) and ``nostage``
(``-DCONV3D_F32_NO_STAGE``: the k loop alone, on whatever shared memory
holds); the plain instance also as ``noloads`` (the k loop's FFMA from
registers, its shared loads once per unit) and ``loadsonly`` (the k
loop's shared loads, no FFMA), both without staging; beside ``F.conv3d``
(TF32 off; cuDNN's data gradient for the dx)
and ``--against`` (a previous ``csrc/conv3d.cu``, whose f32 instances
carried these convs, on its own weight layout and tiles); then the card's
FFMA rate alone.

With ``--fused`` the bf16 fused ResBlock conv (K4, the fused instance of
``csrc/conv3d_sm90.cu``) in parts, each beside plain K3 on the same
inputs, at the model's fused sites: the kernel as committed with every
part off (``none``), the prologue alone (``pro``), the skip alone
(``skip``), the stats alone (``stats``) and all three (``all``); then
study builds with all three: ``cons`` (the prologue in the consumer
warpgroups at the start of each chunk, as ``csrc/conv3d.cu`` did),
``frag`` (the skip read straight into the fragments from device memory),
``exact`` (the correctly rounded expf and reciprocal in the SiLU) and
``tap1`` / ``tap8`` (the next chunk's halo issued at tap 1 or 8, not 4);
``lean`` (``-DCONV3D_SM90_PROLOGUE_ONLY``: the skip and stats code
compiled out) with every part off and with the prologue alone; beside
them
the unfused sequence (K2 + K3 + skip add + K1) and ``--against`` (a
previous ``csrc/conv3d.cu``, whose bf16 fused instance carried K4). Every
variant's output is checked against the plain version; where the fused
route's tile (``ops/conv3d_fused.py:fused_tile``) differs from the conv's,
also all three parts on the conv's tile (``k3_tile``). Then K1 (GN
stats): as committed, ``unroll1`` (``-DGN_STATS_UNROLL=1``: one load in
flight per thread), rows per split halved and doubled, beside
``torch.var_mean`` and ``--against-gn`` (a previous
``csrc/groupnorm.cu``, two launches), and a plain 16-byte read of the same
bytes (``torch.sum`` over the tensor) as the practical read rate.
Imports no JAX.
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
from ddpm3d_tpu_torch.ops import conv3d_fused as fo  # noqa: E402
from ddpm3d_tpu_torch.ops import conv3d_s8 as s8  # noqa: E402
from ddpm3d_tpu_torch.ops import groupnorm as gn  # noqa: E402
from ddpm3d_tpu_torch.ops.phase_up import phase_window_mask  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "conv3d_sm90_study")
H100_BF16_FLOPS = 989e12

W_LOAD = """          mbar_expect_tx(m.wfull(st), kWBytes);
          tma_load_3d(m.w_at(st), &tm_w, m.wfull(st), c * kBK, t.n0, tap);"""
H_LOAD = """  mbar_expect_tx(m.hfull(st), s.halo_tx);
  tma_load_5d(m.halo_at(st), tm_x, m.hfull(st), c * kBK, t.w0 - 1, t.h0 - 1,
              t.d0 - 1, t.b);"""
STORE = "if (r >= rows || col >= s.Cout) continue;"


# the same ablations of csrc/conv3d_s8.cu
S8_W_LOAD = """          mbar_expect_tx(m.wfull(st), kWBytes);
          tma_load_3d(m.w_at(st), &tm_w, m.wfull(st), c * kBK, t.n0, tap);"""
S8_H_LOAD = """  mbar_expect_tx(m.hfull(st), s.halo_tx);
  tma_load_5d(m.halo_at(st), tm_x, m.hfull(st), c * kBK, t.w0 - s.pad,
              t.h0 - s.pad, t.d0 - s.pad, t.b);"""
S8_STAGE = "if (r >= rows) continue;  // only the tile's rows fit the stage"
S8_STORE = "if (r >= rows || n >= s.N) continue;"
S8_TMA_STORE = "if (threadIdx.x == 128 && nc < s.N) {"
NEVER = " || acc[0][0] != 0x7fffffff)"  # a condition the compiler keeps


def _anchors(src: str, parts) -> None:
    for part in parts:
        if part not in src:
            raise SystemExit(f"source changed, ablation anchor missing:\n{part}")


def variants_s8(src: str, against: str = None) -> dict:
    """{name: (source text, extra nvcc flags)} of the int8 study."""
    _anchors(src, (S8_W_LOAD, S8_H_LOAD, S8_STAGE, S8_STORE, S8_TMA_STORE))
    nostore = src.replace(S8_STORE, S8_STORE.replace(")", NEVER, 1)).replace(
        S8_TMA_STORE, S8_TMA_STORE.replace(
            ")", " && acc[0][0] == 0x7fffffff)", 1))
    out = {
        "base": (src, ()),
        "all_taps": (src, ("-DCONV3D_S8_ALL_TAPS",)),
        "thread_stores": (src, ("-DCONV3D_S8_THREAD_STORES",)),
        "noweights": (src.replace(S8_W_LOAD, "if (nw < kStages) {\n" + S8_W_LOAD
                                  + "\n} else { mbar_arrive(m.wfull(st)); }"), ()),
        "nohalo": (src.replace(S8_H_LOAD, "if (n < s.hstages) {\n" + S8_H_LOAD
                               + "\n} else { mbar_arrive(m.hfull(st)); }"), ()),
        "nostore": (nostore, ()),
        "noepilogue": (nostore.replace(S8_STAGE, S8_STAGE.replace(
            ")", NEVER, 1)), ()),
    }
    if against is not None:
        out["against"] = (against, ())
    return out


def variants(src: str, against: str = None) -> dict:
    _anchors(src, (W_LOAD, H_LOAD, STORE))
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


def build(sources: dict, entry: str = "conv3d_sm90_launch") -> dict:
    """{variant: ctypes function ``entry``} from {variant: source text or
    (source text, extra nvcc flags)}, built in parallel by the package's
    builder; prints each build's ptxas lines."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        text, flags = text if isinstance(text, tuple) else (text, ())
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (cu, tuple(flags))
    paths = _build.build_all(jobs)
    fns = {}
    for name in sources:
        with open(paths[name] + ".log") as f:
            for line in f:
                if any(k in line for k in ("registers", "spill", "serialized")):
                    print(f"ptxas[{name}]: {line.strip()}")
        fns[name] = _build.variant_fn(ctypes.CDLL(paths[name]), entry)
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


def launch_s8(fn, xq, wp, s_x, s_w, bias, up, tile):
    """One bf16-out launch; ``bias`` as the wrapper passes it (on the
    phase route already rounded to bf16)."""
    B, D, H, W, cin = xq.shape
    n = wp.shape[1]
    cout = n // 4 if up else n
    shape = (B, D, 2 * H, 2 * W, cout) if up else (B, D, H, W, cout)
    y = torch.empty(shape, dtype=torch.bfloat16, device=xq.device)
    err = fn(xq.data_ptr(), wp.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
             bias.data_ptr(), y.data_ptr(), B, D, H, W, cin, n, wp.shape[0],
             int(up), *tile, 1, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_s8_launch")
    return y


# (B, D, H, W, Cin), N, taps, upsample: the main-path int8 sites of
# chip_smoke.py's S8_TIMED, the widest phase site and a deep 1x1 site
S8_SHAPES = (
    ((1, 96, 96, 96, 128), 128, 27, False),
    ((1, 96, 96, 96, 256), 128, 27, False),
    ((1, 96, 96, 96, 256), 128, 1, False),
    ((1, 96, 48, 48, 256), 128, 27, False),
    ((1, 96, 6, 6, 1024), 512, 27, False),
    ((1, 96, 48, 48, 128), 4 * 128, 27, True),
    ((1, 96, 12, 12, 768), 384, 1, False),
)


def study_s8(fns, gen, shape, n, taps, up) -> dict:
    """Every variant at one site (three rounds), bit-equality to the plain
    version for those that compute the function, and the yardstick."""
    dev = torch.device("cuda")
    cin = shape[-1]
    k = 3 if taps == 27 else 1
    xq = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, cin, k, k, k), generator=gen,
                       device=dev, dtype=torch.int8)
    if up:  # the stacked phase kernels are zero outside their windows
        wq = wq * phase_window_mask(n // 4).to(dev, torch.int8)
    s_x = torch.full((1,), 0.02, device=dev)
    s_w = 1e-4 + 1e-3 * torch.rand((n,), generator=gen, device=dev)
    bias = torch.randn((n // 4 if up else n,), generator=gen, device=dev)
    kb = bias.bfloat16().float() if up else bias  # as the wrapper passes it
    wp = s8.pack_weight_s8(wq)
    ref = s8.conv3d_s8_plain(xq, wq, s_x, s_w, bias, torch.bfloat16, up)
    tile = s8.s8_tile(*shape[:4], n, taps)
    vox = shape[0] * shape[1] * shape[2] * shape[3]
    cout = n // 4 if up else n
    macs = vox * cin * cout * (48 if up else taps)
    line = dict(shape=list(shape), n=n, taps=taps, upsample=up,
                tile=list(tile), bound_ms=2.0 * macs / 1979e12 * 1e3)
    if taps == 1:
        a, b = xq.reshape(vox, cin), wq.reshape(n, cin).t()
        lib = lambda: torch._int_mm(a, b)  # noqa: E731
        line["library"] = "torch._int_mm"
    else:
        xb = torch.randn(ref.shape[:-1] + (cin,), generator=gen,
                         device=dev).bfloat16()
        wk = cv.pack_weight(torch.randn((cout, cin, 3, 3, 3), generator=gen,
                                        device=dev) * 0.01, torch.bfloat16)
        lib = lambda: cv.conv3d_kernel(xb, wk)  # noqa: E731
        line["library"] = "bf16 K3 (conv3d_sm90) on the conv int8 replaces"
    line["library_ms"] = [time_ms(lib)]
    for _ in range(3):
        for name, fn in fns.items():
            t = cv.pick_tile(*shape[1:4]) if name == "against" else tile
            y = launch_s8(fn, xq, wp, s_x, s_w, kb, up, t)
            torch.cuda.synchronize()
            if name in ("base", "all_taps", "thread_stores", "against"):
                line[name + "_equal"] = bool(torch.equal(y, ref))
            line.setdefault(name, []).append(
                time_ms(lambda: launch_s8(fn, xq, wp, s_x, s_w, kb, up, t)))
    line["library_ms"].append(time_ms(lib))
    return line


def main_s8(against) -> None:
    with open(os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc",
                           "conv3d_s8.cu")) as f:
        fns = build(variants_s8(f.read(), against), "conv3d_s8_launch")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm(gen)
    for shape, n, taps, up in S8_SHAPES:
        print(json.dumps(study_s8(fns, gen, shape, n, taps, up)), flush=True)
    a = torch.randint(-127, 128, (8192, 8192), device="cuda", dtype=torch.int8)
    ms = time_ms(lambda: torch._int_mm(a, a.t()))
    print(json.dumps({"int_mm_8192_ms": ms,
                      "tops": 2 * 8192 ** 3 / ms / 1e9}), flush=True)


# ablations of csrc/conv3d_head.cu
HEAD_MATH = "        head_chunk<COP>(ring"
HEAD_STAGE = "        if (nx < items)\n"
HEAD_CK = "constexpr int kHeadCK = 16;"
HEAD_STAGES = "constexpr int kHeadStages = 2;"
HEAD_R = "static constexpr int R = COP <= 2 ? 4 : 8 / COP;"
DX_STORE = "      if (mr >= s.M) continue;"
DX_GATHER = "    // the thread's 14 taps in two batches of 7 loads in flight\n"
DX_GATHER_END = "    __syncthreads();\n\n    float acc[8][8];"
DX_THREADS = ("constexpr int kNThreads = 128;\nconstexpr int kNBlocks = 3;")


def variants_head(src: str) -> tuple:
    """({name: source} of the forward study, {name: source} of the dx's)."""
    _anchors(src, (HEAD_MATH, HEAD_STAGE, HEAD_CK, HEAD_STAGES, HEAD_R,
                   DX_STORE,
                   DX_GATHER, DX_GATHER_END, DX_THREADS))
    fwd = {
        "base": src,
        "nomath": src.replace(HEAD_MATH, HEAD_MATH.replace(
            "head_chunk", "if (s.nC < 0) head_chunk")),
        "nostage": src.replace(HEAD_STAGE, HEAD_STAGE.replace(
            ")", " && k < 1)")),
        "chunk8": src.replace(HEAD_CK, HEAD_CK.replace("16", "8")),
        "chunk8_stages4": src.replace(HEAD_CK, HEAD_CK.replace("16", "8"))
                             .replace(HEAD_STAGES, HEAD_STAGES.replace("2", "4")),
        "chunk8_stages3": src.replace(HEAD_CK, HEAD_CK.replace("16", "8"))
                             .replace(HEAD_STAGES, HEAD_STAGES.replace("2", "3")),
        "stages3": src.replace(HEAD_STAGES, HEAD_STAGES.replace("2", "3")),
        "r8": src.replace(HEAD_R, HEAD_R.replace("? 4 :", "? 8 :")),
    }
    dx = {
        "dx_base": src,
        "dx_nostore": src.replace(DX_STORE, DX_STORE.replace(
            ")", " || acc[i][0] != 1.2345e-30f)", 1)),
        "dx_nogather": src.replace(DX_GATHER, "    if (tile == (int)blockIdx.x) {\n")
                          .replace(DX_GATHER_END, "    }\n" + DX_GATHER_END),
        "dx_t256": src.replace(DX_THREADS, DX_THREADS.replace(
            "128", "256").replace("= 3", "= 2")),
    }
    return fwd, dx


def main_head(against) -> None:
    """The f32 head conv and its dx (see the module note)."""
    with open(os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc",
                           "conv3d_head.cu")) as f:
        fwd_src, dx_src = variants_head(f.read())
    fwd = build(fwd_src, "conv3d_head_launch")
    dxf = build(dx_src, "conv3d_f32_narrow_launch")
    old = build({"against": against} if against else {}, "conv3d_ndhwc_launch")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm(gen)
    st = torch.cuda.current_stream().cuda_stream
    B, D, H, W, cin, cout = 1, 96, 96, 96, 128, 2
    x = torch.randn((B, D, H, W, cin), generator=gen, device="cuda")
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda") \
        * (27 * cin) ** -0.5
    b = torch.randn((cout,), generator=gen, device="cuda")
    vox = B * D * H * W
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 4.0 * (vox * (cin + cout) + 27 * cin * cout + cout)
    bound = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    ref = cv.conv3d_plain(x, w, b)
    wp = cv.pack_weight_head(w)
    y = torch.empty_like(ref)

    def head(fn, nseg):
        return lambda: _build.check(fn(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(), B, D, H,
            W, cin, cout, nseg, st), "conv3d_head_launch")

    plan = cv.head_plan(D, H, W, cout)[2]
    line = dict(kernel="head", shape=[B, D, H, W, cin], cout=cout,
                bound_ms=bound, plan_nseg=plan)
    segs = {"base": sorted({plan // 2, plan, plan + 2, 2 * plan}),
            "stages3": [plan // 2, plan],  # one block per SM
            "r8": [2 * 132 // 9]}  # its 32-wide window: 9 per plane
    for _ in range(3):
        for name, fn in fwd.items():
            for nseg in segs.get(name, [plan]):
                key = name if nseg == plan else f"{name}_nseg{nseg}"
                y.zero_()
                line.setdefault(key, []).append(time_ms(head(fn, nseg)))
                line[key + "_rel_err"] = ((y - ref).abs().max()
                                          / ref.abs().max()).item()
        if "against" in old:
            wo = cv.pack_weight(w, torch.float32)
            line.setdefault("against", []).append(time_ms(lambda: launch_old(
                old["against"], x, wo, b, y)))
            line["against_rel_err"] = ((y - ref).abs().max()
                                       / ref.abs().max()).item()
        xn = x.permute(0, 4, 1, 2, 3)
        line.setdefault("library_ms", []).append(
            time_ms(lambda: F.conv3d(xn, w, b, padding=1)))
    print(json.dumps(line), flush=True)
    del x, y, ref

    dy = torch.randn((B, D, H, W, cout), generator=gen, device="cuda")
    xs = torch.empty((B, D, H, W, cin), device="cuda")
    ref = cv.conv3d_dx_plain(dy, w)
    wd = cv.pack_weight_dx(w, torch.float32)
    wg = cv.pack_weight_f32(cv.flip_weight(w))
    dx = torch.empty_like(ref)
    wf = cv.flip_weight(w).contiguous()
    dyn = dy.permute(0, 4, 1, 2, 3)
    line = dict(kernel="head_dx", shape=[B, D, H, W, cout], cout=cin,
                bound_ms=bound)

    def narrow(fn):
        return lambda: _build.check(fn(
            dy.data_ptr(), wd.data_ptr(), None, dx.data_ptr(), B, D, H, W,
            cin, st), "conv3d_f32_narrow_launch")

    for _ in range(3):
        for name, fn in dxf.items():
            dx.zero_()
            line.setdefault(name, []).append(time_ms(narrow(fn)))
            line[name + "_rel_err"] = ((dx - ref).abs().max()
                                       / ref.abs().max()).item()
        line.setdefault("general", []).append(time_ms(lambda: launch_f32(
            _build.fn("conv3d_f32_launch"), dy, wg, None, dx)))
        line.setdefault("cudnn_data_grad_ms", []).append(time_ms(
            lambda: torch.ops.aten.convolution_backward(
                dyn, xs.permute(0, 4, 1, 2, 3), w, None, [1, 1, 1],
                [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
                [True, False, False])))
        line.setdefault("conv3d_call_ms", []).append(
            time_ms(lambda: F.conv3d(dyn, wf, padding=1)))
        line.setdefault("fill_ms", []).append(time_ms(lambda: dx.fill_(1.0)))
    print(json.dumps(line), flush=True)


# the card's practical f32 FFMA rate: 8 independent chains per thread, 8
# warps per block, 4 blocks per SM, no memory traffic
FFMA_PEAK_CU = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) ffma_kernel(float* out, int iters) {
  float a[8];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-9f + i;
  const float m = 0.999999f, c = 1e-7f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = fmaf(a[i], m, c);
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += a[i];
  if (s == 1.2345f) out[0] = s;  // keeps the chains alive
}
extern "C" int ffma_peak_launch(void* out, int blocks, int iters,
                                void* stream) {
  ffma_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


# the fused study: (B, D, H, W, Cin), Cout, skip — the model's fused sites
FUSED_SHAPES = (
    ((1, 96, 96, 96, 128), 128, True),    # level-0 ResBlock out_conv
    ((1, 96, 96, 96, 256), 128, False),   # level-0 decoder in_conv
    ((1, 96, 48, 48, 256), 128, False),   # level-1 decoder in_conv
    ((1, 96, 6, 6, 1024), 512, False),    # level-4 decoder in_conv
)
FUSED_BUILDS = {
    "cons": ("-DCONV3D_SM90_PROLOGUE_IN_CONSUMERS",),
    "frag": ("-DCONV3D_SM90_SKIP_FRAGMENT",),
    "exact": ("-DCONV3D_SM90_EXACT_SILU",),
    "tap1": ("-DCONV3D_SM90_FUSED_HALO_TAP=1",),
    "tap8": ("-DCONV3D_SM90_FUSED_HALO_TAP=8",),
    "lean": ("-DCONV3D_SM90_PROLOGUE_ONLY",),
}
PARTS = {"none": (0, 0, 0), "pro": (1, 0, 0), "skip": (0, 1, 0),
         "stats": (0, 0, 1), "all": (1, 1, 1)}


def launch_fused(fn, x, wp, b, pg, pb, sk, parts, y, part, st, tile):
    """One launch of a build's ``conv3d_sm90_fused_launch`` with the parts
    (prologue, skip, stats) on or off."""
    B, D, H, W, cin = x.shape
    pro, skip, stats = parts
    err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(),
             pg.data_ptr() if pro else None, pb.data_ptr() if pro else None,
             1, sk.data_ptr() if skip else None, y.data_ptr(),
             part.data_ptr() if stats else None,
             st.data_ptr() if stats else None, B, D, H, W, cin, wp.shape[1],
             *tile, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_sm90_fused_launch")


def launch_fused_old(fn, x, wp, b, pg, pb, sk):
    """The previous kernel: the bf16 fused instance of an older
    ``csrc/conv3d.cu`` (``conv3d_fused_launch``) with every part on."""
    B, D, H, W, cin = x.shape
    cout = wp.shape[1]
    td, th, tw = cv.pick_tile(D, H, W)
    tiles = -(-D // td) * -(-H // th) * -(-W // tw)
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((B * tiles * 2 * cout,), device=x.device)
    part2 = torch.empty((B * -(-tiles // fo.STATS_GROUP) * 2 * cout,),
                        device=x.device)
    st = torch.empty((B, 2, cout), device=x.device)
    err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(), pg.data_ptr(),
             pb.data_ptr(), 1, None if sk is None else sk.data_ptr(),
             y.data_ptr(), part.data_ptr(), part2.data_ptr(), st.data_ptr(),
             B, D, H, W, cin, cout, td, th, tw, 1,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_fused_launch (previous)")
    return y


def study_fused(fns, old, gen, shape, cout, use_skip) -> dict:
    """K4's parts and builds at one site, three rounds each."""
    dev = torch.device("cuda")
    B, D, H, W, cin = shape
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).bfloat16()
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) \
        * (27 * cin) ** -0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    pg = 0.5 * (1 + 0.1 * torch.randn((B, cin), generator=gen, device=dev))
    pb = -0.25 + 0.1 * torch.randn((B, cin), generator=gen, device=dev)
    sk = torch.randn(shape[:-1] + (cout,), generator=gen, device=dev) \
        .bfloat16() if use_skip else None
    wp = cv.pack_weight(w, torch.bfloat16)
    tile = fo.fused_tile(D, H, W, cout)
    T = -(-D // tile[0]) * -(-H // tile[1]) * -(-W // tile[2])
    y = torch.empty(shape[:-1] + (cout,), dtype=torch.bfloat16, device=dev)
    part = torch.empty((B * T * 2 * cout,), device=dev)
    st = torch.empty((B, 2, cout), device=dev)
    ref = fo.conv3d_fused_plain(x, w.bfloat16(), b, prologue_g=pg,
                                prologue_b=pb, skip=sk)
    skx = sk if sk is not None else torch.zeros_like(y)

    def unfused():
        h = gn.gn_apply(x.reshape(B, -1, cin), pg, pb, True).reshape(x.shape)
        out = cv.conv3d_kernel(h, wp, b)
        if sk is not None:
            out = out + sk
        gn.channel_stats(out.reshape(B, -1, cout))

    flops = 2.0 * 27 * cin * cout * D * H * W * B
    line = dict(shape=list(shape), cout=cout, has_skip=use_skip,
                tile=list(tile), conv_tile=list(cv.sm90_tile(*shape[:4], cout)),
                bound_ms=flops / H100_BF16_FLOPS * 1e3)
    runs = {"k3": lambda: cv.conv3d_kernel(x, wp, b), "unfused": unfused}
    for part_name, parts in PARTS.items():
        if part_name == "skip" and sk is None:
            continue
        if sk is None:  # "all" without a skip at this site
            parts = (parts[0], 0, parts[2])
        runs[part_name] = (lambda p=parts: launch_fused(
            fns["base"], x, wp, b, pg, pb, skx, p, y, part, st, tile))
    for name, fn in fns.items():
        if name == "lean":  # no skip or stats code: parts off, prologue on
            for pn, parts in (("none", (0, 0, 0)), ("pro", (1, 0, 0))):
                runs[f"lean.{pn}"] = (lambda f=fn, p=parts: launch_fused(
                    f, x, wp, b, pg, pb, skx, p, y, part, st, tile))
        elif name != "base":
            runs[name] = (lambda f=fn: launch_fused(
                f, x, wp, b, pg, pb, skx, (1, int(sk is not None), 1), y,
                part, st, tile))
    k3_tile = cv.sm90_tile(*shape[:4], cout)
    if k3_tile != tile:  # all three parts on the conv's own tile
        T3 = -(-D // k3_tile[0]) * -(-H // k3_tile[1]) * -(-W // k3_tile[2])
        part3 = torch.empty((B * T3 * 2 * cout,), device=dev)
        runs["k3_tile"] = lambda: launch_fused(
            fns["base"], x, wp, b, pg, pb, skx, (1, int(sk is not None), 1),
            y, part3, st, k3_tile)
    if old is not None:
        runs["against"] = lambda: launch_fused_old(old, x, wp, b, pg, pb, sk)
    for name, run in runs.items():
        if (name in fns and name != "lean") or name in (
                "all", "against", "k3_tile"):
            out = run()
            out = y if out is None else out
            torch.cuda.synchronize()
            line[name + "_rel_err"] = (
                (out.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item()
    for _ in range(3):
        for name, run in runs.items():
            line.setdefault(name, []).append(time_ms(run))
    return line


def study_gn(fns, old, gen) -> list:
    """K1's variants at the main path's widest and deepest GN shapes."""
    lines = []
    for N, C, dt in ((96 ** 3, 128, torch.bfloat16),
                     (96 ** 3, 128, torch.float32),
                     (96 * 6 * 6, 512, torch.bfloat16),
                     (96 * 6 * 6, 1024, torch.bfloat16)):
        x = (torch.randn((1, N, C), generator=gen, device="cuda") * 2
             + 0.5).to(dt)
        ref = gn.channel_stats_plain(x)
        code = 1 if dt == torch.bfloat16 else 0
        v = 8 if code else 4
        stream = torch.cuda.current_stream().cuda_stream

        def k1(fn, rows):
            S = -(-N // rows)
            CS = -(-C // (gn.STATS_LANES * v))
            stats = torch.empty((1, 2, C), device="cuda")
            ticket, part = gn._stats_scratch(x.device, stream, CS,
                                             CS * S * 2 * gn.STATS_LANES * v)
            _build.check(fn(x.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                            stats.data_ptr(), 1, N, C, rows, code, stream),
                         "gn_stats_launch")
            return stats

        def k1_old():
            rows = max(64, -(-N // 1024))
            part = torch.empty((-(-N // rows) * 2 * C,), device="cuda")
            stats = torch.empty((1, 2, C), device="cuda")
            _build.check(old(x.data_ptr(), part.data_ptr(), stats.data_ptr(),
                             1, N, C, rows, code, stream), "gn_stats_launch")
            return stats

        rows = gn.rows_per_split(N)
        runs = {"base": lambda: k1(fns["base"], rows),
                "unroll1": lambda: k1(fns["unroll1"], rows),
                "rows_half": lambda: k1(fns["base"], max(1, rows // 2)),
                "rows_double": lambda: k1(fns["base"], 2 * rows),
                "var_mean": lambda: torch.var_mean(
                    x.reshape(1, N, 32, C // 32), dim=(1, 3)),
                "read_sum": lambda: torch.sum(x, dtype=torch.float32)}
        if old is not None:
            runs["against"] = k1_old
        line = dict(shape=[1, N, C], dtype=str(dt).split(".")[-1],
                    rows_per_split=rows,
                    bound_ms=x.numel() * x.element_size() / 3.35e12 * 1e3)
        for name in ("base", "unroll1", "rows_half", "rows_double",
                     "against"):
            if name in runs:
                out = runs[name]()
                torch.cuda.synchronize()
                line[name + "_rel_err"] = (
                    (out - ref).abs().max() / ref.abs().max()).item()
        for _ in range(3):
            for name, run in runs.items():
                line.setdefault(name, []).append(time_ms(run))
        lines.append(line)
    return lines


def main_fused(against, against_gn) -> None:
    src = os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc", "conv3d_sm90.cu")
    gsrc = os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc", "groupnorm.cu")
    jobs = {f"fused_{k}": (src, flags) for k, flags in FUSED_BUILDS.items()}
    jobs["gn_unroll1"] = (gsrc, ("-DGN_STATS_UNROLL=1",))
    os.makedirs(OUT, exist_ok=True)
    for name, text in (("fused_against", against), ("gn_against", against_gn)):
        if text is not None:
            path = os.path.join(OUT, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            jobs[name] = (path, ())
    libs = _build.build_variants(jobs)
    paths = _build.build_all()
    for line in open(paths["conv3d_sm90"] + ".log"):
        if any(k in line for k in ("registers", "spill", "serialized")):
            print(f"ptxas[conv3d_sm90]: {line.strip()}")
    fns = {"base": _build.fn("conv3d_sm90_fused_launch")}
    fns.update({k: _build.variant_fn(libs[f"fused_{k}"],
                                     "conv3d_sm90_fused_launch")
                for k in FUSED_BUILDS})
    old = (old_fused_fn(libs["fused_against"]) if "fused_against" in libs
           else None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm(gen)
    for shape, cout, use_skip in FUSED_SHAPES:
        print(json.dumps(study_fused(fns, old, gen, shape, cout, use_skip)),
              flush=True)
    gfns = {"base": _build.fn("gn_stats_launch"),
            "unroll1": _build.variant_fn(libs["gn_unroll1"], "gn_stats_launch")}
    gold = None
    if "gn_against" in libs:
        gold = libs["gn_against"].gn_stats_launch
        gold.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        gold.restype = ctypes.c_int
    for line in study_gn(gfns, gold, gen):
        print(json.dumps(line), flush=True)


def ffma_peak() -> dict:
    """TFLOP/s of FFMA alone on this card (2 FLOP per FFMA)."""
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "ffma_peak.cu")
    with open(cu, "w") as f:
        f.write(FFMA_PEAK_CU)
    lib = ctypes.CDLL(_build.build_all({"ffma_peak": (cu, ())})["ffma_peak"])
    fn = lib.ffma_peak_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    ms = time_ms(lambda: _build.check(fn(
        out.data_ptr(), blocks, iters, torch.cuda.current_stream().cuda_stream),
        "ffma_peak"), n=5)
    flops = 2.0 * blocks * 256 * iters * 16 * 8
    return {"ffma_peak_ms": ms, "ffma_tflops": flops / ms / 1e9}


def old_fused_fn(lib):
    """``conv3d_fused_launch`` of an older ``csrc/conv3d.cu`` (x, w, bias,
    g, gb, silu, skip, y, part, part2, stats, B, D, H, W, Cin, Cout, TD, TH,
    TW, dtype, stream)."""
    fn = lib.conv3d_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_f32(fn, x, wp, b, y):
    """``conv3d_f32_launch`` (``csrc/conv3d_f32.cu``, weight from
    ``pack_weight_f32``) into ``y``."""
    B, D, H, W, cin = x.shape
    err = fn(x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
             y.data_ptr(), B, D, H, W, cin, wp.shape[2],
             *cv.pick_tile_f32(D, H, W), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_f32_launch")


def launch_old(fn, x, wp, b, y):
    """An older csrc/conv3d.cu's ``conv3d_ndhwc_launch`` (f32, its [27, Cout,
    Cin] weight) into ``y``."""
    B, D, H, W, cin = x.shape
    err = fn(x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
             y.data_ptr(), B, D, H, W, cin, wp.shape[1],
             *cv.pick_tile(D, H, W), 0, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_ndhwc_launch")


F32_BUILDS = {"base": (), "nomath": ("-DCONV3D_F32_NO_MATH",),
              "nostage": ("-DCONV3D_F32_NO_STAGE",)}
# the plain instance's k loop (csrc/conv3d_f32.cu:unit_math), and two
# study versions of it run without staging: ``noloads`` (A and B read once
# per unit, then the 1536 FFMA of the unit from registers: the FFMA loop's
# own ceiling) and ``loadsonly`` (every shared load of the loop, no FFMA:
# what the 11 loads per k cost the shared-memory pipe)
F32_LOOP = """#pragma unroll 1
  for (int k = 0; k < kBK; ++k) {
    float a[kHW];
    load_a(a, hb, k);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const float* wr = wb + (kw * kBK + k) * kBN;
      ffma_row(acc, a + kw, *reinterpret_cast<const float4*>(wr),
               *reinterpret_cast<const float4*>(wr + 16));
    }
  }"""
F32_NOLOADS = """  float a[kHW];
  load_a(a, hb, 0);
  float4 b[3][2];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    b[kw][0] = *reinterpret_cast<const float4*>(wb + kw * kBK * kBN);
    b[kw][1] = *reinterpret_cast<const float4*>(wb + kw * kBK * kBN + 16);
  }
#pragma unroll 1
  for (int k = 0; k < kBK; ++k) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) ffma_row(acc, a + kw, b[kw][0], b[kw][1]);
  }"""
F32_LOADSONLY = """#pragma unroll 1
  for (int k = 0; k < kBK; ++k) {
    float a[kHW];
    load_a(a, hb, k);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kHW; ++j) sum += a[j];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const float* wr = wb + (kw * kBK + k) * kBN;
      const float4 b0 = *reinterpret_cast<const float4*>(wr);
      const float4 b1 = *reinterpret_cast<const float4*>(wr + 16);
      sum += b0.x + b0.y + b0.z + b0.w + b1.x + b1.y + b1.z + b1.w;
    }
    acc[k][0] += sum;
  }"""


def main_f32(against) -> None:
    """The f32 torso conv, fused and dx at [1,96^3,128] -> 128 (see the
    module note)."""
    src = os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc", "conv3d_f32.cu")
    jobs = {f"f32_{k}": (src, flags) for k, flags in F32_BUILDS.items()}
    with open(src) as f:
        text = f.read()
    _anchors(text, (F32_LOOP,))
    os.makedirs(OUT, exist_ok=True)
    texts = {"noloads": text.replace(F32_LOOP, F32_NOLOADS),
             "loadsonly": text.replace(F32_LOOP, F32_LOADSONLY)}
    if against is not None:
        texts["against"] = against
    for name, body in texts.items():
        path = os.path.join(OUT, f"f32_{name}.cu")
        with open(path, "w") as f:
            f.write(body)
        flags = ("-DCONV3D_F32_NO_STAGE",) if name != "against" else ()
        jobs[f"f32_{name}"] = (path, flags)
    libs = _build.build_variants(jobs)
    for name in jobs:
        with open(_build._lib_path(name, *jobs[name]) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"ptxas[{name}]: {line.strip()}")
    plain = {k: _build.variant_fn(libs[f"f32_{k}"], "conv3d_f32_launch")
             for k in list(F32_BUILDS) + ["noloads", "loadsonly"]}
    fused = {k: _build.variant_fn(libs[f"f32_{k}"], "conv3d_f32_fused_launch")
             for k in F32_BUILDS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm(gen)
    st = torch.cuda.current_stream().cuda_stream
    B, D, H, W, C = 1, 96, 96, 96, 128
    x = torch.randn((B, D, H, W, C), generator=gen, device="cuda")
    w = torch.randn((C, C, 3, 3, 3), generator=gen, device="cuda") \
        * (27 * C) ** -0.5
    b = torch.randn((C,), generator=gen, device="cuda")
    pg = 0.5 + 0.05 * torch.randn((B, C), generator=gen, device="cuda")
    pb = -0.25 + 0.1 * torch.randn((B, C), generator=gen, device="cuda")
    skip = torch.randn_like(x)
    wp, wo = cv.pack_weight_f32(w), cv.pack_weight(w, torch.float32)
    y = torch.empty_like(x)
    td, th = cv.pick_tile_f32(D, H, W)
    T = -(-D // td) * -(-H // th) * -(-W // cv.F32_TW)
    part = torch.empty((T * 2 * C,), device="cuda")
    part2 = torch.empty((-(-T // fo.STATS_GROUP) * 2 * C,), device="cuda")
    stats = torch.empty((B, 2, C), device="cuda")
    flops = 2.0 * 27 * C * C * B * D * H * W
    refs = {"plain": cv.conv3d_plain(x, w, b),
            "fused": fo.conv3d_fused_plain(x, w, b, prologue_g=pg,
                                           prologue_b=pb, skip=skip)}
    xn = x.permute(0, 4, 1, 2, 3)

    def fused_run(fn):
        return lambda: _build.check(fn(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), pg.data_ptr(),
            pb.data_ptr(), 1, skip.data_ptr(), y.data_ptr(), part.data_ptr(),
            part2.data_ptr(), stats.data_ptr(), B, D, H, W, C, C, td, th, st),
            "conv3d_f32_fused_launch")

    runs = {}
    for k in plain:
        runs[f"plain_{k}"] = ("plain", lambda fn=plain[k]: launch_f32(
            fn, x, wp, b, y))
        if k in fused:
            runs[f"fused_{k}"] = ("fused", fused_run(fused[k]))
    if against is not None:
        lib = libs["f32_against"]
        runs["plain_against"] = ("plain", lambda: launch_old(
            _build.variant_fn(lib, "conv3d_ndhwc_launch"), x, wo, b, y))
        ofn = old_fused_fn(lib)
        tiles = cv.pick_tile(D, H, W)
        ot = -(-D // tiles[0]) * -(-H // tiles[1]) * -(-W // tiles[2])
        opart = torch.empty((ot * 2 * C,), device="cuda")
        opart2 = torch.empty((-(-ot // fo.STATS_GROUP) * 2 * C,),
                             device="cuda")
        runs["fused_against"] = ("fused", lambda: _build.check(ofn(
            x.data_ptr(), wo.data_ptr(), b.data_ptr(), pg.data_ptr(),
            pb.data_ptr(), 1, skip.data_ptr(), y.data_ptr(), opart.data_ptr(),
            opart2.data_ptr(), stats.data_ptr(), B, D, H, W, C, C, *tiles, 0,
            st), "conv3d_fused_launch (against)"))
    runs["library_ms"] = (None, lambda: F.conv3d(xn, w, b, padding=1))
    line = dict(kernel="f32", shape=[B, D, H, W, C], cout=C,
                bound_ms=flops / 67e12 * 1e3)
    for name, (which, run) in runs.items():
        if which is not None:
            y.zero_()
            run()
            line[name + "_rel_err"] = ((y - refs[which]).abs().max()
                                       / refs[which].abs().max()).item()
    for _ in range(3):
        for name, (_, run) in runs.items():
            line.setdefault(name, []).append(time_ms(run, n=5))
    print(json.dumps(line), flush=True)
    del xn, skip, refs

    # the dx: the same kernel on dy with the flipped, in/out-swapped weight
    dy = torch.randn_like(x)
    ref = cv.conv3d_dx_plain(dy, w)
    wd = cv.pack_weight_dx(w, torch.float32)
    wdo = cv.pack_weight(cv.flip_weight(w), torch.float32)
    line = dict(kernel="f32_dx", shape=[B, D, H, W, C], cout=C,
                bound_ms=flops / 67e12 * 1e3)
    runs = {f"dx_{k}": lambda fn=plain[k]: launch_f32(fn, dy, wd, None, y)
            for k in F32_BUILDS}
    if against is not None:
        runs["dx_against"] = lambda: launch_old(
            _build.variant_fn(libs["f32_against"], "conv3d_ndhwc_launch"),
            dy, wdo, None, y)
    for name, run in runs.items():
        y.zero_()
        run()
        line[name + "_rel_err"] = ((y - ref).abs().max()
                                   / ref.abs().max()).item()
    dyn, xs = dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)
    runs["cudnn_data_grad_ms"] = lambda: torch.ops.aten.convolution_backward(
        dyn, xs, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0],
        1, [True, False, False])
    for _ in range(3):
        for name, run in runs.items():
            line.setdefault(name, []).append(time_ms(run, n=5))
    print(json.dumps(line), flush=True)


def warm(gen) -> None:
    x, w, _ = inputs(gen, (1, 96, 96, 96, 128), 128)
    for _ in range(50):  # warm the card to its loaded clock
        F.conv3d(x.permute(0, 4, 1, 2, 3), w.bfloat16(), padding=1)
    torch.cuda.synchronize()


def smi() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another version of the source")
    ap.add_argument("--s8", action="store_true",
                    help="study the int8 kernel (csrc/conv3d_s8.cu)")
    ap.add_argument("--head", action="store_true",
                    help="study the f32 head kernels (csrc/conv3d_head.cu)")
    ap.add_argument("--fused", action="store_true",
                    help="study the bf16 fused conv (csrc/conv3d_sm90.cu's "
                         "fused instance) and GN stats (csrc/groupnorm.cu)")
    ap.add_argument("--f32", action="store_true",
                    help="study the f32 conv (csrc/conv3d_f32.cu): plain, "
                         "fused and dx")
    ap.add_argument("--against-gn",
                    help="with --fused: a previous csrc/groupnorm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv3d_sm90_study: no CUDA device available")
    torch.backends.cudnn.allow_tf32 = False
    against = None
    if args.against:
        with open(args.against) as f:
            against = f.read()
    if args.s8:
        main_s8(against)
        smi()
        return
    if args.fused:
        against_gn = None
        if args.against_gn:
            with open(args.against_gn) as f:
                against_gn = f.read()
        main_fused(against, against_gn)
        smi()
        return
    if args.f32:
        main_f32(against)
        print(json.dumps(ffma_peak()), flush=True)
        smi()
        return
    if args.head:
        main_head(against)
        print(json.dumps(ffma_peak()), flush=True)
        smi()
        return
    with open(os.path.join(ROOT, "ddpm3d_tpu_torch", "csrc",
                           "conv3d_sm90.cu")) as f:
        fns = build(variants(f.read(), against))
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm(gen)
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
    smi()


if __name__ == "__main__":
    main()
