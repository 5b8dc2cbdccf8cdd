"""The bf16 conv at Cin above 8 that is not a multiple of 8, on the CPU:
``csrc/conv3d_narrow.cu``'s gather instance (route ``sm90_gather``: A
gathered a 64-k chunk at a time, the weight streamed through a ring of
64-k tiles with each chunk's k table, three warpgroups on one 192-row
slice).

The kernel does not run here (no nvcc, no card), so its index arithmetic
is held in torch, with the slice and chunk sizes read from the source
(:func:`narrow_constants`): the packed weight, the A fragments a chunk at
a time, the k table computed per chunk into a ring slot, the rows of each
warpgroup's slice and the zero-filled weight tiles, whose products must
equal ``conv3d_plain``. The routes, the packing and ``conv3d_plain``
against the JAX package's conv at these widths are cases of
``tests/test_torch_port_conv_smallcin.py``'s tests; the instances' tiles
and shared memory of ``tests/test_torch_port_ops.py``'s.
"""

import itertools
import pathlib
import re

import pytest
import torch

from ddpm3d_tpu_torch.ops import conv3d as cv

NARROW_SRC = (pathlib.Path(cv.__file__).resolve().parents[1] / "csrc"
              / "conv3d_narrow.cu")


def narrow_constants(cin: int) -> dict:
    """The compile-time constants of ``csrc/conv3d_narrow.cu`` for Cin =
    ``cin``: its namespace's ``constexpr int``s and the members of
    ``Narrow<cin>``, evaluated in order from the source's own expressions
    (C's integer ``/`` as ``//``, ``a ? b : c`` as ``b if a else c``)."""
    env = {"kCin": cin}
    for name, expr in re.findall(
            r"^(?:  static )?constexpr int (\w+) =\s*([^;]+);",
            NARROW_SRC.read_text(), re.M):
        expr = expr.replace("/", "//")
        cond = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr, re.S)
        if cond:
            expr = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
        env[name] = eval(f"({expr})", {}, env)  # noqa: S307
    return env


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests (the suite's workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


WIDE_CIN = (9, 12, 15, 17, 20)
# bf16 inputs: every product is exact in f32, so only the order of the f32
# sums differs
BF16_F32_SUM_REL = 1e-6


def _entry(cin, k, H, W):
    """csrc/conv3d_narrow.cu:put_k_entry: k -> (offset of (tap, ci) from a
    row's first element, tap); a padding k -> (0, 27)."""
    if k >= 27 * cin:
        return 0, 27
    tap, ci = divmod(k, cin)
    kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
    return (((kd - 1) * H + kh - 1) * W + kw - 1) * cin + ci, tap


def _slice_rows(M, src):
    """The first row of each warp's 16, as the gather instance walks them:
    its kWG warpgroups take rows kRows wg .. of one kWG kRows-row slice,
    for slices enough to cover M rows."""
    per = src["kWG"] * src["kRows"]
    return [sl * per + wg * src["kRows"] + 16 * w
            for sl in range(-(-M // per))
            for wg in range(src["kWG"]) for w in range(src["kRows"] // 16)]


def _emulate(x, wp):
    """The gather instance's f32 sums for x [B, D, H, W, Cin] and the
    packed [Cout, Kpad] weight (Cout <= 128, one column tile): for each
    warp's 16 rows and chunk c of kK k (kSteps k-steps), each register's k
    pair from narrow_fragment_taps and the chunk's kK k-table entries
    computed alone, A times the chunk's [128][kK] weight tile (zero past
    Kpad)."""
    B, D, H, W, cin = x.shape
    src = narrow_constants(cin)
    M = B * D * H * W
    kc, n_steps = src["kK"], src["kSteps"]
    assert wp.shape[1] == src["kKpad"] == cv.narrow_k(cin)
    flat = x.float().reshape(-1)
    cout = wp.shape[0]
    m_all = torch.arange(M)
    d, h, w = m_all // (H * W) % D, m_all // W % H, m_all % W
    y = torch.zeros((M, cout))
    for m0 in _slice_rows(M, src):
        for c in range(-(-src["kKpad"] // kc)):
            k0 = kc * c
            tab = [_entry(cin, k0 + i, H, W) for i in range(kc)]
            tile = torch.zeros((128, kc))
            cols = wp[:, k0:k0 + kc].float()
            tile[:cout, :cols.shape[1]] = cols
            A = torch.full((16, 16 * n_steps), float("nan"))
            for gg, tq, ks, reg in itertools.product(
                    range(8), range(4), range(n_steps), range(4)):
                row = gg + (8 if reg % 2 else 0)
                k = k0 + 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
                for kk, (tap, ci) in zip((k, k + 1), cv.narrow_fragment_taps(
                        cin, k0 // 16 + ks, tq, reg)):
                    assert cin * tap + ci == kk
                    off, etap = tab[kk - k0]
                    assert etap == (tap if kk < 27 * cin else 27)
                    m = m0 + row
                    inside = m < M and etap < 27
                    if inside:
                        kd, kh, kw = etap // 9, etap // 3 % 3, etap % 3
                        inside = (0 <= d[m] + kd - 1 < D
                                  and 0 <= h[m] + kh - 1 < H
                                  and 0 <= w[m] + kw - 1 < W)
                    A[row, kk - k0] = (flat[m * cin + off].item()
                                       if inside else 0.0)
                if cin % 2 == 0 and k < 27 * cin:  # one aligned word
                    off, tap = tab[k - k0]
                    assert tab[k + 1 - k0] == (off + 1, tap)
                    assert off % 2 == 0
            part = A @ tile[:cout].T
            rows = [m0 + r for r in range(16) if m0 + r < M]
            if rows:
                y[rows] += part[:len(rows)]
    return y.reshape(B, D, H, W, cout)


@pytest.mark.parametrize("cin", WIDE_CIN)
@pytest.mark.parametrize("B,dhw", [(1, (3, 5, 7)), (2, (2, 4, 3))])
def test_wide_cin_kernel_emulated(cin, B, dhw):
    """A assembled as the gather instance does (a 64-k chunk at a time by
    the chunk's own k table, the warpgroups' rows, the zero-filled tiles),
    times pack_weight_narrow's [Cout, Kpad]:
    the f32 sums equal the f32 conv of the bf16 values, one bf16 rounding
    of them is conv3d_plain but for sums within one rounding of a tie.
    Ragged volumes (3 x 5 x 7 leaves a slice part-filled) and batch 2."""
    assert cv.conv3d_route((B, *dhw, cin), torch.bfloat16, 24) == (
        "sm90_gather")
    cout = 24
    g = torch.Generator().manual_seed(40 + cin)
    x = torch.randn((B, *dhw, cin), generator=g).bfloat16()
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g)
         / (27 * cin) ** 0.5).bfloat16()
    wp = cv.pack_weight_kernel(w, torch.bfloat16)
    assert wp.shape == (cout, cv.narrow_k(cin))
    y32 = _emulate(x, wp)
    ref32 = cv.conv3d_plain(x.float(), w.float())
    assert (y32 - ref32).abs().max() <= BF16_F32_SUM_REL * ref32.abs().max()
    ref = cv.conv3d_plain(x, w)
    assert (y32.bfloat16() != ref).float().mean() <= 0.01
    assert (y32.bfloat16().float() - ref.float()).abs().max() <= (
        2 ** -8 * ref.float().abs().max())
