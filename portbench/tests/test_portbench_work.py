"""The work counts of the yardstick, against hand sums."""

import pytest

import os

from harness import manifest, peaks, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROD = manifest.config(HERE, "superres_prod")
INT8 = manifest.config(HERE, "superres_prod_int8")


def test_production_forward_has_90_sites_and_71_norms():
    sites, norms = work.forward_work(PROD, (96, 96, 96))
    assert len(sites) == 90
    assert sum(s.taps == 1 for s in sites) == 18
    assert len(norms) == 71


def test_production_forward_is_19_68_tflop_at_batch_1():
    sites, _ = work.forward_work(PROD, (96, 96, 96))
    assert sum(s.ops for s in sites) / 1e12 == pytest.approx(19.68, abs=5e-3)
    # the (1, 2, 2) pyramid keeps the ratio: 16^3 scaled by 216
    small, _ = work.forward_work(PROD, (16, 16, 16))
    assert sum(s.ops for s in small) * 216 == pytest.approx(
        sum(s.ops for s in sites))


def test_site_bytes_and_bound_by_hand():
    sites, _ = work.forward_work(PROD, (96, 96, 96))
    s = {x.name: x for x in sites}["in1_0/in_conv"]
    vox = 96 ** 3
    assert s.bytes == vox * 128 * 2 * 2 + 128 * 128 * 27 * 2 + 4 * 128
    assert s.ops == 2 * vox * 27 * 128 * 128
    assert s.bound_s() == pytest.approx(s.ops / peaks.H100_BF16_FLOPS)
    head = {x.name: x for x in sites}["head_conv"]
    assert head.precision == "f32" and head.cout == 2
    assert head.bytes == vox * 128 * 4 + vox * 2 * 4 + 2 * 128 * 27 * 4 + 8


def test_int8_sites_and_phase_taps():
    sites, _ = work.forward_work(INT8, (96, 96, 96))
    prec = {x.name: x.precision for x in sites}
    assert sum(p == "int8" for p in prec.values()) == 88
    assert prec["in0_0"] == "bf16" and prec["head_conv"] == "f32"
    up = [x for x in sites if x.in_voxels < x.out_voxels]
    assert len(up) == 4 and all(x.taps == 12 for x in up)
    skip = {x.name: x for x in sites}["out14_0/skip"]
    # int8 weights one byte, the bf16 activation read once
    assert skip.bytes == 96 ** 3 * (256 + 128) * 2 + 128 * 256 + 4 * 128


def test_norm_bytes_by_hand():
    _, norms = work.forward_work(PROD, (96, 96, 96))
    assert norms[0].bytes == 2 * 96 ** 3 * 128 * 2
    assert norms[-1].precision == "f32"
    assert norms[-1].bytes == 2 * 96 ** 3 * 128 * 4
    total = work.per_forward(PROD, (96, 96, 96), 2)
    assert total["gn_bound_s"] == pytest.approx(
        2 * sum(n.bytes for n in norms) / peaks.HBM_BYTES)
    assert total["conv_ops"] == pytest.approx(2 * 19.68e12, rel=1e-3)
