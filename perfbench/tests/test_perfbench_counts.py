"""The work counts (perfbench/work/) at one stated shape, 1,000 rays a step
of each cell's configuration, against counts written out by hand."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import peaks  # noqa: E402
from perfbench.lib.bench import Bench  # noqa: E402

RAYS = 1000


@pytest.fixture(scope="module")
def bench():
    return Bench(REPO)


@pytest.fixture(scope="module")
def ilf(bench):
    return bench.config("nerfacto-tpu-ilf050")


@pytest.fixture(scope="module")
def hsh(bench):
    return bench.config("semantic-nerfw-hash")


def test_kernel_a(bench, ilf):
    # proposals: H = 5 levels x 16 / 2 = 40, dims (80, 16, 1); weights and
    # biases 80*16 + 16 + 16 + 1 = 1,313, B 120 floats; 96 and 32 samples
    # a ray; MACs a point 3*40 + 1,280 + 16 = 1,416; f32 instructions a
    # point 13*40 + 16*4.5 + 1 = 593
    assert bench.work("fourier_mlp_fwd").calls(bench, ilf, RAYS) == [
        (96_000 * 16 + 4 * 1_433, 2.0 * 96_000 * 1_416, 96_000 * 593.0),
        (32_000 * 16 + 4 * 1_433, 2.0 * 32_000 * 1_416, 32_000 * 593.0)]


def test_kernel_b(bench, ilf):
    # field: H = 128; base (256, 128, 128, 16): 51,200 MACs, 51,472
    # weights; rgb (31, 64, 64, 3): 6,272 MACs, 6,403 weights; B 384;
    # 48 samples a ray; 12 + 16*4 + 16 bytes a point; f32 instructions
    # 13*128 + 384*2.5 + 24 + 8 + 30 = 2,686
    (got,) = bench.work("fourier_field_fwd").calls(bench, ilf, RAYS)
    assert got == (48_000 * 92 + 4 * 58_259, 2.0 * 48_000 * 57_856, 48_000 * 2_686.0)


def test_kernels_c_and_d(bench, ilf):
    # C: MACs 120 + 1,280 (hidden recompute) + 1,296 (dW) + 16 (W.dh past
    # the first) = 2,712; instructions 13*40 + 16*8 + 1 = 649; weights read
    # and gradients written
    c = bench.work("fourier_mlp_bwd").calls(bench, ilf, RAYS)
    assert c[0] == (96_000 * 16 + 8 * 1_433, 2.0 * 96_000 * 2_712, 96_000 * 649.0)
    # D: 384 + 2 x (51,200 + 6,272) + 18,432 + 6,272 = 140,032 MACs;
    # instructions 2,686 + 960 + 9 + 28.5 = 3,683.5; 12 + 64 + 16 + 64 bytes
    (d,) = bench.work("fourier_field_bwd").calls(bench, ilf, RAYS)
    assert d == (48_000 * 156 + 8 * 58_259, 2.0 * 48_000 * 140_032, 48_000 * 3_683.5)


def test_hash_backward_kernels(bench, hsh):
    # 26 levels: 5 + 5 proposal levels at 256 and 96 samples a ray, 16 field
    # levels at 48; 8 corner keys a point: 20,224,000 keys; every level's
    # span is its table (2^17, 2^19): the dense levels end inside it
    sort = bench.work("radix_sort").calls(bench, hsh, RAYS)
    assert len(sort) == 26
    assert sum(c[0] for c in sort) == 12 * 20_224_000
    by_key = bench.work("segment_sum_by_key").calls(bench, hsh, RAYS)
    spans = 10 * 2**17 + 16 * 2**19
    assert sum(c[0] for c in by_key) == 4 * (4 * 20_224_000 + 2 * spans)
    assert sum(c[2] for c in by_key) == 2 * 20_224_000


def test_step_flops(bench, ilf, hsh):
    # ilf050: proposals 2n (1,296 + 1,312), field base 2n (51,200 + 69,632),
    # rgb 2n (6,272 + 12,544)
    assert bench.work("mlp_flops").step_flops(bench, ilf, RAYS) == (
        2.0 * 128_000 * 2_608 + 2.0 * 48_000 * 120_832 + 2.0 * 48_000 * 18_816)
    # hash: proposals (10, 16, 1) with the first layer's W.dh (the table
    # learns): 2n (176 + 352); base (32, 64, 16): 2n (3,072 + 6,144); rgb
    # (63, 64, 64, 3): 2n (8,320 + 16,640); semantics (15, 64, 4): 2n (1,216
    # + 1,472)
    assert bench.work("mlp_flops").step_flops(bench, hsh, RAYS) == (
        2.0 * 352_000 * 528 + 2.0 * 48_000 * (9_216 + 24_960 + 2_688))


def test_bound_takes_the_largest_term():
    assert peaks.bound_s(3.35e12, 0.0, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 1.0, 33.5e12) == pytest.approx(1.0)
