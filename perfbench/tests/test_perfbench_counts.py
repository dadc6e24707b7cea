"""The frozen counts against the one-pass bounds the port's kernels were
measured by (K2 at 256^2 1.025 ms a 4,096 draws, K1 at 512^2 0.584, K4
at 256^2 0.669 a 4,096 steps, K4 at 1024^2 with a 402 px pupil 2.343 a
256 steps; 3xTF32 beside)."""

import pytest

from perfbench.counts import bounds as b

ONE = b.PEAK_TF32


@pytest.mark.parametrize("fn, args, ms", [
    (b.k2_bound, (256, 82, 4096, True), 1.025),
    (b.k1_bound, (512, 82, 4096, True), 0.584),
    (b.ar_bound, (4, 256, 82, 4096, True), 0.669),
    (b.ar_bound, (4, 1024, 402, 256, True), 2.343),
    (b.k2_bound, (1024, 402, 630, True), 11.443),
    (b.k3_bound, (1024, 402, 630, True), 3.831)])
def test_one_pass_bounds(fn, args, ms):
    assert fn(*args, peak=ONE)[0] == pytest.approx(ms, abs=6e-4)


def test_three_pass_bound_of_k4_at_1024():
    assert b.ar_bound(4, 1024, 402, 256, True)[0] == pytest.approx(
        6.515, abs=6e-4)


def test_iid_least_is_the_lesser_route():
    assert b.iid_least_ms(256, 82, 4096, True, "default") == pytest.approx(
        b.k1_bound(256, 82, 4096, True, peak=ONE)[0])
    assert b.iid_least_ms(1024, 402, 630, True, "default") == pytest.approx(
        b.k3_bound(1024, 402, 630, True, peak=ONE)[0])
