"""The frozen roofline formulas give the bounds PERF.md's kernel table
lists."""

import pytest

import roofline


def test_thomas_bound_at_ground16_w1024():
    assert roofline.thomas_bound_s(100, 16, 1024, 4) * 1e3 == pytest.approx(0.0978, abs=5e-5)
    nbytes, flops = roofline.thomas_cost(100, 16, 1024, 4)
    assert nbytes / roofline.HBM_BYTES_PER_S > flops / roofline.FP32_FLOP_PER_S


def test_jacobi_bound_at_ground16_w1024():
    assert roofline.jacobi_bound_s(100, 8, 1024, 7, 4) * 1e3 == pytest.approx(0.0300, abs=5e-5)
    nbytes, flops = roofline.jacobi_cost(100, 8, 1024, 7, 4)
    assert flops / roofline.FP32_FLOP_PER_S > nbytes / roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("shape,ms", [((100, 48, 1024, 4), 0.857),
                                      ((100, 16, 4096, 4), 0.391)])
def test_thomas_bound_other_instances(shape, ms):
    assert roofline.thomas_bound_s(*shape) * 1e3 == pytest.approx(ms, abs=1e-3)


def test_float64_bounds_use_the_fp64_peak():
    """ground16_f64's instances: the Thomas solve is bound by its bytes,
    twice float32's; Jacobi's 10 sweeps by the FP64 peak."""
    assert roofline.thomas_bound_s(100, 16, 4096, 8) == pytest.approx(
        2 * roofline.thomas_bound_s(100, 16, 4096, 4))
    flops = roofline.jacobi_cost(100, 8, 4096, 10, 8)[1]
    assert roofline.jacobi_bound_s(100, 8, 4096, 10, 8) == pytest.approx(
        flops / roofline.FP64_FLOP_PER_S)
