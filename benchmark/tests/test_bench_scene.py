"""The seeded inputs: deterministic, the same sizes for every seed, and a
US76 copy equal to the port's."""

import numpy as np
import pytest

import core
import scene
from conftest import tiny_cell


def test_us76_copy_matches_the_port():
    from sasktran2_tpu_torch.climatology.us76 import us76_pressure_temperature

    z = np.linspace(0.0, 100000.0, 101)
    p, t = scene.us76(z)
    p0, t0 = us76_pressure_temperature(z)
    np.testing.assert_allclose(p, p0, rtol=1e-13)
    np.testing.assert_allclose(t, t0, rtol=1e-13)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_state_is_a_function_of_the_seed(seed):
    cell = tiny_cell("ground16_f64.wf")
    a = scene.make_state(cell.config, cell.traffic, seed)
    b = scene.make_state(cell.config, cell.traffic, seed)
    np.testing.assert_array_equal(a.vmr, b.vmr)
    assert a.albedo == b.albedo and 0.05 <= a.albedo <= 0.5
    assert np.all(a.vmr > 0) and a.xs_table[1].min() > 0
    va, aa = scene.call_inputs(a, cell.traffic, seed, 3)
    vb, ab = scene.call_inputs(b, cell.traffic, seed, 3)
    np.testing.assert_array_equal(va, vb)
    assert aa == ab


def test_calls_differ_and_sizes_do_not_depend_on_the_seed():
    cell = core.resolve(core.load_json(core.os.path.join(core.ROOT, "BENCHMARK.json")),
                        "ground16_f64.wf")
    s1 = scene.make_state(cell.config, cell.traffic, 1)
    s2 = scene.make_state(cell.config, cell.traffic, 2)
    assert s1.wavelengths_nm.shape == s2.wavelengths_nm.shape == (4096,)
    assert not np.array_equal(s1.vmr, s2.vmr)
    v0, a0 = scene.call_inputs(s1, cell.traffic, 1, 0)
    v1, a1 = scene.call_inputs(s1, cell.traffic, 1, 1)
    assert not np.array_equal(v0, v1) and a0 != a1


@pytest.mark.parametrize("n_calls", [1, 2, 5, 40])
def test_check_picks_the_last_call(n_calls):
    cell = tiny_cell("ground16_f64.wf")
    picked = scene.check_calls(cell.traffic, 99, n_calls)
    assert picked[-1] == n_calls - 1
    assert len(picked) == min(cell.traffic["check"]["calls"], n_calls)
    assert len(set(picked)) == len(picked)
