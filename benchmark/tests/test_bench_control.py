"""The control comes out not correct: the program on its own path in the
precision below the configuration's (float32 for float64; TF32 matrix
products for float32 with TF32 off), in the place of the configured
one, fails the cell's limits on the answers a run checks. At each cell's
own configuration and size, on the card, for one seed and the check's
calls (``readings.py`` reads the same over more seeds)."""

import pytest

import core
import readings
from conftest import ROOT

MANIFEST = core.load_json(core.os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_control_fails_the_limits(cuda_device, workload):
    import sasktran2_tpu_torch as sk

    import system

    cell = core.resolve(MANIFEST, workload)
    engine, cfg, geometry = system.build_engine(
        sk, readings.control_config(cell.config), cuda_device)
    numbers, calls, _ = readings.program_numbers(
        cell, engine, cfg, geometry, 4242, 0.0, cuda_device,
        readings.lower_precision(cell.config)[1])
    assert calls >= cell.traffic["check"]["calls"]
    assert any(numbers[k] > v["limit"] for k, v in cell.limits.items()), numbers
