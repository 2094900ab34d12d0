"""Tests of the benchmark harness. They run on the CPU; those marked
``cuda`` need the card and skip without one (run them on the chip with
``python -m pytest benchmark/tests -m cuda``)."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda:0"


def tiny_cell(workload, nalt=11, nstr=4, num_wavelengths=16, rays=2):
    """A cell small enough for the CPU: fewer levels, streams, rays and
    wavelengths, float64 (the port on the CPU computes in float64), with
    its traffic's own check settings. ``workload`` is a cell of the
    manifest, or ``<config>.<traffic>`` of files that no cell uses (no
    limits then)."""
    import core

    manifest = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if workload in {w["name"] for w in manifest["workloads"]}:
        cell = copy.deepcopy(core.resolve(manifest, workload))
    else:
        config, traffic = workload.split(".")
        cell = core.Cell(workload, {"config": config, "traffic": traffic,
                                    "chips": 1},
                         core.load_json(core.find("configs", config)),
                         core.load_json(core.find("traffic", traffic)),
                         {}, [], [])
    c = cell.config
    c["geometry"]["num_altitudes"] = nalt
    c["solver"].update(num_streams=nstr, num_singlescatter_moments=nstr,
                       dtype="float64")
    step = max(1, len(c["rays"]) // rays)
    c["rays"] = c["rays"][::step][:rays]
    cell.traffic["wavelengths_nm"]["num"] = num_wavelengths
    cell.traffic["warmup_calls"] = 0
    return cell
