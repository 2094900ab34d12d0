"""A run whose timed path is broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (set-up,
window, check against the reference) on the CPU at a tiny size, with the
cell's own limits and check settings, the port's
``Engine.calculate_radiance`` wrapped to plant one fault: a call that
returns the previous call's answers (state left unchanged), half of the
wavelengths left out, a radiance altered where it is produced, or, where
the cell asks for weighting functions, the Jacobian row of one line of
sight zeroed. The same run without a fault is correct."""

import time

import numpy as np
import pytest

import core
from conftest import ROOT, tiny_cell

MANIFEST = core.load_json(core.os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _faulty(kind, limit):
    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch.dataset import DataArray

    real = sk.Engine.calculate_radiance
    last = {}

    def call(self, atmosphere, mesh=None):
        out = real(self, atmosphere, mesh)
        if kind == "stale":
            prev = last.get("out")
            last["out"] = out
            return out if prev is None else prev
        for name in list(out.keys()):
            if name != "radiance" and not name.startswith("wf_"):
                continue
            da = out[name]
            vals = da.to_numpy().copy()
            ax = da.dims.index("wavelength")
            if kind == "half":
                W = vals.shape[ax]
                idx = [slice(None)] * vals.ndim
                idx[ax] = slice(W // 2, None)
                vals[tuple(idx)] = 0.0
            elif kind == "altered" and name == "radiance":
                vals = vals * (1.0 + 10.0 * limit)
            elif kind == "row" and name.startswith("wf_"):
                vals[..., 0, :] = 0.0            # the first line of sight
            out[name] = DataArray(vals, da.dims)
        return out

    return call


def _faults(workload):
    jac = core.resolve(MANIFEST, workload).traffic["jacobians"]
    return [None, "stale", "half", "altered"] + (["row"] if jac else [])


@pytest.mark.parametrize(("workload", "fault"),
                         [(w, f) for w in CELLS for f in _faults(w)])
def test_fault_makes_the_run_not_correct(monkeypatch, workload, fault):
    import sasktran2_tpu_torch as sk

    cell = tiny_cell(workload)
    if fault is not None:
        monkeypatch.setattr(sk.Engine, "calculate_radiance",
                            _faulty(fault, cell.limits["radiance_max"]["limit"]))
    result, rec, lines = core.run_cell(cell, 2**31 + 77, 3.5, False, "cpu",
                                       time.perf_counter())
    assert result["attempted"] >= cell.traffic["check"]["calls"]
    assert result["failed"] == 0
    assert result["correct"] is (fault is None), lines
    assert all(np.isfinite(v) for _, v, _ in lines)
