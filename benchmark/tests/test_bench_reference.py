"""The plain reference computes what the port computes: both on the CPU
in float64 at a tiny size, the port through its public API with
``device="cpu"``.

The port traces limb rays with its native C++ tracer where it can build
it; the reference freezes the numpy tracer, equal to the port's to the
last bit. The two tracers differ by up to about 1e-7 relative in the
weights of the segment at a tangent point, so limb cells are held to
1e-6; the plane-parallel cell, which traces nothing, to 1e-9."""

import numpy as np
import pytest

import scene
import system
from conftest import tiny_cell
from reference.plain import model


@pytest.mark.parametrize("workload", ["ground16.wf", "limb16.wf", "limb16.rad",
                                      "ground16_f64.wf"])
def test_reference_agrees_with_the_port(workload):
    import sasktran2_tpu_torch as sk

    cell = tiny_cell(workload, rays=3, num_wavelengths=4)
    jac = cell.traffic["jacobians"]
    state = scene.make_state(cell.config, cell.traffic, 2024)
    engine, cfg, geometry = system.build_engine(sk, cell.config, "cpu")
    atmo = system.build_atmosphere(sk, cfg, geometry, state, jac)
    vmr, albedo = scene.call_inputs(state, cell.traffic, 2024, 5)
    system.set_call_inputs(atmo, vmr, albedo)
    W = len(state.wavelengths_nm)
    got = system.pick(engine.calculate_radiance(atmo), np.arange(W))
    ref = model.reference(cell.config,
                          scene.lanes(state, [(w, vmr, albedo) for w in range(W)]),
                          jacobians=jac)
    assert set(got) == set(ref) == ({"radiance", *model.WF_NAMES} if jac
                                    else {"radiance"})
    for name, r in ref.items():
        assert got[name].shape == r.shape, name
        scale = np.abs(r) if name == "radiance" else np.abs(r).max()
        tol = 1e-9 if workload.startswith("ground") else 1e-6
        assert np.max(np.abs(got[name] - r) / scale) < tol, name
