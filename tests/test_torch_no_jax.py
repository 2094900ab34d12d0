"""The port imports nothing of jax or of the JAX package ``sasktran2_tpu``.

In a fresh interpreter: import ``sasktran2_tpu_torch``, build a US76 +
Rayleigh + Lambertian atmosphere with the port's constituents, run a tiny
spherical engine with a ground-viewing and a limb ray, exact single
scatter and DO multiple scatter on the CPU (scalar; polarized, which runs
the vector solver and the vector limb source; scalar with flux observers;
over a MODIS BRDF, ground-viewing only; thermal infrared with DO
emission, an absorber and flux observers; or all of polarized, thermal,
BRDF and flux observers, which takes the generic per-wavelength route),
and check that neither ``jax`` nor any ``sasktran2_tpu`` module is in
``sys.modules`` and that the host ray tracer was built inside
the port. A static pass parses every module of the port, and
``chip_smoke.py``, for such imports. With no GPU, an engine that names no
device raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import sasktran2_tpu_torch as skt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch import native

    case = sys.argv[1]
    # "generic": polarized, thermal, a BRDF, a limb ray and a flux observer,
    # the configuration of the generic per-wavelength route
    nstokes = 3 if case in ("polarized", "generic") else 1
    thermal = case in ("thermal", "generic")
    brdf = case in ("brdf", "generic")
    config = sk.Config(
        num_streams=4,
        num_stokes=nstokes,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=(sk.SingleScatterSource.DiscreteOrdinates
                               if thermal else sk.SingleScatterSource.Exact),
        emission_source=(sk.EmissionSource.DiscreteOrdinates if thermal
                         else sk.EmissionSource.NoSource),
    )
    geometry = sk.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 6),
        geometry_type=sk.GeometryType.Spherical,
    )
    viewing = sk.ViewingGeometry()
    viewing.add_ray(sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    if case != "brdf":
        viewing.add_ray(sk.TangentAltitudeSolar(30000.0, 0.3, 200000.0, 0.6))
    if case in ("flux", "thermal", "generic"):
        viewing.add_flux_observer(sk.FluxObserverSolar(0.6, 10000.0))
    wl = [4500.0, 9000.0] if thermal else [350.0, 600.0]
    atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wl)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    if brdf:
        atmo["surface"] = sk.constituent.MODIS(0.25, 0.15, 0.05)
    if thermal:
        atmo["absorber"] = sk.constituent.VMRAltitudeAbsorber(
            sk.optical.TabulatedCrossSectionAbsorber(
                [4000.0, 15000.0], [1e-26, 1e-25]),
            [0.0, 100000.0], [4e-4, 4e-4])
        atmo["thermal"] = sk.constituent.ThermalEmission()
        atmo["surface_emission"] = sk.constituent.SurfaceThermalEmission(288.0)
    engine = sk.Engine(config, geometry, viewing, device="cpu")
    out = engine.calculate_radiance(atmo)
    rad = out["radiance"].to_numpy()
    nlos = 1 if case == "brdf" else 2
    assert rad.shape == (2, nlos, nstokes) and np.all(rad[..., 0] > 0), rad
    assert "wf_rayleigh_pressure_pa" in out
    if case in ("flux", "thermal", "generic"):
        assert "wf_rayleigh_pressure_pa_downwelling_flux" in out
    if brdf:
        assert "wf_surface_volumetric" in out
    if thermal:
        assert "wf_thermal_temperature_k_upwelling_flux" in out
    lib = native.get_native_lib()
    if lib is not None:
        built = os.path.realpath(lib._name)
        port = os.path.realpath(os.path.dirname(sk.__file__))
        assert built.startswith(port + os.sep), built
    print(engine.ray_tracer)
    print(sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.")
        or m == "sasktran2_tpu" or m.startswith("sasktran2_tpu.")
    ))
""")


@pytest.mark.parametrize("case", ["scalar", "polarized", "flux", "brdf",
                                  "thermal", "generic"])
def test_port_never_imports_jax(case):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, case], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    tracer, imported = proc.stdout.strip().splitlines()[-2:]
    assert tracer in ("native C++", "numpy")
    assert imported == "[]"


def _port_sources():
    pkg = os.path.join(REPO, "sasktran2_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "sasktran2_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    return bad


def test_port_sources_import_neither_jax_nor_reference():
    sources = list(_port_sources())
    assert len(sources) > 30
    bad = [b for path in sources for b in _forbidden_imports(path)]
    assert bad == []


def test_engine_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = skt.Config(
        num_streams=4,
        multiple_scatter_source=skt.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=skt.SingleScatterSource.DiscreteOrdinates,
    )
    geometry = skt.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 6),
        geometry_type=skt.GeometryType.PlaneParallel,
    )
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        skt.Engine(config, geometry, viewing)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    assert engine._device == torch.device("cpu")
