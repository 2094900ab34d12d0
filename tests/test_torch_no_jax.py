"""The port imports nothing of jax or of the JAX package ``sasktran2_tpu``.

In a fresh interpreter: import ``sasktran2_tpu_torch``, build a US76 +
Rayleigh + Lambertian atmosphere with the port's constituents, run a tiny
spherical engine with a ground-viewing and a limb ray, exact single
scatter and DO multiple scatter on the CPU (scalar; polarized, which runs
the vector solver and the vector limb source; scalar with flux observers;
over a MODIS BRDF, ground-viewing only; thermal infrared with DO
emission, an absorber and flux observers; or all of polarized, thermal,
BRDF and flux observers, which takes the generic per-wavelength route;
or successive orders; or EngineIntegratedLineShape over a line-by-line
absorber and an aerosol from a Mie table generated on the CPU; or a small
O2 A-band dayglow limb scan from a ``LimbVertical`` container, with a
HITRAN line file and Yankovsky airglow; or a small 2D tomographic limb
scan, traced by ``rt/raytrace2d.py``, its wavelengths split over two CPU
blocks by ``mesh=``; or an absorber whose table ``database.web``'s
``StandardDatabase`` fetched from a ``file://`` tree; or ``test_util``'s
finite-difference check of a WF and ``zawada``'s file lookup, which must
not import ``h5py`` either), and check that neither ``jax``
nor any ``sasktran2_tpu`` module, nor ``pandas``, is in ``sys.modules``
and that the host ray tracer was built inside the port. A static pass
parses every module of the port, and ``chip_smoke.py``, for such imports,
and for ``pandas`` imported outside a function. With no GPU, an engine that names no
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
from tests.torch_support import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch import native

    case = sys.argv[1]
    if case == "web":
        # database.web: StandardDatabase over a file:// tree in a temporary
        # directory, its table an absorber of a small engine
        import tempfile
        from pathlib import Path
        from sasktran2_tpu_torch import scenarios as sc
        from sasktran2_tpu_torch.optical.database import (
            OpticalDatabaseGenericAbsorber)
        tmp = Path(tempfile.mkdtemp())
        table = sc.web_cross_section()
        dims, xs = table["data_vars"]["xs"]
        served = tmp / "tree" / "v_latest" / sc.WEB_KEY
        served.parent.mkdir(parents=True)
        np.savez(served, coord_wavelength_nm=table["coords"]["wavelength_nm"],
                 xs=xs, dims_xs=np.array(dims))
        db = sk.database.StandardDatabase(base_url=(tmp / "tree").as_uri(),
                                          db_root=tmp / "db")
        ds = db.load_ds(sc.WEB_KEY)
        assert (tmp / "db" / sc.WEB_KEY).exists()
        config = sk.Config(
            num_streams=4,
            multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
            single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates)
        geometry = sk.Geometry1D(
            cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
            altitude_grid_m=np.linspace(0.0, 100000.0, 6),
            geometry_type=sk.GeometryType.PlaneParallel)
        viewing = sk.ViewingGeometry()
        viewing.add_ray(sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
        atmo = sk.Atmosphere(geometry, config, wavelengths_nm=[350.0, 600.0])
        sk.climatology.us76.add_us76_standard_atmosphere(atmo)
        atmo["rayleigh"] = sk.constituent.Rayleigh()
        atmo["surface"] = sk.constituent.LambertianSurface(0.3)
        alts = geometry.altitudes()
        atmo["web"] = sk.constituent.VMRAltitudeAbsorber(
            OpticalDatabaseGenericAbsorber(db=ds), alts, sc.web_vmr(alts))
        engine = sk.Engine(config, geometry, viewing, device="cpu")
        out = engine.calculate_radiance(atmo)
        rad = out["radiance"].to_numpy()
        assert rad.shape == (2, 1, 1) and np.all(rad > 0), rad
        assert "wf_web" in out
        print(engine.ray_tracer)
        print(sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "sasktran2_tpu", "pandas")
        ))
        sys.exit(0)
    if case == "test_util":
        # test_util: the FD check of a WF at 16 streams on 5 levels, and
        # zawada's file lookup under an empty database root
        import tempfile
        from sasktran2_tpu_torch import scenarios as sc
        from sasktran2_tpu_torch.test_util import wf, zawada
        os.environ["SASKTRAN2_TPU_TORCH_DB_ROOT"] = tempfile.mkdtemp()
        config, geometry, viewing, atmo = sc.fd16_case(sk, num_altitudes=5)
        engine = sk.Engine(config, geometry, viewing, device="cpu")
        ds = wf.numeric_wf(atmo.storage.ssa[:, 0], sc.FD_FRACTIONAL_CHANGE,
                           engine, atmo, "wf_ssa")
        wf.validate_wf(ds["wf_ssa"], ds["wf_ssa_numeric"],
                       wf_dim="altitude", decimal=5)
        assert np.all(ds["wf_ssa_numeric"].to_numpy() != 0)
        assert zawada.comparison_file() is None
        assert sk.test_util.test_aerosol_constituent([22000.0])[0] == 1e-7
        print(engine.ray_tracer)
        print(sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "sasktran2_tpu", "pandas", "h5py")
        ))
        sys.exit(0)
    if case == "2d_mesh":
        from sasktran2_tpu_torch import scenarios
        from sasktran2_tpu_torch.parallel import make_mesh
        config, geometry, viewing, atmo = scenarios.tomo2d_case(
            sk, "float64", [350.0, 600.0], num_altitudes=11,
            angles_deg=np.linspace(-20.0, 20.0, 5))
        engine = sk.Engine(config, geometry, viewing, device="cpu")
        out = engine.calculate_radiance(
            atmo, mesh=make_mesh(devices=["cpu", "cpu"]))
        rad = out["radiance"].to_numpy()
        assert rad.shape == (2, 40, 1) and np.all(rad > 0), rad
        assert "wf_ozone" in out and "los_optical_depth" in out
        print(engine.ray_tracer)
        print(sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "sasktran2_tpu", "pandas")
        ))
        sys.exit(0)
    if case == "airglow":
        # a small O2 A-band dayglow limb scan from a LimbVertical container,
        # its O2 lines read by HITRANLineDatabase from a file written under
        # a temporary database root, the airglow from Yankovsky populations
        import tempfile
        from sasktran2_tpu_torch import scenarios as sc
        root = tempfile.mkdtemp()
        os.environ["SASKTRAN2_TPU_TORCH_DB_ROOT"] = root
        sc.write_dayglow_par(root)
        container = sk.LimbVertical.from_tangent_parameters(
            sk.solar.SolarGeometryHandlerForced(60.0, 30.0),
            np.array([65000.0, 80000.0, 95000.0]), 20.0, 40.0, None,
            600000.0, 90.0, reference_altitude=80000.0)
        geometry = container.model_geometry(np.linspace(0.0, 100000.0, 11))
        config = sk.Config(
            num_streams=4,
            multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
            single_scatter_source=sk.SingleScatterSource.Exact,
            emission_source=sk.EmissionSource.VolumeEmissionRate,
            num_do_sza=2,
        )
        wvn = sc.DAYGLOW_WAVENUMBERS[[145, 1859]]
        atmo = sk.Atmosphere(geometry, config, wavenumbers_cminv=wvn)
        sk.climatology.us76.add_us76_standard_atmosphere(atmo)
        atmo["rayleigh"] = sk.constituent.Rayleigh()
        atmo["surface"] = sk.constituent.LambertianSurface(0.3)
        cat = sk.database.HITRANLineDatabase().load_catalogue("O2")
        alts = geometry.altitudes()
        atmo["o2"] = sk.constituent.VMRAltitudeAbsorber(
            sk.optical.LineAbsorber(cat, device="cpu"), alts,
            np.full(alts.size, 0.2095))
        p, t = sk.climatology.us76.us76_pressure_temperature(alts)
        pops = sc.dayglow_populations(sk, alts, t, p)
        band = sk.photchem.emission.oxygen_a_band_from_catalogue(cat)
        ver, w = sk.photchem.emission.\
            oxygen_a_band_line_list_weights_from_populations(
                band, t, pops[0], pops[1], pops[2])
        atmo["airglow"] = sk.constituent.LineListVolumeEmissionRate(
            alts, ver, band.wavelength_nm, w, device="cpu")
        out = sk.Engine(config, geometry, container,
                        device="cpu").calculate_radiance(atmo)
        rad = out["radiance"].to_numpy()
        assert rad.shape == (2, 3, 1) and np.all(rad > 0), rad
        assert "wf_airglow_photon_ver" in out and "tangent_altitude" in out
        print(sk.Engine(config, geometry, container,
                        device="cpu").ray_tracer)
        print(sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "sasktran2_tpu", "pandas")
        ))
        sys.exit(0)
    # "generic": polarized, thermal, a BRDF, a limb ray and a flux observer,
    # the configuration of the generic per-wavelength route
    # "so": successive orders (a 4 x 4 direction grid, 4 iterations)
    # "optical": EngineIntegratedLineShape over a line-by-line absorber
    # and a Mie aerosol from a table generated into a temporary directory
    optical = case == "optical"
    nstokes = 3 if case in ("polarized", "generic") else 1
    thermal = case in ("thermal", "generic")
    brdf = case in ("brdf", "generic")
    so = case == "so"
    config = sk.Config(
        num_streams=4,
        num_stokes=nstokes,
        multiple_scatter_source=(
            sk.MultipleScatterSource.SuccessiveOrders if so
            else sk.MultipleScatterSource.DiscreteOrdinates),
        num_successive_orders_incoming=16,
        num_successive_orders_iterations=4,
        single_scatter_source=(sk.SingleScatterSource.DiscreteOrdinates
                               if thermal else sk.SingleScatterSource.Exact),
        emission_source=(sk.EmissionSource.DiscreteOrdinates if thermal
                         else sk.EmissionSource.NoSource),
        spectral_grid_mode=(sk.SpectralGridMode.EngineIntegratedLineShape
                            if optical else sk.SpectralGridMode.Monochromatic),
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
    if optical:
        wvn = 13000.0 + 0.2 * np.arange(20)
        atmo = sk.Atmosphere(
            geometry, config, wavenumbers_cminv=wvn,
            spectral_grid=sk.basis.Grid.from_triangles([13001.5, 13002.5],
                                                       0.6))
    else:
        atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wl)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    if brdf:
        atmo["surface"] = sk.constituent.MODIS(0.25, 0.15, 0.05)
    if optical:
        import tempfile
        cat = sk.optical.LineCatalogue(
            nu0=np.array([13001.0, 13002.7]),
            intensity=np.array([1e-24, 5e-25]),
            gamma_air=np.array([0.04, 0.05]),
            gamma_self=np.array([0.045, 0.055]),
            n_air=np.array([0.7, 0.7]), delta_air=np.array([-0.01, -0.01]),
            elower=np.array([10.0, 100.0]), molar_mass=31.98983e-3)
        atmo["o2"] = sk.constituent.VMRAltitudeAbsorber(
            sk.optical.LineAbsorber(cat, device="cpu"),
            [0.0, 100000.0], [0.2095, 0.2095])
        with tempfile.TemporaryDirectory() as root:
            table = sk.database.MieDatabase(
                sk.mie.LogNormalDistribution(),
                sk.mie.RefractiveIndex(lambda w: 1.44 + 1e-7j, "sulfate"),
                [760.0, 775.0], db_root=root, max_legendre_moments=8,
                num_size_quadrature=32, num_angles=31,
                median_radius=[100.0, 140.0], mode_width=[1.5, 1.7],
                device="cpu")
            atmo["aerosol"] = sk.constituent.ExtinctionScatterer(
                table, [0.0, 100000.0], [1e-5, 1e-9], 765.0,
                param_values={"median_radius": [120.0, 120.0],
                              "mode_width": [1.6, 1.6]})
            atmo.internal_object()
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
        if m.split(".")[0] in ("jax", "sasktran2_tpu", "pandas")
    ))
""")


@pytest.mark.parametrize("case", ["scalar", "polarized", "flux", "brdf",
                                  "thermal", "generic", "so", "optical",
                                  "airglow", "2d_mesh", "web", "test_util"])
def test_port_never_imports_jax(case):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, case], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    tracer, imported = proc.stdout.strip().splitlines()[-2:]
    assert tracer in ("native C++", "numpy", "numpy 2D")
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


def _import_time_pandas(path):
    """``import pandas`` statements that run when the module is imported:
    those outside every function body."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(node) if n is not node)
    bad = []
    for node in ast.walk(tree):
        if id(node) in inside:
            continue
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] == "pandas" for n in names):
            bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    return bad


def test_port_imports_pandas_only_inside_functions():
    """The card's machine has no pandas: ``solar.to_mjd`` imports it when
    called, and no module of the port imports it at import time."""
    bad = [b for path in _port_sources() for b in _import_time_pandas(path)]
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
