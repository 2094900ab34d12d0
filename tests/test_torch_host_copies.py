"""The port's copies of the JAX package's host modules, pinned bit-equal to
the originals: the ray tracer (native and numpy) and its solar-table mode,
the single-scatter phase tables (with the polarized d^l_02 tables), the
DO ray-source angular tables (scalar and polarized), the polarized
solver's Pi matrices and per-greek mode tables, the engine's Stokes-basis
rotations and flux-observer interpolation, the stream quadrature and
associated Legendre tables, ``Config``, the US76 + Rayleigh + Lambertian
atmosphere, the BRDF, thermal and volume-emission constituents, the
VMR absorber with its tabulated cross sections and the Planck function,
and ``params.atmosphere_from_reference`` (a BRDF surface included).
The geometries are the 16-stream slice's (cut to 20 altitudes), both cases
of ``tests/test_torch_engine.py`` and a spherical limb scan with a
ground-viewing ray; each side builds its objects with its own package from
the same numpy inputs."""

import dataclasses

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu import config as config_ref
from sasktran2_tpu.ops import quadrature as quadrature_ref
from sasktran2_tpu.ops import wigner as wigner_ref
from sasktran2_tpu.rt import disco_vec as disco_vec_ref
from sasktran2_tpu.rt import disco_vec_minor as disco_vec_minor_ref
from sasktran2_tpu.rt import do_source as do_source_ref
from sasktran2_tpu.rt import raytrace as raytrace_ref
from sasktran2_tpu.rt import singlescatter as singlescatter_ref
from sasktran2_tpu_torch import config as config_port
from sasktran2_tpu_torch.ops import quadrature, wigner
from sasktran2_tpu_torch.params import atmosphere_from_reference
from sasktran2_tpu_torch.rt import (
    disco_vec,
    disco_vec_minor,
    do_source,
    raytrace,
    singlescatter,
)
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 100000.0, 20)
WAVELENGTHS = np.array([310.0, 400.0, 550.0])

# name -> (geometry type, cos_sza, rays as (class name, arguments))
GEOMETRIES = {
    "slice_planeparallel": ("PlaneParallel", 0.6, [
        ("GroundViewingSolar", (0.6, 0.5, mu, 200000.0))
        for mu in (0.4, 0.6, 0.8, 1.0)
    ]),
    "engine_planeparallel": ("PlaneParallel", 0.6, [
        ("GroundViewingSolar", (0.6, 0.5, mu, 200000.0)) for mu in (0.5, 0.9)
    ]),
    "engine_pseudospherical": ("PseudoSpherical", 0.6, [
        ("GroundViewingSolar", (0.6, 0.5, 0.7, 200000.0)),
        ("SolarAnglesObserverLocation", (0.4, 1.1, -0.8, 200000.0)),
        ("GroundViewingSolar", (0.4, 2.0, 1.0, 200000.0)),
    ]),
    "limb_spherical": ("Spherical", 0.6, [
        ("TangentAltitudeSolar", (t, 0.4, 200000.0, 0.6))
        for t in (10000.0, 35000.0, 80000.0)
    ] + [("GroundViewingSolar", (0.6, 0.5, 0.8, 200000.0))]),
}
LIMB = "limb_spherical"


def _build(pkg, name):
    geometry_type, cos_sza, rays = GEOMETRIES[name]
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
    )
    geometry = pkg.Geometry1D(
        cos_sza=cos_sza, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )
    ray_objs = [getattr(pkg, cls)(*args) for cls, args in rays]
    return config, geometry, ray_objs


@pytest.fixture(scope="session")
def reference_traces():
    """The JAX package's traced tables of every geometry, numpy and native.
    The native ones must come from the native tracer
    (``use_native="require"``), loaded past any concurrent build of it
    (``torch_support.reference_native_lib``)."""
    torch_support.reference_native_lib()
    out = {}
    for name in GEOMETRIES:
        _, geometry, rays = _build(sk, name)
        for use_native in (False, True):
            out[name, use_native] = raytrace_ref.trace_spherical(
                geometry.altitudes(), geometry.earth_radius_m,
                geometry.cos_sza, rays,
                use_native="require" if use_native else False,
            )
    return out


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_trace_spherical_equal(reference_traces, name, use_native):
    _, geometry, rays = _build(skt, name)
    got = raytrace.trace_spherical(
        geometry.altitudes(), geometry.earth_radius_m, geometry.cos_sza,
        rays, use_native="require" if use_native else False,
    )
    ref = reference_traces[name, use_native]
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(
            getattr(got, field.name), getattr(ref, field.name),
            err_msg=field.name,
        )


def test_solar_table_equal(reference_traces):
    """``apply_solar_table`` (``SingleScatterSource.Table``) recomposes the
    same sun weights, at the default and at a coarse solar-zenith grid."""
    _, geometry, _ = _build(skt, LIMB)
    traced = reference_traces[LIMB, False]
    for kw in ({}, {"n_sza": 7}):
        got = raytrace.apply_solar_table(
            traced, geometry.altitudes(), geometry.earth_radius_m, **kw)
        ref = raytrace_ref.apply_solar_table(
            traced, geometry.altitudes(), geometry.earth_radius_m, **kw)
        for field in dataclasses.fields(ref):
            np.testing.assert_array_equal(
                getattr(got, field.name), getattr(ref, field.name),
                err_msg=field.name,
            )


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ray_source_tables_equal(reference_traces, name):
    """The single-scatter phase tables and the DO ray-source angular
    tables of every geometry."""
    traced = reference_traces[name, False]
    for nleg in (4, 16):
        np.testing.assert_array_equal(
            singlescatter.phase_tables(traced, nleg),
            singlescatter_ref.phase_tables(traced, nleg),
        )
        np.testing.assert_array_equal(
            singlescatter.phase_tables_d02(traced, nleg),
            singlescatter_ref.phase_tables_d02(traced, nleg),
        )
    for build, build_ref in (
        (do_source.build_ray_angular_tables,
         do_source_ref.build_ray_angular_tables),
        (do_source.build_ray_vector_tables,
         do_source_ref.build_ray_vector_tables),
    ):
        got = build(traced, 16, 16)
        ref = build_ref(traced, 16, 16)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize(("nstr", "nleg", "mu0", "num_azimuth"),
                         [(2, 2, 0.6, None), (4, 4, 0.35, None),
                          (16, 16, 0.6, 3), (8, 3, 0.9999, 3)])
def test_vector_tables_equal(nstr, nleg, mu0, num_azimuth):
    """The polarized solver's host tables: ``NS``, ``DSIGN``, the Pi
    matrices and every field of ``build_vector_minor_tables``."""
    user_mu = np.array([0.35, 0.8, 0.55])
    assert disco_vec.NS == disco_vec_ref.NS
    np.testing.assert_array_equal(disco_vec.DSIGN, disco_vec_ref.DSIGN)
    for m in range(3):
        np.testing.assert_array_equal(
            disco_vec._pi_matrices(user_mu, m, nleg),
            disco_vec_ref._pi_matrices(user_mu, m, nleg),
        )
    got = disco_vec_minor.build_vector_minor_tables(
        nstr, nleg, mu0, user_mu, num_azimuth=num_azimuth)
    ref = disco_vec_minor_ref.build_vector_minor_tables(
        nstr, nleg, mu0, user_mu, num_azimuth=num_azimuth)
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(
            getattr(got, field.name), getattr(ref, field.name),
            err_msg=field.name,
        )


@pytest.mark.parametrize(("nstr", "nleg", "mu0", "num_azimuth"),
                         [(2, 2, 0.6, None), (4, 4, 0.35, None),
                          (16, 16, 0.6, 3), (8, 3, 0.9999, 3)])
def test_vector_mode_tables_equal(nstr, nleg, mu0, num_azimuth):
    """Every field of the generic vector solver's
    ``build_vector_mode_tables``."""
    user_mu = np.array([0.35, 0.8, 0.55])
    got = disco_vec.build_vector_mode_tables(
        nstr, nleg, mu0, user_mu, num_azimuth=num_azimuth)
    ref = disco_vec_ref.build_vector_mode_tables(
        nstr, nleg, mu0, user_mu, num_azimuth=num_azimuth)
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(
            getattr(got, field.name), getattr(ref, field.name),
            err_msg=field.name,
        )


@pytest.mark.parametrize("num_stokes", [1, 3])
def test_generic_tables_equal(num_stokes):
    """The generic route's tables of every ground-viewing group, every
    limb group's points of a 2-point solar zenith grid and every flux
    group, scalar and polarized, against the JAX engine's
    ``_build_do_tables`` (``engine.py:487-587``)."""
    engines = {}
    for pkg in (sk, skt):
        _, geometry, rays = _build(pkg, LIMB)
        config = pkg.Config(
            num_streams=4, num_stokes=num_stokes, num_do_sza=2,
            multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
            single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        )
        viewing = pkg.ViewingGeometry()
        for ray in rays:
            viewing.add_ray(ray)
        viewing.add_ray(pkg.SolarAnglesObserverLocation(0.4, 1.1, -0.8, 2e5))
        for cos_sza, alt in ((0.6, 0.0), (0.3, 12345.0)):
            viewing.add_flux_observer(pkg.FluxObserverSolar(cos_sza, alt))
        kw = {"device": "cpu"} if pkg is skt else {}
        engines[pkg] = pkg.Engine(config, geometry, viewing, **kw)
    port, ref = engines[skt], engines[sk]
    do_tables, limb_tables = port._generic_tables
    pairs = list(zip(do_tables, [t for _, t, _, _ in ref._do_groups]))
    assert len(limb_tables) == len(ref._limb_groups) == 1
    pairs += list(zip(limb_tables[0], ref._limb_groups[0][1]))
    pairs += [(t, t_r) for (_, t, _), (_, t_r, _)
              in zip(port._flux_groups, ref._flux_groups)]
    assert len(pairs) == 2 + 2 + 2
    for tables, tables_r in pairs:
        assert type(tables).__name__ == type(tables_r).__name__
        for field in dataclasses.fields(tables_r):
            np.testing.assert_array_equal(
                getattr(tables, field.name), getattr(tables_r, field.name),
                err_msg=field.name,
            )


@pytest.mark.parametrize("basis", ["Standard", "Solar", "Observer"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_stokes_basis_rotations_equal(name, basis):
    """The engine's per-line-of-sight Stokes rotations (C, S) and the
    flux-observer interpolation of a polarized or scalar engine of each
    geometry."""
    engines = {}
    for pkg in (sk, skt):
        _, geometry, rays = _build(pkg, name)
        config = pkg.Config(
            num_streams=4, num_stokes=3,
            multiple_scatter_source=pkg.MultipleScatterSource.NoSource,
            single_scatter_source=pkg.SingleScatterSource.Exact,
            stokes_basis=getattr(pkg.StokesBasis, basis),
        )
        viewing = pkg.ViewingGeometry()
        for ray in rays:
            viewing.add_ray(ray)
        kw = {"device": "cpu"} if pkg is skt else {}
        engines[pkg] = pkg.Engine(config, geometry, viewing, **kw)
    np.testing.assert_array_equal(engines[skt]._stokes_cs,
                                  engines[sk]._stokes_cs)
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(3, len(engines[sk]._rays), 3, 2))
    np.testing.assert_array_equal(engines[skt]._rotate_stokes(arr, 2),
                                  engines[sk]._rotate_stokes(arr, 2))


def test_flux_groups_equal():
    """Flux groups: observers grouped by cos_sza in sorted order, their
    m = 0 tables and the interpolation onto their altitudes."""
    engines = {}
    for pkg in (sk, skt):
        config, geometry, rays = _build(pkg, "engine_pseudospherical")
        viewing = pkg.ViewingGeometry()
        for ray in rays:
            viewing.add_ray(ray)
        for cos_sza, alt in ((0.6, 0.0), (0.3, 12345.0), (0.6, 99000.0),
                             (0.3, 100000.0), (0.6, 37000.0)):
            viewing.add_flux_observer(pkg.FluxObserverSolar(cos_sza, alt))
        kw = {"device": "cpu"} if pkg is skt else {}
        engines[pkg] = pkg.Engine(config, geometry, viewing, **kw)
    got, ref = engines[skt]._flux_groups, engines[sk]._flux_groups
    assert len(got) == len(ref) == 2
    for (idx, tables, interp), (idx_r, tables_r, interp_r) in zip(got, ref):
        np.testing.assert_array_equal(idx, idx_r)
        np.testing.assert_array_equal(interp, interp_r)
        for field in dataclasses.fields(tables_r):
            np.testing.assert_array_equal(
                getattr(tables, field.name), getattr(tables_r, field.name),
                err_msg=field.name,
            )


@pytest.mark.parametrize("refraction", ["los", "solar"])
def test_trace_spherical_refracted_equal(refraction):
    """The refracted numpy path (``rt/refraction.py``) on a non-unit
    refractive index."""
    n = 1.0 + 2.9e-4 * np.exp(-ALTITUDES / 8000.0)
    kw = {"los_refraction": refraction == "los",
          "solar_refraction": refraction == "solar"}
    traced = []
    for pkg, module in ((sk, raytrace_ref), (skt, raytrace)):
        _, geometry, rays = _build(pkg, "engine_pseudospherical")
        traced.append(module.trace_spherical(
            geometry.altitudes(), geometry.earth_radius_m, geometry.cos_sza,
            rays, refractive_index=n, **kw,
        ))
    ref, got = traced
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(
            getattr(got, field.name), getattr(ref, field.name),
            err_msg=field.name,
        )


@pytest.mark.parametrize("nstr", [2, 4, 8, 16, 24])
def test_streams_and_alp_equal(nstr):
    mu, w = quadrature.streams(nstr)
    mu_ref, w_ref = quadrature_ref.streams(nstr)
    np.testing.assert_array_equal(mu, mu_ref)
    np.testing.assert_array_equal(w, w_ref)
    x = np.concatenate([mu, -mu, [0.3, -0.45, 1.0]])
    for m in range(min(nstr, 4)):
        np.testing.assert_array_equal(
            wigner.normalized_alp(x, m, nstr),
            wigner_ref.normalized_alp(x, m, nstr),
        )


def test_config_defaults_and_enums_equal():
    got, ref = config_port.Config(), config_ref.Config()
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if hasattr(b, "value"):
            assert type(a).__name__ == type(b).__name__, field.name
            a, b = a.value, b.value
        elif isinstance(b, tuple):
            a = tuple(getattr(v, "value", v) for v in a)
            b = tuple(getattr(v, "value", v) for v in b)
        assert a == b, field.name
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    enums = [n for n, v in vars(config_ref).items()
             if isinstance(v, type) and issubclass(v, config_ref.enum.Enum)
             and v.__module__ == config_ref.__name__]
    assert len(enums) >= 14
    for name in enums:
        ref_members = {m.name: m.value for m in getattr(config_ref, name)}
        got_members = {m.name: m.value for m in getattr(config_port, name)}
        assert got_members == ref_members, name


def _constituent_atmosphere(pkg, name):
    config, geometry, _ = _build(pkg, name)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface([0.1, 0.3, 0.2])
    return atmo


def _assert_atmospheres_equal(got, ref):
    ref_core, got_core = ref.internal_object(), got.internal_object()
    assert set(got_core) == set(ref_core)
    for k, v in ref_core.items():
        np.testing.assert_array_equal(got_core[k], v, err_msg=k)
    ref_maps = ref.storage.derivative_mappings
    got_maps = got.storage.derivative_mappings
    assert set(got_maps) == set(ref_maps)
    for name, m in ref_maps.items():
        for field in ("d_extinction", "d_ssa", "d_emission", "d_leg_coeff",
                      "scat_factor", "interpolator", "interp_dim",
                      "assign_name", "log_radiance_space"):
            a, b = getattr(got_maps[name], field), getattr(m, field)
            if b is None:
                assert a is None, (name, field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")
    ref_surf = ref.surface.derivative_mappings
    assert set(got.surface.derivative_mappings) == set(ref_surf)
    for name, m in ref_surf.items():
        np.testing.assert_array_equal(
            got.surface.derivative_mappings[name].d_brdf, m.d_brdf
        )


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_constituent_atmosphere_equal(name):
    _assert_atmospheres_equal(
        _constituent_atmosphere(skt, name), _constituent_atmosphere(sk, name)
    )


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_atmosphere_from_reference_round_trip(name):
    """A raw-input reference atmosphere carried into the port gives the
    same core arrays and mappings, and owns its own copies."""
    config, geometry, _ = _build(sk, name)
    rng = np.random.default_rng(11)
    ref = sk.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    ref.storage.total_extinction[:] = rng.uniform(
        1e-6, 1e-4, size=ref.storage.total_extinction.shape)
    ref.storage.ssa[:] = rng.uniform(0.5, 1.0, size=ref.storage.ssa.shape)
    ref.storage.leg_coeff[:] = rng.uniform(
        0.0, 1.0, size=ref.storage.leg_coeff.shape)
    ref.storage.leg_coeff[0] = 1.0
    ref.storage.solar_irradiance[:] = rng.uniform(1.0, 2.0, size=3)
    ref.surface.albedo[:] = rng.uniform(0.0, 1.0, size=3)
    ref.internal_object()  # raw input mode registers its unit mappings
    config_t, geometry_t, _ = _build(skt, name)
    got = atmosphere_from_reference(ref, geometry_t, config_t)
    assert isinstance(got, skt.Atmosphere)
    assert got.model_geometry is geometry_t
    np.testing.assert_array_equal(got.wavelengths_nm, ref.wavelengths_nm)
    _assert_atmospheres_equal(got, ref)
    assert not np.shares_memory(got.storage.ssa, ref.storage.ssa)


# the BRDF and thermal constituents, the absorber and its tabulated cross
# section (``constituent/{brdf,emission,vmr_absorber}.py``,
# ``optical/{base,tabulated}.py``): name -> constituents as (key, class
# path, arguments), built by each package from the same numpy inputs
_XS_WL = np.linspace(250.0, 800.0, 23)
_XS = 1e-24 * (1.0 + np.sin(_XS_WL / 40.0) ** 2)
_XS_T = np.stack([_XS, 1.3 * _XS, 0.7 * _XS])
SURFACE_AND_EMISSION = {
    "modis": [("surface", "constituent.MODIS", (0.25, [0.1, 0.15, 0.2], 0.05))],
    "snow": [("surface", "constituent.SnowKokhanovsky", (2e-6, 1e-7, 5e5))],
    "weighted": [("surface", "constituent.WeightedBRDF", ({
        "snow": ("constituent.SnowKokhanovsky", (), 0.7),
        "soil": ("constituent.MODIS", (0.2, 0.1, 0.05), [0.3, 0.2, 0.25]),
        "lake": ("constituent.LambertianSurface", (0.04,), 0.1),
    },))],
    "thermal": [
        ("thermal", "constituent.ThermalEmission", ()),
        ("surface_emission", "constituent.SurfaceThermalEmission",
         (288.15, 0.98)),
        ("surface", "constituent.LambertianSurface", (0.02,)),
    ],
    "ver_and_absorber": [
        ("ver", "constituent.VolumeEmissionRate",
         (np.linspace(0.0, 100000.0, 7), np.linspace(1e6, 3e6, 7), 400.0)),
        ("absorber", "constituent.VMRAltitudeAbsorber", (
            ("optical.TabulatedCrossSectionAbsorber", (_XS_WL, _XS)),
            np.linspace(0.0, 100000.0, 5), np.linspace(1e-6, 3e-6, 5))),
        ("absorber_t", "constituent.VMRAltitudeAbsorber", (
            ("optical.TabulatedCrossSectionAbsorber",
             (_XS_WL, _XS_T, np.array([200.0, 250.0, 300.0]))),
            np.linspace(0.0, 100000.0, 5), np.full(5, 2e-6))),
    ],
}


def _resolve(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _make(pkg, path, args):
    if path == "constituent.WeightedBRDF":
        (members,) = args
        return _resolve(pkg, path)({
            name: (_resolve(pkg, p)(*a), w) for name, (p, a, w)
            in members.items()})
    args = [_make(pkg, *a) if isinstance(a, tuple) and len(a) == 2
            and isinstance(a[0], str) else a for a in args]
    return _resolve(pkg, path)(*args)


def _surface_emission_atmosphere(pkg, name):
    config, geometry, _ = _build(pkg, "engine_planeparallel")
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    for key, path, args in SURFACE_AND_EMISSION[name]:
        atmo[key] = _make(pkg, path, args)
    return atmo


@pytest.mark.parametrize("name", list(SURFACE_AND_EMISSION))
def test_surface_and_emission_constituents_equal(name):
    """The core arrays (``brdf_args`` and the emission included), every
    derivative mapping, and the BRDF kernel's class (members included)."""
    got = _surface_emission_atmosphere(skt, name)
    ref = _surface_emission_atmosphere(sk, name)
    _assert_atmospheres_equal(got, ref)

    def classes(kernel):
        if kernel is None:
            return None
        return (type(kernel).__name__, kernel.num_args,
                [classes(k) for k in getattr(kernel, "kernels", [])])

    assert classes(got.surface.brdf) == classes(ref.surface.brdf)
    if got.surface.brdf is not None:
        assert type(got.surface.brdf).__module__ == (
            "sasktran2_tpu_torch.rt.brdf")


def test_planck_and_tabulated_cross_sections_equal():
    wl_m = np.linspace(3e-6, 16e-6, 40)[None, :]
    t = np.linspace(180.0, 320.0, 9)[:, None]
    np.testing.assert_array_equal(
        skt.constituent.planck_blackbody_radiance(wl_m, t),
        sk.constituent.planck_blackbody_radiance(wl_m, t))
    kw = {"altitudes_m": np.linspace(0.0, 5e4, 6),
          "temperature_k": np.linspace(290.0, 210.0, 6)}
    for args in ((_XS_WL, _XS), (_XS_WL, _XS_T, np.array([200.0, 250, 300]))):
        np.testing.assert_array_equal(
            skt.optical.TabulatedCrossSectionAbsorber(*args).cross_sections(
                WAVELENGTHS, **kw),
            sk.optical.TabulatedCrossSectionAbsorber(*args).cross_sections(
                WAVELENGTHS, **kw))


@pytest.mark.parametrize("name", ["modis", "weighted"])
def test_atmosphere_from_reference_carries_brdf(name):
    """A BRDF surface carried into the port: the port's kernel of the same
    class, the same arguments (a copy) and surface mappings."""
    ref = _surface_emission_atmosphere(sk, name)
    ref.internal_object()
    config, geometry, _ = _build(skt, "engine_planeparallel")
    got = atmosphere_from_reference(ref, geometry, config)
    assert type(got.surface.brdf).__name__ == type(ref.surface.brdf).__name__
    assert type(got.surface.brdf).__module__ == "sasktran2_tpu_torch.rt.brdf"
    assert not np.shares_memory(got.surface.brdf_args, ref.surface.brdf_args)
    _assert_atmospheres_equal(got, ref)
