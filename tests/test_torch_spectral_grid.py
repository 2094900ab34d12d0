"""The integrated-line-shape spectral grid modes of the port against the
JAX package's, in float64 on the CPU.

* The spectral basis module (``Grid`` constructors, ``mapping_matrix``
  for Delta, Rectangle, Triangle and Gaussian bases) is pinned bit-equal.
* ``AtmosphereIntegratedLineShape`` (the fine-grid storage reduced onto
  the output basis, with the quotient-rule chain of every derivative
  mapping) and ``EngineIntegratedLineShape`` (the engine on the fine grid,
  every wavelength-dimensioned output mapped with the [Wo, Wf] matrix) at
  engine level against the JAX engine: radiance, the LOS optical depth
  and every ``wf_*`` to 1e-10 of each variable's largest magnitude, and
  the output wavelength coordinate equal. The fine grid is given in
  wavelengths and in wavenumbers (60 points, 0.1 cm^-1 apart), the
  atmosphere is US76 + Rayleigh + a line-by-line O2 absorber of 36
  synthetic lines (the port's ``LineAbsorber`` on the CPU) + a
  Henyey-Greenstein aerosol + Lambertian 0.3, on 6 altitudes.
* The port's EngineIntegratedLineShape outputs equal the mapping matrix
  applied to its Monochromatic outputs on the same fine grid, as
  ``tests/test_spectral_grid_mode.py:78-120`` checks for the JAX package.
* What the port refuses: a viewing geometry or a ``mesh=`` that is not
  the port's own (``TypeError``); an atmosphere on a geometry with a
  horizontal axis that is not a ``Geometry2D`` is a 1D one.

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_spectral_grid.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu import basis as basis_ref
from sasktran2_tpu_torch import basis
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 30000.0, 6)
WAVENUMBERS = 13000.0 + 0.1 * np.arange(60)
OUT_WAVENUMBERS = np.array([13001.5, 13002.5, 13003.5, 13004.5])


def _catalogue(pkg):
    rng = np.random.default_rng(41)
    n = 36
    ga = rng.uniform(0.03, 0.055, n)
    return pkg.optical.LineCatalogue(
        nu0=np.sort(rng.uniform(12995.0, 13011.0, n)),
        intensity=10 ** rng.uniform(-26.0, -23.0, n),
        gamma_air=ga, gamma_self=ga + 0.005,
        n_air=rng.uniform(0.6, 0.8, n),
        delta_air=rng.uniform(-0.012, -0.005, n),
        elower=rng.uniform(0.0, 2000.0, n), molar_mass=31.98983e-3,
    )


def _grids(pkg, coordinate):
    """(fine-grid keyword, output basis) in the given coordinate."""
    if coordinate == "wavenumber":
        return ({"wavenumbers_cminv": WAVENUMBERS},
                pkg.basis.Grid.from_gaussians(OUT_WAVENUMBERS, 1.0))
    wl = np.sort(1e7 / WAVENUMBERS)
    centers = np.sort(1e7 / OUT_WAVENUMBERS)
    return ({"wavelengths_nm": wl},
            pkg.basis.Grid.from_gaussians(centers, 0.0059))


def _case(pkg, mode, coordinate, output_basis=True):
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=8,
        output_los_optical_depth=True,
        spectral_grid_mode=getattr(pkg.SpectralGridMode, mode),
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=pkg.GeometryType.PlaneParallel,
    )
    viewing = pkg.ViewingGeometry()
    for mu in (0.5, 0.9):
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.5, mu, 200000.0))
    fine, out_grid = _grids(pkg, coordinate)
    if output_basis:
        fine["spectral_grid"] = out_grid
    atmo = pkg.Atmosphere(geometry, config, **fine)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    device_kw = {"device": "cpu"} if pkg is skt else {}
    atmo["o2"] = pkg.constituent.VMRAltitudeAbsorber(
        pkg.optical.LineAbsorber(_catalogue(pkg), **device_kw),
        ALTITUDES, np.full(len(ALTITUDES), 0.2095))
    atmo["aerosol"] = pkg.constituent.NumberDensityScatterer(
        pkg.constituent.HGScatteringOptical(1e-13, 0.97, 0.6, nleg=8),
        ALTITUDES, 5e7 * np.exp(-ALTITUDES / 2000.0))
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("coordinate", ["wavelength", "wavenumber"])
@pytest.mark.parametrize("mode", ["AtmosphereIntegratedLineShape",
                                  "EngineIntegratedLineShape"])
def test_integrated_line_shape_matches_jax(mode, coordinate):
    case = _case(sk, mode, coordinate)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    config, geometry, viewing, atmo = _case(skt, mode, coordinate)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert got["radiance"].to_numpy().shape[0] == len(OUT_WAVENUMBERS)
    torch_support.assert_outputs_match(got, ref)
    assert len([k for k in ref.keys() if k.startswith("wf_")]) >= 4
    np.testing.assert_array_equal(got.coords["wavelength"],
                                  ref.coords["wavelength"])
    if mode == "AtmosphereIntegratedLineShape":
        # a second call rebuilds the storage at the fine size
        again = engine.calculate_radiance(atmo)
        torch_support.assert_outputs_match(again, ref)


@pytest.mark.parametrize("coordinate", ["wavelength", "wavenumber"])
def test_engine_line_shape_is_mapped_monochromatic(coordinate):
    """The port's EngineIntegratedLineShape outputs are M applied to its
    Monochromatic outputs on the fine grid."""
    outs = {}
    for mode in ("Monochromatic", "EngineIntegratedLineShape"):
        config, geometry, viewing, atmo = _case(
            skt, mode, coordinate, output_basis=mode != "Monochromatic")
        outs[mode] = skt.Engine(config, geometry, viewing, device="cpu")\
            .calculate_radiance(atmo)
    fine, out_grid = _grids(skt, coordinate)
    coord = next(iter(fine.values()))
    M = basis.mapping_matrix(basis.Grid.from_deltas(coord), out_grid)
    mono, mapped = outs["Monochromatic"], outs["EngineIntegratedLineShape"]
    assert set(mono.keys()) == set(mapped.keys())
    for key in mono.keys():
        da = mono[key]
        ax = da.dims.index("wavelength")
        want = np.moveaxis(np.tensordot(
            M, np.moveaxis(da.to_numpy(), ax, 0), axes=1), 0, ax)
        got = mapped[key].to_numpy()
        assert torch_support.rel_err(got, want) <= 1e-10, key
    expect = (out_grid.centers if coordinate == "wavelength"
              else 1e7 / out_grid.centers)
    np.testing.assert_array_equal(mapped.coords["wavelength"], expect)


def test_basis_equal():
    """The ``Grid`` constructors and ``mapping_matrix`` for every basis
    type (Delta rows interpolate, the others integrate by quadrature)."""
    src = np.linspace(499.0, 501.0, 81)
    centers = np.array([499.4, 500.0, 500.7])
    for ctor, width in (("from_deltas", None), ("from_rectangles", 0.3),
                        ("from_triangles", 0.4), ("from_gaussians", 0.25)):
        args = (centers,) if width is None else (centers, width)
        got = getattr(basis.Grid, ctor)(*args)
        ref = getattr(basis_ref.Grid, ctor)(*args)
        np.testing.assert_array_equal(got.centers, ref.centers)
        assert len(got) == len(ref)
        for a, b in zip(got.bases, ref.bases):
            assert type(a).__name__ == type(b).__name__
            assert vars(a) == vars(b)
        np.testing.assert_array_equal(
            basis.mapping_matrix(basis.Grid.from_deltas(src), got),
            basis_ref.mapping_matrix(basis_ref.Grid.from_deltas(src), ref))
    x = np.linspace(499.0, 501.0, 33)
    for cls, args in (("Rectangle", (500.0, 0.5)), ("Triangle", (500.0, 0.4,
                                                                  0.6)),
                      ("Gaussian", (500.0, 0.3))):
        np.testing.assert_array_equal(
            getattr(basis, cls)(*args).evaluate(x),
            getattr(basis_ref, cls)(*args).evaluate(x))


class _Geometry2D(skt.Geometry1D):
    """A 1D geometry with a horizontal axis, as a 2D geometry has."""

    num_horizontal = 3


class _RayList:
    """A viewing geometry that is not the port's ``ViewingGeometry``."""

    def __init__(self, rays):
        self.observer_rays = rays


def test_remaining_refusals():
    config, geometry, viewing, atmo = _case(skt, "Monochromatic",
                                            "wavenumber", output_basis=False)
    # the storage's rows follow the JAX package's test: Geometry2D or not
    fake = _Geometry2D(0.6, 0.0, 6372000.0, geometry.altitudes())
    rows = skt.Atmosphere(fake, config, wavelengths_nm=[500.0]).storage
    assert rows.total_extinction.shape[0] == geometry.num_altitudes
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    with pytest.raises(TypeError, match="sasktran2_tpu_torch.parallel.Mesh"):
        engine.calculate_radiance(atmo, mesh=object())
    with pytest.raises(TypeError, match="sasktran2_tpu_torch.ViewingGeometry"):
        skt.Engine(config, geometry, _RayList(viewing.observer_rays),
                   device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ddiff2_gradient_finite_at_a_repeated_node(dtype):
    """``ops.linalg.ddiff2`` at a == c exactly with all three nodes
    clustered (an eigenvalue equal to the beam's decay rate, a user
    direction at the solar zenith angle): the value is the series and
    its gradient is finite, in float32 as in float64, and equals the
    gradient at nodes 1e-3 apart to 1e-2."""
    from sasktran2_tpu_torch.ops.linalg import ddiff2

    def grads(a0, b0, c0):
        a, b, c = (torch.tensor([v], dtype=dtype, requires_grad=True)
                   for v in (a0, b0, c0))
        val = ddiff2(a, b, c, torch.tensor([0.004], dtype=dtype))
        return val, torch.autograd.grad(val.sum(), (a, b, c))

    val, g = grads(1.6666666, 1.6666666, 1.6666666)
    assert torch.isfinite(val).all() and all(torch.isfinite(x).all()
                                             for x in g)
    _, g_near = grads(1.6656666, 1.6666666, 1.6676666)
    for x, y in zip(g, g_near):
        assert abs(float(x) - float(y)) <= 1e-2 * abs(float(y))
