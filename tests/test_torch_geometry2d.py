"""The port's 2D geometry (``Geometry2D``, ``TangentAltitude``,
``rt/raytrace2d.py``, the ``*_2d`` functions of ``rt/singlescatter.py``
and the engine's 2D route) against the JAX package's, in float64 on the
CPU.

* Engine level: every 2D configuration of ``tests/test_geometry2d.py``,
  ``test_geometry2d_emission.py`` and ``test_geometry2d_refraction.py``
  (transmission, a horizontal gradient, exact single scatter, Standard
  and VER emission with ``TangentAltitudeSolar`` rays, occultation plus
  emission, a ground-viewing ray's surface emission, line-of-sight
  refraction with n = 1 and with a refractivity profile), with weighting
  functions wherever the extinction is positive, and one mixing exact
  single scatter and emission over a limb, a ground-viewing and a
  downward ``SolarAnglesObserverLocation`` ray: radiance,
  ``los_optical_depth`` and every ``wf_*`` to 1e-10 of each variable's
  largest magnitude, and the analytic values those tests check.
* Function level: the four 2D functions, values and the gradients of a
  seeded linear functional of the output (``torch.autograd`` against
  ``jax.vjp``) to 1e-10, on one trace (equal in both packages) of limb
  rays at two horizontal angles, a ground-viewing ray and a downward ray.
* The refusals: the JAX package's, in its order and with its messages
  (multiple scatter before emission: DO emission validates only with DO
  multiple scatter); a polarized 2D engine, which the JAX package
  accepts and then fails on with an ``AttributeError``, the port refuses
  with ``NotImplementedError``.
* The 2D trace is memoised per process: a float32 and a float64 engine of
  one geometry share it.

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_geometry2d.npz``
(``tests/torch_support.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.ops import wigner as wigner_ref
from sasktran2_tpu.rt import raytrace2d as raytrace2d_ref
from sasktran2_tpu.rt import singlescatter as ss_ref
from sasktran2_tpu_torch.rt import raytrace2d, singlescatter
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

RE = 6372000.0


def _config(pkg, ss=False, occult=False, emission=None, **kw):
    return pkg.Config(
        single_scatter_source=(pkg.SingleScatterSource.Exact if ss
                               else pkg.SingleScatterSource.NoSource),
        multiple_scatter_source=pkg.MultipleScatterSource.NoSource,
        occultation_source=(pkg.OccultationSource.Standard if occult
                            else pkg.OccultationSource.NoSource),
        emission_source=(pkg.EmissionSource.NoSource if emission is None
                         else getattr(pkg.EmissionSource, emission)),
        num_singlescatter_moments=4, num_streams=2,
        output_los_optical_depth=True, **kw,
    )


def _raw(pkg, config, geometry, ext, ssa, emission=None, wavelengths=None,
         derivs=True, leg=None, surface_emission=None):
    """A raw-input atmosphere: the storage set directly, as the JAX
    package's 2D tests set it."""
    atmo = pkg.Atmosphere(
        geometry, config, numwavel=1 if wavelengths is None else None,
        wavelengths_nm=wavelengths, calculate_derivatives=derivs,
    )
    atmo.storage.total_extinction[:] = ext
    atmo.storage.ssa[:] = ssa
    if emission is not None:
        atmo.storage.emission_source[:] = emission
    for l, v in (leg or {0: 1.0}).items():
        atmo.leg_coeff.a1[l] = v
    if surface_emission is not None:
        atmo.surface.emission[:] = surface_emission
    return atmo


def _limb_2d(pkg, alts, angles, cos_sza=0.6, tangents=(15000.0, 30000.0),
             n=None):
    geometry = pkg.Geometry2D(cos_sza, 0.0, RE, alts, angles)
    if n is not None:
        geometry.refractive_index = n
    viewing = pkg.ViewingGeometry()
    for t in tangents:
        viewing.add_ray(pkg.TangentAltitude(t, 2e5, 0.0, 0.0))
    return geometry, viewing


ALTS80 = np.linspace(0.0, 80000.0, 17)
PROF80 = 5e-5 * np.exp(-ALTS80 / 8000.0)
EM_ALTS = np.array([0.0, 10000.0, 30000.0])
EM_ANGLES = np.array([-0.5, 0.0, 0.5])
EM_WAVELENGTHS = np.array([8000.0, 10000.0])
N_PROFILE = 1.0 + 2.8e-4 * np.exp(-ALTS80 / 8000.0)


def _emission_viewing(pkg, tangents=(15000.0,)):
    viewing = pkg.ViewingGeometry()
    for t in tangents:
        viewing.add_ray(pkg.TangentAltitudeSolar(t, 0.0, 100000.0, 0.6))
    return viewing


def _emission_geometry(pkg):
    return pkg.Geometry2D(0.6, 0.0, RE, EM_ALTS, EM_ANGLES)


def case(pkg, name):
    """(config, geometry, viewing, atmosphere) of a 2D configuration."""
    if name in ("transmission", "gradient_field", "single_scatter"):
        # tests/test_geometry2d.py
        ss = name == "single_scatter"
        config = _config(pkg, ss=ss, occult=not ss)
        geometry, viewing = _limb_2d(pkg, ALTS80, np.linspace(-0.5, 0.5, 11))
        field = np.tile(PROF80, 11)
        if name == "gradient_field":
            field = np.concatenate(
                [PROF80 * s for s in np.exp(np.linspace(-1.0, 1.0, 11))])
        leg = {0: 1.0, 2: 0.5} if ss else None
        return config, geometry, viewing, _raw(
            pkg, config, geometry, field[:, None], 0.9 if ss else 0.0,
            leg=leg)
    if name == "single_scatter_1d_grid":
        alts = np.linspace(0.0, 60000.0, 13)
        config = _config(pkg, ss=True)
        geometry, viewing = _limb_2d(pkg, alts, np.linspace(-0.4, 0.4, 9),
                                     cos_sza=0.5, tangents=(20000.0, 30000.0))
        prof = 5e-5 * np.exp(-alts / 8000.0)
        return config, geometry, viewing, _raw(
            pkg, config, geometry, np.tile(prof, 9)[:, None], 0.8,
            leg={0: 1.0, 2: 0.5})
    if name == "ver_constant":
        # tests/test_geometry2d_emission.py (no absorption: no WFs)
        config = _config(pkg, emission="VolumeEmissionRate")
        geometry = _emission_geometry(pkg)
        return config, geometry, _emission_viewing(pkg), _raw(
            pkg, config, geometry, 0.0, 0.0, np.array([2.0e-6, 3.0e-6]),
            EM_WAVELENGTHS, derivs=False)
    if name in ("standard_emission", "occultation_emission"):
        config = _config(pkg, emission="Standard",
                         occult=name == "occultation_emission")
        geometry = _emission_geometry(pkg)
        return config, geometry, _emission_viewing(pkg), _raw(
            pkg, config, geometry, np.array([1.0e-6, 3.0e-6]), 0.0,
            np.array([2.0, 3.0]), EM_WAVELENGTHS)
    if name in ("uniform_standard", "uniform_ver"):
        standard = name == "uniform_standard"
        config = _config(pkg, emission=("Standard" if standard
                                        else "VolumeEmissionRate"))
        geometry = _emission_geometry(pkg)
        ext = np.array([[1.0e-6, 2.0e-6], [2.0e-6, 1.0e-6], [0.5e-6, 0.7e-6]])
        emission = np.array([[1.0, 4.0], [2.0, 3.0], [5.0, 2.0]])
        ssa = (np.array([[0.1, 0.2], [0.3, 0.1], [0.2, 0.4]]) if standard
               else np.zeros_like(ext))
        return config, geometry, _emission_viewing(
            pkg, (12000.0, 22000.0)), _raw(
            pkg, config, geometry, np.tile(ext, (3, 1)), np.tile(ssa, (3, 1)),
            np.tile(emission, (3, 1)), EM_WAVELENGTHS)
    if name == "ground_emission":
        config = _config(pkg, emission="Standard")
        geometry = _emission_geometry(pkg)
        viewing = pkg.ViewingGeometry()
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.0, 0.5, 100000.0))
        return config, geometry, viewing, _raw(
            pkg, config, geometry, 1.0e-6, 0.0, 0.0, EM_WAVELENGTHS,
            surface_emission=np.array([2.0, 3.0]))
    if name in ("refraction_n1", "refraction"):
        # tests/test_geometry2d_refraction.py
        config = _config(pkg, occult=True, los_refraction=True)
        n = np.ones_like(ALTS80) if name == "refraction_n1" else N_PROFILE
        geometry, viewing = _limb_2d(pkg, ALTS80, np.linspace(-0.5, 0.5, 11),
                                     tangents=(12000.0, 25000.0), n=n)
        return config, geometry, viewing, _raw(
            pkg, config, geometry, np.tile(PROF80, 11)[:, None], 0.0)
    if name == "mixed_rays":
        # exact single scatter and Standard emission over a limb ray at a
        # horizontal angle, a TangentAltitudeSolar ray, a ground-viewing
        # ray and a downward ray from an observer inside the atmosphere
        alts = np.linspace(0.0, 60000.0, 13)
        config = _config(pkg, ss=True, emission="Standard")
        geometry = pkg.Geometry2D(0.6, 0.0, RE, alts,
                                  np.linspace(-0.4, 0.4, 9))
        viewing = pkg.ViewingGeometry()
        viewing.add_ray(pkg.TangentAltitude(20000.0, 2e5, 0.1, 0.0))
        viewing.add_ray(pkg.TangentAltitudeSolar(25000.0, 0.0, 2e5, 0.55))
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.0, 0.7, 2e5))
        viewing.add_ray(pkg.SolarAnglesObserverLocation(0.65, 0.0, -0.8,
                                                        40000.0))
        rng = np.random.default_rng(11)
        prof = 4e-5 * np.exp(-alts / 8000.0)
        ext = np.outer(rng.uniform(0.7, 1.3, 9), prof).ravel()[:, None]
        ext = ext * np.array([1.0, 0.6])
        return config, geometry, viewing, _raw(
            pkg, config, geometry, ext, rng.uniform(0.5, 0.95, (117, 2)),
            rng.uniform(0.5, 2.0, (117, 2)), np.array([450.0, 700.0]),
            leg={0: 1.0, 1: 0.4, 2: 0.5}, surface_emission=np.array([1.5,
                                                                    2.5]))
    raise KeyError(name)


ENGINE_CASES = [
    "transmission", "gradient_field", "single_scatter",
    "single_scatter_1d_grid", "ver_constant", "standard_emission",
    "occultation_emission", "uniform_standard", "uniform_ver",
    "ground_emission", "refraction_n1", "refraction", "mixed_rays",
]


def _path_length(tangent_altitude_m=15000.0):
    top = RE + EM_ALTS[-1]
    rt = RE + tangent_altitude_m
    return 2.0 * np.sqrt(top**2 - rt**2)


def _analytic(name, out):
    """The analytic checks of the JAX package's 2D tests, on the port."""
    rad = out["radiance"].to_numpy()
    if name == "transmission":
        od = out["los_optical_depth"].to_numpy()[0]
        np.testing.assert_allclose(rad[0, :, 0], np.exp(-od), rtol=1e-10)
    elif name == "ver_constant":
        np.testing.assert_allclose(
            rad[:, 0, 0], np.array([2.0e-6, 3.0e-6]) * _path_length(),
            rtol=2e-9)
    elif name == "standard_emission":
        ext = np.array([1.0e-6, 3.0e-6])
        np.testing.assert_allclose(
            rad[:, 0, 0],
            np.array([2.0, 3.0]) * (1.0 - np.exp(-ext * _path_length())),
            rtol=2e-9)
        assert out["wf_extinction"].to_numpy().shape[0] == 9
    elif name == "single_scatter":
        assert np.all(rad > 0) and rad[0, 0, 0] > rad[0, 1, 0]
    elif name == "ground_emission":
        assert np.all(rad > 0) and np.all(rad[:, 0, 0] < [2.0, 3.0])


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_2d_matches_jax(name):
    ref_case = case(sk, name)

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = case(skt, name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    assert not engine._twostream_fast_ok() and not engine._polarized_fast_ok()
    got = engine.calculate_radiance(atmo)
    torch_support.assert_outputs_match(got, ref)
    _analytic(name, got)


# ---------------------------------------------------------------------------
# the four 2D functions
# ---------------------------------------------------------------------------

FN_ALTS = np.linspace(0.0, 80000.0, 9)
FN_ANGLES = np.linspace(-0.4, 0.4, 7)
W, L = 3, 4


def _fn_rays(pkg):
    return [
        pkg.TangentAltitude(15000.0, 2e5, 0.1, 0.0),
        pkg.TangentAltitude(35000.0, 2e5, -0.15, 0.0),
        pkg.GroundViewingSolar(0.6, 0.0, 0.7, 2e5),
        pkg.SolarAnglesObserverLocation(0.5, 0.0, -0.8, 2e5),
    ]


@pytest.fixture(scope="module")
def traced():
    """The JAX package's 2D trace, and the port's, which must equal it."""
    ref = raytrace2d_ref.trace_2d(FN_ALTS, FN_ANGLES, RE, 0.6, _fn_rays(sk))
    got = raytrace2d.trace_2d(FN_ALTS, FN_ANGLES, RE, 0.6, _fn_rays(skt))
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, field.name),
                                      getattr(ref, field.name),
                                      err_msg=field.name)
    return ref, got


def _fn_inputs(nloc, seed=5):
    rng = np.random.default_rng(seed)
    prof = np.tile(2e-5 * np.exp(-FN_ALTS / 8000.0), len(FN_ANGLES))
    g = rng.uniform(0.0, 0.6, size=(W, nloc))
    return {
        "extinction": prof[None] * rng.uniform(0.8, 1.2, size=(W, nloc)),
        "ssa": rng.uniform(0.5, 0.99, size=(W, nloc)),
        "leg_coeff": (2 * np.arange(L) + 1) * g[..., None] ** np.arange(L),
        "emission": rng.uniform(0.5, 2.0, size=(W, nloc)),
    }


FUNCTIONS = {
    "integrate_single_scatter_2d": (
        ("extinction", "ssa", "leg_coeff"),
        lambda mod, tr, pt, x: mod.integrate_single_scatter_2d(
            x["extinction"], x["ssa"], x["leg_coeff"], tr, pt),
    ),
    "emission_radiance_2d": (
        ("extinction", "ssa", "emission"),
        lambda mod, tr, pt, x: mod.emission_radiance_2d(
            x["extinction"], x["ssa"], x["emission"], tr),
    ),
    "ver_emission_radiance_2d": (
        ("extinction", "emission"),
        lambda mod, tr, pt, x: mod.ver_emission_radiance_2d(
            x["extinction"], x["emission"], tr),
    ),
    "optical_depth_2d": (
        ("extinction",),
        lambda mod, tr, pt, x: mod.optical_depth_2d(x["extinction"], tr),
    ),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_2d_function_and_gradients(traced, name):
    ref_traced, port_traced = traced
    wrt, call = FUNCTIONS[name]
    x = _fn_inputs(ref_traced.nloc)
    phase_tab = np.moveaxis(
        wigner_ref.legendre_p(ref_traced.cos_scatter, L), 0, -1)

    def ref_fn(*args):
        return call(ss_ref, ref_traced, phase_tab,
                    {**x, **dict(zip(wrt, args))})

    (ref,), ref_grads = torch_support.jax_vjp_reference(
        ref_fn, [x[k] for k in wrt],
        lambda outs: [np.random.default_rng(7).normal(size=outs[0].shape)])
    assert ref.shape == (W, 4)
    ct = np.random.default_rng(7).normal(size=ref.shape)

    xt = {k: torch.tensor(v) for k, v in x.items()}
    ins = [xt[k].requires_grad_(True) for k in wrt]
    out = call(singlescatter, singlescatter.Rays2D(port_traced), phase_tab,
               xt)
    assert torch_support.rel_err(out.detach().numpy(), ref) <= 1e-10
    grads = torch.autograd.grad(out, ins, grad_outputs=torch.tensor(ct))
    for k, g, rg in zip(wrt, grads, ref_grads):
        assert np.all(np.isfinite(g.numpy())), k
        assert torch_support.rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, k


# ---------------------------------------------------------------------------
# refusals and the memoised trace
# ---------------------------------------------------------------------------

def _refused(pkg, name):
    """(config, geometry, viewing) of a configuration the 2D route
    refuses."""
    geometry, viewing = _limb_2d(pkg, ALTS80, np.linspace(-0.5, 0.5, 11))
    config = _config(pkg, occult=True)
    if name == "multiple_scatter":
        config.multiple_scatter_source = (
            pkg.MultipleScatterSource.DiscreteOrdinates)
    elif name == "do_emission":
        # DO emission validates only with DO single and multiple scatter
        config.single_scatter_source = (
            pkg.SingleScatterSource.DiscreteOrdinates)
        config.multiple_scatter_source = (
            pkg.MultipleScatterSource.DiscreteOrdinates)
        config.emission_source = pkg.EmissionSource.DiscreteOrdinates
    elif name == "interpolation":
        geometry = pkg.Geometry2D(
            0.6, 0.0, RE, ALTS80, np.linspace(-0.5, 0.5, 11),
            interpolation_method=pkg.InterpolationMethod.ShellInterpolation)
    elif name == "ray_type":
        viewing.add_ray(pkg.SolarAnglesObserverLocation(0.6, 0.0, 0.5,
                                                        10000.0))
    elif name == "solar_refraction":
        config.solar_refraction = True
    elif name == "polarized":
        config.num_stokes = 3
    return config, geometry, viewing


# the message of each refusal; DO emission validates only with DO multiple
# scatter, which the 2D route refuses first, so the emission refusal
# cannot be reached by a configuration that validates
REFUSALS = {
    "multiple_scatter": "single scatter, occultation and emission",
    "do_emission": "single scatter, occultation and emission",
    "interpolation": "LinearInterpolation only",
    "ray_type": "requires TangentAltitude, TangentAltitudeSolar or ground",
    "solar_refraction": "LOS refraction only",
}


@pytest.mark.parametrize("name", [*REFUSALS, "polarized"])
def test_2d_refusals(name):
    if name == "polarized":
        # the JAX package builds the engine and fails in the call
        config, geometry, viewing = _refused(sk, name)
        engine = sk.Engine(config, geometry, viewing)
        atmo = _raw(sk, config, geometry, np.tile(PROF80, 11)[:, None], 0.0,
                    derivs=False)
        with pytest.raises(AttributeError):
            engine.calculate_radiance(atmo)
        with pytest.raises(NotImplementedError, match="no polarized 2D path"):
            skt.Engine(*_refused(skt, name), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=REFUSALS[name]):
        sk.Engine(*_refused(sk, name))
    with pytest.raises(NotImplementedError, match=REFUSALS[name]):
        skt.Engine(*_refused(skt, name), device="cpu")


def test_2d_trace_memoised():
    """Engines of one geometry and rays share one trace whatever their
    dtype; another refractive index traces anew."""
    config, geometry, viewing, _ = case(skt, "refraction")
    first = skt.Engine(config, geometry, viewing, device="cpu")
    config.dtype = "float32"
    again = skt.Engine(config, geometry, viewing, device="cpu")
    assert again._traced2d is first._traced2d
    geometry.refractive_index = np.ones_like(ALTS80)
    other = skt.Engine(config, geometry, viewing, device="cpu")
    assert other._traced2d is not first._traced2d
