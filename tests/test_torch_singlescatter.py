"""The port's line-of-sight sources (``rt/singlescatter.py``) against the
JAX package's, in float64 on the CPU: exact single scatter, emission,
volume-emission-rate emission, the optical-depth source integral, the
line-of-sight optical depth and occultation, on one traced spherical
geometry with two limb rays, a ground-viewing ray and a downward ray from
an observer inside the atmosphere (20 altitudes, 3 wavelengths). Inputs
are made from a numpy seed; values and the gradients of a random linear
functional of the output (``torch.autograd`` against ``jax.vjp``) agree to
1e-10 of their largest magnitude.

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_singlescatter.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
from sasktran2_tpu.rt import raytrace as raytrace_ref
from sasktran2_tpu.rt import singlescatter as ss_ref
from sasktran2_tpu_torch.rt import singlescatter
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 100000.0, 20)
W, L = 3, 4


@pytest.fixture(scope="module")
def traced():
    rays = [
        sk.TangentAltitudeSolar(15000.0, 0.3, 200000.0, 0.6),
        sk.TangentAltitudeSolar(40000.0, 1.2, 200000.0, 0.5),
        sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0),
        sk.SolarAnglesObserverLocation(0.4, 1.1, -0.7, 30000.0),
    ]
    return raytrace_ref.trace_spherical(ALTITUDES, 6372000.0, 0.6, rays)


def _inputs(traced, seed=3):
    rng = np.random.default_rng(seed)
    A = len(ALTITUDES)
    R, S = traced.mask.shape
    ext = 2e-5 * np.exp(-ALTITUDES / 8000.0)[None] * rng.uniform(
        0.8, 1.2, size=(W, A))
    g = rng.uniform(0.0, 0.6, size=(W, A))
    leg = (2 * np.arange(L) + 1) * g[..., None] ** np.arange(L)
    return {
        "extinction": ext,
        "ssa": rng.uniform(0.5, 0.99, size=(W, A)),
        "leg_coeff": leg,
        "albedo": rng.uniform(0.05, 0.4, size=W),
        "emission": rng.uniform(0.5, 2.0, size=(W, A)),
        "surface_emission": rng.uniform(0.5, 2.0, size=W),
        "j_in": rng.uniform(0.0, 1.0, size=(W, R, S)),
        "j_out": rng.uniform(0.0, 1.0, size=(W, R, S)),
    }


# function -> (the inputs it differentiates, call given a module, traced
# rays and the phase table)
CASES = {
    "integrate_single_scatter": (
        ("extinction", "ssa", "leg_coeff", "albedo"),
        lambda mod, tr, pt, x: mod.integrate_single_scatter(
            x["extinction"], x["ssa"], x["leg_coeff"], x["albedo"], tr, pt),
    ),
    "emission_radiance": (
        ("extinction", "ssa", "emission", "albedo", "surface_emission"),
        lambda mod, tr, pt, x: mod.emission_radiance(
            x["extinction"], x["ssa"], x["emission"], x["albedo"],
            x["surface_emission"], tr),
    ),
    "ver_emission_radiance": (
        ("extinction", "emission"),
        lambda mod, tr, pt, x: mod.ver_emission_radiance(
            x["extinction"], x["emission"], tr),
    ),
    "integrate_od_source": (
        ("extinction", "j_in", "j_out"),
        lambda mod, tr, pt, x: mod.integrate_od_source(
            x["extinction"], x["j_in"], x["j_out"], tr),
    ),
    "optical_depth": (
        ("extinction",),
        lambda mod, tr, pt, x: mod.optical_depth(x["extinction"], tr),
    ),
    "occultation_radiance": (
        ("extinction",),
        lambda mod, tr, pt, x: mod.occultation_radiance(x["extinction"], tr),
    ),
}


def _rel_err(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("name", list(CASES))
def test_los_source_and_gradients(traced, name):
    wrt, call = CASES[name]
    x = _inputs(traced)
    phase_tab = ss_ref.phase_tables(traced, L)
    np.testing.assert_array_equal(
        singlescatter.phase_tables(traced, L), phase_tab
    )

    def ref_fn(*args):
        return call(ss_ref, traced, phase_tab, {**x, **dict(zip(wrt, args))})

    (ref,), ref_grads = torch_support.jax_vjp_reference(
        ref_fn, [x[k] for k in wrt],
        lambda outs: [np.random.default_rng(7).normal(size=outs[0].shape)])
    assert ref.shape == (W, traced.mask.shape[0])
    ct = np.random.default_rng(7).normal(size=ref.shape)

    xt = {k: torch.tensor(v) for k, v in x.items()}
    ins = [xt[k].requires_grad_(True) for k in wrt]
    out = call(singlescatter, traced, phase_tab, xt)
    assert _rel_err(out.detach().numpy(), ref) <= 1e-10
    grads = torch.autograd.grad(out, ins, grad_outputs=torch.tensor(ct))
    for k, g, rg in zip(wrt, grads, ref_grads):
        assert np.all(np.isfinite(g.numpy())), k
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, k
