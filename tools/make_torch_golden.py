"""Write the f64 JAX reference values that ``chip_smoke.py`` holds the
PyTorch port's engine runs against.

The cases are those of ``sasktran2_tpu_torch.scenarios``: the 16-stream
ground-viewing case (``smoke_case``), the 16-stream limb scan
(``limb_case``), the two-stream case (``twostream_case``), the 16-stream
flux case (``flux16_case``), the 4-stream polarized case
(``pol4_case``), the 16-stream MODIS BRDF case (``brdf16_case``) and the
16-stream thermal infrared cases, ground-viewing with fluxes and limb
(``thermal16_case``, ``thermallimb16_case``), and the three 4-stream
polarized cells of the generic per-wavelength route, over a MODIS BRDF,
with flux observers, and the thermal limb scan (``polbrdf4_case``,
``polflux4_case``, ``polthermallimb4_case``). Wavelengths are
independent in this model, so 8 wavelengths taken from a case's
1024-point grid give the same values as the full grid. Runs the JAX
engine on the CPU in float64:

    python tools/make_torch_golden.py [--case nstr16|limb16|2str|flux16|pol4|brdf16|thermal16|thermallimb16|polbrdf4|polflux4|polthermallimb4|pol16_solver|test_vec8|test_limbpol4|all]

and writes ``sasktran2_tpu_torch/data/golden_<case>.npz`` with the
wavelength indices, the wavelengths, ``radiance``, the ``*_flux``
variables and every ``wf_*``.

``pol16_solver`` is solver-level, because the JAX package cannot compile
its polarized engine at 16 streams on the CPU: the layer inputs of
``pol16_case`` at the 8 wavelengths (from the JAX engine's
``_layer_optical``) and the radiance [U, 3, W] of ``solve_nstream_vector``
on them at the case's four rays (``golden_pol16_solver.npz``). It holds
no gradients: the JAX gradient graph of the 16-stream vector solver did
not finish compiling on the CPU in 20 minutes (13 GB resident), where the
forward graph compiles in about a minute.

``test_vec8`` and ``test_limbpol4`` hold the JAX side of two CPU tests
whose JAX compile takes over a minute, so that the test suite runs only
the port: the 8-stream case of
``tests/test_torch_polarized.py::test_solve_nstream_vector_matches_jax``
(the solver's outputs and its vjp at that test's cotangents) and the
``limb_exact_ss_sza2_observer_basis`` case of
``tests/test_torch_polarized_engine.py`` (every engine output, its
dimension names, and whether the JAX engine took its polarized fast
path). Both are
built by the tests' own functions, which this script imports, and written
to ``golden_test_<case>.npz``; they hold float64 values only.

It also runs the same case through the JAX engine in float32 and stores
that run's own error against the float64 values, ``jax_f32_err_<name>``:
for ``radiance`` and the fluxes the largest relative error per element
(for the polarized radiance: I per element, Q and U relative to the
largest |Q| and |U|), for each ``wf_*`` and gradient the largest error
relative to the variable's largest magnitude.
``chip_smoke.py`` prints it beside the port's own float32 error; the
port is held to its gates alone (some variables of the thermal case miss
them in the reference's float32: its 80 km downwelling flux and its flux
pressure weighting functions).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from sasktran2_tpu_torch import scenarios

    solar = scenarios.smoke_wavelengths
    thermal = scenarios.thermal_wavelengths
    cases = {
        "nstr16": (scenarios.smoke_case, scenarios.GOLDEN_PATH, solar),
        "limb16": (scenarios.limb_case, scenarios.GOLDEN_LIMB_PATH, solar),
        "2str": (scenarios.twostream_case, scenarios.GOLDEN_2STR_PATH, solar),
        "flux16": (scenarios.flux16_case, scenarios.GOLDEN_FLUX16_PATH,
                   solar),
        "pol4": (scenarios.pol4_case, scenarios.GOLDEN_POL4_PATH, solar),
        "brdf16": (scenarios.brdf16_case, scenarios.GOLDEN_BRDF16_PATH,
                   solar),
        "thermal16": (scenarios.thermal16_case,
                      scenarios.GOLDEN_THERMAL16_PATH, thermal),
        "thermallimb16": (scenarios.thermallimb16_case,
                          scenarios.GOLDEN_THERMALLIMB16_PATH, thermal),
        "polbrdf4": (scenarios.polbrdf4_case, scenarios.GOLDEN_POLBRDF4_PATH,
                     solar),
        "polflux4": (scenarios.polflux4_case, scenarios.GOLDEN_POLFLUX4_PATH,
                     solar),
        "polthermallimb4": (scenarios.polthermallimb4_case,
                            scenarios.GOLDEN_POLTHERMALLIMB4_PATH, thermal),
    }
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    tests = {"test_vec8": vec8_test_golden,
             "test_limbpol4": limbpol4_test_golden}
    parser.add_argument("--case",
                        choices=[*cases, "pol16_solver", *tests, "all"],
                        default="all")
    args = parser.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import sasktran2_tpu as sk

    def run(name, build, dtype, wl):
        jax.config.update("jax_enable_x64", dtype == "float64")
        config, geometry, viewing, atmo = build(sk, dtype, wl)
        t0 = time.perf_counter()
        out = sk.Engine(config, geometry, viewing).calculate_radiance(atmo)
        print(f"{name}: JAX {dtype} engine call on the CPU (compile "
              f"included): {time.perf_counter() - t0:.1f} s")
        return {k: out[k].to_numpy() for k in out.keys()
                if k == "radiance" or k.endswith("_flux")
                or k.startswith("wf_")}

    idx = scenarios.GOLDEN_INDICES
    for name, (build, path, grid) in cases.items():
        if args.case not in (name, "all"):
            continue
        wl = grid()[idx]
        f32 = run(name, build, "float32", wl)
        f64 = run(name, build, "float64", wl)
        arrays = {"indices": idx, "wavelengths_nm": wl, **f64}
        for key, ref in f64.items():
            arrays[f"jax_f32_err_{key}"] = scenarios.golden_error(
                key, f32[key], ref, qu_scale=scenarios.QU_SCALE.get(
                    name, "own"))
        save(path, arrays)
    if args.case in ("pol16_solver", "all"):
        save(scenarios.GOLDEN_POL16_SOLVER_PATH,
             pol16_solver(sk, solar()[idx], idx))
    for name, make in tests.items():
        if args.case in (name, "all"):
            jax.config.update("jax_enable_x64", True)
            t0 = time.perf_counter()
            arrays = make()
            print(f"{name}: JAX float64 on the CPU (compile included): "
                  f"{time.perf_counter() - t0:.1f} s")
            save(os.path.join(scenarios.DATA, f"golden_{name}.npz"), arrays)


def save(path, arrays):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    for k, v in arrays.items():
        print(f"    {k} {np.shape(v) or v}")


def pol16_solver(sk, wl, idx):
    """The solver-level golden values of the 16-stream polarized case."""
    import jax
    import jax.numpy as jnp
    from sasktran2_tpu.rt.disco_vec_minor import (
        build_vector_minor_tables,
        solve_nstream_vector,
    )
    from sasktran2_tpu_torch import scenarios

    jax.config.update("jax_enable_x64", True)
    config, geometry, viewing, atmo = scenarios.pol16_case(sk, "float64", wl)
    engine = sk.Engine(config, geometry, viewing)
    core = {k: jnp.asarray(v) for k, v in atmo.internal_object().items()}
    legs = tuple(core[k] for k in ("leg_coeff", "leg_a2", "leg_a3", "leg_b1"))
    dtau, omega, greeks = engine._layer_optical(
        core["extinction"], core["ssa"], legs)
    inputs = {
        "dtau": np.asarray(dtau).T,                       # [P, W]
        "omega": np.asarray(omega).T,
        **{k: np.transpose(np.asarray(g), (2, 1, 0))      # [L, P, W]
           for k, g in zip(("a1", "a2", "a3", "b1"), greeks)},
        "albedo": np.asarray(core["albedo"]),
        "f0": np.asarray(core["solar_irradiance"]),
    }
    user_mu = scenarios.POL16_SOLVER_USER_MU
    tables = build_vector_minor_tables(
        16, 16, 0.6, user_mu, num_azimuth=scenarios.POL16_SOLVER_NUM_AZIMUTH)
    user_up = np.ones(len(user_mu), dtype=bool)
    user_azi = np.full(len(user_mu), scenarios.POL16_SOLVER_AZIMUTH)

    def solve(x):
        return solve_nstream_vector(
            x["dtau"], x["omega"], x["a1"], x["a2"], x["a3"], x["b1"],
            x["albedo"], tables, user_up, user_azi, f0=x["f0"],
            num_azimuth=scenarios.POL16_SOLVER_NUM_AZIMUTH)

    out = {}
    for dtype in (jnp.float32, jnp.float64):
        jax.config.update("jax_enable_x64", dtype == jnp.float64)
        x = {k: jnp.asarray(v, dtype=dtype) for k, v in inputs.items()}
        t0 = time.perf_counter()
        rad = jax.jit(solve)(x)
        out[dtype] = {"radiance": np.asarray(rad, dtype=np.float64)}
        print(f"pol16_solver: JAX {np.dtype(dtype).name} solve on the CPU "
              f"(compile included): {time.perf_counter() - t0:.1f} s",
              flush=True)
    f32, f64 = out[jnp.float32], out[jnp.float64]
    arrays = {"indices": idx, "wavelengths_nm": wl, "user_mu": user_mu,
              **{f"input_{k}": v for k, v in inputs.items()}, **f64}
    for key, ref in f64.items():
        arrays[f"jax_f32_err_{key}"] = scenarios.golden_error(
            key, f32[key], ref, stokes_axis=1)
    return arrays


def vec8_test_golden():
    """The JAX side of the 8-stream case of
    ``test_solve_nstream_vector_matches_jax``: ``out_<i>`` the solver's
    outputs, ``grad_<input>`` its vjp at the test's cotangents."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_polarized import (
        GRAD_NAMES,
        VEC8_CASE,
        _cotangents,
        _pair,
        _problem,
    )

    nstr = VEC8_CASE[0]
    ref_fn, _ = _pair(*VEC8_CASE)
    inputs = _problem(7 + nstr, nstr)
    ref, vjp = jax.vjp(jax.jit(ref_fn), *[jnp.asarray(x) for x in inputs])
    grads = vjp([jnp.asarray(c) for c in _cotangents(nstr, ref)])
    return {**{f"out_{i}": np.asarray(r) for i, r in enumerate(ref)},
            **{f"grad_{k}": np.asarray(g) for k, g in zip(GRAD_NAMES, grads)}}


def limbpol4_test_golden():
    """The JAX engine's outputs on the ``limb_exact_ss_sza2_observer_basis``
    case of ``tests/test_torch_polarized_engine.py``."""
    import sasktran2_tpu as sk
    from tests.test_torch_polarized_engine import LIMBPOL4_CASE, _engine_case

    config, geometry, viewing, atmo = _engine_case(sk, LIMBPOL4_CASE)
    engine = sk.Engine(config, geometry, viewing)
    out = engine.calculate_radiance(atmo)
    return {**{k: out[k].to_numpy() for k in out.keys()},
            **{f"dims_of_{k}": np.array(out[k].dims) for k in out.keys()},
            "polarized_fast_ok": np.array(engine._polarized_fast_ok())}


if __name__ == "__main__":
    main()
