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
``polflux4_case``, ``polthermallimb4_case``), and the three
successive-orders limb cells (``solimb16_case``,
``solimb16_doinit_case``, ``polsolimb16_case``: 8 of their 64
wavelengths, one wavelength per JAX engine call, float64 only). Wavelengths are
independent in this model, so 8 wavelengths taken from a case's
1024-point grid give the same values as the full grid. Runs the JAX
engine on the CPU in float64:

    python tools/make_torch_golden.py [--case nstr16|limb16|2str|flux16|pol4|brdf16|thermal16|thermallimb16|polbrdf4|polflux4|polthermallimb4|solimb16|solimb16_doinit|polsolimb16|pol16_solver|o2a16|dayglowlimb16|amf16|tomo2d|tests|all] [--tests MODULE,...]

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

``o2a16`` is the optical cell (``o2a16_case``): its Mie table, its line
cross sections at 10 of the 101 levels and one Monochromatic engine call
at 16 fine wavenumbers (``o2a16_golden``; about 15 minutes, 7 of them the
table).

``dayglowlimb16`` is the O2 A-band dayglow limb scan
(``dayglowlimb16_case``, ``dayglowlimb16_golden``): the engine in float32
and float64 at the 8 wavenumbers of ``dayglowlimb16_check_indices``, with
the O2 line file written to a temporary database root of the JAX
package. ``amf16`` is ``amf16_case`` (``amf16_golden``: its
``air_mass_factor`` beside the radiance and the ``wf_*``, with the JAX
package's own float32 error at each level, below 60 km and on the whole
column, the difference between its two routes, and its route).

``tomo2d`` is the 2D tomographic limb cell (``tomo2d_case``,
``tomo2d_golden``): the JAX engine in float64 and float32 at the 8
wavelengths ``SO_GOLDEN_INDICES`` of its 64-point grid, with radiance and
``los_optical_depth`` at all 8 and every ``wf_*`` (each [4,141, W, 40, 1])
at the two of them in ``TOMO2D_WF_POSITIONS``, to keep the file small.

``tests`` runs the port's CPU test modules of ``TEST_MODULES`` (or those
given by ``--tests``) in record mode (``tests/torch_support.py``): each
test's JAX side is computed from its own inputs and written to
``golden_<module>.npz``, with a digest of the inputs it was made from,
which the tier-1 run then reads instead of compiling the JAX graphs. A
test whose inputs no longer match the digest fails: rerun this after
changing a test's inputs.

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
    so_cases = {
        "solimb16": (scenarios.solimb16_case,
                     scenarios.GOLDEN_SOLIMB16_PATH),
        "solimb16_doinit": (scenarios.solimb16_doinit_case,
                            scenarios.GOLDEN_SOLIMB16_DOINIT_PATH),
        "polsolimb16": (scenarios.polsolimb16_case,
                        scenarios.GOLDEN_POLSOLIMB16_PATH),
    }
    parser.add_argument("--case",
                        choices=[*cases, *so_cases, "pol16_solver", "o2a16",
                                 "dayglowlimb16", "amf16", "tomo2d", "tests",
                                 "all"],
                        default="all")
    parser.add_argument("--tests", default=None,
                        help="with --case tests: the comma-separated test "
                             "modules to record (default: all of "
                             "TEST_MODULES)")
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
    so_idx = scenarios.SO_GOLDEN_INDICES
    for name, (build, path) in so_cases.items():
        if args.case not in (name, "all"):
            continue
        wl = scenarios.so_wavelengths()[so_idx]
        save(path, {"indices": so_idx, "wavelengths_nm": wl,
                    **so_golden(sk, name, build, wl)})
    if args.case in ("pol16_solver", "all"):
        save(scenarios.GOLDEN_POL16_SOLVER_PATH,
             pol16_solver(sk, solar()[idx], idx))
    if args.case in ("o2a16", "all"):
        save(scenarios.GOLDEN_O2A16_PATH, o2a16_golden(sk))
    if args.case in ("dayglowlimb16", "all"):
        save(scenarios.GOLDEN_DAYGLOWLIMB16_PATH, dayglowlimb16_golden(sk))
    if args.case in ("amf16", "all"):
        save(scenarios.GOLDEN_AMF16_PATH, amf16_golden(sk, solar()[idx], idx))
    if args.case in ("tomo2d", "all"):
        save(scenarios.GOLDEN_TOMO2D_PATH, tomo2d_golden(sk))
    if args.case in ("tests", "all"):
        t0 = time.perf_counter()
        record_test_goldens(args.tests.split(",") if args.tests else None)
        print(f"tests: recorded in {time.perf_counter() - t0:.1f} s")


def save(path, arrays):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    for k, v in arrays.items():
        print(f"    {k} {np.shape(v) or v}")


def so_golden(sk, name, build, wl):
    """The float64 outputs of a successive-orders cell, one wavelength per
    JAX engine call: the JAX engine maps its wavelengths in one batch and
    its vjp over every output row at once, and one wavelength's transport
    gather alone is [R, S, 2, 2, 4] (about 65 MB at 51 altitudes); one
    engine (one host build of its SO geometry, one compile) serves all
    the wavelengths."""
    import jax

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    config, geometry, viewing, _ = build(sk, "float64", wl[:1])
    engine = sk.Engine(config, geometry, viewing)
    print(f"{name}: JAX engine constructor (SO geometry build) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    parts = []
    for w in wl:
        t0 = time.perf_counter()
        atmo = build(sk, "float64", np.array([w]))[3]
        out = engine.calculate_radiance(atmo)
        parts.append({k: (out[k].to_numpy(), out[k].dims.index("wavelength"))
                      for k in out.keys() if k == "radiance"
                      or k.endswith("_flux") or k.startswith("wf_")})
        print(f"{name}: {w:.1f} nm, JAX float64 engine call on the CPU "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {k: np.concatenate([p[k][0] for p in parts], axis=parts[0][k][1])
            for k in parts[0]}


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


def jax_mie_table(sk):
    """The o2a16 cell's Mie table from the JAX package in float64, in the
    layout of ``MieDatabase.generate``: ``_integration_grid``, the ensemble
    sums of ``integrate_mie`` and ``compute_greek_coefficients`` as the
    JAX package has them, with the Mie efficiencies and amplitudes of
    each radius from ``optical.mie`` at that radius's own nmax. The JAX
    package's ``integrate_mie`` takes one nmax for all 1,000 radii of a
    call, and its psi recurrence then gives NaN at the smallest radii of
    the larger distributions (it raises for a median radius of 200 nm and
    a mode width of 1.7): here every radius of the table is computed in
    one call with the radii of the same nmax. Returns the arrays, and per
    grid point the NaN members of the JAX package's own batch at 750 nm
    (its ``mie_efficiencies`` on the 1,000 radii)."""
    import itertools

    import jax.numpy as jnp
    from sasktran2_tpu.legendre import compute_greek_coefficients
    from sasktran2_tpu.mie import distribution as dist_ref
    from sasktran2_tpu.optical import mie as mie_ref
    from sasktran2_tpu_torch import scenarios as sc

    wl = sc.O2A16_MIE_WAVELENGTHS_NM
    grids = [sc.O2A16_MEDIAN_RADII_NM, sc.O2A16_MODE_WIDTHS]
    m = sc.O2A16_REFRACTIVE_INDEX
    num_angles, num_quad, L = 481, 1000, 64
    angles = np.linspace(0.0, 180.0, num_angles)
    mu = jnp.asarray(np.cos(np.deg2rad(angles)))
    points = list(itertools.product(*grids))
    members, nan_750 = [], []
    for pi, (rg, width) in enumerate(points):
        dist = sk.mie.LogNormalDistribution().distribution(
            median_radius=rg, mode_width=width)
        r, w = dist_ref._integration_grid(dist, num_quad, 0.999999)
        wpdf, area = w * dist.pdf(r), np.pi * r**2
        for wi, lam in enumerate(wl):
            members.append((pi, wi, 2.0 * np.pi * r / lam, wpdf, area))
        q750 = np.asarray(mie_ref.mie_efficiencies(
            jnp.asarray(2.0 * np.pi * r / wl[0]), m)[0])
        nan_750.append(int(np.sum(~np.isfinite(q750))))
    x_all = np.concatenate([mb[2] for mb in members])
    own = np.array([mie_ref._nmax_for(float(v)) for v in x_all])
    qext = np.zeros(x_all.size)
    qsca = np.zeros(x_all.size)
    s1_all = np.zeros((x_all.size, num_angles), dtype=np.complex128)
    s2_all = np.zeros((x_all.size, num_angles), dtype=np.complex128)
    t0 = time.perf_counter()
    for nmax in np.unique(own):
        sel = np.nonzero(own == nmax)[0]
        xs = jnp.asarray(x_all[sel])
        qe, qs = mie_ref.mie_efficiencies(xs, m)
        s1, s2 = mie_ref.mie_amplitudes(xs, m, mu)
        qext[sel], qsca[sel] = np.asarray(qe), np.asarray(qs)
        s1_all[sel], s2_all[sel] = np.asarray(s1), np.asarray(s2)
    print(f"o2a16: JAX Mie of {x_all.size} radii in {len(np.unique(own))} "
          f"calls by nmax: {time.perf_counter() - t0:.1f} s", flush=True)
    shape = tuple(g.size for g in grids)
    W = wl.size
    xs_total = np.zeros(shape + (W,))
    xs_scattering = np.zeros(shape + (W,))
    lm = {k: np.zeros((L,) + shape + (W,))
          for k in ("lm_a1", "lm_a2", "lm_a3", "lm_a4", "lm_b1", "lm_b2")}
    phase = {k: np.zeros((len(points), W, num_angles))
             for k in ("p11", "p12", "p33", "p34")}
    start = 0
    for pi, wi, x, wpdf, area in members:
        # the ensemble sums of ``integrate_mie`` (mie/distribution.py),
        # in its order
        sl = slice(start, start + x.size)
        start += x.size
        s1, s2 = s1_all[sl], s2_all[sl]
        cext = float(np.dot(wpdf, qext[sl] * area))
        csca = float(np.dot(wpdf, qsca[sl] * area))
        idx = np.unravel_index(pi, shape)
        xs_total[idx + (wi,)] = cext * 1e-18
        xs_scattering[idx + (wi,)] = csca * 1e-18
        p11 = np.einsum("b,bt->t", wpdf, np.abs(s1) ** 2 + np.abs(s2) ** 2)
        p12 = np.einsum("b,bt->t", wpdf, np.abs(s1) ** 2 - np.abs(s2) ** 2)
        cross = s1 * np.conj(s2)
        p33 = np.einsum("b,bt->t", wpdf, 2.0 * np.real(cross))
        p34 = np.einsum("b,bt->t", wpdf, 2.0 * np.imag(cross))
        k = 2.0 * np.pi / wl[wi]
        c = 4.0 * np.pi / (2.0 * k**2 * csca)
        for name, v in (("p11", p11), ("p12", p12), ("p33", p33),
                        ("p34", p34)):
            phase[name][pi, wi] = v * c
    del s1_all, s2_all
    for pi in range(len(points)):
        a1, a2, a3, a4, b1, b2 = compute_greek_coefficients(
            p11=phase["p11"][pi], p12=phase["p12"][pi],
            p22=phase["p11"][pi], p33=phase["p33"][pi],
            p34=phase["p34"][pi], p44=phase["p33"][pi],
            angle_grid=angles, num_coeff=L)
        idx = np.unravel_index(pi, shape)
        for name, v in zip(lm, (a1, a2, a3, a4, b1, b2)):
            lm[name][(slice(None), *idx)] = v.T
    names = ("median_radius", "mode_width", "wavelength_nm")
    arrays = {"coord_wavelength_nm": wl, "coord_legendre": np.arange(L),
              "coord_median_radius": grids[0], "coord_mode_width": grids[1],
              "xs_total": xs_total, "dims_xs_total": np.array(names),
              "xs_scattering": xs_scattering,
              "dims_xs_scattering": np.array(names)}
    for name, v in lm.items():
        arrays[name] = v
        arrays[f"dims_{name}"] = np.array(("legendre",) + names)
    return arrays, np.array(nan_750)


def o2a16_golden(sk):
    """The o2a16 cell's golden values, in float64 from the JAX package:
    the Mie table (``jax_mie_table``), the line cross sections at the
    ``O2A16_XS_LEVELS`` of the 101 levels on the whole fine grid, and one
    Monochromatic engine call at the 16 wavenumbers of
    ``o2a16_check_indices`` (radiance and every ``wf_*``), with the JAX
    engine's own float32 error beside it (``jax_f32_err_<name>``), the
    difference between its fast path and its generic route in float64
    (``jax_route_err_<name>``, by ``golden_error``) and its route for the
    cell."""
    import tempfile

    import jax

    from sasktran2_tpu_torch import scenarios as sc

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    table, nan_750 = jax_mie_table(sk)
    print(f"o2a16: Mie table {time.perf_counter() - t0:.1f} s; the JAX "
          f"package's own batch at 750 nm has NaN members per grid point "
          f"{nan_750.tolist()}", flush=True)
    out = {f"table_{k}": v for k, v in table.items()}
    out["jax_batch_nan_members_750nm"] = nan_750
    wvn = sc.O2A16_WAVENUMBERS
    idx = sc.o2a16_check_indices()
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "o2a16_mie.npz")
        np.savez_compressed(path, **table)
        optical = sk.optical.OpticalDatabaseGenericScatterer(db_filepath=path)
        config, geometry, viewing, atmo = sc.o2a16_case(
            sk, "float64", wvn[idx], optical, mode="Monochromatic")
        atmo.internal_object()
        levels = sc.O2A16_XS_LEVELS
        p, t = atmo.pressure_pa[levels], atmo.temperature_k[levels]
        t0 = time.perf_counter()
        xs = sk.optical.LineAbsorber(sc.o2a16_catalogue(sk))\
            .cross_section_grid(wvn, p, t)
        print(f"o2a16: JAX cross sections at {len(levels)} levels x "
              f"{wvn.size}: {time.perf_counter() - t0:.1f} s", flush=True)
        out.update({"xs_levels": levels, "xs_pressure_pa": p,
                    "xs_temperature_k": t, "xs": xs})
        runs = {}
        for dtype in ("float32", "float64"):
            jax.config.update("jax_enable_x64", dtype == "float64")
            config, geometry, viewing, atmo = sc.o2a16_case(
                sk, dtype, wvn[idx], optical, mode="Monochromatic")
            t0 = time.perf_counter()
            res = sk.Engine(config, geometry, viewing)\
                .calculate_radiance(atmo)
            print(f"o2a16: JAX {dtype} Monochromatic engine call on the CPU "
                  f"(compile included): {time.perf_counter() - t0:.1f} s",
                  flush=True)
            runs[dtype] = {k: res[k].to_numpy() for k in res.keys()
                           if k == "radiance" or k.startswith("wf_")}
        # the JAX package's own generic route (gates forced off) on the
        # same case in f64: how far its two routes agree, per variable
        config, geometry, viewing, atmo = sc.o2a16_case(
            sk, "float64", wvn[idx], optical, mode="Monochromatic")
        engine = sk.Engine(config, geometry, viewing)
        engine._twostream_fast_ok = lambda: False
        t0 = time.perf_counter()
        res = engine.calculate_radiance(atmo)
        print(f"o2a16: JAX float64 Monochromatic engine call on the CPU, "
              f"generic route forced (compile included): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for key, ref in runs["float64"].items():
            out[f"jax_route_err_{key}"] = sc.golden_error(
                key, res[key].to_numpy(), ref)
        jax.config.update("jax_enable_x64", True)
        config, geometry, viewing, _ = sc.o2a16_case(
            sk, "float32", wvn[:2], optical)
        engine = sk.Engine(config, geometry, viewing)
        out["twostream_fast_ok"] = np.array(engine._twostream_fast_ok())
        out["polarized_fast_ok"] = np.array(engine._polarized_fast_ok())
    out.update({"indices": idx, "wavenumbers_cminv": wvn[idx],
                **runs["float64"]})
    for key, ref in runs["float64"].items():
        out[f"jax_f32_err_{key}"] = sc.golden_error(
            key, runs["float32"][key], ref)
    return out


def dayglowlimb16_golden(sk):
    """The dayglowlimb16 cell's golden values: the JAX engine in float64
    at the 8 wavenumbers of ``dayglowlimb16_check_indices`` (radiance,
    every ``wf_*`` and the container's ``tangent_altitude``), with its own
    float32 error beside each (``jax_f32_err_<name>``) and its route. The
    O2 line file is written to a temporary directory that the JAX
    package's database root (``SASKTRAN2_TPU_DB_ROOT``) points at while
    the cases are built."""
    import tempfile

    import jax

    from sasktran2_tpu_torch import scenarios as sc

    idx = sc.dayglowlimb16_check_indices()
    wvn = sc.DAYGLOW_WAVENUMBERS[idx]
    out = {"indices": idx, "wavenumbers_cminv": wvn}
    runs = {}
    before = os.environ.get("SASKTRAN2_TPU_DB_ROOT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["SASKTRAN2_TPU_DB_ROOT"] = root
        try:
            sc.write_dayglow_par(root)
            for dtype in ("float32", "float64"):
                jax.config.update("jax_enable_x64", dtype == "float64")
                config, geometry, viewing, atmo = sc.dayglowlimb16_case(
                    sk, dtype, wvn)
                engine = sk.Engine(config, geometry, viewing)
                t0 = time.perf_counter()
                res = engine.calculate_radiance(atmo)
                print(f"dayglowlimb16: JAX {dtype} engine call on the CPU "
                      f"(compile included): {time.perf_counter() - t0:.1f} s",
                      flush=True)
                runs[dtype] = {k: res[k].to_numpy() for k in res.keys()
                               if k == "radiance" or k.startswith("wf_")}
            out["tangent_altitude"] = res["tangent_altitude"].to_numpy()
            out["twostream_fast_ok"] = np.array(engine._twostream_fast_ok())
            out["polarized_fast_ok"] = np.array(engine._polarized_fast_ok())
        finally:
            if before is None:
                os.environ.pop("SASKTRAN2_TPU_DB_ROOT", None)
            else:
                os.environ["SASKTRAN2_TPU_DB_ROOT"] = before
    out.update(runs["float64"])
    for key, ref in runs["float64"].items():
        out[f"jax_f32_err_{key}"] = sc.golden_error(
            key, runs["float32"][key], ref)
    return out


def amf16_golden(sk, wl, idx):
    """The amf16 cell's golden values at the wavelengths ``wl``: the JAX
    engine in float64 (radiance, every ``wf_*`` and ``air_mass_factor``),
    its own float32 error beside each on the whole column
    (``jax_f32_err_<name>``), and for the variables with an altitude axis
    below 60 km (``jax_f32_err_below60_<name>``) and at each level
    (``jax_f32_err_by_level_<name>``), all relative to the column's
    largest magnitude; the difference between its fast path and its
    generic route in float64 (``jax_route_err_<name>``, by
    ``golden_error``), and its route for the cell."""
    import jax

    from sasktran2_tpu_torch import scenarios as sc

    def keep(out):
        return {k: out[k].to_numpy() for k in out.keys()
                if k in ("radiance", "air_mass_factor")
                or k.startswith("wf_")}

    runs = {}
    for dtype, generic in (("float32", False), ("float64", False),
                           ("float64", True)):
        jax.config.update("jax_enable_x64", dtype == "float64")
        config, geometry, viewing, atmo = sc.amf16_case(sk, dtype, wl)
        engine = sk.Engine(config, geometry, viewing)
        if generic:
            engine._twostream_fast_ok = lambda: False
        elif dtype == "float64":
            gates = {k: np.array(getattr(engine, f"_{k}")()) for k in
                     ("twostream_fast_ok", "polarized_fast_ok")}
        t0 = time.perf_counter()
        runs[dtype, generic] = keep(engine.calculate_radiance(atmo))
        print(f"amf16: JAX {dtype} engine call on the CPU"
              f"{', generic route forced' if generic else ''} (compile "
              f"included): {time.perf_counter() - t0:.1f} s", flush=True)
    ref = runs["float64", False]
    low = geometry.altitudes() < 60000.0
    out = {"indices": idx, "wavelengths_nm": wl, **ref, **gates}
    for key, r in ref.items():
        f32 = runs["float32", False][key]
        out[f"jax_f32_err_{key}"] = sc.golden_error(key, f32, r)
        out[f"jax_route_err_{key}"] = sc.golden_error(
            key, runs["float64", True][key], r)
        if r.shape[0] == low.size:
            by_level = (np.abs(f32 - r).reshape(low.size, -1).max(axis=1)
                        / np.max(np.abs(r)))
            out[f"jax_f32_err_by_level_{key}"] = by_level
            out[f"jax_f32_err_below60_{key}"] = float(by_level[low].max())
    return out


def tomo2d_golden(sk):
    """The tomo2d cell's golden values: the JAX engine in float64 at the
    8 wavelengths ``SO_GOLDEN_INDICES`` of its grid (radiance and
    ``los_optical_depth`` at all 8, every ``wf_*`` at the wavelengths
    ``TOMO2D_WF_POSITIONS`` among them), and beside each the JAX
    package's own float32 error on the same values
    (``jax_f32_err_<name>``)."""
    import jax

    from sasktran2_tpu_torch import scenarios as sc

    idx = sc.SO_GOLDEN_INDICES
    wl = sc.so_wavelengths()[idx]
    pos = sc.TOMO2D_WF_POSITIONS
    runs = {}
    for dtype in ("float32", "float64"):
        jax.config.update("jax_enable_x64", dtype == "float64")
        config, geometry, viewing, atmo = sc.tomo2d_case(sk, dtype, wl)
        t0 = time.perf_counter()
        engine = sk.Engine(config, geometry, viewing)
        print(f"tomo2d: JAX engine constructor (2D trace) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out = engine.calculate_radiance(atmo)
        print(f"tomo2d: JAX {dtype} engine call on the CPU (compile "
              f"included): {time.perf_counter() - t0:.1f} s", flush=True)
        runs[dtype] = {}
        for k in out.keys():
            if k in ("radiance", "los_optical_depth"):
                runs[dtype][k] = out[k].to_numpy()
            elif k.startswith("wf_"):
                ax = out[k].dims.index("wavelength")
                runs[dtype][k] = np.take(out[k].to_numpy(), pos, axis=ax)
    out = {"indices": idx, "wavelengths_nm": wl, "wf_positions": pos,
           **runs["float64"]}
    for key, ref in runs["float64"].items():
        out[f"jax_f32_err_{key}"] = sc.golden_error(
            key, runs["float32"][key], ref)
    return out


def record_test_goldens(modules=None):
    """Run the port's CPU tests in record mode (``tests/torch_support.py``):
    every ``jax_reference`` computes its JAX side, and each test module's
    references go to ``golden_<module>.npz``. The tests' port side runs
    and is checked as usual."""
    import pytest

    from tests import torch_support

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ[torch_support.RECORD_ENV] = "1"
    files = [os.path.join(root, "tests", f"{m}.py")
             for m in (modules or TEST_MODULES)]
    rc = pytest.main([*files, "-q", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "-p", "no:xdist"])
    if rc != 0:
        raise SystemExit(f"the port's tests failed in record mode: {rc}")
    for module, trees in sorted(torch_support.RECORDED.items()):
        torch_support.write(module, trees)
        print(f"    {torch_support.path(module)}: {len(trees)} references")


# the test modules whose JAX side the tier-1 run reads from golden files
TEST_MODULES = (
    "test_torch_brdf",
    "test_torch_constituents2d",
    "test_torch_engine",
    "test_torch_flux",
    "test_torch_generic",
    "test_torch_geometry2d",
    "test_torch_host_data",
    "test_torch_kernels",
    "test_torch_limb",
    "test_torch_lineemission",
    "test_torch_lineshape",
    "test_torch_mesh",
    "test_torch_mie",
    "test_torch_misc_constituents",
    "test_torch_nstream",
    "test_torch_photchem",
    "test_torch_polarized",
    "test_torch_polarized_engine",
    "test_torch_scatterer",
    "test_torch_singlescatter",
    "test_torch_spectral_grid",
    "test_torch_successive",
    "test_torch_successive_engine",
    "test_torch_test_util",
    "test_torch_thermal",
    "test_torch_thomas48",
    "test_torch_twostream",
    "test_torch_viewinggeo_containers",
    "test_torch_web_database",
)


if __name__ == "__main__":
    main()
