"""Residuals of the finite-difference WF check, level by level, on the CPU.

    python tools/fd_residuals.py --package torch|jax [--stokes 1|3]
        [--wf extinction|ssa] [--levels 41] [--top-km 60] [--step 1e-3]

Runs ``test_util.wf.numeric_wf`` of the chosen package in float64 on
``sasktran2_tpu_torch.scenarios.fd16_case`` (16 streams, DO single and
multiple scatter, four ground-viewing rays, one wavelength) with the
altitude grid given, and prints the worst |analytic - numeric| over the
largest analytic magnitude along altitude (what ``validate_wf`` bounds by
1.5e-5 at decimal 5), in all and per level. ``chip_smoke.py`` phase 28
runs the same check on the card; this shows where the central difference
meets float64 roundoff (the top levels of a 0-100 km grid, whose
extinction is about 4e-11 / m): there a residual that grows tenfold
when ``--step`` shrinks tenfold is roundoff, not an analytic WF's error.
The JAX package's engine is compiled on the CPU (a few minutes at 16
streams); the port's runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("torch", "jax"),
                        required=True)
    parser.add_argument("--stokes", type=int, choices=(1, 3), default=1)
    parser.add_argument("--wf", choices=("extinction", "ssa"),
                        default="extinction")
    parser.add_argument("--levels", type=int, default=41)
    parser.add_argument("--top-km", type=float, default=60.0)
    parser.add_argument("--step", type=float,
                        default=None, help="fractional change (default "
                        "scenarios.FD_FRACTIONAL_CHANGE, 1e-3)")
    args = parser.parse_args()

    from sasktran2_tpu_torch import scenarios

    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import sasktran2_tpu as sk

        kw = {}
    else:
        import sasktran2_tpu_torch as sk

        kw = {"device": "cpu"}
    config, geometry, viewing, atmo = scenarios.fd16_case(
        sk, args.stokes, args.levels, top_m=args.top_km * 1e3)
    engine = sk.Engine(config, geometry, viewing, **kw)
    var = {"extinction": "total_extinction", "ssa": "ssa"}[args.wf]
    name = f"wf_{args.wf}"
    step = scenarios.FD_FRACTIONAL_CHANGE if args.step is None else args.step
    t0 = time.perf_counter()
    ds = sk.test_util.wf.numeric_wf(
        getattr(atmo.storage, var)[:, 0], step, engine, atmo, name)
    a = ds[name].to_numpy()
    n = ds[name + "_numeric"].to_numpy()
    ax = ds[name].dims.index("altitude")
    rel = np.abs(a - n) / np.abs(a).max(axis=ax, keepdims=True)
    per_level = np.moveaxis(rel, ax, 0).reshape(args.levels, -1).max(axis=1)
    print(f"{args.package} stokes={args.stokes} {name} {args.levels} levels "
          f"on 0-{args.top_km:g} km, step {step:g}: "
          f"{time.perf_counter() - t0:.1f} s; "
          f"worst {rel.max():.3e} (decimal 5: < 1.5e-5)")
    for alt, r in zip(geometry.altitudes(), per_level):
        print(f"  {alt / 1e3:7.2f} km  {r:.3e}")


if __name__ == "__main__":
    main()
