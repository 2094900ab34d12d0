"""Write the f64 JAX reference values that ``chip_smoke.py`` holds the
PyTorch port's engine runs against.

The cases are those of ``sasktran2_tpu_torch.scenarios``: the 16-stream
ground-viewing case (``smoke_case``), the 16-stream limb scan
(``limb_case``) and the two-stream case (``twostream_case``). Wavelengths
are independent in this model, so 8 wavelengths taken from the 1024-point
grid give the same values as the full grid. Runs the JAX engine on the
CPU in float64:

    python tools/make_torch_golden.py [--case nstr16|limb16|2str|all]

and writes ``sasktran2_tpu_torch/data/golden_<case>.npz`` with the
wavelength indices, the wavelengths, ``radiance`` and every ``wf_*``.

It also runs the same case through the JAX engine in float32 and stores
that run's own error against the float64 values, ``jax_f32_err_<name>``:
for ``radiance`` the largest relative error per element, for each
``wf_*`` the largest error relative to the variable's largest magnitude.
A float32 run of the port is held to the larger of its gate and that
error (``chip_smoke.py``): some weighting functions of these cases cannot
be computed to the gate in float32 by the reference either.
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

    cases = {
        "nstr16": (scenarios.smoke_case, scenarios.GOLDEN_PATH),
        "limb16": (scenarios.limb_case, scenarios.GOLDEN_LIMB_PATH),
        "2str": (scenarios.twostream_case, scenarios.GOLDEN_2STR_PATH),
    }
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--case", choices=[*cases, "all"], default="all")
    args = parser.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import sasktran2_tpu as sk

    def run(name, build, dtype):
        jax.config.update("jax_enable_x64", dtype == "float64")
        config, geometry, viewing, atmo = build(sk, dtype, wl)
        t0 = time.perf_counter()
        out = sk.Engine(config, geometry, viewing).calculate_radiance(atmo)
        print(f"{name}: JAX {dtype} engine call on the CPU (compile "
              f"included): {time.perf_counter() - t0:.1f} s")
        return {k: out[k].to_numpy() for k in out.keys()
                if k == "radiance" or k.startswith("wf_")}

    idx = scenarios.GOLDEN_INDICES
    wl = scenarios.smoke_wavelengths()[idx]
    for name, (build, path) in cases.items():
        if args.case not in (name, "all"):
            continue
        f32 = run(name, build, "float32")
        f64 = run(name, build, "float64")
        arrays = {"indices": idx, "wavelengths_nm": wl, **f64}
        for key, ref in f64.items():
            err = np.abs(f32[key] - ref)
            arrays[f"jax_f32_err_{key}"] = float(
                np.max(err / np.abs(ref)) if key == "radiance"
                else np.max(err) / np.max(np.abs(ref))
            )
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **arrays)
        for k, v in arrays.items():
            print(f"    {k} {np.shape(v) or v}")


if __name__ == "__main__":
    main()
