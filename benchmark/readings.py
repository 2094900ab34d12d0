"""The readings that the check's limits are set from, in one process.

    python3 benchmark/readings.py --workload <name> --seeds 101-112 \
        --control-seeds 201-203 [--seconds 3] [--out FILE]

For each program seed: the cell's state from that seed, a closed-loop
window of at least ``--seconds`` and of at least the calls the check
compares, and the check's numbers against the float64 reference (the
program's lower readings). For each control seed the same window run by
the program on its own path in the precision below the configuration's
(float32 for float64; TF32 matrix products for float32 with TF32 off):
the control's readings; beside it the reference itself computed in that
precision on the calls the check would compare. One engine per precision
serves every seed, as the set-up of a run builds one. Each reading is one
JSON line on standard output and in ``--out``, with every checked
radiance's wavelength, absorber and Rayleigh optical depths and relative
error.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import numpy as np  # noqa: E402

import core  # noqa: E402
import scene  # noqa: E402
import system  # noqa: E402


def seeds(spec):
    """"101-112" or "5,9,13" -> a list of ints."""
    out = []
    for part in spec.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def lane_table(got, ref, lanes, state):
    """Per checked radiance: wavelength, the column optical depths of the
    absorber and of Rayleigh scattering, and the relative error."""
    from reference.plain.optics import rayleigh_bates

    z = state.altitudes_m
    n_air = lanes["pressure_pa"] / lanes["temperature_k"] / 1.380649e-23
    xs_a = np.interp(lanes["wavelength_nm"], *lanes["xs_table"])
    xs_r, _ = rayleigh_bates(lanes["wavelength_nm"])
    dz = np.diff(z)

    def column(f):
        return np.sum(0.5 * (f[:, 1:] + f[:, :-1]) * dz, axis=1)

    tau_a = column(lanes["vmr"] * n_air) * xs_a
    tau_r = column(n_air) * xs_r
    rel = np.abs(got["radiance"] - ref["radiance"]) / np.abs(ref["radiance"])
    return [[float(lanes["wavelength_nm"][i]), float(tau_a[i]), float(tau_r[i]),
             [float(x) for x in rel[i]]] for i in range(rel.shape[0])]


def lower_precision(config):
    """(dtype, tf32) of the control: the precision below the
    configuration's."""
    if config["solver"]["dtype"] == "float64":
        return "float32", False
    return "float32", True


def control_numbers(cell, state, seed, device):
    """The numbers of the reference computed in the control's precision,
    on the lanes the check would compare in a run of ``check.calls``
    calls with this seed."""
    import torch

    n = cell.traffic["check"]["calls"]
    picks = []
    for i in scene.check_calls(cell.traffic, seed, n):
        vmr, albedo = scene.call_inputs(state, cell.traffic, seed, i)
        picks += [(w, vmr, albedo)
                  for w in scene.check_wavelengths(cell.traffic, seed, i, state)]
    lanes = scene.lanes(state, picks)
    ref_mod = core.reference_module(cell.entry["config"])
    jac = cell.traffic["jacobians"]
    ref = ref_mod.reference(cell.config, lanes, dtype=torch.float64,
                            device=device, jacobians=jac)
    dtype, tf32 = lower_precision(cell.config)
    with tf32_products(tf32):
        ctl = ref_mod.reference(cell.config, lanes, dtype=getattr(torch, dtype),
                                device=device, jacobians=jac)
    return core.compare(ctl, ref), lane_table(ctl, ref, lanes, state)


class tf32_products:
    """TF32 in float32 matrix products on or off inside the block (the
    port turns it off at import)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        import torch

        b = torch.backends
        self.old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch

        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.old


def control_config(config):
    """The configuration as the program's control path runs it."""
    dtype, _ = lower_precision(config)
    return {**config, "solver": {**config["solver"], "dtype": dtype}}


def program_numbers(cell, engine, cfg, geometry, seed, seconds, device,
                    tf32=False):
    """The check's numbers of a short window of ``engine`` on this seed;
    with ``tf32`` its float32 matrix products run in TF32."""
    import sasktran2_tpu_torch as sk

    state = scene.make_state(cell.config, cell.traffic, seed)
    atmo = system.build_atmosphere(sk, cfg, geometry, state,
                                   bool(cell.traffic["jacobians"]))
    with tf32_products(tf32):
        kept, calls, failed = core.run_window(
            engine, atmo, state, cell, seed, seconds,
            min_calls=cell.traffic["check"]["calls"])[:3]
    if failed:
        return {"failed": failed}, calls, []
    del atmo
    got, ref, lanes, _ = core.check_answers(cell, state, kept, seed, device)
    return core.compare(got, ref), calls, lane_table(got, ref, lanes, state)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    import sasktran2_tpu_torch as sk

    cell = core.resolve(core.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                        args.workload)
    card = (core.card_info(torch) if args.device.startswith("cuda")
            else {"platform": "cpu"})
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row.update({"workload": args.workload, "card": card})
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = [("program", s) for s in seeds(args.seeds)]
    runs += [("control_program", s) for s in seeds(args.control_seeds)]
    built = {}
    for kind, seed in runs:
        control = kind != "program"
        if kind not in built:
            built.clear()
            config = control_config(cell.config) if control else cell.config
            built[kind] = system.build_engine(sk, config, args.device)
        engine, cfg, geometry = built[kind]
        tf32 = control and lower_precision(cell.config)[1]
        t = time.perf_counter()
        numbers, calls, table = program_numbers(
            cell, engine, cfg, geometry, seed, args.seconds, args.device, tf32)
        emit({"kind": kind, "seed": seed, "calls": calls, "numbers": numbers,
              "lanes": table, "seconds": time.perf_counter() - t})
    built.clear()
    for seed in seeds(args.control_seeds):
        state = scene.make_state(cell.config, cell.traffic, seed)
        t = time.perf_counter()
        numbers, table = control_numbers(cell, state, seed, args.device)
        emit({"kind": "control_reference", "seed": seed, "numbers": numbers,
              "lanes": table, "seconds": time.perf_counter() - t})
    if out:
        out.close()
    foreign = core.foreign_modules()
    if foreign:
        print(f"modules of JAX or the JAX package loaded: {foreign}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
