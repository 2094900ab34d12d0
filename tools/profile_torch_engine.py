"""Where the time goes in one of the PyTorch port's engine calls on a GPU.

    python tools/profile_torch_engine.py
        [--case ground|limb|2str|flux16|pol4|pol16|limbpol16|generic16|
                polbrdf4|polflux4|polthermallimb4|solimb16|solimb16_doinit|
                polsolimb16|o2a16|tomo2d]
        [--trace engine_trace.json] [--tree PATH] [--time N]

Builds the case of ``sasktran2_tpu_torch.scenarios`` (``ground``: the
16-stream ground-viewing ``smoke_case``, the default; ``limb``: the
16-stream limb scan ``limb_case``; ``2str``: ``twostream_case``;
``flux16``, ``pol4``, ``pol16``, ``limbpol16``: the flux and polarized
cases of the same names; the generic per-wavelength route's cells:
``generic16``, ``smoke_case`` with the engine's fast-path gates replaced
by ``lambda: False``, and ``polbrdf4``, ``polflux4``,
``polthermallimb4``, the last on the thermal cases' 4,000-15,000 nm grid;
the successive-orders cells ``solimb16``, ``solimb16_doinit`` and
``polsolimb16`` on their 64-wavelength grid; the optical cell ``o2a16``
on its 4,096 fine wavenumbers, EngineIntegratedLineShape, with its Mie
table generated on the card into a temporary directory first; the 2D
cell ``tomo2d`` on its 64 wavelengths) at W = 1024 in float32 on
``cuda:0``, warms up,
then profiles one ``calculate_radiance`` call with Jacobians and one
without under ``torch.profiler``. For each it prints the wall time, the
device time summed over kernels and copies, the device busy share (device
time / wall time), the number of device kernels, the launches of both
CUDA kernels (in all and per block size K or matrix order n), the
SO transport steps (``rt.successive.transport_step.calls``), the
block-Thomas solves that take the torch-op loop (K > 24: the polarized
16-stream BVP; ``ops.lanes.TORCH_OP_THOMAS_CALLS_BY_K``) with the sum of
the kernel time launched inside that loop and its share of the call's
device time, and the operators with the most self device time. Device
time is kernel and copy time: the ``record_function`` span on the
device's track is left out of every sum, since it also spans idle gaps. Then, without the profiler, one warm call with
and one without Jacobians give the Jacobian rows' share of the call, and
split it on the host clock (each part ending in a device synchronize):
the atmosphere's constituent pipeline (``internal_object``), the device
compute (``Engine._compute``: the forward model, the Jacobian rows and
the LOS optical depth), the WF assembly (``Engine._assemble_wfs``, numpy)
and the rest (the one host copy, validation, the output ``Dataset``).
Needs a GPU.

``--time N`` skips the profiler: after the cold call it times N warm
calls with Jacobians (host clock, each ending in a device synchronize)
and prints one JSON line with the times, their median and the
wavelengths/s. ``--tree PATH`` imports the port from another checkout of
the repo (an earlier commit unpacked with ``git archive``), so that two
trees can be timed in turns, in separate processes, within one call on
one card; the ground case exists in every tree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0
    )


TORCH_OP_THOMAS = "thomas_torch_op_loop"


def _annotation(e):
    # a record_function span on the device's track: it spans its kernels
    # and the idle gaps between them, so it is not kernel time
    return bool(getattr(e, "is_user_annotation", False))


def profile_call(engine, atmo, label, trace_path=None, top=15):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from sasktran2_tpu_torch.ops import jacobi_cuda, lanes, thomas_cuda
    from sasktran2_tpu_torch.rt import successive

    successive.transport_step.calls = 0
    thomas_cuda.thomas_solve.launches = 0
    thomas_cuda.thomas_solve.launches_by_k = {}
    jacobi_cuda.jacobi_eigh.launches = 0
    jacobi_cuda.jacobi_eigh.launches_by_n = {}
    lanes.TORCH_OP_THOMAS_CALLS_BY_K.clear()
    plain = thomas_cuda.thomas_solve_plain

    def annotated(*args):
        # the solver reaches the torch-op loop only for K > 24 on the card
        with record_function(TORCH_OP_THOMAS):
            return plain(*args)

    thomas_cuda.thomas_solve_plain = annotated
    torch.cuda.synchronize()
    try:
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            engine.calculate_radiance(atmo)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        thomas_cuda.thomas_solve_plain = plain
    events = prof.events()
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not _annotation(e)
    ]
    device_s = sum(e.device_time_total for e in kernels) / 1e6
    print(f"[{label}] wall {wall:.4f} s (profiler on), device time "
          f"{device_s:.4f} s (kernels and copies), device busy "
          f"{100 * device_s / wall:.1f}%, {len(kernels)} device "
          f"kernels/copies; Thomas launches "
          f"{thomas_cuda.thomas_solve.launches} "
          f"{thomas_cuda.thomas_solve.launches_by_k}, Jacobi launches "
          f"{jacobi_cuda.jacobi_eigh.launches} "
          f"{jacobi_cuda.jacobi_eigh.launches_by_n}, SO transport steps "
          f"{successive.transport_step.calls}", flush=True)
    loops = [e for e in events if e.name == TORCH_OP_THOMAS
             and e.device_type == torch.autograd.DeviceType.CPU]
    if loops:
        # the host-side range: its device time is the sum of the kernels
        # launched inside it
        host_ms = sum(e.cpu_time_total for e in loops) / 1e3
        kernel_s = sum(e.device_time_total for e in loops) / 1e6
        print(f"[{label}] block-Thomas through the torch-op loop (K > 24): "
              f"{dict(lanes.TORCH_OP_THOMAS_CALLS_BY_K)} solves per K; "
              f"kernel time inside the loop {kernel_s:.4f} s "
              f"({1e3 * kernel_s / len(loops):.3f} ms per solve), "
              f"{100 * kernel_s / device_s:.1f}% of the call's device time; "
              f"host {host_ms:.3f} ms in all", flush=True)
    averages = [e for e in prof.key_averages() if not _annotation(e)]
    rows = sorted(averages, key=_device_us, reverse=True)[:top]
    for e in rows:
        print(f"    {_device_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cases = {
        "ground": "smoke_case", "limb": "limb_case", "2str": "twostream_case",
        "flux16": "flux16_case", "pol4": "pol4_case", "pol16": "pol16_case",
        "limbpol16": "limbpol16_case", "generic16": "smoke_case",
        "polbrdf4": "polbrdf4_case", "polflux4": "polflux4_case",
        "polthermallimb4": "polthermallimb4_case",
        "solimb16": "solimb16_case", "solimb16_doinit": "solimb16_doinit_case",
        "polsolimb16": "polsolimb16_case", "o2a16": "o2a16_case",
        "tomo2d": "tomo2d_case",
    }
    parser.add_argument("--case", choices=list(cases), default="ground")
    parser.add_argument("--trace", default=None,
                        help="write the Jacobian call's chrome trace here")
    parser.add_argument("--tree", default=REPO,
                        help="checkout whose sasktran2_tpu_torch to import")
    parser.add_argument("--time", type=int, default=0, metavar="N",
                        help="time N warm calls instead of profiling")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_engine needs a GPU")
    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch import scenarios

    build = getattr(scenarios, cases[args.case])

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    grid = {"polthermallimb4": scenarios.thermal_wavelengths,
            "solimb16": scenarios.so_wavelengths,
            "solimb16_doinit": scenarios.so_wavelengths,
            "polsolimb16": scenarios.so_wavelengths,
            "tomo2d": scenarios.so_wavelengths}.get(
        args.case, scenarios.smoke_wavelengths)
    if args.case == "o2a16":
        import tempfile

        with tempfile.TemporaryDirectory() as root:
            table = scenarios.o2a16_mie_table(sk, root, device="cuda:0")
        config, geometry, viewing, atmo = build(
            sk, "float32", scenarios.O2A16_WAVENUMBERS, table,
            device="cuda:0")
    else:
        config, geometry, viewing, atmo = build(sk, "float32", grid())
    engine = sk.Engine(config, geometry, viewing, device="cuda:0")
    if args.case == "generic16":
        engine._twostream_fast_ok = lambda: False
    if args.time:
        engine.calculate_radiance(atmo)
        times = []
        for _ in range(args.time):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.calculate_radiance(atmo)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(json.dumps({
            "tree": os.path.abspath(args.tree), "case": args.case,
            "card": card, "times_s": times, "median_s": med,
            "wavelengths_per_s": atmo.num_wavelengths / med,
        }), flush=True)
        return
    engine.calculate_radiance(atmo)  # the cold call
    profile_call(engine, atmo, f"{card}] [{args.case} with Jacobians",
                 args.trace)
    atmo.calculate_derivatives = False
    engine.calculate_radiance(atmo)
    profile_call(engine, atmo, f"{card}] [{args.case} radiance only")
    walls, parts = {}, {}
    for jac in (True, False):
        atmo.calculate_derivatives = jac
        parts[jac] = {}
        timed_parts(engine, atmo, parts[jac])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            engine.calculate_radiance(atmo)
            torch.cuda.synchronize()
        finally:
            for obj, name in ((engine, "_compute"), (engine, "_assemble_wfs"),
                              (atmo, "internal_object")):
                vars(obj).pop(name, None)
        walls[jac] = time.perf_counter() - t0
    print(f"[{card}] [{args.case}] without the profiler: {walls[True]:.4f} s "
          f"with Jacobians, {walls[False]:.4f} s without; Jacobian rows' "
          f"share {(walls[True] - walls[False]) / walls[True]:.3f}",
          flush=True)
    for jac in (True, False):
        rest = walls[jac] - sum(parts[jac].values())
        print(f"[{card}] [{args.case}] {'with' if jac else 'without'} "
              "Jacobians, host clock: "
              + "; ".join(f"{k} {v:.4f} s" for k, v in parts[jac].items())
              + f"; rest {rest:.4f} s", flush=True)


def timed_parts(engine, atmo, parts):
    """Shadow the engine's ``_compute`` and ``_assemble_wfs`` and the
    atmosphere's ``internal_object`` with timed wrappers (instance
    attributes, which the caller removes): each adds its host-clock time,
    device synchronized, to ``parts``."""
    import torch

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    engine._compute = timed("device compute", engine._compute)
    engine._assemble_wfs = timed("WF assembly", engine._assemble_wfs)
    atmo.internal_object = timed("constituent pipeline", atmo.internal_object)


if __name__ == "__main__":
    main()
