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
CUDA kernels (in all and per block size K or matrix order n; the
polarized 16-stream BVP is the Thomas kernel at K = 48), the SO transport
steps (``rt.successive.transport_step.calls``), and the operators with
the most self device time. Device time is kernel and copy time. Then
the port's own spans of the call (``sasktran2_tpu_torch.spans``, recorded
while the profiler runs, no synchronize): per span name, the count, the
host time and the self time (less the child spans'), and the Jacobian
rows' share of the call. Needs a GPU.

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


def profile_call(engine, atmo, label, trace_path=None, top=15):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sasktran2_tpu_torch import spans
    from sasktran2_tpu_torch.ops import jacobi_cuda, thomas_cuda
    from sasktran2_tpu_torch.rt import successive

    successive.transport_step.calls = 0
    thomas_cuda.thomas_solve.launches = 0
    thomas_cuda.thomas_solve.launches_by_k = {}
    jacobi_cuda.jacobi_eigh.launches = 0
    jacobi_cuda.jacobi_eigh.launches_by_n = {}
    torch.cuda.synchronize()
    spans.RECORDER.clear()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        engine.calculate_radiance(atmo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the spans' ranges show on the device's timeline too: left out
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation
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
    rows = sorted((e for e in prof.key_averages()
                   if not e.is_user_annotation),
                  key=_device_us, reverse=True)[:top]
    for e in rows:
        print(f"    {_device_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")
    print_spans(list(spans.RECORDER.spans), label)
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


def print_spans(recorded, label):
    """The port's spans of one call, by name: count, host seconds and self
    seconds (less the child spans'); and the rows' share of the call."""
    from sasktran2_tpu_torch.spans import totals

    by_name = totals(recorded)
    call = by_name.get("call", [0, 0.0])[1]
    rows = by_name.get("rows", [0, 0.0])[1]
    print(f"[{label}] spans (count, host s, self s); rows' share "
          f"{rows / call if call else 0.0:.3f}", flush=True)
    for name, (n, host, own) in by_name.items():
        print(f"    {name:<12s} x{n:<5d} {host:10.4f} {own:10.4f}")


if __name__ == "__main__":
    main()
