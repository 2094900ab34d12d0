#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sasktran2_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero before the
final line:

0. The card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions. Requires ``torch.cuda.is_available()``.
1. Builds both CUDA kernels from ``sasktran2_tpu_torch/csrc`` with nvcc,
   one nvcc process per source, started together.
2. Thomas kernel (f32 and f64) against its plain PyTorch twin and an f64
   truth, at the engine's shape and at the JAX package's test shapes, and
   the autograd backward (which launches the kernel) against the plain
   twin's autograd.
3. Jacobi kernel (f32 and f64) against numpy ``eigvalsh``, the
   eigen-residual, the orthogonality of V, and the plain twin; and the
   time of ``torch.linalg.eigh`` on the same matrices as one contiguous
   [P*W, 8, 8] batch, the one PyTorch call that computes the same
   function (timed here only; the port never calls it), on its cuSOLVER
   route in the fewest calls cuSOLVER accepts, and through MAGMA as a
   note.
4. The port's ground-viewing engine end to end: 16 streams, P = 100
   layers, 4 rays, W = 1024 wavelengths, float32, full Jacobians, through
   ``Engine.calculate_radiance`` of an engine built with no ``device``
   (so on ``cuda``). Launch counts of both kernels must be > 0, and
   neither ``jax`` nor any ``sasktran2_tpu`` module may be loaded; values
   must be finite, radiance > 0, and radiance and ``wf_*`` must match the
   JAX float64 golden values at 8 wavelengths. The same case in float64
   at those 8 wavelengths must match them to 1e-8.
5. Times: the median of 5 warm engine calls (wavelengths/s, with and
   without Jacobians) and each kernel beside its plain twin at the
   engine's shapes, with its launches per call, its bound (the larger of
   the bytes it must move over 3.35 TB/s and its FP32 operations over
   67 TFLOP/s, the H100 SXM's published peaks) and the share of that
   bound it reaches.
6. The 16-stream spherical limb scan (``scenarios.limb_case``: 20 limb
   rays, exact single scatter, DO multiple scatter on a 2-point solar
   zenith grid, W = 1024, float32, full Jacobians) with the checks of
   phase 4 against ``golden_limb16.npz``, both kernels' launch counts of
   its call, and the median of 3 warm calls with and without Jacobians,
   as wavelengths/s and wavelength-lines-of-sight/s.
7. The two-stream solver (``scenarios.twostream_case``, W = 1024) with
   the same checks against ``golden_2str.npz`` and the same times; it
   has no kernel. The check that no ``jax`` or ``sasktran2_tpu`` module
   is loaded is made again before the kernel record, whose launch counts
   are phase 4's.

The line before the last is the kernel record as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def thomas_bound(P, K, W, itemsize):
    """lo, di, up and r read once, x written once; per (layer, lane) the
    carry products 2K^3 + 2K^2, the Gauss-Jordan sweep K (2K+1)(2K-1) and
    the back substitution 2K^2 FLOPs."""
    nbytes = (3 * P * K * K * W + 2 * P * K * W) * itemsize
    flops = P * W * (2 * K**3 + 4 * K * K + K * (2 * K + 1) * (2 * K - 1))
    return bound(nbytes, flops)


def jacobi_bound(P, n, W, sweeps, itemsize):
    """a read once, w and v written once; per matrix, sweep and each of the
    n-1 rounds the least FP32 work of A <- J^T A J and V <- V J with the n/2
    disjoint rotations of the round: n/2 rotation angles (12 FLOPs each:
    the half-angle tangent's difference, doubling, two-term norm, sqrt,
    sum, divide, 1 + t^2, rsqrt and s = t c); the (n/2)(n/2-1)/2 2x2
    blocks of A's upper triangle that lie off the diagonal, each a column
    and a row rotation of four two-term sums (24 FLOPs); the n/2 diagonal
    blocks in closed form, a_pp - t a_pq and a_qq + t a_pq (4 FLOPs); and
    V's n^2 two-term sums (3 FLOPs each). No symmetrization: the input is
    symmetric and A stays so."""
    nbytes = (2 * P * n * n * W + P * n * W) * itemsize
    h = n // 2
    per_round = 12 * h + 12 * h * (h - 1) + 4 * h + 3 * n * n
    return bound(nbytes, P * W * sweeps * (n - 1) * per_round)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def check_no_jax(label):
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "sasktran2_tpu"))
    print(f"[{label}] jax or sasktran2_tpu modules loaded: {foreign}",
          flush=True)
    check(not foreign, "the port loaded jax or the JAX package")


def card_label():
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi did not answer: {e}")
    return line


def ptxas_summary(log_path):
    """One line per kernel instantiation from nvcc's -Xptxas -v report:
    registers, stack and spills."""
    out, name, frame = [], None, ""
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"([a-z]+_kernel)I([fd])((?:L[ib]\d+E)+)E", ln)
            if "Compiling entry function" in ln and m:
                dtype = "float" if m.group(2) == "f" else "double"
                args = re.findall(r"L[ib](\d+)E", m.group(3))
                name = f"{m.group(1)}<{', '.join([dtype, *args])}>"
            elif "stack frame" in ln and name:
                frame = ln.strip()
            elif "Used" in ln and name:
                used = ln.split(":", 1)[1].strip()
                out.append(f"{name}: {used}; {frame}")
                name = None
    return out


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of ``fn`` in ms over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def thomas_inputs(P, K, W, seed, dtype, dev, shift=5.0):
    """Random block-tridiagonal systems as ``tests/test_pallas_thomas.py``
    makes them: N(0, 0.3^2) off-diagonal blocks, N(0, 1) + ``shift`` I
    diagonal blocks."""
    import torch

    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    di = rng.normal(size=(P, K, K, W)) + shift * np.eye(K)[:, :, None]
    r = rng.normal(size=(P, K, W))
    return [torch.as_tensor(t, dtype=dtype, device=dev) for t in (lo, di, up, r)]


def phase_thomas(dev, label):
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda
    from sasktran2_tpu_torch.ops.lanes import lane_block_thomas_solve

    f32, f64 = torch.float32, torch.float64
    record = {}
    # the JAX package's test shapes use its diagonal shift of 5; among the
    # 10^5 blocks of the engine-sized cases some N(0, 1) + 5 I blocks are
    # near-singular for K >= 16, so those get 5 + 2 sqrt(K)
    for P, K, W, shift in [(100, 16, 1024, 13.0), (8, 24, 300, 14.8),
                           (7, 4, 8, 5.0), (13, 16, 130, 5.0),
                           (5, 6, 128, 5.0)]:
        a64 = thomas_inputs(P, K, W, 1 + P + K, f64, dev, shift)
        a32 = [t.to(f32) for t in a64]
        truth = thomas_cuda.thomas_solve_plain(*a64)
        k64 = thomas_cuda.thomas_solve(*a64)
        k32 = thomas_cuda.thomas_solve(*a32).double()
        p32 = thomas_cuda.thomas_solve_plain(*a32).double()
        torch.cuda.synchronize()
        err_k = float((k32 - truth).abs().max())
        err_p = float((p32 - truth).abs().max())
        rel64 = float((k64 - truth).abs().max() / truth.abs().max())
        kp = float((k32 - p32).abs().max())
        print(f"[{label}] thomas P={P} K={K} W={W}: f32 kernel err "
              f"{err_k:.3e} vs plain-f32 err {err_p:.3e} "
              f"(<= max(4*plain, 1e-5)); "
              f"|kernel-plain| f32 {kp:.3e}; f64 kernel vs plain rel "
              f"{rel64:.3e} (<= 1e-10)", flush=True)
        check(err_k <= max(4.0 * err_p, 1e-5), f"thomas f32 P={P} K={K} W={W}")
        check(rel64 <= 1e-10, f"thomas f64 P={P} K={K} W={W}")
        if (P, K, W) == (100, 16, 1024):
            record["max_abs_err"] = kp

    # autograd: the Function's backward runs the kernel on the transposed
    # system; compare with autograd through the plain loop, in f64
    lo, di, up, r = thomas_inputs(13, 16, 130, 7, f64, dev)
    g = torch.as_tensor(np.random.default_rng(8).normal(size=r.shape),
                        dtype=f64, device=dev)
    ins_k = [t.clone().requires_grad_(True) for t in (lo, di, up, r)]
    ins_p = [t.clone().requires_grad_(True) for t in (lo, di, up, r)]
    before = thomas_cuda.thomas_solve.launches
    (lane_block_thomas_solve(*ins_k) * g).sum().backward()
    launched = thomas_cuda.thomas_solve.launches - before
    (thomas_cuda.thomas_solve_plain(*ins_p) * g).sum().backward()
    gerr = max(
        float((a.grad - b.grad).abs().max() / b.grad.abs().max())
        for a, b in zip(ins_k, ins_p)
    )
    print(f"[{label}] thomas autograd (13,16,130) f64: grad rel err "
          f"{gerr:.3e} (<= 1e-9), kernel launches {launched} (fwd + bwd)",
          flush=True)
    check(gerr <= 1e-9 and launched == 2, "thomas autograd")

    a32 = [t.to(f32) for t in thomas_inputs(100, 16, 1024, 3, f64, dev, 13.0)]
    record["ms"] = cuda_ms(lambda: thomas_cuda.thomas_solve(*a32), 20)
    record["plain_ms"] = cuda_ms(
        lambda: thomas_cuda.thomas_solve_plain(*a32), 3)
    record["bound_ms"], record["bound_by"] = thomas_bound(100, 16, 1024, 4)
    # no single PyTorch call solves the block-tridiagonal system: a dense
    # torch.linalg.solve of the assembled [1024, 1600, 1600] system gives
    # the same x at about 10^4 times the work and 10 GB
    record["library_ms"] = None
    return record


def phase_jacobi(dev, label):
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda

    f32, f64 = torch.float32, torch.float64
    record = {}
    for P, n, W in [(2, 2, 130), (2, 8, 130), (2, 16, 128), (2, 24, 130),
                    (2, 32, 128), (100, 8, 1024)]:
        # the reference's 7 f32 sweeps converge random matrices up to
        # n = 16; at n = 24 and 32 they need 10
        sweeps = 7 if n <= 16 else 10
        rng = np.random.default_rng(P + n)
        a = rng.normal(size=(P, n, n, W))
        sym64 = 0.5 * (a + np.swapaxes(a, -3, -2))
        sym32 = sym64.astype(np.float32)
        t32 = torch.as_tensor(sym32, device=dev)
        w, v = jacobi_cuda.jacobi_eigh(t32, sweeps)
        wp, vp = jacobi_cuda.jacobi_eigh_plain(t32, sweeps)
        w64, v64 = jacobi_cuda.jacobi_eigh(
            torch.as_tensor(sym64, device=dev), 10)
        wp64, _ = jacobi_cuda.jacobi_eigh_plain(
            torch.as_tensor(sym64, device=dev), 10)
        torch.cuda.synchronize()
        w, v = w.cpu().numpy(), v.cpu().numpy()
        av = np.einsum("pijw,pjaw->piaw", sym32.astype(np.float64), v)
        res = float(np.max(np.abs(av - w[:, None] * v)))
        orth = float(np.max(np.abs(
            np.einsum("pjaw,pjbw->pabw", v, v) - np.eye(n)[None, :, :, None]
        )))
        ev_err = 0.0
        for p in range(P):
            for lane in range(0, W, max(1, W // 5)):
                expect = np.linalg.eigvalsh(sym32[p, :, :, lane].astype(np.float64))
                got = np.sort(w[p, :, lane])
                ev_err = max(ev_err, float(np.max(
                    np.abs(got - expect) / (2e-5 + 2e-5 * np.abs(expect))
                )))
        kp = float((torch.as_tensor(w) - wp.cpu()).abs().max())
        rel64 = float((w64 - wp64).abs().max() / wp64.abs().max())
        print(f"[{label}] jacobi P={P} n={n} W={W} sweeps={sweeps}: f32 "
              f"|AV-VL| {res:.3e} (<= 5e-4), |V^T V - I| {orth:.3e} "
              f"(<= 5e-4), eigvalsh err / (2e-5 + 2e-5|l|) {ev_err:.3f} "
              f"(<= 1), |kernel-plain| eigvals f32 {kp:.3e}; f64 kernel vs "
              f"plain eigvals rel {rel64:.3e} (<= 1e-10)", flush=True)
        check(res <= 5e-4 and orth <= 5e-4 and ev_err <= 1.0,
              f"jacobi f32 n={n}")
        check(rel64 <= 1e-10, f"jacobi f64 n={n}")
        if (P, n, W) == (100, 8, 1024):
            record["max_abs_err"] = kp
            record["ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh(t32, 7), 20)
            record["plain_ms"] = cuda_ms(
                lambda: jacobi_cuda.jacobi_eigh_plain(t32, 7), 3)
            record["bound_ms"], record["bound_by"] = jacobi_bound(
                P, n, W, 7, 4)
            batch = t32.permute(0, 3, 1, 2).reshape(P * W, n, n).contiguous()
            record["library_ms"] = library_eigh_ms(batch, label)
    return record


def library_eigh_ms(batch, label):
    """Time of ``torch.linalg.eigh`` over the whole of ``batch`` on its
    cuSOLVER route, in as few calls as cuSOLVER takes: where it refuses
    the whole batch, in consecutive chunks of the largest size it accepts,
    found by halving. MAGMA's one call on the whole batch is printed as a
    note. None where cuSOLVER accepts no chunk."""
    import torch

    n_mat = batch.shape[0]
    chunk = n_mat
    try:
        torch.backends.cuda.preferred_linalg_library("cusolver")
        while chunk >= 1:
            try:
                torch.linalg.eigh(batch[:chunk])
                torch.cuda.synchronize()
                break
            except RuntimeError as e:
                print(f"[{label}] torch.linalg.eigh, cuSOLVER route, refused "
                      f"{chunk} matrices: {str(e).splitlines()[0][:120]}",
                      flush=True)
                chunk //= 2
        ms = None
        if chunk >= 1:
            parts = list(batch.split(chunk))
            ms = cuda_ms(lambda: [torch.linalg.eigh(b) for b in parts], 5)
            print(f"[{label}] torch.linalg.eigh {tuple(batch.shape)} f32, "
                  f"cuSOLVER route, {len(parts)} call(s) of <= {chunk} "
                  f"matrices: {ms:.3f} ms for the whole batch", flush=True)
        torch.backends.cuda.preferred_linalg_library("magma")
        magma = cuda_ms(lambda: torch.linalg.eigh(batch), 2)
        print(f"[{label}] note: torch.linalg.eigh {tuple(batch.shape)} f32 "
              f"through MAGMA (a hybrid host and device route), one call: "
              f"{magma:.3f} ms", flush=True)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    return ms


def compare_golden(out, golden, idx, rad_tol, wf_tol, what, label,
                   f32=False):
    """Max relative differences against the JAX float64 golden values:
    radiance per element, each wf_* against its largest magnitude. For a
    float32 run (``f32``) the JAX package's own float32 error on the same
    case (``jax_f32_err_<name>`` in the golden file, from
    ``tools/make_torch_golden.py``) is printed beside each, for
    reference."""
    rad = out["radiance"].to_numpy()[idx]
    ref = golden["radiance"]
    errs = {"radiance": float(np.max(np.abs(rad - ref) / np.abs(ref)))}
    for name in golden.files:
        if not name.startswith("wf_"):
            continue
        got = out[name].to_numpy()
        ax = out[name].dims.index("wavelength")
        got = np.take(got, idx, axis=ax)
        ref_wf = golden[name]
        errs[name] = float(
            np.max(np.abs(got - ref_wf)) / np.max(np.abs(ref_wf))
        )
    tols = {k: rad_tol if k == "radiance" else wf_tol for k in errs}

    def note(name):
        if not f32:
            return ""
        return f", JAX f32 {float(golden[f'jax_f32_err_{name}']):.3e}"

    print(f"[{label}] {what} vs JAX f64 golden at {len(idx)} wavelengths "
          "(radiance max rel per element, wf_* rel to their max): "
          + ", ".join(f"{k} {v:.3e} (<= {tols[k]:g}{note(k)})"
                      for k, v in errs.items()), flush=True)
    for k, v in errs.items():
        check(v <= tols[k], f"{what}: {k} vs golden")


def timed_calls(engine, atmo, reps):
    """Wall times of ``reps`` warm engine calls, each ending in a device
    synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.calculate_radiance(atmo)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def engine_case(sk, build, golden_path, wl, reps, what, label,
                kernels_expected):
    """One engine case of ``sasktran2_tpu_torch.scenarios`` end to end on
    the card: the cold call in float32 with Jacobians through an engine
    built with no device (so on ``cuda``), with the launches of both
    kernels counted from zero and the peak device memory; finite outputs,
    radiance > 0, and the golden checks (f32 radiance per element within
    2e-3, each ``wf_*`` within 5e-2 of its largest magnitude; the same case
    in float64 at the 8 golden wavelengths within 1e-8); then the median
    of ``reps`` warm calls with and without Jacobians, as wavelengths/s
    and wavelength-lines-of-sight/s. Returns the launch counts."""
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda, thomas_cuda
    from sasktran2_tpu_torch.scenarios import GOLDEN_INDICES

    W = len(wl)
    config, geometry, viewing, atmo = build(sk, "float32", wl)
    engine = sk.Engine(config, geometry, viewing)  # no device: the card
    check(engine._device.type == "cuda", "the engine did not default to cuda")
    nlos = len(viewing.observer_rays)
    print(f"[{label}] {what}: engine device {engine._device}; ray tracer: "
          f"{engine.ray_tracer}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    thomas_cuda.thomas_solve.launches = 0
    jacobi_cuda.jacobi_eigh.launches = 0
    t0 = time.perf_counter()
    out = engine.calculate_radiance(atmo)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {
        "thomas": thomas_cuda.thomas_solve.launches,
        "jacobi": jacobi_cuda.jacobi_eigh.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] {what} W={W} f32 with Jacobians: first call "
          f"{first_s:.2f} s, kernel launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if kernels_expected:
        check(launches["thomas"] > 0 and launches["jacobi"] > 0,
              f"{what}: a kernel of the path was not launched")
    check_no_jax(label)
    rad = out["radiance"].to_numpy()
    wf_names = [k for k in out.keys() if k.startswith("wf_")]
    check(rad.shape == (W, nlos, 1), f"{what}: radiance shape {rad.shape}")
    finite = np.isfinite(rad).all() and all(
        np.isfinite(out[k].to_numpy()).all() for k in wf_names)
    print(f"[{label}] {what}: radiance and {wf_names} finite: "
          f"{bool(finite)}; radiance > 0: {bool((rad > 0).all())}",
          flush=True)
    check(finite and (rad > 0).all(), f"{what}: non-finite or non-positive "
          "output")
    golden = np.load(golden_path)
    check(np.allclose(golden["wavelengths_nm"], wl[GOLDEN_INDICES]),
          f"{what}: golden file is for another wavelength grid")
    compare_golden(out, golden, GOLDEN_INDICES, 2e-3, 5e-2,
                   f"{what} f32 W={W}", label, f32=True)
    config64, geometry64, viewing64, atmo64 = build(
        sk, "float64", wl[GOLDEN_INDICES])
    out64 = sk.Engine(config64, geometry64, viewing64, device="cuda:0")\
        .calculate_radiance(atmo64)
    compare_golden(out64, golden, np.arange(len(GOLDEN_INDICES)), 1e-8, 1e-8,
                   f"{what} f64 W={len(GOLDEN_INDICES)}", label)

    times = timed_calls(engine, atmo, reps)
    med = statistics.median(times)
    print(f"[{label}] {what} warm calls (s): {[round(t, 4) for t in times]}; "
          f"median {med:.4f} s = {W / med:.1f} wavelengths/s = "
          f"{W * nlos / med:.1f} wavelength-LOS/s (f32, full Jacobians)",
          flush=True)
    atmo.calculate_derivatives = False
    times = timed_calls(engine, atmo, reps)
    med = statistics.median(times)
    print(f"[{label}] {what} radiance only (s): "
          f"{[round(t, 4) for t in times]}; median {med:.4f} s = "
          f"{W / med:.1f} wavelengths/s = {W * nlos / med:.1f} "
          "wavelength-LOS/s", flush=True)
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import sasktran2_tpu_torch as sk
        from sasktran2_tpu_torch.ops import _build
        from sasktran2_tpu_torch.scenarios import (
            GOLDEN_2STR_PATH,
            GOLDEN_LIMB_PATH,
            GOLDEN_PATH,
            limb_case,
            smoke_case,
            smoke_wavelengths,
            twostream_case,
        )
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    # --- phase 0: the card -------------------------------------------------
    label = card_label()
    dev = torch.device("cuda:0")
    print(label, flush=True)
    print(f"[{label}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # --- phase 1: build, one nvcc per source, all started together ----------
    t0 = time.perf_counter()
    names = ("thomas", "jacobi")
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            paths = list(pool.map(_build.build, names))
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    dt = time.perf_counter() - t0
    for name, path in zip(names, paths):
        print(f"[{label}] built {name}: {os.path.relpath(path, HERE)} "
              f"({dt:.1f} s for both)", flush=True)
        for ln in ptxas_summary(path[:-3] + ".log"):
            print(f"[{label}]     ptxas {ln}")

    # --- phases 2, 3: kernels against their plain twins ----------------------
    thomas_rec = phase_thomas(dev, label)
    jacobi_rec = phase_jacobi(dev, label)

    # --- phases 4, 5: the ground-viewing engine end to end, and times ---------
    wl = smoke_wavelengths()
    launches = engine_case(
        sk, smoke_case, GOLDEN_PATH, wl, 5, "engine nstr=16 P=100 nlos=4",
        label, kernels_expected=True,
    )

    for name, rec in (("thomas", thomas_rec), ("jacobi", jacobi_rec)):
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.3f} ms")
        print(f"[{label}] {name} kernel {rec['ms']:.3f} ms per launch, "
              f"{launches[name]} launches per call; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share of "
              f"bound {rec['bound_ms'] / rec['ms']:.3f}; plain "
              f"{rec['plain_ms']:.3f} ms; library call {lib}; at the "
              f"engine's shape, f32", flush=True)

    # --- phase 6: the 16-stream limb scan --------------------------------------
    limb_launches = engine_case(
        sk, limb_case, GOLDEN_LIMB_PATH, wl, 3, "limb nstr=16 P=100 nlos=20",
        label, kernels_expected=True,
    )
    print(f"[{label}] limb scan kernel launches per call with Jacobians: "
          f"{limb_launches}", flush=True)

    # --- phase 7: the two-stream solver ----------------------------------------
    engine_case(sk, twostream_case, GOLDEN_2STR_PATH, wl, 3,
                "two-stream P=100 nlos=1", label, kernels_expected=False)

    check_no_jax(label)
    kernels = [
        {"name": "thomas_block_tridiag_solve", "route": "cuda",
         "source": "sasktran2_tpu_torch/csrc/thomas.cu",
         "replaces": "sasktran2_tpu/ops/pallas_thomas.py:147",
         "launches": launches["thomas"], **thomas_rec},
        {"name": "jacobi_eigh", "route": "cuda",
         "source": "sasktran2_tpu_torch/csrc/jacobi.cu",
         "replaces": "sasktran2_tpu/ops/pallas_jacobi.py:130",
         "launches": launches["jacobi"], **jacobi_rec},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
