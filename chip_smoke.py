#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sasktran2_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero before the
final line:

0. The card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions. Requires ``torch.cuda.is_available()``.
1. Builds both CUDA kernels from ``sasktran2_tpu_torch/csrc`` with nvcc,
   one nvcc process per source, started together, and prints ptxas's
   registers and stack frame of every instantiation; the Jacobi kernel's
   shared-memory branch (8 < n <= 32) must have no stack frame.
2. Thomas kernel (f32 and f64) against its plain PyTorch twin and an f64
   truth, at the engine's shape and at the JAX package's test shapes, and
   the autograd backward (which launches the kernel) against the plain
   twin's autograd.
3. Jacobi kernel (f32 and f64, both branches: n <= 8 in registers,
   n = 12 to 32 in shared memory) against numpy ``eigvalsh``, the
   eigen-residual, the orthogonality of V, and the plain twin; repeated
   launches of the shared-memory branch, which must be bit-identical
   (evidence against races where no race detector runs); converged
   matrices whose pairs are in reversed order (off-diagonal 1e-30 in f32,
   1e-300 in f64), whose eigenvectors must stay orthonormal; and the
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
   bound it reaches; for K1 also ``torch.linalg.solve`` on the same
   systems assembled dense, [1024, 1600, 1600], in calls of 128.
6. The 16-stream spherical limb scan (``scenarios.limb_case``: 20 limb
   rays, exact single scatter, DO multiple scatter on a 2-point solar
   zenith grid, W = 1024, float32, full Jacobians) with the checks of
   phase 4 against ``golden_limb16.npz``, both kernels' launch counts of
   its call, and the median of 3 warm calls with and without Jacobians,
   as wavelengths/s and wavelength-lines-of-sight/s.
7. The two-stream solver (``scenarios.twostream_case``, W = 1024) with
   the same checks against ``golden_2str.npz`` and the same times; it
   has no kernel.
8. The kernel instances of the polarized path, each at a polarized
   engine's own inputs (captured in a radiance-only call): K3 at
   [100, 24, 24, 1024] (pol16) and [100, 6, 6, 1024] (pol4), K1/K2 at
   [100, 12, 12, 1024] (pol4), each against its plain twin and a float64
   truth, timed beside its bound (and ``torch.linalg.eigh`` for K3, the
   dense ``torch.linalg.solve`` of [1024, 1200, 1200] for K1); the
   eigen-residual of the engine's 7-sweep n = 24 eigensolves of every
   azimuth mode, which must be <= 1e-5 of max |A|; and the
   time of one K = 48 block-Thomas solve, which takes the torch-op loop
   as the reference takes its scan (no kernel at K > 24).
9. Flux observers (``scenarios.flux16_case``: 16 streams, one ray, six
   observers, all four flux types) with the checks of phase 4 against
   ``golden_flux16.npz``, the fluxes and their weighting functions
   included.
10. Polarized (I, Q, U) at 4 streams (``scenarios.pol4_case``) against
    ``golden_pol4.npz``.
11. Polarized at 16 streams (``scenarios.pol16_case``), which the JAX
    package cannot compile on the CPU: (a) the vector solver on the card
    against the JAX f64 solver on the same layers
    (``golden_pol16_solver.npz``); (b) the engine in float32 against the
    port's own float64 engine on the card; (c) I, Q, U and DOLP of a
    conservative Rayleigh slab at 16 against 8 streams.
12. The polarized 16-stream limb scan (``scenarios.limbpol16_case``)
    against the port's own float64 engine, as 11 (b).
13. The MODIS BRDF case (``scenarios.brdf16_case``: ``smoke_case`` over
    a BRDF, all 16 azimuth modes) with the checks of phase 4 against
    ``golden_brdf16.npz``; its Thomas launches per call must be at least
    16/3 of ground16's (phase 4), the count that every mode solved gives,
    which shows the azimuth-mode truncation was off.
14. The thermal infrared case with fluxes (``scenarios.thermal16_case``:
    4,000-15,000 nm, the sun off, DO emission, 4 rays and 6 observers)
    against ``golden_thermal16.npz``.
15. The thermal limb scan (``scenarios.thermallimb16_case``, 20 limb
    rays) against ``golden_thermallimb16.npz``.
16. generic16: ``smoke_case`` with the engine's fast-path gates replaced
    by ``lambda: False``, so the generic per-wavelength route solves it
    (``rt.disco.solve_plane_parallel``: the azimuth modes as a batch
    axis, K1 at K = 16 and K3 at n = 8 on the (mode x wavelength) batch),
    with the checks of phase 4 against the same ``golden_nstr16.npz``
    and its rate printed beside ground16's from this run.
17. polbrdf4: ``pol4_case`` over the MODIS BRDF (``polbrdf4_case``, all
    4 azimuth modes), against ``golden_polbrdf4.npz``.
18. polflux4: ``pol4_case`` with ``flux16_case``'s six observers and four
    flux types, against ``golden_polflux4.npz``: the rays and the m = 0
    vector flux solve on the generic route.
19. polthermallimb4: ``thermallimb16_case``'s atmosphere, wavelengths and
    20 limb rays polarized at 4 streams (``polthermallimb4_case``; the
    vector thermal source and ``ms_source_along_rays_vec``), against
    ``golden_polthermallimb4.npz``, with Q and U held to the largest |I|
    (the sun is off and Rayleigh scattering at 4-15 um polarizes only a
    trace).
Each of 17-19 must take the generic route by the engine's own gates, and
each of 16-19 must launch K1 and K3 at the sizes named.

Each engine case prints its launches per kernel instance, the peak device
memory, the warm-call times with and without Jacobians and the Jacobian
rows' share. The check that no ``jax`` or ``sasktran2_tpu`` module is
loaded is made again before the kernel record, which lists every kernel
instance with its launches in its own case (and in every case that
launched it) and, apart, the K = 48 torch-op path.

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
            m = re.search(r"([a-z_]+_kernel)I([fd])((?:L[ib]\d+E)+)E", ln)
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


def stack_frame_bytes(summary_line):
    """The stack frame in bytes from one line of ``ptxas_summary``."""
    m = re.search(r"(\d+) bytes stack frame", summary_line)
    return int(m.group(1)) if m else None


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
    record["library_ms"] = library_dense_solve_ms(a32, label)
    return record


def library_dense_solve_ms(system, label, chunk=128):
    """Time of ``torch.linalg.solve`` on the block-tridiagonal systems
    ``system`` = (lo, di, up, r) [P, K, K, W] assembled as dense
    [W, P*K, P*K] matrices, the one PyTorch call that computes the same x
    (at about P^2 times the Thomas solve's work): ``chunk`` wavelengths a
    call, the matrices of every chunk assembled before the clock starts.
    Prints the dense solution's largest difference from the Thomas
    kernel's relative to max |x|, as a note."""
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda

    lo, di, up, r = system
    P, K, _, W = di.shape
    idx = torch.arange(P, device=di.device)
    chunks = []
    for w0 in range(0, W, chunk):
        sl = slice(w0, min(w0 + chunk, W))
        C = sl.stop - sl.start
        dense = torch.zeros((C, P, K, P, K), dtype=di.dtype, device=di.device)
        dense[:, idx, :, idx, :] = di[..., sl].permute(0, 3, 1, 2)
        dense[:, idx[1:], :, idx[:-1], :] = lo[1:, ..., sl].permute(0, 3, 1, 2)
        dense[:, idx[:-1], :, idx[1:], :] = up[:-1, ..., sl].permute(0, 3, 1, 2)
        rhs = r[..., sl].permute(2, 0, 1).reshape(C, P * K, 1)
        chunks.append((dense.reshape(C, P * K, P * K), rhs))
    xs = [torch.linalg.solve(a, b) for a, b in chunks]
    x = torch.cat(xs).reshape(W, P, K).permute(1, 2, 0)
    xk = thomas_cuda.thomas_solve(*system)
    diff = float((x - xk).abs().max() / xk.abs().max())
    ms = cuda_ms(lambda: [torch.linalg.solve(a, b) for a, b in chunks], 1)
    print(f"[{label}] library call: torch.linalg.solve on the assembled "
          f"dense [{W}, {P * K}, {P * K}] systems ({di.dtype}, {len(chunks)} "
          f"calls of <= {chunk}): {ms:.3f} ms for the whole batch; its x vs "
          f"the Thomas kernel's, rel to max |x|: {diff:.3e} (a note)",
          flush=True)
    del chunks, xs
    torch.cuda.empty_cache()
    return ms


def phase_jacobi(dev, label):
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda

    f32, f64 = torch.float32, torch.float64
    record = {}
    for P, n, W in [(2, 2, 130), (2, 8, 130), (2, 12, 130), (2, 16, 128),
                    (2, 24, 130), (2, 32, 128), (100, 8, 1024)]:
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
        if n > jacobi_cuda.FIXED_N_MAX:
            # no race detector runs on this card: a race that depends on
            # timing would show as launches that disagree
            same = all(jacobi_repeats_identical(torch.as_tensor(x, device=dev),
                                                sweeps)
                       for x in (sym32, sym64))
            print(f"[{label}] jacobi P={P} n={n} W={W}: 5 launches each in "
                  f"f32 and f64 bit-identical: {same}", flush=True)
            check(same, f"jacobi n={n}: repeated launches differ")
        if (P, n, W) == (100, 8, 1024):
            record["max_abs_err"] = kp
            record["ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh(t32, 7), 20)
            record["plain_ms"] = cuda_ms(
                lambda: jacobi_cuda.jacobi_eigh_plain(t32, 7), 3)
            record["bound_ms"], record["bound_by"] = jacobi_bound(
                P, n, W, 7, 4)
            batch = t32.permute(0, 3, 1, 2).reshape(P * W, n, n).contiguous()
            record["library_ms"] = library_eigh_ms(batch, label)
    jacobi_reversed_pairs(dev, label)
    return record


def jacobi_reversed_pairs(dev, label):
    """K3 on converged matrices whose pairs are in reversed order:
    diagonal n, n-1, ..., 1 (a_qq < a_pp in every pair) and off-diagonal
    entries of 1e-30 (1e-300 in f64), where the rotation is a near-swap
    with |a_pq| / |a_qq - a_pp| below 1e-19. The eigenvectors must stay
    orthonormal (|V^T V - I| <= 1e-6) and the eigenvalues exact to 1e-6
    relative: a tangent t = (r - x) / y whose square overflows would give
    c = s = 0 and zero two eigenvectors."""
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda

    for dt, tiny in ((torch.float32, 1e-30), (torch.float64, 1e-300)):
        for n in (2, 6, 8, 12, 24):
            d = np.arange(n, 0, -1, dtype=np.float64)
            a = np.full((n, n), tiny) + np.diag(d - tiny)
            a = torch.as_tensor(np.broadcast_to(a[None, :, :, None],
                                                (2, n, n, 64)).copy(),
                                dtype=dt, device=dev)
            w, v = jacobi_cuda.jacobi_eigh(a, 7 if dt == torch.float32 else 10)
            w, v = w.double().cpu().numpy(), v.double().cpu().numpy()
            orth = float(np.max(np.abs(np.einsum("pjaw,pjbw->pabw", v, v)
                                       - np.eye(n)[None, :, :, None])))
            ev = float(np.max(np.abs(np.sort(w, axis=1)
                                     - np.sort(d)[None, :, None]) / n))
            ok = np.isfinite(orth) and orth <= 1e-6 and ev <= 1e-6
            print(f"[{label}] jacobi n={n} {dt} reversed converged pairs "
                  f"(off-diagonal {tiny:g}): |V^T V - I| {orth:.3e} "
                  f"(<= 1e-6), eigenvalues rel {ev:.3e} (<= 1e-6)",
                  flush=True)
            check(ok, f"jacobi n={n} {dt}: reversed converged pairs")


def jacobi_repeats_identical(a, sweeps, launches=5):
    """Whether ``launches`` launches of K3 on ``a`` give bit-identical
    eigenvalues and eigenvectors."""
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda

    w0, v0 = jacobi_cuda.jacobi_eigh(a, sweeps)
    same = True
    for _ in range(launches - 1):
        w, v = jacobi_cuda.jacobi_eigh(a, sweeps)
        same = same and torch.equal(w, w0) and torch.equal(v, v0)
    return same


def library_eigh_ms(batch, label, magma=True):
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
        if magma:
            torch.backends.cuda.preferred_linalg_library("magma")
            magma_ms = cuda_ms(lambda: torch.linalg.eigh(batch), 2)
            print(f"[{label}] note: torch.linalg.eigh {tuple(batch.shape)} "
                  f"f32 through MAGMA (a hybrid host and device route), one "
                  f"call: {magma_ms:.3f} ms", flush=True)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    return ms


def compare_golden(out, golden, idx, rad_tol, wf_tol, what, label,
                   f32=False, qu_scale="own"):
    """Errors against reference values (``golden``: a dict or an npz of
    the JAX float64 golden values, or the port's own float64 run), by
    ``scenarios.golden_error``: radiance and fluxes per element (the
    polarized Q and U relative to their largest magnitude), each ``wf_*``
    against its largest magnitude. For a float32 run (``f32``) the JAX
    package's own float32 error on the same case (``jax_f32_err_<name>``
    in the golden file, from ``tools/make_torch_golden.py``) is printed
    beside each where the file has it."""
    from sasktran2_tpu_torch.scenarios import golden_error

    names = [k for k in golden if k == "radiance" or k.startswith("wf_")
             or (k.endswith("_flux") and not k.startswith("jax_f32_err_"))]
    errs = {}
    for name in names:
        got = out[name].to_numpy()
        ax = out[name].dims.index("wavelength")
        errs[name] = golden_error(name, np.take(got, idx, axis=ax),
                                  golden[name], qu_scale=qu_scale)
    tols = {k: wf_tol if k.startswith("wf_") else rad_tol for k in errs}

    def note(name):
        key = f"jax_f32_err_{name}"
        if not f32 or key not in golden:
            return ""
        return f", JAX f32 {float(golden[key]):.3e}"

    qu = "their max" if qu_scale == "own" else "the max of |I|"
    print(f"[{label}] {what} vs reference at {len(idx)} wavelengths "
          f"(radiance and fluxes max rel per element, polarized Q, U rel to "
          f"{qu}, wf_* rel to their max): "
          + ", ".join(f"{k} {v:.3e} (<= {tols[k]:g}{note(k)})"
                      for k, v in errs.items()), flush=True)
    for k, v in errs.items():
        check(v <= tols[k], f"{what}: {k} vs reference")


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


def reset_launches():
    from sasktran2_tpu_torch.ops import jacobi_cuda, lanes, thomas_cuda

    thomas_cuda.thomas_solve.launches = 0
    thomas_cuda.thomas_solve.launches_by_k = {}
    jacobi_cuda.jacobi_eigh.launches = 0
    jacobi_cuda.jacobi_eigh.launches_by_n = {}
    lanes.TORCH_OP_THOMAS_CALLS_BY_K.clear()


def read_launches():
    """The kernels' launch counts, in all and per instance, and the
    block-Thomas solves that took the torch-op loop (K > 24) per K."""
    from sasktran2_tpu_torch.ops import jacobi_cuda, lanes, thomas_cuda

    return {
        "thomas": thomas_cuda.thomas_solve.launches,
        "jacobi": jacobi_cuda.jacobi_eigh.launches,
        "thomas_by_k": dict(thomas_cuda.thomas_solve.launches_by_k),
        "jacobi_by_n": dict(jacobi_cuda.jacobi_eigh.launches_by_n),
        "torch_op_thomas_by_k": dict(lanes.TORCH_OP_THOMAS_CALLS_BY_K),
    }


def engine_outputs(out):
    return {k: out[k].to_numpy() for k in out.keys()
            if k == "radiance" or k.startswith("wf_") or k.endswith("_flux")}


# wavelengths/s of each engine case of this run: what -> (with Jacobians,
# radiance only)
RATES = {}


def force_generic(engine):
    """Send ``engine`` down the generic per-wavelength route: both
    fast-path gates replaced by ``lambda: False``, as the JAX package's
    tests do (``tests/test_brdf.py:211``)."""
    engine._twostream_fast_ok = lambda: False
    engine._polarized_fast_ok = lambda: False
    return engine


def engine_case(sk, build, golden_path, wl, reps, what, label,
                kernels_expected, generic=None, qu_scale="own"):
    """One engine case of ``sasktran2_tpu_torch.scenarios`` end to end on
    the card: the cold call in float32 with Jacobians through an engine
    built with no device (so on ``cuda``), with the launches of both
    kernels counted from zero (in all and per instance: Thomas block size
    K, Jacobi order n) and the peak device memory; finite outputs, radiance
    (I) > 0, and the checks against the reference at the 8 golden
    wavelengths: f32 radiance and fluxes per element within 2e-3 (the
    polarized Q and U relative to their largest magnitude), each ``wf_*``
    within 5e-2 of its largest magnitude. The reference is the JAX float64
    golden file ``golden_path``, against which the same case in float64
    on the card must also agree within 1e-8; where the JAX package cannot
    compile the case (``golden_path`` None) it is the port's own float64
    run on the card. ``kernels_expected`` maps each kernel (and
    ``torch_op_thomas``, the K > 24 block solves) to the instances (K or
    n) the path must launch. ``generic`` None leaves the route to the
    engine; "forced" sends it down the generic route (``force_generic``),
    "own" requires that the engine's gates chose the generic route, and
    both check that the call took it. ``qu_scale`` is ``compare_golden``'s.
    Then the median of ``reps`` warm calls with and without Jacobians, as
    wavelengths/s (kept in ``RATES``) and wavelength-lines-of-sight/s, and
    the Jacobian rows' share. Returns the launch counts."""
    import torch
    from sasktran2_tpu_torch.scenarios import GOLDEN_INDICES

    W = len(wl)
    config, geometry, viewing, atmo = build(sk, "float32", wl)
    engine = sk.Engine(config, geometry, viewing)  # no device: the card
    check(engine._device.type == "cuda", "the engine did not default to cuda")
    if generic == "forced":
        force_generic(engine)
    nlos = len(viewing.observer_rays)
    ns = config.num_stokes
    print(f"[{label}] {what}: engine device {engine._device}; ray tracer: "
          f"{engine.ray_tracer}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.calculate_radiance(atmo)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] {what} W={W} f32 with Jacobians: first call "
          f"{first_s:.2f} s, kernel launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB, route "
          f"{'fast path' if engine._fast_route else 'generic'}", flush=True)
    if generic is not None:
        check(not engine._fast_route, f"{what}: the call did not take the "
              "generic route")
    for name, sizes in kernels_expected.items():
        by = launches[{"thomas": "thomas_by_k", "jacobi": "jacobi_by_n",
                       "torch_op_thomas": "torch_op_thomas_by_k"}[name]]
        for size in sizes:
            check(by.get(size, 0) > 0, f"{what}: the {name} kernel at "
                  f"{size} was not launched")
    check_no_jax(label)
    rad = out["radiance"].to_numpy()
    names = [k for k in out.keys() if k.startswith("wf_")
             or k.endswith("_flux")]
    check(rad.shape == (W, nlos, ns), f"{what}: radiance shape {rad.shape}")
    finite = np.isfinite(rad).all() and all(
        np.isfinite(out[k].to_numpy()).all() for k in names)
    positive = bool((rad[..., 0] > 0).all())
    print(f"[{label}] {what}: radiance and {len(names)} other variables "
          f"finite: {bool(finite)}; radiance (I) > 0: {positive}",
          flush=True)
    check(finite and positive, f"{what}: non-finite or non-positive output")
    idx = GOLDEN_INDICES
    config64, geometry64, viewing64, atmo64 = build(sk, "float64", wl[idx])
    engine64 = sk.Engine(config64, geometry64, viewing64, device="cuda:0")
    if generic == "forced":
        force_generic(engine64)
    out64 = engine64.calculate_radiance(atmo64)
    if golden_path is not None:
        golden = dict(np.load(golden_path))
        check(np.allclose(golden["wavelengths_nm"], wl[idx]),
              f"{what}: golden file is for another wavelength grid")
        compare_golden(out, golden, idx, 2e-3, 5e-2, f"{what} f32 W={W}",
                       label, f32=True, qu_scale=qu_scale)
        compare_golden(out64, golden, np.arange(len(idx)), 1e-8, 1e-8,
                       f"{what} f64 W={len(idx)}", label, qu_scale=qu_scale)
    else:
        compare_golden(out, engine_outputs(out64), idx, 2e-3, 5e-2,
                       f"{what} f32 W={W} vs the port's f64 on the card",
                       label)

    times = timed_calls(engine, atmo, reps)
    med_jac = statistics.median(times)
    print(f"[{label}] {what} warm calls (s): {[round(t, 4) for t in times]}; "
          f"median {med_jac:.4f} s = {W / med_jac:.1f} wavelengths/s = "
          f"{W * nlos / med_jac:.1f} wavelength-LOS/s (f32, full Jacobians)",
          flush=True)
    atmo.calculate_derivatives = False
    torch.cuda.reset_peak_memory_stats()
    times = timed_calls(engine, atmo, reps)
    med = statistics.median(times)
    RATES[what] = (W / med_jac, W / med)
    nout = nlos * ns + sum(k.endswith("_flux") for k in out.keys()
                           if not k.startswith("wf_")) * len(
        getattr(viewing, "flux_observers", []))
    print(f"[{label}] {what} radiance only (s): "
          f"{[round(t, 4) for t in times]}; median {med:.4f} s = "
          f"{W / med:.1f} wavelengths/s = {W * nlos / med:.1f} "
          f"wavelength-LOS/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; Jacobian rows: "
          f"{nout} outputs, ({med_jac:.4f} - {med:.4f}) / {nout} = "
          f"{(med_jac - med) / nout:.4f} s per row, "
          f"{(med_jac - med) / med_jac:.3f} of the call", flush=True)
    return launches


class Capture:
    """Keep a detached copy of the arguments of every call of a function
    that a module holds by name (``module.name``) while the block runs,
    calling it as before."""

    def __init__(self, module, name):
        self.module, self.name, self.args = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            self.args.append([a.detach().clone() if hasattr(a, "detach")
                              else a for a in args])
            return fn(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def capture_engine_inputs(sk, build, wl):
    """The eigensolve and block-Thomas inputs of each mode of a polarized
    engine case's radiance-only f32 call on the card: two lists, one entry
    per mode, of [P, n, n, W] matrices and (lo, di, up, rhs) systems."""
    from sasktran2_tpu_torch.rt import disco_vec_minor

    config, geometry, viewing, atmo = build(sk, "float32", wl)
    atmo.calculate_derivatives = False
    engine = sk.Engine(config, geometry, viewing)
    with Capture(disco_vec_minor, "lane_jacobi_eigh_scan") as eig, \
            Capture(disco_vec_minor, "lane_block_thomas_solve") as bvp:
        engine.calculate_radiance(atmo)
    return [c[0] for c in eig.args], [c[:4] for c in bvp.args]


def eigen_residual(a, w, v):
    """max |A V - V diag(w)| relative to max |A|, and max |V^T V - I|, in
    float64, for [P, n, n, W] matrices."""
    import torch

    a, w, v = (t.double() for t in (a, w, v))
    av = torch.einsum("pijw,pjaw->piaw", a, v)
    res = float((av - w[:, None] * v).abs().max() / a.abs().max())
    n = a.shape[1]
    vtv = torch.einsum("pjaw,pjbw->pabw", v, v)
    eye = torch.eye(n, dtype=vtv.dtype, device=vtv.device)[None, :, :, None]
    return res, float((vtv - eye).abs().max())


def phase_jacobi_instance(a32, label, what):
    """K3 at an engine's own matrices ``a32`` [P, n, n, W] (f32): the
    kernel against its plain twin (eigenvalues, sorted, against a float64
    truth of 12 sweeps: error <= max(4 x the plain twin's, 1e-5), relative
    to max |A|), the eigen-residual of both at the engine's 7 sweeps (the
    kernel's <= 1e-5 of max |A|) and of the kernel at 10, time, bound and
    ``torch.linalg.eigh``'s time."""
    import torch
    from sasktran2_tpu_torch.ops import jacobi_cuda

    P, n, _, W = a32.shape
    scale = float(a32.abs().max())
    truth, _ = jacobi_cuda.jacobi_eigh_plain(a32.double(), 12)
    truth = truth.sort(dim=1).values
    w, v = jacobi_cuda.jacobi_eigh(a32, 7)
    wp, vp = jacobi_cuda.jacobi_eigh_plain(a32, 7)
    err_k = float((w.double().sort(dim=1).values - truth).abs().max()) / scale
    err_p = float((wp.double().sort(dim=1).values - truth).abs().max()) / scale
    res_k, orth_k = eigen_residual(a32, w, v)
    res_p, _ = eigen_residual(a32, wp, vp)
    w10, v10 = jacobi_cuda.jacobi_eigh(a32, 10)
    res_10, _ = eigen_residual(a32, w10, v10)
    torch.cuda.synchronize()
    print(f"[{label}] K3 jacobi at {what}'s own matrices [{P}, {n}, {n}, "
          f"{W}] f32, 7 sweeps: eigenvalues vs f64 truth rel {err_k:.3e} "
          f"(<= max(4 x plain {err_p:.3e}, 1e-5)); eigen-residual "
          f"|AV-VL|/max|A| kernel {res_k:.3e} (<= 1e-5), plain {res_p:.3e}, "
          f"kernel at 10 sweeps {res_10:.3e}; |V^T V - I| {orth_k:.3e}",
          flush=True)
    check(err_k <= max(4.0 * err_p, 1e-5), f"jacobi instance n={n}")
    check(res_k <= 1e-5, f"jacobi instance n={n}: eigen-residual")
    rec = {"max_abs_err": float((w - wp).abs().max())}
    rec["ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh(a32, 7), 10)
    rec["plain_ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh_plain(a32, 7), 2)
    rec["bound_ms"], rec["bound_by"] = jacobi_bound(P, n, W, 7, 4)
    batch = a32.permute(0, 3, 1, 2).reshape(P * W, n, n).contiguous()
    rec["library_ms"] = library_eigh_ms(batch, label, magma=False)
    return rec


def phase_thomas_instance(system32, label, what):
    """K1/K2 at an engine's own block-tridiagonal system (f32): the kernel
    and its plain twin against a float64 solve of the same system, error
    relative to max |x| <= max(4 x the plain twin's, 1e-5); time, bound
    and the dense ``torch.linalg.solve``'s time."""
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda

    P, K, _, W = system32[1].shape
    truth = thomas_cuda.thomas_solve_plain(*[t.double() for t in system32])
    xk = thomas_cuda.thomas_solve(*system32).double()
    xp = thomas_cuda.thomas_solve_plain(*system32).double()
    scale = float(truth.abs().max())
    err_k = float((xk - truth).abs().max()) / scale
    err_p = float((xp - truth).abs().max()) / scale
    torch.cuda.synchronize()
    print(f"[{label}] K1/K2 thomas at {what}'s own system [{P}, {K}, {K}, "
          f"{W}] f32: vs f64 solve rel {err_k:.3e} (<= max(4 x plain "
          f"{err_p:.3e}, 1e-5))", flush=True)
    check(err_k <= max(4.0 * err_p, 1e-5), f"thomas instance K={K}")
    rec = {"max_abs_err": float((xk - xp).abs().max())}
    rec["ms"] = cuda_ms(lambda: thomas_cuda.thomas_solve(*system32), 20)
    rec["plain_ms"] = cuda_ms(
        lambda: thomas_cuda.thomas_solve_plain(*system32), 3)
    rec["bound_ms"], rec["bound_by"] = thomas_bound(P, K, W, 4)
    rec["library_ms"] = library_dense_solve_ms(system32, label)
    return rec


def phase_pol16_solver(label):
    """Phase 11 (a): the port's ``solve_nstream_vector`` at 16 streams on
    the card against the JAX package's float64 radiance on the same layer
    inputs (``golden_pol16_solver.npz``: P = 100, four rays, the 8 golden
    wavelengths), in float64 within 1e-8 and in float32 within 2e-3 (I
    per element, Q and U relative to their largest magnitude)."""
    import torch
    from sasktran2_tpu_torch import scenarios
    from sasktran2_tpu_torch.rt import disco_vec_minor

    golden = dict(np.load(scenarios.GOLDEN_POL16_SOLVER_PATH))
    user_mu = golden["user_mu"]
    tables = disco_vec_minor.build_vector_minor_tables(
        16, 16, 0.6, user_mu, num_azimuth=scenarios.POL16_SOLVER_NUM_AZIMUTH)
    user_up = np.ones(len(user_mu), dtype=bool)
    user_azi = np.full(len(user_mu), scenarios.POL16_SOLVER_AZIMUTH)
    for dtype, tol in ((torch.float64, 1e-8), (torch.float32, 2e-3)):
        x = {k[6:]: torch.tensor(v, dtype=dtype, device="cuda")
             for k, v in golden.items() if k.startswith("input_")}
        with torch.no_grad():
            rad = disco_vec_minor.solve_nstream_vector(
                x["dtau"], x["omega"], x["a1"], x["a2"], x["a3"], x["b1"],
                x["albedo"], tables, user_up, user_azi, f0=x["f0"],
                num_azimuth=scenarios.POL16_SOLVER_NUM_AZIMUTH)
        err = scenarios.golden_error(
            "radiance", rad.double().cpu().numpy(), golden["radiance"],
            stokes_axis=1)
        note = (f", JAX f32 {float(golden['jax_f32_err_radiance']):.3e}"
                if dtype == torch.float32 else "")
        print(f"[{label}] pol16 solver {str(dtype)[6:]} on the card vs JAX "
              f"f64 (P=100, U=4, W=8): radiance {err:.3e} (<= {tol:g}"
              f"{note})", flush=True)
        check(err <= tol, f"pol16 solver {dtype}: radiance")


def phase_dolp_16_vs_8(label):
    """Phase 11 (c): the conservative Rayleigh slab of
    ``tests/test_nstream_vec.py:250-294`` on the card in float32 at W =
    1024 identical lanes: I, Q, U and DOLP at 16 streams against 8 within
    that test's tolerances (rtol 5e-3, atol 1e-5 |I|; DOLP rtol 1e-3)."""
    import torch
    from sasktran2_tpu_torch.rt import disco_vec_minor

    L, P, W = 3, 6, 1024
    greeks = np.zeros((4, L, P, W))
    greeks[0, 0], greeks[0, 2], greeks[1, 2] = 1.0, 0.5, 3.0
    greeks[3, 2] = np.sqrt(6.0) / 2.0

    def run(nstr):
        tab = disco_vec_minor.build_vector_minor_tables(
            nstr, L, 0.9999, np.array([0.7575]), num_azimuth=3)
        f = torch.float32
        r = disco_vec_minor.solve_nstream_vector(
            torch.full((P, W), 0.25 / P, dtype=f, device="cuda"),
            torch.ones((P, W), dtype=f, device="cuda"),
            *torch.tensor(greeks, dtype=f, device="cuda"),
            torch.zeros(W, dtype=f, device="cuda"), tab, np.array([True]),
            np.array([np.pi]), num_azimuth=3)
        return r[0].double().cpu().numpy()                 # [3, W]

    iqu16, iqu8 = run(16), run(8)
    spread = float(np.max(np.abs(iqu16 - iqu16[:, :1])))
    rel = float(np.max(np.abs(iqu16 - iqu8)
                       / (5e-3 * np.abs(iqu8) + 1e-5 * np.abs(iqu8[0]))))
    dolp16 = np.hypot(iqu16[1], iqu16[2]) / iqu16[0]
    dolp8 = np.hypot(iqu8[1], iqu8[2]) / iqu8[0]
    drel = float(np.max(np.abs(dolp16 - dolp8) / np.abs(dolp8)))
    print(f"[{label}] Rayleigh slab f32 W={W}: I, Q, U at 16 streams "
          f"{iqu16[:, 0]} vs 8 {iqu8[:, 0]}: |diff| / (5e-3|x| + 1e-5|I|) "
          f"{rel:.3f} (<= 1); DOLP {dolp16[0]:.5f} vs {dolp8[0]:.5f}, rel "
          f"{drel:.3e} (<= 1e-3); spread over lanes {spread:.1e}",
          flush=True)
    check(rel <= 1.0 and drel <= 1e-3 and 0.1 < dolp16[0] < 0.7,
          "DOLP 16 vs 8 streams")


def phases_2_to_7(sk, dev, wl, label):
    """Phases 2-7: both kernels against their plain twins, the 16-stream
    ground-viewing case with the kernels' times, the 16-stream limb scan
    and the two-stream case. Returns the kernel records and the launch
    counts of the ground and limb calls."""
    from sasktran2_tpu_torch.scenarios import (
        GOLDEN_2STR_PATH,
        GOLDEN_LIMB_PATH,
        GOLDEN_PATH,
        limb_case,
        smoke_case,
        twostream_case,
    )

    thomas_rec = phase_thomas(dev, label)
    jacobi_rec = phase_jacobi(dev, label)

    # phases 4, 5: the ground-viewing engine end to end, and times
    launches = engine_case(
        sk, smoke_case, GOLDEN_PATH, wl, 5, "engine nstr=16 P=100 nlos=4",
        label, kernels_expected={"thomas": [16], "jacobi": [8]},
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

    # phase 6: the 16-stream limb scan
    limb_launches = engine_case(
        sk, limb_case, GOLDEN_LIMB_PATH, wl, 3, "limb nstr=16 P=100 nlos=20",
        label, kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    print(f"[{label}] limb scan kernel launches per call with Jacobians: "
          f"{limb_launches}", flush=True)

    # phase 7: the two-stream solver
    engine_case(sk, twostream_case, GOLDEN_2STR_PATH, wl, 3,
                "two-stream P=100 nlos=1", label, kernels_expected={})

    return thomas_rec, jacobi_rec, launches, limb_launches


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
        from sasktran2_tpu_torch.ops import _build, jacobi_cuda, thomas_cuda
        from sasktran2_tpu_torch.scenarios import (
            GOLDEN_BRDF16_PATH,
            GOLDEN_FLUX16_PATH,
            GOLDEN_PATH,
            GOLDEN_POL4_PATH,
            GOLDEN_POLBRDF4_PATH,
            GOLDEN_POLFLUX4_PATH,
            GOLDEN_POLTHERMALLIMB4_PATH,
            GOLDEN_THERMAL16_PATH,
            GOLDEN_THERMALLIMB16_PATH,
            LIMBPOL_NUM_LOS,
            POLTHERMAL_NUM_LOS,
            QU_SCALE,
            brdf16_case,
            flux16_case,
            limbpol16_case,
            pol4_case,
            pol16_case,
            polbrdf4_case,
            polflux4_case,
            polthermallimb4_case,
            smoke_case,
            smoke_wavelengths,
            thermal16_case,
            thermal_wavelengths,
            thermallimb16_case,
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
    shared_branch = []
    for name, path in zip(names, paths):
        print(f"[{label}] built {name}: {os.path.relpath(path, HERE)} "
              f"({dt:.1f} s for both)", flush=True)
        for ln in ptxas_summary(path[:-3] + ".log"):
            print(f"[{label}]     ptxas {ln}")
            if ln.startswith("jacobi_group_kernel<"):
                shared_branch.append((ln.split(":")[0], stack_frame_bytes(ln)))
    print(f"[{label}] jacobi shared-memory branch (8 < n <= 32), stack frame "
          f"bytes per instantiation: {shared_branch} (all must be 0)",
          flush=True)
    check(len(shared_branch) == 4 and all(b == 0 for _, b in shared_branch),
          "the jacobi kernel's n > 8 branch has a stack frame (local memory)")

    wl = smoke_wavelengths()
    thomas_rec, jacobi_rec, launches, limb_launches = phases_2_to_7(
        sk, dev, wl, label)
    # --- phase 8: the kernel instances of the polarized path ----------------
    # each at a polarized engine's own inputs (a radiance-only call)
    eig4, bvp4 = capture_engine_inputs(sk, pol4_case, wl)
    eig16, bvp16 = capture_engine_inputs(sk, pol16_case, wl)
    jacobi24_rec = phase_jacobi_instance(eig16[0], label, "pol16")
    print(f"[{label}] note, not measured in this run: the local-memory n > 8 "
          "branch that the shared-memory one replaced took 124.197 ms per "
          "launch at [100, 24, 24, 1024] f32 (tools/compare_kernel_versions.py;"
          " PERF.md section 6)", flush=True)
    for m, a in enumerate(eig16[1:], 1):
        res, _ = eigen_residual(a, *jacobi_cuda.jacobi_eigh(a, 7))
        print(f"[{label}] K3 jacobi at pol16 mode {m}'s matrices: "
              f"eigen-residual |AV-VL|/max|A| {res:.3e} (<= 1e-5)", flush=True)
        check(res <= 1e-5, f"jacobi eigen-residual at pol16 mode {m}")
    jacobi6_rec = phase_jacobi_instance(eig4[0], label, "pol4")
    thomas12_rec = phase_thomas_instance(bvp4[0], label, "pol4")
    k48 = bvp16[0]
    k48_ms = cuda_ms(lambda: thomas_cuda.thomas_solve_plain(*k48), 3)
    print(f"[{label}] pol16 BVP {tuple(k48[1].shape)} f32 through the "
          f"torch-op loop (no kernel at K > 24, as the reference's scan): "
          f"{k48_ms:.3f} ms per solve", flush=True)
    del eig4, bvp4, eig16, bvp16

    # --- phase 9: flux observers ----------------------------------------------
    flux_launches = engine_case(
        sk, flux16_case, GOLDEN_FLUX16_PATH, wl, 3,
        "flux nstr=16 P=100 nlos=1 nobs=6 (4 types)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )

    # --- phase 10: polarized, 4 streams -----------------------------------------
    pol4_launches = engine_case(
        sk, pol4_case, GOLDEN_POL4_PATH, wl, 3,
        "pol4 nstr=4 P=100 nlos=4 (I, Q, U)", label,
        kernels_expected={"thomas": [12], "jacobi": [6]},
    )

    # --- phase 11: polarized, 16 streams ---------------------------------------
    phase_pol16_solver(label)
    # one warm call each for the two 16-stream polarized cases: a call
    # with Jacobians takes 60-80 s on the H100 (PERF.md), and the script
    # must end within 1,200 s
    pol16_launches = engine_case(
        sk, pol16_case, None, wl, 1,
        "pol16 nstr=16 P=100 nlos=4 (I, Q, U)", label,
        kernels_expected={"jacobi": [24], "torch_op_thomas": [48]},
    )
    phase_dolp_16_vs_8(label)

    # --- phase 12: polarized limb scan, 16 streams ------------------------------
    limbpol_launches = engine_case(
        sk, limbpol16_case, None, wl, 1,
        f"limbpol16 nstr=16 P=100 nlos={LIMBPOL_NUM_LOS} (I, Q, U)", label,
        kernels_expected={"jacobi": [24], "torch_op_thomas": [48]},
    )

    # --- phase 13: BRDF surface, every azimuth mode -------------------------------
    brdf_launches = engine_case(
        sk, brdf16_case, GOLDEN_BRDF16_PATH, wl, 3,
        "brdf16 nstr=16 P=100 nlos=4 (MODIS)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    ratio = brdf_launches["thomas"] / launches["thomas"]
    print(f"[{label}] brdf16 Thomas launches per call {brdf_launches['thomas']}"
          f" against ground16's {launches['thomas']}: {ratio:.3f} x (>= 16/3 "
          f"= {16 / 3:.3f}: all 16 modes against Rayleigh's 3)", flush=True)
    check(3 * brdf_launches["thomas"] >= 16 * launches["thomas"],
          "brdf16 did not solve every azimuth mode")

    # --- phases 14, 15: thermal emission, ground-viewing with fluxes, limb --------
    twl = thermal_wavelengths()  # phases 14, 15 and 19
    thermal_launches = engine_case(
        sk, thermal16_case, GOLDEN_THERMAL16_PATH, twl, 3,
        "thermal16 nstr=16 P=100 nlos=4 nobs=6 (4 types)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    thermallimb_launches = engine_case(
        sk, thermallimb16_case, GOLDEN_THERMALLIMB16_PATH, twl, 3,
        "thermallimb16 nstr=16 P=100 nlos=20", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )

    # --- phases 16-19: the generic per-wavelength route -------------------------
    generic_launches = engine_case(
        sk, smoke_case, GOLDEN_PATH, wl, 3,
        "generic16 nstr=16 P=100 nlos=4 (generic route forced)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]}, generic="forced",
    )
    fast_rate = RATES["engine nstr=16 P=100 nlos=4"]
    generic_rate = RATES[
        "generic16 nstr=16 P=100 nlos=4 (generic route forced)"]
    print(f"[{label}] generic16 against ground16 (the same case on the fast "
          f"path, this run): {generic_rate[0]:.1f} vs {fast_rate[0]:.1f} "
          f"wavelengths/s with Jacobians, {generic_rate[1]:.1f} vs "
          f"{fast_rate[1]:.1f} radiance only; kernel launches per call "
          f"{generic_launches['thomas']} / {generic_launches['jacobi']} vs "
          f"{launches['thomas']} / {launches['jacobi']} (thomas / jacobi)",
          flush=True)
    polbrdf_launches = engine_case(
        sk, polbrdf4_case, GOLDEN_POLBRDF4_PATH, wl, 3,
        "polbrdf4 nstr=4 P=100 nlos=4 (I, Q, U; MODIS)", label,
        kernels_expected={"thomas": [12], "jacobi": [6]}, generic="own",
    )
    polflux_launches = engine_case(
        sk, polflux4_case, GOLDEN_POLFLUX4_PATH, wl, 3,
        "polflux4 nstr=4 P=100 nlos=4 nobs=6 (I, Q, U; 4 types)", label,
        kernels_expected={"thomas": [12], "jacobi": [6]}, generic="own",
    )
    polthermal_launches = engine_case(
        sk, polthermallimb4_case, GOLDEN_POLTHERMALLIMB4_PATH, twl, 3,
        f"polthermallimb4 nstr=4 P=100 nlos={POLTHERMAL_NUM_LOS} (I, Q, U)",
        label, kernels_expected={"thomas": [12], "jacobi": [6]},
        generic="own", qu_scale=QU_SCALE["polthermallimb4"],
    )

    check_no_jax(label)
    by_path = {
        "ground16": launches, "limb16": limb_launches, "flux16": flux_launches,
        "pol4": pol4_launches, "pol16": pol16_launches,
        "limbpol16": limbpol_launches, "brdf16": brdf_launches,
        "thermal16": thermal_launches, "thermallimb16": thermallimb_launches,
        "generic16": generic_launches, "polbrdf4": polbrdf_launches,
        "polflux4": polflux_launches, "polthermallimb4": polthermal_launches,
    }

    def instance(kernel, size, main):
        key = "thomas_by_k" if kernel == "thomas" else "jacobi_by_n"
        per_path = {k: v[key].get(size, 0) for k, v in by_path.items()}
        return {"launches": per_path[main],
                "launches_by_path": {k: v for k, v in per_path.items() if v}}

    thomas = {"route": "cuda", "source": "sasktran2_tpu_torch/csrc/thomas.cu",
              "replaces": "sasktran2_tpu/ops/pallas_thomas.py:147"}
    jacobi = {"route": "cuda", "source": "sasktran2_tpu_torch/csrc/jacobi.cu",
              "replaces": "sasktran2_tpu/ops/pallas_jacobi.py:130"}
    kernels = [
        {"name": "thomas_block_tridiag_solve", **thomas,
         **instance("thomas", 16, "ground16"), **thomas_rec},
        {"name": "thomas_block_tridiag_solve K=12 (pol4)", **thomas,
         **instance("thomas", 12, "pol4"), **thomas12_rec},
        {"name": "jacobi_eigh", **jacobi,
         **instance("jacobi", 8, "ground16"), **jacobi_rec},
        {"name": "jacobi_eigh n=6 (pol4)", **jacobi,
         **instance("jacobi", 6, "pol4"), **jacobi6_rec},
        {"name": "jacobi_eigh n=24 (pol16)", **jacobi,
         **instance("jacobi", 24, "pol16"), **jacobi24_rec},
    ]
    torch_op_paths = [
        {"name": "thomas_block_tridiag_solve K=48 (pol16)",
         "route": "torch ops, as the reference's scan; no Pallas kernel at "
                  "K > 24",
         "source": "sasktran2_tpu_torch/ops/thomas_cuda.py "
                   "(thomas_solve_plain)",
         "calls": pol16_launches["torch_op_thomas_by_k"][48],
         "calls_by_path": {
             "pol16": pol16_launches["torch_op_thomas_by_k"][48],
             "limbpol16": limbpol_launches["torch_op_thomas_by_k"][48]},
         "ms": k48_ms},
    ]
    print(json.dumps({"kernels": kernels, "torch_op_paths": torch_op_paths}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
