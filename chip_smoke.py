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
   truth, at the engine's shape and at the JAX package's test shapes; its
   pivoting branch (24 < K <= 48) the same way on random systems at K =
   26, 32, 40 and 48 at a ragged W, and at each on a system whose leading
   diagonal element is 0 in every layer (only a pivoting solve gets it
   right); and the autograd backward (which launches the kernel) against
   the plain twin's autograd, at K = 16 and 48.
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
   [100, 12, 12, 1024] (pol4) and, through the pivoting branch, at pol16's
   [100, 48, 48, 1024], each against its plain twin and a float64 truth
   (f32 within max(4 x the plain twin's error, 1e-5), f64 within 1e-10),
   timed beside its bound (and ``torch.linalg.eigh`` for K3, the dense
   ``torch.linalg.solve`` of [1024, 1200, 1200] and [1024, 4800, 4800] for
   K1, in calls of 128); the eigen-residual of the engine's 7-sweep
   n = 24 eigensolves of every azimuth mode, which must be <= 1e-5 of
   max |A|.
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
20-22. Successive orders (``rt/successive.py``) on ``limb_case``'s 20
    limb rays at 51 altitudes, 64 wavelengths, a 10 x 10 direction grid
    and 50 iterations, each against its JAX float64 golden file (one
    wavelength per JAX call): solimb16 (one SZA profile,
    ``golden_solimb16.npz``), solimb16_doinit (the field seeded by a
    16-stream, 16-mode DO solve, which must launch K1 at K = 16 and K3 at
    n = 8; ``golden_solimb16_doinit.npz``) and polsolimb16 (I, Q, U;
    ``golden_polsolimb16.npz``), each by the engine's own gates on the
    generic route. First the time of the host build of the SO geometry
    the three share (one memoised build); after each cell the time of
    one SO transport step at the cell's shapes. Phase 21 also holds K1
    and K3 at solimb16_doinit's own DO-seed inputs ([50, 16, 16, 1024]
    and [50, 8, 8, 1024], captured in a radiance-only call) against
    their plain twins and a float64 truth, as phase 8 does, timed
    beside their bounds and library calls, on contiguous copies, and as
    the path calls them (permuted views of its lanes, which the wrappers
    copy).
23. The optical cell o2a16 (``scenarios.o2a16_case``: an O2 A-band
    line-by-line calculation with a Mie aerosol, 16 streams, 4 rays,
    EngineIntegratedLineShape on 4,096 fine wavenumbers mapped onto 82
    Gaussians): its Mie table generated on the card (seconds, the Mie
    compute's share) and held to the JAX f64 table in
    ``golden_o2a16.npz`` within 1e-10; the line cross sections at all
    101 levels (ms, peak memory), held per level within 1e-10 of the
    level's maximum at 10 levels; the engine call (cold, launches, peak
    memory, the route, which must be the JAX engine's, then warm calls
    with and without Jacobians as fine wavelengths/s and
    wavelength-LOS/s); and a Monochromatic call at 16 wavenumbers (line
    cores, wings, continuum) in f32 and f64 against the JAX f64 engine
    (``o2a16_monochromatic`` states the gates). It must launch K1 at
    K = 16 and K3 at n = 8, and holds both at the cell's own solver
    inputs ([100, 16, 16, 4096] and [100, 8, 8, 4096], captured in a
    radiance-only call at azimuth modes 0 and 15) against their plain
    twins and a float64 truth, as phase 8 does, timed at mode 0 beside
    their bounds and library calls.
24. The O2 A-band dayglow limb scan dayglowlimb16
    (``scenarios.dayglowlimb16_case``: 21 limb rays from a
    ``LimbVertical`` container, 16 streams, exact single scatter, DO on
    a 2-point SZA grid, VER emission, 4,096 wavenumbers 0.005 cm^-1
    apart; O2 lines read by ``HITRANLineDatabase`` from a file the phase
    writes under a temporary ``SASKTRAN2_TPU_TORCH_DB_ROOT``; the airglow
    a ``LineListVolumeEmissionRate`` of ``Yankovsky`` populations) with
    the checks of phase 4 against ``golden_dayglowlimb16.npz`` at 8
    wavenumbers (the ray tangent at the model's top, 100 km, must give
    radiance 0), the output's ``tangent_altitude`` within 1 m of the
    requested, the route the JAX engine's gates choose, one warm call,
    the host times of the container build and the photochemical solve,
    and a radiance-only call with ``PopulationEmissionRate`` in place of
    the line list, equal within 1e-6 (``phase_dayglowlimb16``).
25. amf16 (``scenarios.amf16_case``: ground16 with a weak background
    absorber and ``AirMassFactor``), timed in float64, the precision its
    users configure, and checked in float64 and at the 8 golden
    wavelengths in float32 against ``golden_amf16.npz``
    (``compare_conditioned``: the ``air_mass_factor`` gated as a
    weighting function, the variables whose JAX routes differ by more
    than 1e-8 by o2a16's rule, in float32 level by level beside the JAX
    package's own float32 error), on the route the JAX engine's gates
    choose (``phase_amf16``).
26. tomo2d (``scenarios.tomo2d_case``: tomographic limb retrievals along
    the orbit track; a ``Geometry2D`` of 101 altitudes x 41 horizontal
    angles, 40 ``TangentAltitude`` rays in 4 images, exact single
    scatter, a 2D aerosol and a 2D absorber, W = 64, float32, full
    Jacobians): the host 2D trace timed (the first engine constructor;
    the trace is memoised, and the float64 check must reuse it), one cold
    and one warm call with Jacobians and one radiance-only call, the
    peak memory and the rows' share; zero launches of K1 and K3 (the 2D
    path has no DO solve); against ``golden_tomo2d.npz`` (radiance and
    the LOS optical depth at 8 wavelengths, each ``wf_*`` at 2 of them)
    by the gates of phase 4 (``phase_tomo2d``).
27. ``calculate_radiance(mesh=)`` on ground16's engine and atmosphere
    from phase 4: ``parallel.make_mesh(devices=[cuda:0, cuda:0])``, two
    blocks of 512 wavelengths, each on a host thread of its own. Radiance
    and every ``wf_*`` within rtol 1e-6 and atol 1e-4 of the largest
    magnitude of the unsharded call (the JAX mesh test's tolerance), the
    largest difference printed; K1 and K3 launched exactly twice as often
    per call as unsharded, instance by instance; the split calls timed
    beside the unsharded one. Then a mesh of two devices, the card and
    the host CPU, one block each, at 4 wavelengths in float64 on
    ground16, tomo2d and a small successive-orders limb scan: the same
    tolerance against the unsharded call on the card, the kernels
    launched only by the card's block, and the per-device tables (SO
    plans, 2D operators) built on both devices (``phase_mesh``).
28. The web layer and the test utilities (``phase_web_and_test_util``).
    (a) A ``file://`` tree under a temporary directory holds
    ``scenarios.web_cross_section`` as an ``.npz`` at
    ``v_latest/<scenarios.WEB_KEY>`` and in a zip; through
    ``database.StandardDatabase`` its ``load_ds`` is bit-equal to the
    in-memory table, the cached file to the served one, and a second
    ``path()`` fetches nothing. An ``OpticalDatabaseGenericAbsorber`` of
    it, as a ``VMRAltitudeAbsorber``, goes into ground16 (W = 1024, f32,
    Jacobians, on the card): radiance and every ``wf_*`` equal to the
    same absorber built from the in-memory table (the largest difference
    printed; the inputs are identical). ``ZipWebDatabase`` extracts the
    zip, and a second ``load()`` fetches nothing and leaves the archive's
    mtime as it was. Every URL opened must have the ``file`` scheme.
    (b) ``test_util.wf.numeric_wf`` and ``validate_wf(wf_dim="altitude",
    decimal=5)`` in float64 at W = 1 (``scenarios.fd16_case``: 41
    levels on 0-60 km, fractional change 1e-3, as
    ``tests/test_polarized_engine.py:168-173`` does): ground16's
    configuration for ``total_extinction`` and ``ssa`` (K1 K = 16, K3
    n = 8) and pol16's for ``total_extinction``, I, Q and U (the K = 48
    pivoting branch, K3 n = 24), each through the kernels' adjoints in
    the base call. Then ground16's and pol16's ``total_extinction`` on
    the cells' own 0-100 km at the same 41 levels, where the top levels'
    central differences meet float64 roundoff: the worst difference per
    level, decimal 5 required up to 60 km and decimal 4 at every level,
    the levels that miss decimal 5 named; and again at a tenfold step
    (``scenarios.FD_CELL_STEP``), whose roundoff is tenfold smaller,
    at decimal 5 at every level. The numeric WF must be nonzero
    wherever the analytic one exceeds 1e-3 of its largest magnitude
    (``validate_wf`` skips zeros). Printed: the worst difference over
    the largest magnitude along altitude, per WF and Stokes component,
    the launches per kernel instance (no torch-op solve) and the seconds
    of each check.

Every phase prints its end time since the script started.

Each engine case prints its launches per kernel instance, the peak device
memory, the warm-call times with and without Jacobians and the Jacobian
rows' share: 5 warm calls each for ground16, 3 for the cells that take a
few seconds a call, 1 for brdf16, thermallimb16, polthermallimb4, o2a16,
dayglowlimb16, tomo2d and an SO cell whose cold call takes over 60 s, and none
with Jacobians for pol16 and limbpol16 (their cold call's time stands
for it), so that the script ends well inside its limit. The check that
no ``jax`` or ``sasktran2_tpu`` module is loaded is made again before the
kernel record, which lists every kernel instance with its launches in
its own case (and in every case that launched it, ``ground16_mesh2``
the split call of phase 27) and, apart, the
torch-op path of the SO transport step. No case may take the torch-op
block-Thomas loop (K > 48).

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


T_START = time.perf_counter()


def phase_done(label, phase):
    print(f"[{label}] phase {phase} done at "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)


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


def thomas_pivot_inputs(P, K, W, seed, dtype, dev):
    """A system only a pivoting solve gets right, as
    ``tests/test_torch_thomas48.py`` makes it: diagonal blocks 10 x a
    permutation matrix (no fixed point at row 0) plus N(0, 0.1^2) with
    di[p, 0, 0] = 0 in every layer, N(0, 0.3^2) off-diagonal blocks."""
    import torch

    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    r = rng.normal(size=(P, K, W))
    perm = rng.permutation(K)
    perm = np.roll(perm, -int(np.argmax(perm == 0)) - 1)
    di = rng.normal(size=(P, K, K, W)) * 0.1 + 10.0 * np.eye(K)[perm][
        :, :, None]
    di[:, 0, 0, :] = 0.0
    return [torch.as_tensor(t, dtype=dtype, device=dev) for t in (lo, di, up, r)]


def phase_thomas(dev, label):
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda
    from sasktran2_tpu_torch.ops.lanes import lane_block_thomas_solve

    f32, f64 = torch.float32, torch.float64
    record = {}
    # the JAX package's test shapes use its diagonal shift of 5; among the
    # 10^5 blocks of the engine-sized cases some N(0, 1) + 5 I blocks are
    # near-singular for K >= 16, so those get 5 + 2 sqrt(K); K > 24 is the
    # pivoting branch, at the ragged W = 1001 (element copies, a partial
    # last block) and 1004 (16-byte copies)
    cases = [(100, 16, 1024, 13.0), (8, 24, 300, 14.8), (7, 4, 8, 5.0),
             (13, 16, 130, 5.0), (5, 6, 128, 5.0)]
    for K, W in [(26, 1001), (32, 1004), (40, 1001), (48, 1001)]:
        cases += [(20, K, W, 5.0 + 2.0 * K**0.5), (20, K, W, "pivot")]
    for P, K, W, shift in cases:
        if shift == "pivot":
            a64 = thomas_pivot_inputs(P, K, W, 7 + K, f64, dev)
        else:
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
        what = " (pivot-needing)" if shift == "pivot" else ""
        print(f"[{label}] thomas P={P} K={K} W={W}{what}: f32 kernel err "
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
    for K, shift in ((16, 5.0), (48, 5.0 + 2.0 * 48**0.5)):
        lo, di, up, r = thomas_inputs(13, K, 130, 7, f64, dev, shift)
        g = torch.as_tensor(np.random.default_rng(8).normal(size=r.shape),
                            dtype=f64, device=dev)
        ins_k = [t.clone().requires_grad_(True) for t in (lo, di, up, r)]
        ins_p = [t.clone().requires_grad_(True) for t in (lo, di, up, r)]
        before = thomas_cuda.thomas_solve.launches_by_k.get(K, 0)
        (lane_block_thomas_solve(*ins_k) * g).sum().backward()
        launched = thomas_cuda.thomas_solve.launches_by_k[K] - before
        (thomas_cuda.thomas_solve_plain(*ins_p) * g).sum().backward()
        gerr = max(
            float((a.grad - b.grad).abs().max() / b.grad.abs().max())
            for a, b in zip(ins_k, ins_p)
        )
        print(f"[{label}] thomas autograd (13,{K},130) f64: grad rel err "
              f"{gerr:.3e} (<= 1e-9), kernel launches {launched} (fwd + "
              "bwd)", flush=True)
        check(gerr <= 1e-9 and launched == 2, f"thomas autograd K={K}")

    a32 = [t.to(f32) for t in thomas_inputs(100, 16, 1024, 3, f64, dev, 13.0)]
    record["ms"] = cuda_ms(lambda: thomas_cuda.thomas_solve(*a32), 20)
    record["plain_ms"] = cuda_ms(
        lambda: thomas_cuda.thomas_solve_plain(*a32), 3)
    record["bound_ms"], record["bound_by"] = thomas_bound(100, 16, 1024, 4)
    record["library_ms"] = library_dense_solve_ms(a32, label)
    return record


def library_dense_solve_ms(system, label, chunk=128, group_bytes=16e9):
    """Time of ``torch.linalg.solve`` on the block-tridiagonal systems
    ``system`` = (lo, di, up, r) [P, K, K, W] assembled as dense
    [W, P*K, P*K] matrices, the one PyTorch call that computes the same x
    (at about P^2 times the Thomas solve's work): ``chunk`` wavelengths a
    call, the matrices of a group of chunks (at most ``group_bytes`` of
    them) assembled before the clock starts, the groups' times summed.
    Prints the dense solution's largest difference from the Thomas
    kernel's relative to max |x|, as a note."""
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda

    lo, di, up, r = system
    P, K, _, W = di.shape
    idx = torch.arange(P, device=di.device)
    per_chunk = chunk * (P * K) ** 2 * di.element_size()
    group = max(1, int(group_bytes // per_chunk)) * chunk
    xk = thomas_cuda.thomas_solve(*system)
    ms, diff, calls = 0.0, 0.0, 0
    for g0 in range(0, W, group):
        chunks = []
        for w0 in range(g0, min(g0 + group, W), chunk):
            sl = slice(w0, min(w0 + chunk, W))
            C = sl.stop - sl.start
            dense = torch.zeros((C, P, K, P, K), dtype=di.dtype,
                                device=di.device)
            dense[:, idx, :, idx, :] = di[..., sl].permute(0, 3, 1, 2)
            dense[:, idx[1:], :, idx[:-1], :] = lo[1:, ..., sl].permute(
                0, 3, 1, 2)
            dense[:, idx[:-1], :, idx[1:], :] = up[:-1, ..., sl].permute(
                0, 3, 1, 2)
            rhs = r[..., sl].permute(2, 0, 1).reshape(C, P * K, 1)
            chunks.append((sl, dense.reshape(C, P * K, P * K), rhs))
        for sl, a, b in chunks:
            x = torch.linalg.solve(a, b).reshape(-1, P, K).permute(1, 2, 0)
            diff = max(diff, float((x - xk[..., sl]).abs().max()))
        ms += cuda_ms(lambda: [torch.linalg.solve(a, b)
                               for _, a, b in chunks], 1)
        calls += len(chunks)
        del chunks
        torch.cuda.empty_cache()
    diff /= float(xk.abs().max())
    print(f"[{label}] library call: torch.linalg.solve on the assembled "
          f"dense [{W}, {P * K}, {P * K}] systems ({di.dtype}, {calls} "
          f"calls of <= {chunk}, in groups of <= {group} wavelengths): "
          f"{ms:.3f} ms for the whole batch; its x vs the Thomas solve's, "
          f"rel to max |x|: {diff:.3e} (a note)", flush=True)
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
    ``scenarios.golden_error``: radiance, fluxes and the line-of-sight
    optical depth per element (the polarized Q and U relative to their
    largest magnitude), each ``wf_*`` against its largest magnitude. A
    golden that holds its ``wf_*`` at only some of its wavelengths names
    their positions in ``idx`` as ``wf_positions``. For a float32 run
    (``f32``) the JAX package's own float32 error on the same case
    (``jax_f32_err_<name>`` in the golden file, from
    ``tools/make_torch_golden.py``) is printed beside each where the file
    has it."""
    from sasktran2_tpu_torch.scenarios import golden_error

    names = [k for k in golden if k in ("radiance", "air_mass_factor",
                                        "los_optical_depth")
             or k.startswith("wf_") and k != "wf_positions"
             or (k.endswith("_flux") and not k.startswith("jax_f32_err_"))]
    wf_idx = (np.asarray(idx)[np.asarray(golden["wf_positions"])]
              if "wf_positions" in golden else idx)
    errs = {}
    for name in names:
        got = out[name].to_numpy()
        ax = out[name].dims.index("wavelength")
        at = wf_idx if name.startswith("wf_") else idx
        errs[name] = golden_error(name, np.take(got, at, axis=ax),
                                  golden[name], qu_scale=qu_scale)
    # the box air-mass factors are gated as a weighting function
    tols = {k: rad_tol if k in ("radiance", "los_optical_depth") or (
        k.endswith("_flux") and not k.startswith("wf_")) else wf_tol
        for k in errs}

    def note(name):
        key = f"jax_f32_err_{name}"
        if not f32 or key not in golden:
            return ""
        return f", JAX f32 {float(golden[key]):.3e}"

    qu = "their max" if qu_scale == "own" else "the max of |I|"
    at_wf = ("" if wf_idx is idx
             else f", wf_* at {len(wf_idx)} of them")
    print(f"[{label}] {what} vs reference at {len(idx)} wavelengths{at_wf} "
          f"(radiance, fluxes and LOS optical depth max rel per element, "
          f"polarized Q, U rel to {qu}, wf_* rel to their max): "
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
    from sasktran2_tpu_torch.rt import successive

    successive.transport_step.calls = 0
    thomas_cuda.thomas_solve.launches = 0
    thomas_cuda.thomas_solve.launches_by_k = {}
    jacobi_cuda.jacobi_eigh.launches = 0
    jacobi_cuda.jacobi_eigh.launches_by_n = {}
    lanes.TORCH_OP_THOMAS_CALLS_BY_K.clear()


def read_launches():
    """The kernels' launch counts, in all and per instance, the
    block-Thomas solves that took the torch-op loop (K > 48) per K, and
    the SO transport steps."""
    from sasktran2_tpu_torch.ops import jacobi_cuda, lanes, thomas_cuda
    from sasktran2_tpu_torch.rt import successive

    return {
        "so_transport_steps": successive.transport_step.calls,
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
GROUND16 = "engine nstr=16 P=100 nlos=4"


def force_generic(engine):
    """Send ``engine`` down the generic per-wavelength route: both
    fast-path gates replaced by ``lambda: False``, as the JAX package's
    tests do (``tests/test_brdf.py:211``)."""
    engine._twostream_fast_ok = lambda: False
    engine._polarized_fast_ok = lambda: False
    return engine


# (engine, atmosphere) of the cases that a later phase reuses, by ``what``
KEPT = {}


def engine_case(sk, build, golden_path, wl, reps, what, label,
                kernels_expected, generic=None, qu_scale="own", idx=None,
                check_out=None, dtype="float32", check_engines=None,
                keep=False):
    """One engine case of ``sasktran2_tpu_torch.scenarios`` end to end on
    the card: the cold call in ``dtype`` (float32, or float64 for a cell
    whose users configure it) with Jacobians through an engine built with
    no device (so on ``cuda``), with the launches of both kernels counted
    from zero (in all and per instance: Thomas block size K, Jacobi order
    n) and the peak device memory; finite outputs, radiance (I) > 0, and
    the checks against the reference at the 8 golden wavelengths, with
    the same case in the other precision there: f32 radiance and fluxes
    per element within 2e-3 (the polarized Q and U relative to their
    largest magnitude), each ``wf_*`` within 5e-2 of its largest
    magnitude. The reference is the JAX float64 golden file
    ``golden_path`` (its grid under ``wavelengths_nm`` or
    ``wavenumbers_cminv``), which the f64 call must match within 1e-8 (a
    golden that carries the JAX package's route differences is compared
    by ``compare_conditioned``); where the golden records the JAX
    engine's gates for the case, the route must be theirs. Where the JAX
    package cannot compile the case (``golden_path`` None) the reference
    is the port's own float64 run on the card (a float32 case only).
    ``kernels_expected`` maps each kernel to the instances (K or n) the
    path must launch; no block-Thomas solve may take the torch-op loop.
    ``generic`` None leaves the route to the engine; "forced" sends it
    down the generic route (``force_generic``), "own" requires that the
    engine's gates chose the generic route, and both check that the call
    took it. ``qu_scale`` is ``compare_golden``'s; ``idx`` the golden
    wavelengths' indices in ``wl`` (default
    ``scenarios.GOLDEN_INDICES``); ``check_out``, where given, is called
    with the cold call's output, and ``check_engines`` with the engine and
    the other precision's engine; ``keep`` keeps the engine and its
    atmosphere in ``KEPT[what]`` for a later phase. Then the median of ``reps`` warm calls
    (None: 3, or 1 where the cold call took over 60 s; 0: the cold call's
    time with Jacobians and one call without) with and without
    Jacobians, as wavelengths/s (kept in ``RATES``) and
    wavelength-lines-of-sight/s, and the Jacobian rows' share. Returns
    the launch counts."""
    import torch
    from sasktran2_tpu_torch.scenarios import GOLDEN_INDICES

    check(golden_path is not None or dtype == "float32",
          f"{what}: a float64 case needs a golden file")
    prec = {"float32": "f32", "float64": "f64"}[dtype]
    W = len(wl)
    config, geometry, viewing, atmo = build(sk, dtype, wl)
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
    if reps is None:
        reps = 1 if first_s > 60.0 else 3
    print(f"[{label}] {what} W={W} {prec} with Jacobians: first call "
          f"{first_s:.2f} s, kernel launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB, route "
          f"{'fast path' if engine._fast_route else 'generic'}", flush=True)
    if generic is not None:
        check(not engine._fast_route, f"{what}: the call did not take the "
              "generic route")
    for name, sizes in kernels_expected.items():
        by = launches[{"thomas": "thomas_by_k", "jacobi": "jacobi_by_n"}[name]]
        for size in sizes:
            check(by.get(size, 0) > 0, f"{what}: the {name} kernel at "
                  f"{size} was not launched")
    check(not launches["torch_op_thomas_by_k"], f"{what}: block-Thomas "
          f"solves took the torch-op loop: {launches['torch_op_thomas_by_k']}")
    check_no_jax(label)
    rad = out["radiance"].to_numpy()
    names = [k for k in out.keys() if k.startswith("wf_")
             or k.endswith("_flux") or k == "air_mass_factor"]
    check(rad.shape == (W, nlos, ns), f"{what}: radiance shape {rad.shape}")
    finite = np.isfinite(rad).all() and all(
        np.isfinite(out[k].to_numpy()).all() for k in names)
    # a limb ray tangent at the model's top crosses no atmosphere: its
    # radiance is exactly 0, and every other ray's is > 0
    lit = np.array([getattr(r, "tangent_altitude_m", -1.0)
                    < geometry.altitudes()[-1] for r in viewing.observer_rays])
    positive = bool((rad[:, lit, 0] > 0).all()
                    and (rad[:, ~lit, 0] == 0).all())
    print(f"[{label}] {what}: radiance and {len(names)} other variables "
          f"finite: {bool(finite)}; radiance (I) > 0: {positive}"
          + (f" ({int((~lit).sum())} ray(s) tangent at the model's top: "
             "radiance 0)" if not lit.all() else ""), flush=True)
    check(finite and positive, f"{what}: non-finite or non-positive output")
    if check_out is not None:
        check_out(out)
    idx = GOLDEN_INDICES if idx is None else idx
    other = "float64" if dtype == "float32" else "float32"
    config_o, geometry_o, viewing_o, atmo_o = build(sk, other, wl[idx])
    engine_o = sk.Engine(config_o, geometry_o, viewing_o, device="cuda:0")
    if generic == "forced":
        force_generic(engine_o)
    out_o = engine_o.calculate_radiance(atmo_o)
    if check_engines is not None:
        check_engines(engine, engine_o)
    at_golden = np.arange(len(idx))
    # (output, the golden wavelengths' indices in it, its width)
    (out32, idx32, w32), (out64, idx64, w64) = (
        ((out, idx, W), (out_o, at_golden, len(idx))) if dtype == "float32"
        else ((out_o, at_golden, len(idx)), (out, idx, W)))
    if golden_path is not None:
        golden = dict(np.load(golden_path))
        grid = golden.get("wavelengths_nm", golden.get("wavenumbers_cminv"))
        check(np.allclose(grid, wl[idx]),
              f"{what}: golden file is for another wavelength grid")
        if "twostream_fast_ok" in golden and generic is None:
            jax_route = (bool(golden["twostream_fast_ok"])
                         or bool(golden["polarized_fast_ok"]))
            print(f"[{label}] {what} route: "
                  f"{'fast path' if engine._fast_route else 'generic'} (the "
                  f"JAX engine's gates: "
                  f"{'fast path' if jax_route else 'generic'})", flush=True)
            check(engine._fast_route == jax_route
                  and engine._twostream_fast_ok()
                  == bool(golden["twostream_fast_ok"])
                  and engine._polarized_fast_ok()
                  == bool(golden["polarized_fast_ok"]),
                  f"{what}: the route is not the JAX engine's")
        if any(k.startswith("jax_route_err_") for k in golden):
            # the golden knows which variables are ill-conditioned
            low = geometry.altitudes() < LOW_KM * 1e3
            compare_conditioned(out32, golden, idx32, True, low, what, label)
            compare_conditioned(out64, golden, idx64, False, low, what,
                                label)
        else:
            compare_golden(out32, golden, idx32, 2e-3, 5e-2,
                           f"{what} f32 W={w32}", label, f32=True,
                           qu_scale=qu_scale)
            compare_golden(out64, golden, idx64, 1e-8, 1e-8,
                           f"{what} f64 W={w64}", label,
                           qu_scale=qu_scale)
    else:
        compare_golden(out, engine_outputs(out_o), idx, 2e-3, 5e-2,
                       f"{what} f32 W={W} vs the port's f64 on the card",
                       label)

    # reps 0: the cold call's time stands for a call with Jacobians
    times = timed_calls(engine, atmo, reps) if reps else [first_s]
    med_jac = statistics.median(times)
    print(f"[{label}] {what} "
          f"{'warm calls' if reps else 'the cold call (no warm call)'} "
          f"(s): {[round(t, 4) for t in times]}; "
          f"median {med_jac:.4f} s = {W / med_jac:.1f} wavelengths/s = "
          f"{W * nlos / med_jac:.1f} wavelength-LOS/s ({prec}, full "
          f"Jacobians)",
          flush=True)
    atmo.calculate_derivatives = False
    torch.cuda.reset_peak_memory_stats()
    times = timed_calls(engine, atmo, max(reps, 1))
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
    if keep:
        atmo.calculate_derivatives = True
        KEPT[what] = (engine, atmo)
    return launches


def phase_so_build(sk, label):
    """The host build of the SO cells' geometry, timed: the first
    solimb16 engine (float32, on the card) builds it, and the memo of
    ``successive.so_geometry`` hands it to every later engine of the three
    cells. Returns the build's seconds."""
    from sasktran2_tpu_torch.scenarios import so_wavelengths, solimb16_case

    t0 = time.perf_counter()
    first = sk.Engine(*solimb16_case(sk, "float32", so_wavelengths()[:1])[:3])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = sk.Engine(*solimb16_case(sk, "float64", so_wavelengths()[:1])[:3])
    again_s = time.perf_counter() - t0
    geom = first._so_plans[0].geom
    check(again._so_plans[0].geom is geom,
          "a second SO engine of the same geometry built it again")
    R, S = geom.seg_mask.shape
    print(f"[{label}] SO geometry host build (first engine constructor): "
          f"{build_s:.1f} s for {geom.nlev} levels x {geom.ndir} directions "
          f"= {R} internal rays, {S} padded segments, "
          f"{geom.seg_mask.mean():.3f} of them real; a second constructor "
          f"of the same geometry: {again_s:.2f} s (memoised)", flush=True)
    return build_s


def so_transport_ms(sk, build, label, what):
    """Milliseconds of one SO transport step (``successive.
    transport_step``) at the cell's shapes in float32 on the card: the
    field's source [R, n W] and the segment factors [nseg, W]."""
    import torch
    from sasktran2_tpu_torch.rt import successive
    from sasktran2_tpu_torch.scenarios import so_wavelengths

    config, geometry, viewing, _ = build(sk, "float32", so_wavelengths())
    plan = sk.Engine(config, geometry, viewing)._so_plans[0]
    W = len(so_wavelengths())
    gen = torch.Generator(device="cuda").manual_seed(0)
    j = torch.rand((plan.R, config.num_stokes * W), generator=gen,
                   device="cuda")
    c = torch.rand((plan.nseg, W), generator=gen, device="cuda")
    ms = cuda_ms(lambda: successive.transport_step(plan, j, c), 20)
    stencil = plan.ops["stencil"].m
    print(f"[{label}] {what}: one SO transport step [R={plan.R}, "
          f"{config.num_stokes}x{W}] over {plan.nseg} real segments "
          f"({stencil.values().numel()} stencil entries), f32: {ms:.3f} ms",
          flush=True)
    return ms


def so_case(sk, build, golden_path, what, label, kernels_expected):
    """One successive-orders cell: ``engine_case`` on the 64-wavelength
    grid against its golden file (the generic route by the engine's own
    gates; its cold call must run SO transport steps), then the time of
    one transport step at its shapes."""
    from sasktran2_tpu_torch.scenarios import (
        SO_GOLDEN_INDICES,
        so_wavelengths,
    )

    launches = engine_case(
        sk, build, golden_path, so_wavelengths(), None, what, label,
        kernels_expected, generic="own", idx=SO_GOLDEN_INDICES,
    )
    check(launches["so_transport_steps"] > 0,
          f"{what}: no SO transport step ran")
    return launches, so_transport_ms(sk, build, label, what)


class MieTimer:
    """Device-synchronised wall time of the Mie compute
    (``optical.mie``'s coefficients, efficiencies and amplitudes) while the
    block runs: each function is wrapped, the time between a synchronize
    before and after each call summed."""

    NAMES = ("mie_coefficients", "efficiencies_from_coefficients",
             "amplitudes_from_coefficients")

    def __init__(self):
        from sasktran2_tpu_torch.optical import mie

        self.module, self.seconds, self.calls = mie, 0.0, 0

    def __enter__(self):
        import torch

        self.orig = {n: getattr(self.module, n) for n in self.NAMES}

        def timed(fn):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return wrapper

        for n, fn in self.orig.items():
            setattr(self.module, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def phase_o2a16(sk, label):
    """Phase 23: the optical cell o2a16 (``scenarios.o2a16_case``) on the
    card, against ``golden_o2a16.npz`` (JAX float64). (a) The Mie table
    (``o2a16_mie_table``: 18 distributions x 7 wavelengths, 1,000 radii,
    481 angles, 64 moments) generated on the card into a temporary
    directory: seconds, the Mie compute's share, and every array against
    the golden table within 1e-10 of its largest magnitude. (b) The line
    cross sections at all 101 levels x 4,096 wavenumbers: ms (the second
    of two calls) and peak device memory; per level within 1e-10 of the
    level's largest value at the golden's 10 levels. (c) The engine call
    (EngineIntegratedLineShape, f32, full Jacobians), as ``engine_case``
    times its cells: the cold call, launches, peak memory, the route
    (which must be the JAX engine's for the cell), then one warm call
    with and one without Jacobians, as fine wavelengths/s and
    wavelength-LOS/s, and the rows' share; the device memory resident before the call (what earlier
    phases keep) is printed beside the peak. (d) A Monochromatic call on
    the golden's 16 wavenumbers (line cores, wings, continuum) in float32
    and float64 against the golden (``o2a16_monochromatic``). (e) K1 and
    K3 at the cell's own solver inputs (``o2a16_solver_instances``).
    Returns the launch counts of the engine's cold call and the records
    of K1 and K3 at those inputs."""
    import tempfile

    import torch
    from sasktran2_tpu_torch import scenarios as sc

    golden = dict(np.load(sc.GOLDEN_O2A16_PATH))
    wvn = sc.O2A16_WAVENUMBERS
    W = len(wvn)

    with tempfile.TemporaryDirectory() as root:
        # (a) the Mie table
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with MieTimer() as mt:
            table = sc.o2a16_mie_table(sk, root)
        table_s = time.perf_counter() - t0
        with np.load(table.data_file) as f:
            arrays = {k: f[k] for k in f.files}
    errs = {}
    for key in ("xs_total", "xs_scattering", "lm_a1", "lm_a2", "lm_a3",
                "lm_a4", "lm_b1", "lm_b2"):
        ref = golden[f"table_{key}"]
        check(arrays[key].shape == ref.shape, f"o2a16 table {key} shape")
        errs[key] = float(np.max(np.abs(arrays[key] - ref))
                          / np.max(np.abs(ref)))
    print(f"[{label}] o2a16 Mie table on the card (18 distributions x 7 "
          f"wavelengths, 1,000 radii, 481 angles, 64 moments): "
          f"{table_s:.2f} s, of which the Mie compute {mt.seconds:.2f} s "
          f"({mt.seconds / table_s:.3f}) in {mt.calls} calls; vs the JAX "
          f"f64 golden table, rel to each array's max: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (<= 1e-10); the JAX package's own batch at 750 nm has NaN "
          f"members per grid point {golden['jax_batch_nan_members_750nm']}",
          flush=True)
    for k, v in errs.items():
        check(v <= 1e-10, f"o2a16 Mie table {k} vs the JAX golden")

    # (b) the line cross sections at all 101 levels
    config, geometry, viewing, atmo = sc.o2a16_case(sk, "float32", wvn, table)
    levels = golden["xs_levels"]
    check(np.array_equal(atmo.pressure_pa[levels], golden["xs_pressure_pa"])
          and np.array_equal(atmo.temperature_k[levels],
                             golden["xs_temperature_k"]),
          "o2a16: the golden's levels have another pressure or temperature")
    absorber = sk.optical.LineAbsorber(sc.o2a16_catalogue(sk))
    check(absorber.device.type == "cuda", "the line absorber is not on cuda")
    xs_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xs = absorber.cross_section_grid(wvn, atmo.pressure_pa,
                                         atmo.temperature_k)
        xs_ms.append((time.perf_counter() - t0) * 1e3)
    xs_peak = torch.cuda.max_memory_allocated() / 1e9
    per_level = (np.max(np.abs(xs[levels] - golden["xs"]), axis=1)
                 / np.max(np.abs(golden["xs"]), axis=1))
    print(f"[{label}] o2a16 line cross sections on the card, "
          f"{len(atmo.pressure_pa)} levels x {W} wavenumbers x "
          f"{sc.O2A16_NUM_LINES} lines (f64, blocks of "
          f"{max(1, absorber.max_block_elements // (512 * W))} levels): "
          f"{xs_ms[0]:.1f} ms cold, {xs_ms[1]:.1f} ms warm (to the host), "
          f"peak device memory {xs_peak:.2f} GB; vs the JAX f64 golden at "
          f"levels {levels.tolist()}, per level rel to its max: max "
          f"{per_level.max():.3e} (<= 1e-10)", flush=True)
    check(np.all(np.isfinite(xs)) and per_level.max() <= 1e-10,
          "o2a16 cross sections vs the JAX golden")

    # (c) the engine call
    engine = sk.Engine(config, geometry, viewing)  # no device: the card
    check(engine._device.type == "cuda", "the engine did not default to cuda")
    nlos = len(viewing.observer_rays)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.calculate_radiance(atmo)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    route = "fast path" if engine._fast_route else "generic"
    jax_route = (bool(golden["twostream_fast_ok"])
                 or bool(golden["polarized_fast_ok"]))
    print(f"[{label}] o2a16 nstr=16 P=100 nlos={nlos} Wf={W} -> Wo="
          f"{len(sc.o2a16_output_centers())} f32 with Jacobians: first call "
          f"{first_s:.2f} s, kernel launches {launches}, peak device memory "
          f"{peak_gb:.2f} GB ({resident_gb:.2f} GB of it resident before "
          f"the call), route {route} (the JAX engine's gates for the "
          f"cell: {'fast path' if jax_route else 'generic'}); azimuth "
          f"modes solved {engine._num_azi_eff}", flush=True)
    check(engine._fast_route == jax_route
          and engine._twostream_fast_ok() == bool(golden["twostream_fast_ok"])
          and engine._polarized_fast_ok() == bool(golden["polarized_fast_ok"]),
          "o2a16: the route is not the JAX engine's")
    check(launches["thomas_by_k"].get(16, 0) > 0
          and launches["jacobi_by_n"].get(8, 0) > 0,
          "o2a16: K1 at K = 16 or K3 at n = 8 was not launched")
    check_no_jax(label)
    rad = out["radiance"].to_numpy()
    nout = len(sc.o2a16_output_centers())
    names = [k for k in out.keys() if k.startswith("wf_")]
    finite = np.isfinite(rad).all() and all(
        np.isfinite(out[k].to_numpy()).all() for k in names)
    check(rad.shape == (nout, nlos, 1) and finite and (rad > 0).all(),
          f"o2a16: radiance shape {rad.shape}, finite {finite}")
    check(np.allclose(out.coords["wavelength"],
                      1e7 / sc.o2a16_output_centers(), rtol=0, atol=0),
          "o2a16: the output wavelengths are not the basis centres")
    print(f"[{label}] o2a16: radiance [{nout}, {nlos}, 1] and {len(names)} "
          f"wf_* finite, radiance > 0, on the output basis", flush=True)
    # one warm call: the script must end within its limit, and the cell's
    # device times hold to 1-2% where the host's spread (PERF.md)
    reps = 1
    times = timed_calls(engine, atmo, reps)
    med_jac = statistics.median(times)
    atmo.calculate_derivatives = False
    torch.cuda.reset_peak_memory_stats()
    times_rad = timed_calls(engine, atmo, reps)
    med = statistics.median(times_rad)
    print(f"[{label}] o2a16 warm calls with Jacobians (s): "
          f"{[round(t, 4) for t in times]}; median {med_jac:.4f} s = "
          f"{W / med_jac:.1f} wavelengths/s = {W * nlos / med_jac:.1f} "
          f"wavelength-LOS/s; radiance only {[round(t, 4) for t in times_rad]}"
          f"; median {med:.4f} s = {W / med:.1f} wavelengths/s = "
          f"{W * nlos / med:.1f} wavelength-LOS/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; Jacobian rows: "
          f"{nlos}, ({med_jac:.4f} - {med:.4f}) / {nlos} = "
          f"{(med_jac - med) / nlos:.4f} s per row, "
          f"{(med_jac - med) / med_jac:.3f} of the call (fine wavelengths; "
          f"K1 / K3 launches per call with Jacobians "
          f"{launches['thomas_by_k'].get(16, 0)} / "
          f"{launches['jacobi_by_n'].get(8, 0)})", flush=True)
    RATES["o2a16"] = (W / med_jac, W / med)
    del out, engine, atmo

    # (d) Monochromatic at the golden's 16 wavenumbers
    idx = golden["indices"]
    check(np.array_equal(wvn[idx], golden["wavenumbers_cminv"]),
          "o2a16: the golden is for other wavenumbers")
    o2a16_monochromatic(sk, label, golden, wvn[idx], table)
    return launches, o2a16_solver_instances(sk, label, wvn, table)


def o2a16_solver_instances(sk, label, wvn, table):
    """Phase 23 (e): K1 (K = 16) and K3 (n = 8) at o2a16's own solver
    inputs, as the scalar fast path (``rt.disco_nstream``, one
    eigensolve and one block-Thomas solve per azimuth mode) hands them
    over in a radiance-only f32 call on all fine wavenumbers: azimuth
    modes 0 and 15 captured, each held against the plain twin and a
    float64 truth with phase 8's gates (``phase_thomas_instance``,
    ``phase_jacobi_instance``), mode 0 timed beside the bound and the
    library call. Returns the (thomas, jacobi) records."""
    from sasktran2_tpu_torch import scenarios as sc
    from sasktran2_tpu_torch.rt import disco_nstream

    eig, bvp, calls = capture_engine_inputs(
        sk, lambda sk, dtype, wl: sc.o2a16_case(sk, dtype, wl, table), wvn,
        module=disco_nstream, keep=(0, 15))
    check(calls == (16, 16) and len(eig) == 2 and len(bvp) == 2,
          f"o2a16: {calls} eigensolves and block-Thomas solves in one "
          "radiance-only call (16 and 16 expected, one per azimuth mode)")
    check(tuple(bvp[0][1].shape) == (100, 16, 16, len(wvn))
          and tuple(eig[0].shape) == (100, 8, 8, len(wvn)),
          f"o2a16: solver inputs {tuple(bvp[0][1].shape)} and "
          f"{tuple(eig[0].shape)}")
    thomas_rec = phase_thomas_instance(bvp[0], label, "o2a16 mode 0")
    jacobi_rec = phase_jacobi_instance(eig[0], label, "o2a16 mode 0")
    phase_thomas_instance(bvp[1], label, "o2a16 mode 15", timed=False)
    phase_jacobi_instance(eig[1], label, "o2a16 mode 15", timed=False)
    return thomas_rec, jacobi_rec


# the altitude below which an ill-conditioned weighting function (one
# whose JAX float64 routes differ by more than 1e-8) is held to the
# standard gates (o2a16's rule, PERF.md section 2)
LOW_KM = 60.0


def compare_conditioned(out, golden, idx, f32, low, what, label):
    """Errors against a JAX float64 golden that carries the JAX package's
    own route differences (``jax_route_err_<name>``) and float32 errors
    (``jax_f32_err_<name>``), by ``scenarios.golden_error`` (radiance per
    element, each ``wf_*`` and the ``air_mass_factor`` against its largest
    magnitude), at the wavelength indices ``idx`` of ``out``. Gates:
    radiance 2e-3 (f32) and 1e-8 (f64) per element; each other variable
    5e-2 (f32) and 1e-8 (f64) of its largest magnitude. Where the JAX
    package's own fast path and generic route differ by more than 1e-8 in
    float64 (a variable whose upper levels are ill-conditioned, PERF.md,
    ROADMAP Queue 3), the levels ``low`` (below ``LOW_KM``) are held to
    those gates (still against the largest magnitude of the whole column)
    and the whole column to 1e-7 (f64) and to twice the JAX package's own
    f32 error (f32). Where the golden has the JAX package's own f32 error
    below ``LOW_KM`` (``jax_f32_err_below60_<name>``) and it misses 5e-2
    too (amf16's box AMF), the f32 levels ``low`` are held to twice that
    error. The f32 error per 10 km of altitude is printed, with the JAX
    package's own beside it where the golden has it level by level
    (``jax_f32_err_by_level_<name>``). Every output must be finite."""
    from sasktran2_tpu_torch import scenarios as sc

    dtype = "float32" if f32 else "float64"
    parts, bands, failed = [], [], []
    for name in [k for k in golden if k in ("radiance", "air_mass_factor")
                 or k.startswith("wf_")]:
        got = out[name].to_numpy()
        got = np.take(got, idx, axis=out[name].dims.index("wavelength"))
        check(np.all(np.isfinite(got)), f"{what} {dtype}: {name} finite")
        err = sc.golden_error(name, got, golden[name])
        route = float(golden[f"jax_route_err_{name}"])
        jax_f32 = float(golden[f"jax_f32_err_{name}"])
        tol = 2e-3 if name == "radiance" and f32 else (
            5e-2 if f32 else 1e-8)
        note = f"JAX f32 {jax_f32:.3e}" if f32 else \
            f"JAX routes {route:.3e}"
        if name == "radiance" or route <= 1e-8:
            parts.append(f"{name} {err:.3e} (<= {tol:.3g}; {note})")
            if err > tol:
                failed.append(name)
            continue
        check(out[name].dims[0].endswith("altitude")
              and len(low) == len(got),
              f"{what}: {name} is not on the altitude grid")
        diff = np.abs(got - golden[name]) / np.max(np.abs(golden[name]))
        err_low = float(diff[low].max())
        tol_low = tol
        jax_low = golden.get(f"jax_f32_err_below60_{name}")
        if f32 and jax_low is not None and float(jax_low) > tol:
            # the JAX package's own f32 misses the gate below LOW_KM too
            # (the box AMF, ROADMAP Queue 3): twice its error there
            tol_low = 2.0 * float(jax_low)
        tol_all = 2.0 * jax_f32 if f32 else 1e-7
        parts.append(
            f"{name} below {LOW_KM:g} km {err_low:.3e} (<= {tol_low:.3g}"
            + (f"; JAX f32 {float(jax_low):.3e}" if f32 and jax_low
               is not None else "")
            + f"), whole column {err:.3e} (<= {tol_all:.3g}; {note})")
        if not (err_low <= tol_low and err <= tol_all):
            failed.append(name)
        if f32:
            jax_by_level = golden.get(f"jax_f32_err_by_level_{name}")
            by_band = []
            for k in range(0, len(got), 10):
                e = f"{float(diff[k:k + 10].max()):.2e}"
                if jax_by_level is not None:
                    e += f" (JAX {float(jax_by_level[k:k + 10].max()):.2e})"
                by_band.append(e)
            bands.append(f"{name} " + " ".join(by_band))
    print(f"[{label}] {what} {dtype} at {len(idx)} wavelengths on the card "
          f"vs the JAX f64 golden: " + ", ".join(parts), flush=True)
    if bands:
        print(f"[{label}] {what} f32 error by 10 km of altitude (0-9, "
              f"10-19, ..., 100 km), rel to the column's max: "
              + "; ".join(bands), flush=True)
    check(not failed, f"{what} {dtype}: {', '.join(failed)}")


def o2a16_monochromatic(sk, label, golden, wvn, table):
    """Phase 23 (d): a Monochromatic call of o2a16 at the golden's
    wavenumbers in float32 and float64 on the card against the JAX
    float64 golden, by ``compare_conditioned`` (which states the gates:
    the aerosol's and the Rayleigh pressure weighting functions are the
    ill-conditioned ones)."""
    from sasktran2_tpu_torch import scenarios as sc

    for dtype in ("float32", "float64"):
        config, geometry, viewing, atmo = sc.o2a16_case(
            sk, dtype, wvn, table, mode="Monochromatic")
        low = geometry.altitudes() < LOW_KM * 1e3
        out = sk.Engine(config, geometry, viewing).calculate_radiance(atmo)
        compare_conditioned(out, golden, np.arange(len(wvn)),
                            dtype == "float32", low, "o2a16 Monochromatic",
                            label)


class Capture:
    """Keep a detached copy of the arguments of every call (or of the
    calls numbered in ``keep``, from 0) of a function that a module holds
    by name (``module.name``) while the block runs, calling it as before;
    ``calls`` counts the calls."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.args = module, name, []
        self.keep, self.calls = keep, 0

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            if self.keep is None or self.calls in self.keep:
                self.args.append([a.detach().clone() if hasattr(a, "detach")
                                  else a for a in args])
            self.calls += 1
            return fn(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_dayglowlimb16(sk, label):
    """Phase 24: the O2 A-band dayglow limb scan dayglowlimb16
    (``scenarios.dayglowlimb16_case``) on the card, against
    ``golden_dayglowlimb16.npz`` (JAX float64). The O2 line file is
    written to a temporary database root (``SASKTRAN2_TPU_TORCH_DB_ROOT``)
    and read through ``HITRANLineDatabase``. Prints the host time of the
    ``LimbVertical`` build and of the ``Yankovsky`` solve; then
    ``engine_case`` on the 4,096 wavenumbers (one warm call) with the
    golden's 8 wavenumbers, which also checks that the output's
    ``tangent_altitude`` is the requested one within 1 m and that the
    route is the JAX engine's; then a radiance-only call of the same
    scene with ``PopulationEmissionRate`` in place of the line list,
    whose radiance must equal the line list's within 1e-6 per element
    (relative; absolute where it is 0). ``PopulationEmissionRate`` builds
    its line list from the populations as the scene's line list is built
    (``oxygen_a_band_line_list_weights_from_populations``), so this shows
    only that the two constituents compose the same way on the card, not
    the photochemistry. Returns the launch counts of the engine's cold
    call."""
    import tempfile

    import torch
    from sasktran2_tpu_torch import scenarios as sc

    wvn = sc.DAYGLOW_WAVENUMBERS
    idx = sc.dayglowlimb16_check_indices()
    what = (f"dayglowlimb16 nstr=16 P=100 nlos={len(sc.DAYGLOW_TANGENTS_M)}"
            " (LimbVertical, HITRAN file, Yankovsky airglow)")
    before = os.environ.get("SASKTRAN2_TPU_TORCH_DB_ROOT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["SASKTRAN2_TPU_TORCH_DB_ROOT"] = root
        try:
            sc.write_dayglow_par(root)
            t0 = time.perf_counter()
            container = sc.dayglow_container(sk)
            container_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            catalogue = sk.database.HITRANLineDatabase().load_catalogue("O2")
            par_s = time.perf_counter() - t0
            alts = sc.DAYGLOW_ALTITUDES_M
            p, t = sk.climatology.us76.us76_pressure_temperature(alts)
            t0 = time.perf_counter()
            pops = sc.dayglow_populations(sk, alts, t, p)
            solve_s = time.perf_counter() - t0
            band = sk.photchem.emission.oxygen_a_band_from_catalogue(catalogue)
            print(f"[{label}] dayglowlimb16 host: LimbVertical build "
                  f"({len(container.observer_rays)} rays) "
                  f"{container_s * 1e3:.1f} ms; HITRAN line file parse "
                  f"({len(catalogue.nu0)} lines, {band.wavelength_nm.size} in "
                  f"the A band) {par_s * 1e3:.1f} ms; Yankovsky solve "
                  f"({len(alts)} altitudes) {solve_s * 1e3:.1f} ms; O2(b, v=0)"
                  f" peak {pops[0].max():.3e} m^-3 at "
                  f"{alts[np.argmax(pops[0])] / 1e3:.0f} km", flush=True)
            check(all(np.all(np.isfinite(v)) and np.all(v >= 0)
                      for v in pops.values()),
                  "dayglowlimb16: non-finite or negative populations")

            def check_out(out):
                got = out["tangent_altitude"].to_numpy()
                err = float(np.max(np.abs(got - sc.DAYGLOW_TANGENTS_M)))
                print(f"[{label}] dayglowlimb16: the output's "
                      f"tangent_altitude vs the requested: max |diff| "
                      f"{err:.3e} m (<= 1 m); the container's metadata "
                      f"merged: {sorted(container.geometry_ds.keys())}",
                      flush=True)
                check(err <= 1.0, "dayglowlimb16: tangent_altitude")
                check(all(k in out for k in container.geometry_ds.keys()),
                      "dayglowlimb16: the container's metadata is missing")
                check("wf_airglow_photon_ver" in out,
                      "dayglowlimb16: no wf_airglow_photon_ver")

            launches = engine_case(
                sk, sc.dayglowlimb16_case, sc.GOLDEN_DAYGLOWLIMB16_PATH, wvn,
                1, what, label, kernels_expected={"thomas": [16],
                                                  "jacobi": [8]},
                idx=idx, check_out=check_out)
            print(f"[{label}] dayglowlimb16: K1 / K3 launches per call with "
                  f"Jacobians {launches['thomas_by_k']} / "
                  f"{launches['jacobi_by_n']}", flush=True)

            # the population route: radiance only, against the line list's
            radiance = {}
            engine = None
            for emission in ("line_list", "population"):
                config, geometry, viewing, atmo = sc.dayglowlimb16_case(
                    sk, "float32", wvn, emission=emission)
                atmo.calculate_derivatives = False
                if engine is None:
                    engine = sk.Engine(config, geometry, viewing)
                radiance[emission] = engine.calculate_radiance(atmo)[
                    "radiance"].to_numpy()
            del engine
            torch.cuda.empty_cache()
        finally:
            if before is None:
                os.environ.pop("SASKTRAN2_TPU_TORCH_DB_ROOT", None)
            else:
                os.environ["SASKTRAN2_TPU_TORCH_DB_ROOT"] = before
    err = sc.golden_error("radiance", radiance["population"],
                          radiance["line_list"])
    print(f"[{label}] dayglowlimb16 with PopulationEmissionRate in place of "
          f"the line list, radiance only, f32 W={len(wvn)}: max rel diff "
          f"per element {err:.3e} (<= 1e-6; the B band lies outside the "
          f"grid)", flush=True)
    check(err <= 1e-6, "dayglowlimb16: population vs line-list radiance")
    return launches


def phase_amf16(sk, label):
    """Phase 25: amf16 (``scenarios.amf16_case``: ground16 with a weak
    background absorber and ``AirMassFactor``) through ``engine_case`` in
    float64, the precision its users configure for box AMFs (in float32
    the AMF is ill-conditioned, in the port as in the JAX package, and
    the engine warns), against ``golden_amf16.npz`` by
    ``compare_conditioned``: the ``air_mass_factor`` gated as a weighting
    function, the variables whose JAX routes differ by more than 1e-8 by
    o2a16's rule, in float32 level by level beside the JAX package's own
    float32 error. Returns the launch counts of the cold call."""

    def check_out(out):
        amf = out["air_mass_factor"].to_numpy()
        print(f"[{label}] amf16: air_mass_factor {amf.shape} "
              f"{amf.dtype}, range {amf.min():.4f} to {amf.max():.4f}",
              flush=True)
        check(amf.shape[0] == 101, "amf16: air_mass_factor shape")

    from sasktran2_tpu_torch import scenarios as sc

    return engine_case(
        sk, sc.amf16_case, sc.GOLDEN_AMF16_PATH, sc.smoke_wavelengths(), 3,
        "amf16 nstr=16 P=100 nlos=4 (AirMassFactor)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
        check_out=check_out, dtype="float64")


def phase_tomo2d(sk, label):
    """Phase 26: tomo2d (``scenarios.tomo2d_case``: a ``Geometry2D`` of 101
    altitudes x 41 horizontal angles, 40 ``TangentAltitude`` rays in 4
    images, exact single scatter, 2D aerosol and absorber, W = 64) through
    ``engine_case``: the host 2D trace timed first (the engine
    constructor; the trace is memoised, so every later engine of the
    cell, the float64 check's included, reuses it, which is checked), one
    cold and one warm call with Jacobians and one radiance-only call,
    against ``golden_tomo2d.npz`` (radiance and LOS optical depth at 8
    wavelengths, every ``wf_*`` at 2 of them) by the gates of phase 4.
    The 2D path has no DO solve: K1 and K3 must not launch. Returns the
    launch counts."""
    from sasktran2_tpu_torch import scenarios as sc
    from sasktran2_tpu_torch.rt import singlescatter

    wl = sc.so_wavelengths()
    t0 = time.perf_counter()
    first = sk.Engine(*sc.tomo2d_case(sk, "float32", wl[:1])[:3])
    trace_s = time.perf_counter() - t0
    R, S = first._traced2d.mask.shape
    print(f"[{label}] tomo2d host 2D trace (first engine constructor): "
          f"{trace_s:.2f} s for {R} rays x {S} segments on "
          f"{first._traced2d.nloc} locations ({trace_s / R:.3f} s per ray); "
          f"ray tracer: {first.ray_tracer}", flush=True)

    def memoised(engine, engine_o):
        same = (engine._traced2d is first._traced2d
                and engine_o._traced2d is first._traced2d)
        print(f"[{label}] tomo2d: the float32 and float64 engines reuse the "
              f"memoised trace: {same} ({len(singlescatter._TRACE_2D_CACHE)} "
              f"trace(s) in the memo)", flush=True)
        check(same, "tomo2d: an engine of the same geometry traced again")

    launches = engine_case(
        sk, sc.tomo2d_case, sc.GOLDEN_TOMO2D_PATH, wl, 1,
        "tomo2d 2D A=101 H=41 nlos=40 (exact SS)", label,
        kernels_expected={}, idx=sc.SO_GOLDEN_INDICES,
        check_engines=memoised,
    )
    print(f"[{label}] tomo2d kernel launches with Jacobians: thomas "
          f"{launches['thomas']}, jacobi {launches['jacobi']} (0 and 0: no "
          "DO solve on the 2D path)", flush=True)
    check(launches["thomas"] == 0 and launches["jacobi"] == 0,
          "tomo2d launched a DO kernel")
    return launches


def same_as_unsharded(out_m, out_s, what, label):
    """Radiance and every ``wf_*`` of a split call ``out_m`` against the
    unsharded ``out_s`` at the JAX mesh test's tolerance (rtol 1e-6, atol
    1e-4 of the variable's largest magnitude); prints the largest
    difference of each."""
    worst = {}
    for key in out_s.keys():
        b = out_s[key].to_numpy()
        a = out_m[key].to_numpy()
        peak = np.abs(b).max()
        worst[key] = float(np.abs(a - b).max() / (peak if peak > 0 else 1.0))
        ok = np.allclose(a, b, rtol=1e-6, atol=1e-4 * peak)
        check(ok and a.shape == b.shape,
              f"{what}: {key} differs from the unsharded call")
    print(f"[{label}] {what} vs unsharded (rtol 1e-6, atol 1e-4 x "
          f"peak), largest |difference| / peak: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)


def small_so_case(sk, dtype, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of a small
    successive-orders limb scan (``tests/test_torch_mesh.py``'s): 6
    altitudes, 4 streams, one tangent ray."""
    config = sk.Config(
        num_streams=4,
        multiple_scatter_source=sk.MultipleScatterSource.SuccessiveOrders,
        num_successive_orders_incoming=16,
        num_successive_orders_iterations=4,
        single_scatter_source=sk.SingleScatterSource.Exact,
        dtype=dtype,
    )
    geometry = sk.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 6),
        geometry_type=sk.GeometryType.Spherical,
    )
    viewing = sk.ViewingGeometry()
    viewing.add_ray(sk.TangentAltitudeSolar(30000.0, 0.3, 200000.0, 0.6))
    atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wavelengths_nm)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


def mesh_card_and_cpu(sk, label):
    """``mesh=`` over two devices, the card and the host CPU, one block
    of 2 wavelengths each, in float64 (where the card's kernels and the
    host's plain twins agree to rounding; in float32 the DO solve's own
    rounding, 3e-4 of ground16's radiance against the golden, parts
    them) on ground16, tomo2d and a small successive-orders limb scan
    (new engines; tomo2d's reuses the memoised trace): each split within
    ``same_as_unsharded`` of the unsharded call on the card; K1 and K3
    launched exactly as often as unsharded (the CPU block runs their
    plain twins on the host); and each engine's per-device tables (SO
    plans, 2D operators) on both devices afterwards, so that each block
    ran on its own device's tables."""
    import torch
    from sasktran2_tpu_torch import scenarios as sc
    from sasktran2_tpu_torch.parallel import make_mesh

    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    mesh = make_mesh(devices=[card, cpu])
    wl = sc.smoke_wavelengths()[sc.GOLDEN_INDICES[::2]]
    cases = []
    for what, build, tables in (
        ("ground16_card_cpu", sc.smoke_case, lambda e: []),
        ("tomo2d_card_cpu", sc.tomo2d_case,
         lambda e: [k[0] for k in e._rays2d._on.keys()]),
        ("so_small_card_cpu", small_so_case,
         lambda e: [k[1] for k in e._lazy.keys() if k[0] == "so_plans"]),
    ):
        case = build(sk, "float64", wl)
        cases.append((what, sk.Engine(*case[:3]), case[3], tables))
    for what, engine, atmo, tables in cases:
        reset_launches()
        out_s = engine.calculate_radiance(atmo)
        whole = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        out_m = engine.calculate_radiance(atmo, mesh=mesh)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        split = read_launches()
        devices = tables(engine)
        print(f"[{label}] {what}: W={len(wl)} f64 with Jacobians over "
              f"{[str(d) for d in mesh.wavelength_devices]} in "
              f"{split_s:.3f} s; launches {split['thomas']} / "
              f"{split['jacobi']} (unsharded {whole['thomas']} / "
              f"{whole['jacobi']}); per-device tables on "
              f"{[str(d) for d in devices] or 'none (no such table)'}",
              flush=True)
        same_as_unsharded(out_m, out_s, what, label)
        check(split["thomas"] == whole["thomas"]
              and split["jacobi"] == whole["jacobi"],
              f"{what}: the CPU block launched a kernel on the card")
        check(not devices or {card, cpu} <= set(devices),
              f"{what}: the per-device tables are not on both devices")


def phase_mesh(sk, label):
    """Phase 27: ``calculate_radiance(mesh=)`` on ground16's engine and
    atmosphere from phase 4 (no new host build): ``make_mesh(devices=
    [cuda:0, cuda:0])``, two blocks of 512 wavelengths on the one card,
    each on a host thread of its own. Radiance and every ``wf_*`` must
    match the unsharded call at the JAX mesh test's tolerance
    (``same_as_unsharded``), and K1 and K3 must launch exactly twice as
    often per call as unsharded, instance by instance (each block runs
    the whole model). Times: the unsharded call and two split calls with
    Jacobians. Then ``mesh_card_and_cpu``. Returns the launch counts of a
    split call on the card."""
    import torch
    from sasktran2_tpu_torch.parallel import make_mesh

    engine, atmo = KEPT[GROUND16]
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2)
    print(f"[{label}] mesh: {mesh.shape}, devices "
          f"{[str(d) for d in mesh.wavelength_devices]}", flush=True)

    def call(m):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.calculate_radiance(atmo, mesh=m)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_launches()

    out_s, whole_s, whole = call(None)
    torch.cuda.reset_peak_memory_stats()
    out_m, split_s, split = call(mesh)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, split2_s, _ = call(mesh)
    W = out_s["radiance"].to_numpy().shape[0]
    print(f"[{label}] ground16_mesh2 W={W} f32 with Jacobians: unsharded "
          f"{whole_s:.4f} s ({W / whole_s:.1f} wavelengths/s), split in 2 "
          f"blocks {split_s:.4f} / {split2_s:.4f} s "
          f"({W / split2_s:.1f} wavelengths/s warm); peak device memory of "
          f"the split call {peak_gb:.2f} GB", flush=True)
    same_as_unsharded(out_m, out_s, "ground16_mesh2", label)
    print(f"[{label}] ground16_mesh2 kernel launches per call: {split} "
          f"(unsharded {whole})", flush=True)
    for name, key in (("thomas", "thomas_by_k"), ("jacobi", "jacobi_by_n")):
        check(split[name] == 2 * whole[name] and whole[name] > 0
              and split[key] == {k: 2 * v for k, v in whole[key].items()},
              f"ground16_mesh2: {name} launches are not twice the "
              "unsharded call's")
    mesh_card_and_cpu(sk, label)
    return split


def urls_opened_checked():
    """Replace ``urllib.request.urlopen`` (``urlretrieve`` goes through
    it) by one that fails the script on any URL whose scheme is not
    ``file`` and lists those it opens. Returns (the list, a function
    that puts the original back)."""
    import urllib.parse
    import urllib.request

    opened = []
    real = urllib.request.urlopen

    def urlopen(url, *args, **kwargs):
        name = url if isinstance(url, str) else url.full_url
        check(urllib.parse.urlparse(name).scheme == "file",
              f"phase 28 opened {name!r}, not a file:// URL")
        opened.append(name)
        return real(url, *args, **kwargs)

    urllib.request.urlopen = urlopen

    def restore():
        urllib.request.urlopen = real

    return opened, restore


def web_layer(sk, label, tmp, opened):
    """Phase 28 (a) under the directory ``tmp``; returns the launch
    counts of the call with the web-served absorber."""
    import zipfile

    import torch
    from sasktran2_tpu_torch import scenarios
    from sasktran2_tpu_torch.optical.database import (
        OpticalDatabaseGenericAbsorber,
    )

    table = scenarios.web_cross_section()
    wl_xs = table["coords"]["wavelength_nm"]
    dims, xs = table["data_vars"]["xs"]
    tree, root = tmp / "tree", tmp / "db"
    served = tree / "v_latest" / scenarios.WEB_KEY
    served.parent.mkdir(parents=True)
    np.savez(served, coord_wavelength_nm=wl_xs, xs=xs,
             dims_xs=np.array(dims))
    with zipfile.ZipFile(tree / "bundle.zip", "w") as zf:
        zf.write(served, scenarios.WEB_KEY)

    db = sk.database.StandardDatabase(base_url=tree.as_uri(), db_root=root)
    t0 = time.perf_counter()
    loaded = db.load_ds(scenarios.WEB_KEY)
    fetch_ms = (time.perf_counter() - t0) * 1e3
    cached = root / scenarios.WEB_KEY
    ldims, lxs = loaded["data_vars"]["xs"]
    check(cached.read_bytes() == served.read_bytes(),
          "the cached file differs from the served one")
    check(tuple(ldims) == tuple(dims) and np.array_equal(lxs, xs)
          and np.array_equal(loaded["coords"]["wavelength_nm"], wl_xs),
          "StandardDatabase.load_ds differs from the in-memory table")
    n_open = len(opened)
    check(db.path(scenarios.WEB_KEY) == cached and len(opened) == n_open,
          "a second StandardDatabase.path() fetched again")
    print(f"[{label}] web: StandardDatabase fetched {scenarios.WEB_KEY} "
          f"({cached.stat().st_size} bytes) from the file:// tree and "
          f"loaded it in {fetch_ms:.1f} ms; cached bytes equal to the "
          f"served ones, the table bit-equal to the in-memory one; a "
          f"second path() opened no URL", flush=True)

    wl = scenarios.smoke_wavelengths()
    config, geometry, viewing, atmo = scenarios.smoke_case(sk, "float32", wl)
    alts = geometry.altitudes()
    engine = sk.Engine(config, geometry, viewing)  # no device: the card
    check(engine._device.type == "cuda", "the engine did not default to cuda")

    def call(ds):
        atmo["web_absorber"] = sk.constituent.VMRAltitudeAbsorber(
            OpticalDatabaseGenericAbsorber(db=ds), alts,
            scenarios.web_vmr(alts))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine_outputs(engine.calculate_radiance(atmo))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launches()
    out_web, web_s = call(loaded)
    launches = read_launches()
    out_mem, mem_s = call(table)
    check(set(out_web) == set(out_mem) and "wf_web_absorber" in out_web,
          f"web: outputs {sorted(out_web)}")
    rad = out_web["radiance"]
    check(rad.shape == (len(wl), 4, 1) and bool((rad > 0).all())
          and all(np.isfinite(v).all() for v in out_web.values()),
          "web: non-finite or non-positive output")
    diffs = {k: float(np.abs(out_web[k] - out_mem[k]).max()
                      / max(float(np.abs(out_mem[k]).max()), 1e-300))
             for k in out_mem}
    worst = max(diffs, key=diffs.get)
    print(f"[{label}] web: ground16 + the web-served absorber W={len(wl)} "
          f"f32 with Jacobians ({len(out_web) - 1} wf_*): {web_s:.3f} s, the "
          f"in-memory table's call {mem_s:.3f} s; largest difference over "
          f"the variable's largest magnitude {diffs[worst]:.3e} ({worst}); "
          f"exactly equal: {all(v == 0.0 for v in diffs.values())}; "
          f"kernel launches {launches}", flush=True)
    check(all(v == 0.0 for v in diffs.values()), "web: the web-served "
          "absorber's outputs differ from the in-memory one's")
    for name, key, size in (("thomas", "thomas_by_k", 16),
                            ("jacobi", "jacobi_by_n", 8)):
        check(launches[key].get(size, 0) > 0,
              f"web: the {name} kernel at {size} was not launched")
    check(not launches["torch_op_thomas_by_k"], "web: a torch-op solve")

    zdb = sk.database.ZipWebDatabase((tree / "bundle.zip").as_uri(),
                                     db_root=root / "zip")
    archive = zdb.load()
    extracted = root / "zip" / scenarios.WEB_KEY
    check(extracted.read_bytes() == served.read_bytes(),
          "ZipWebDatabase: the extracted file differs from the served one")
    mtime, n_open = archive.stat().st_mtime_ns, len(opened)
    check(zdb.load() == archive and archive.stat().st_mtime_ns == mtime
          and len(opened) == n_open,
          "ZipWebDatabase: a second load() fetched again")
    schemes = sorted({u.split(":", 1)[0] for u in opened})
    print(f"[{label}] web: ZipWebDatabase extracted {scenarios.WEB_KEY} "
          f"(equal bytes); a second load() opened no URL and left the "
          f"archive's mtime as it was; URLs opened in all: {len(opened)}, "
          f"schemes {schemes}", flush=True)
    return launches


def fd_check(sk, label, num_stokes, variables, top_m=None, step=None):
    """Phase 28 (b): ``numeric_wf`` and ``validate_wf`` on
    ``scenarios.fd16_case`` (levels up to ``top_m``, default
    ``scenarios.FD_TOP_M``; fractional change ``step``, default
    ``scenarios.FD_FRACTIONAL_CHANGE``) in float64 on the card for each
    storage variable of ``variables``; returns the launch counts and
    seconds. The gate is ``validate_wf`` at decimal 5, and on a grid that
    goes above ``FD_TOP_M`` the worst difference is printed per level.
    There, at the default step, the top levels' central differences meet
    float64 roundoff: the levels up to ``FD_TOP_M`` are held at decimal
    5, every level at decimal 4, and the levels that miss decimal 5 are
    named."""
    from sasktran2_tpu_torch import scenarios
    from sasktran2_tpu_torch.test_util import wf

    top_m = scenarios.FD_TOP_M if top_m is None else top_m
    step = scenarios.FD_FRACTIONAL_CHANGE if step is None else step
    what = ("pol16" if num_stokes == 3 else "ground16") + \
        f" 0-{top_m / 1e3:g} km step {step:g}"
    config, geometry, viewing, atmo = scenarios.fd16_case(
        sk, num_stokes, top_m=top_m)
    engine = sk.Engine(config, geometry, viewing)  # no device: the card
    check(engine._device.type == "cuda", "the engine did not default to cuda")
    nalt = len(geometry.altitudes())
    reset_launches()
    t0 = time.perf_counter()
    for var in variables:
        name = {"total_extinction": "wf_extinction", "ssa": "wf_ssa"}[var]
        t1 = time.perf_counter()
        ds = wf.numeric_wf(getattr(atmo.storage, var)[:, 0], step, engine,
                           atmo, name)
        dt = time.perf_counter() - t1
        a = ds[name].to_numpy()
        n = ds[name + "_numeric"].to_numpy()
        dims = ds[name].dims
        check(a.shape == (nalt, 1, 4, num_stokes)
              and np.isfinite(a).all() and np.isfinite(n).all(),
              f"FD {what} {name}: shape {a.shape} or non-finite values")
        ax = dims.index("altitude")
        scale = np.abs(a).max(axis=ax, keepdims=True)
        rel = np.abs(a - n) / np.where(scale == 0, 1e99, scale)
        per_stokes = [float(rel[..., s].max()) for s in range(num_stokes)]
        significant = np.abs(a) > 1e-3 * np.abs(a).max()
        nonzero = bool((n[significant] != 0).all())
        print(f"[{label}] FD {what} f64 W=1 A={nalt} {name}: "
              f"{2 * nalt + 1} calls in {dt:.2f} s; worst |analytic - "
              f"numeric| / max over altitude per Stokes component "
              f"{['%.3e' % v for v in per_stokes]} (decimal 5: < 1.5e-5); "
              f"numeric nonzero where |analytic| > 1e-3 max: {nonzero} "
              f"({int(significant.sum())} of {a.size})", flush=True)
        if top_m > scenarios.FD_TOP_M:
            alts = geometry.altitudes()
            per_level = np.moveaxis(rel, ax, 0).reshape(nalt, -1).max(axis=1)
            low = alts <= scenarios.FD_TOP_M
            missed = [f"{z / 1e3:g} km {r:.3e}"
                      for z, r in zip(alts, per_level) if r >= 1.5e-5]
            print(f"[{label}] FD {what} {name} per level (km: worst): "
                  + ", ".join(f"{z / 1e3:g}: {r:.3e}"
                              for z, r in zip(alts, per_level)), flush=True)
            print(f"[{label}] FD {what} {name}: worst up to "
                  f"{scenarios.FD_TOP_M / 1e3:g} km {per_level[low].max():.3e}"
                  f", above it {per_level[~low].max():.3e}; levels that miss "
                  f"decimal 5: {missed or 'none'}; decimal 4 (< 1.5e-4) at "
                  f"every level: {bool(per_level.max() < 1.5e-4)}", flush=True)
        gate = 5
        if top_m > scenarios.FD_TOP_M and step == \
                scenarios.FD_FRACTIONAL_CHANGE:
            check(per_level[low].max() < 1.5e-5,
                  f"FD {what} {name}: decimal 5 missed at or below "
                  f"{scenarios.FD_TOP_M / 1e3:g} km")
            gate = 4
        try:
            wf.validate_wf(ds[name], ds[name + "_numeric"],
                           wf_dim="altitude", decimal=gate)
        except AssertionError as e:
            fail(f"FD {what} {name}: validate_wf at decimal {gate}: {e}")
        check(nonzero, f"FD {what} {name}: a numeric WF is 0 where the "
              "analytic one is significant")
    launches = read_launches()
    total = time.perf_counter() - t0
    print(f"[{label}] FD {what}: {total:.2f} s; kernel launches "
          f"{launches}", flush=True)
    k, n = (48, 24) if num_stokes == 3 else (16, 8)
    check(launches["thomas_by_k"].get(k, 0) > 0
          and launches["jacobi_by_n"].get(n, 0) > 0,
          f"FD {what}: K1 at K = {k} or K3 at n = {n} was not launched")
    check(not launches["torch_op_thomas_by_k"], f"FD {what}: a torch-op solve")
    return launches, total


def phase_web_and_test_util(sk, label):
    """Phase 28: the web layer (a) and the FD check of the WFs (b); see
    the module's docstring. Returns the launch counts of (a), and of (b)
    for ground16 and pol16, and of (b) on 0-100 km by name."""
    import tempfile
    from pathlib import Path

    opened, restore = urls_opened_checked()
    try:
        with tempfile.TemporaryDirectory(prefix="sk_web_") as d:
            web = web_layer(sk, label, Path(d), opened)
    finally:
        restore()
    from sasktran2_tpu_torch import scenarios

    t0 = time.perf_counter()
    ground, ground_s = fd_check(sk, label, 1, ("total_extinction", "ssa"))
    pol, pol_s = fd_check(sk, label, 3, ("total_extinction",))
    # the cells' own 0-100 km at the same 41 levels, at the step of the
    # JAX tests and at a tenfold step, whose roundoff is tenfold smaller
    cell, cell_s = {}, []
    for stokes, what in ((1, "ground16"), (3, "pol16")):
        for step in (scenarios.FD_FRACTIONAL_CHANGE,
                     scenarios.FD_CELL_STEP):
            key = f"fd_{what}_f64_0_100km_step{step:g}"
            cell[key], dt = fd_check(sk, label, stokes, ("total_extinction",),
                                     scenarios.FD_CELL_TOP_M, step)
            cell_s.append(round(dt, 2))
    print(f"[{label}] FD checks: ground16 {ground_s:.2f} s, pol16 "
          f"{pol_s:.2f} s; on 0-{scenarios.FD_CELL_TOP_M / 1e3:g} km "
          f"{cell_s} s; {time.perf_counter() - t0:.2f} s in all", flush=True)
    return web, ground, pol, cell


def capture_engine_inputs(sk, build, wl, module=None, keep=None):
    """The eigensolve and block-Thomas inputs of an engine case's
    radiance-only f32 call on the card, as ``module`` (default: the
    polarized solver's ``rt.disco_vec_minor``, one call per mode; the
    scalar fast path's ``rt.disco_nstream``, one call per mode; the
    generic route's ``ops.lanes``, one call per solve) hands them to
    ``lane_jacobi_eigh_scan`` and ``lane_block_thomas_solve``: two lists,
    one entry per call (or per call numbered in ``keep``), of [P, n, n, W]
    matrices and (lo, di, up, rhs) systems, and the number of calls of
    each."""
    from sasktran2_tpu_torch.rt import disco_vec_minor

    module = disco_vec_minor if module is None else module
    config, geometry, viewing, atmo = build(sk, "float32", wl)
    atmo.calculate_derivatives = False
    engine = sk.Engine(config, geometry, viewing)
    with Capture(module, "lane_jacobi_eigh_scan", keep) as eig, \
            Capture(module, "lane_block_thomas_solve", keep) as bvp:
        engine.calculate_radiance(atmo)
    return ([c[0] for c in eig.args], [c[:4] for c in bvp.args],
            (eig.calls, bvp.calls))


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


def phase_jacobi_instance(a32, label, what, timed=True):
    """K3 at an engine's own matrices ``a32`` [P, n, n, W] (f32): the
    kernel against its plain twin (eigenvalues, sorted, against a float64
    truth of 12 sweeps: error <= max(4 x the plain twin's, 1e-5), relative
    to max |A|), the eigen-residual of both at the engine's 7 sweeps (the
    kernel's <= 1e-5 of max |A|) and of the kernel at 10; where ``timed``,
    the record: time, bound and ``torch.linalg.eigh``'s time."""
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
    if not timed:
        return None
    rec = {"max_abs_err": float((w - wp).abs().max())}
    rec["ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh(a32, 7), 10)
    rec["plain_ms"] = cuda_ms(lambda: jacobi_cuda.jacobi_eigh_plain(a32, 7), 2)
    rec["bound_ms"], rec["bound_by"] = jacobi_bound(P, n, W, 7, 4)
    batch = a32.permute(0, 3, 1, 2).reshape(P * W, n, n).contiguous()
    rec["library_ms"] = library_eigh_ms(batch, label, magma=False)
    return rec


def phase_thomas_instance(system32, label, what, timed=True):
    """K1/K2 at an engine's own block-tridiagonal system (f32): the kernel
    and its plain twin against a float64 solve of the same system, error
    relative to max |x| <= max(4 x the plain twin's, 1e-5), and the kernel
    on the system in float64 within 1e-10 of it; where ``timed``, the
    record: time, bound and the dense ``torch.linalg.solve``'s time."""
    import torch
    from sasktran2_tpu_torch.ops import thomas_cuda

    P, K, _, W = system32[1].shape
    system64 = [t.double() for t in system32]
    truth = thomas_cuda.thomas_solve_plain(*system64)
    xk = thomas_cuda.thomas_solve(*system32).double()
    xp = thomas_cuda.thomas_solve_plain(*system32).double()
    x64 = thomas_cuda.thomas_solve(*system64)
    scale = float(truth.abs().max())
    err_k = float((xk - truth).abs().max()) / scale
    err_p = float((xp - truth).abs().max()) / scale
    err_64 = float((x64 - truth).abs().max()) / scale
    del system64, x64
    torch.cuda.synchronize()
    print(f"[{label}] K1/K2 thomas at {what}'s own system [{P}, {K}, {K}, "
          f"{W}] f32: vs f64 solve rel {err_k:.3e} (<= max(4 x plain "
          f"{err_p:.3e}, 1e-5)); the kernel in f64 rel {err_64:.3e} "
          "(<= 1e-10)", flush=True)
    check(err_k <= max(4.0 * err_p, 1e-5), f"thomas instance K={K}")
    check(err_64 <= 1e-10, f"thomas instance K={K} f64")
    if not timed:
        return None
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
        sk, smoke_case, GOLDEN_PATH, wl, 5, GROUND16,
        label, kernels_expected={"thomas": [16], "jacobi": [8]}, keep=True,
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
        from sasktran2_tpu_torch.ops import (
            _build,
            jacobi_cuda,
            lanes,
            thomas_cuda,
        )
        from sasktran2_tpu_torch.scenarios import (
            GOLDEN_BRDF16_PATH,
            GOLDEN_FLUX16_PATH,
            GOLDEN_PATH,
            GOLDEN_POL4_PATH,
            GOLDEN_POLBRDF4_PATH,
            GOLDEN_POLFLUX4_PATH,
            GOLDEN_POLSOLIMB16_PATH,
            GOLDEN_POLTHERMALLIMB4_PATH,
            GOLDEN_SOLIMB16_DOINIT_PATH,
            GOLDEN_SOLIMB16_PATH,
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
            polsolimb16_case,
            polthermallimb4_case,
            smoke_case,
            smoke_wavelengths,
            so_wavelengths,
            solimb16_case,
            solimb16_doinit_case,
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

    phase_done(label, 1)
    wl = smoke_wavelengths()
    thomas_rec, jacobi_rec, launches, limb_launches = phases_2_to_7(
        sk, dev, wl, label)
    phase_done(label, "2-7")
    # --- phase 8: the kernel instances of the polarized path ----------------
    # each at a polarized engine's own inputs (a radiance-only call)
    eig4, bvp4, _ = capture_engine_inputs(sk, pol4_case, wl)
    eig16, bvp16, _ = capture_engine_inputs(sk, pol16_case, wl)
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
    # the pivoting branch at pol16's own system; its plain twin is the
    # torch-op loop that solved it before (pivoted torch.linalg.solve)
    thomas48_rec = phase_thomas_instance(bvp16[0], label, "pol16")
    print(f"[{label}] pol16 BVP [100, 48, 48, 1024] f32: pivoting kernel "
          f"{thomas48_rec['ms']:.3f} ms per solve, bound "
          f"{thomas48_rec['bound_ms']:.4f} ms ({thomas48_rec['bound_by']}), "
          f"share {thomas48_rec['bound_ms'] / thomas48_rec['ms']:.4f}; the "
          f"plain loop {thomas48_rec['plain_ms']:.3f} ms; dense "
          f"torch.linalg.solve {thomas48_rec['library_ms']:.3f} ms",
          flush=True)
    del eig4, bvp4, eig16, bvp16
    phase_done(label, 8)

    # --- phase 9: flux observers ----------------------------------------------
    flux_launches = engine_case(
        sk, flux16_case, GOLDEN_FLUX16_PATH, wl, 3,
        "flux nstr=16 P=100 nlos=1 nobs=6 (4 types)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    phase_done(label, 9)

    # --- phase 10: polarized, 4 streams -----------------------------------------
    pol4_launches = engine_case(
        sk, pol4_case, GOLDEN_POL4_PATH, wl, 3,
        "pol4 nstr=4 P=100 nlos=4 (I, Q, U)", label,
        kernels_expected={"thomas": [12], "jacobi": [6]},
    )
    phase_done(label, 10)

    # --- phase 11: polarized, 16 streams ---------------------------------------
    phase_pol16_solver(label)
    # no warm call with Jacobians for the two 16-stream polarized cases
    # (their cold call's time stands for it): a call with Jacobians takes
    # 35-60 s on the H100 (PERF.md), and the script must end within
    # 1,200 s
    pol16_launches = engine_case(
        sk, pol16_case, None, wl, 0,
        "pol16 nstr=16 P=100 nlos=4 (I, Q, U)", label,
        kernels_expected={"jacobi": [24], "thomas": [48]},
    )
    phase_dolp_16_vs_8(label)
    phase_done(label, 11)

    # --- phase 12: polarized limb scan, 16 streams ------------------------------
    limbpol_launches = engine_case(
        sk, limbpol16_case, None, wl, 0,
        f"limbpol16 nstr=16 P=100 nlos={LIMBPOL_NUM_LOS} (I, Q, U)", label,
        kernels_expected={"jacobi": [24], "thomas": [48]},
    )
    phase_done(label, 12)

    # --- phase 13: BRDF surface, every azimuth mode -------------------------------
    brdf_launches = engine_case(
        sk, brdf16_case, GOLDEN_BRDF16_PATH, wl, 1,
        "brdf16 nstr=16 P=100 nlos=4 (MODIS)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    ratio = brdf_launches["thomas"] / launches["thomas"]
    print(f"[{label}] brdf16 Thomas launches per call {brdf_launches['thomas']}"
          f" against ground16's {launches['thomas']}: {ratio:.3f} x (>= 16/3 "
          f"= {16 / 3:.3f}: all 16 modes against Rayleigh's 3)", flush=True)
    check(3 * brdf_launches["thomas"] >= 16 * launches["thomas"],
          "brdf16 did not solve every azimuth mode")
    phase_done(label, 13)

    # --- phases 14, 15: thermal emission, ground-viewing with fluxes, limb --------
    twl = thermal_wavelengths()  # phases 14, 15 and 19
    thermal_launches = engine_case(
        sk, thermal16_case, GOLDEN_THERMAL16_PATH, twl, 3,
        "thermal16 nstr=16 P=100 nlos=4 nobs=6 (4 types)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    thermallimb_launches = engine_case(
        sk, thermallimb16_case, GOLDEN_THERMALLIMB16_PATH, twl, 1,
        "thermallimb16 nstr=16 P=100 nlos=20", label,
        kernels_expected={"thomas": [16], "jacobi": [8]},
    )
    phase_done(label, "14-15")

    # --- phases 16-19: the generic per-wavelength route -------------------------
    generic_launches = engine_case(
        sk, smoke_case, GOLDEN_PATH, wl, 3,
        "generic16 nstr=16 P=100 nlos=4 (generic route forced)", label,
        kernels_expected={"thomas": [16], "jacobi": [8]}, generic="forced",
    )
    fast_rate = RATES[GROUND16]
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
        sk, polthermallimb4_case, GOLDEN_POLTHERMALLIMB4_PATH, twl, 1,
        f"polthermallimb4 nstr=4 P=100 nlos={POLTHERMAL_NUM_LOS} (I, Q, U)",
        label, kernels_expected={"thomas": [12], "jacobi": [6]},
        generic="own", qu_scale=QU_SCALE["polthermallimb4"],
    )

    phase_done(label, "16-19")

    # --- phases 20-22: successive orders ---------------------------------------
    so_build_s = phase_so_build(sk, label)
    solimb_launches, so_ms = so_case(
        sk, solimb16_case, GOLDEN_SOLIMB16_PATH,
        "solimb16 SO nstr=16 A=51 nlos=20 D=100", label, {},
    )
    phase_done(label, 20)
    sodo_launches, sodo_ms = so_case(
        sk, solimb16_doinit_case, GOLDEN_SOLIMB16_DOINIT_PATH,
        "solimb16_doinit SO nstr=16 A=51 nlos=20 D=100 (DO-initialised)",
        label, {"thomas": [16], "jacobi": [8]},
    )
    # K1 and K3 at the DO seed's own inputs: the one plane-parallel solve
    # of all 16 azimuth modes and 64 wavelengths ([50, ..., 16 x 64])
    eig_do, bvp_do, _ = capture_engine_inputs(
        sk, solimb16_doinit_case, so_wavelengths(), module=lanes)
    check(len(eig_do) == 1 and len(bvp_do) == 1,
          f"solimb16_doinit: {len(eig_do)} eigensolves and {len(bvp_do)} "
          "block-Thomas solves in one radiance-only call (1 and 1 expected)")
    # the generic route hands the kernels permuted views of its lanes,
    # which the wrappers copy contiguous: timed as the path calls them,
    # and in the records on contiguous copies (the kernels' own time)
    sys_do, a_do = bvp_do[0], eig_do[0]
    path_ms = (cuda_ms(lambda: thomas_cuda.thomas_solve(*sys_do), 20),
               cuda_ms(lambda: jacobi_cuda.jacobi_eigh(a_do, 7), 10))
    thomas_do_rec = phase_thomas_instance(
        [t.contiguous() for t in sys_do], label, "solimb16_doinit")
    jacobi_do_rec = phase_jacobi_instance(
        a_do.contiguous(), label, "solimb16_doinit")
    print(f"[{label}] solimb16_doinit K1 / K3 on the generic route's own "
          f"lane layout (permuted views, copied contiguous by the "
          f"wrappers): {path_ms[0]:.3f} / {path_ms[1]:.3f} ms per call, "
          f"against {thomas_do_rec['ms']:.3f} / {jacobi_do_rec['ms']:.3f} "
          f"ms on contiguous inputs", flush=True)
    del eig_do, bvp_do, sys_do, a_do
    phase_done(label, 21)
    polso_launches, polso_ms = so_case(
        sk, polsolimb16_case, GOLDEN_POLSOLIMB16_PATH,
        "polsolimb16 SO nstr=16 A=51 nlos=20 D=100 (I, Q, U)", label, {},
    )
    phase_done(label, 22)

    # --- phase 23: the optical cell ---------------------------------------------
    o2a_launches, (thomas_o2a_rec, jacobi_o2a_rec) = phase_o2a16(sk, label)
    phase_done(label, 23)

    # --- phase 24: the O2 A-band dayglow limb scan --------------------------------
    dayglow_launches = phase_dayglowlimb16(sk, label)
    phase_done(label, 24)

    # --- phase 25: box air-mass factors ------------------------------------------
    amf_launches = phase_amf16(sk, label)
    phase_done(label, 25)

    # --- phase 26: the 2D tomographic limb cell ---------------------------------
    tomo_launches = phase_tomo2d(sk, label)
    phase_done(label, 26)

    # --- phase 27: the mesh= wavelength split on ground16 -------------------------
    mesh_launches = phase_mesh(sk, label)
    phase_done(label, 27)

    # --- phase 28: the web layer and the test utilities ----------------------
    web_launches, fd_ground_launches, fd_pol_launches, fd_cell_launches = (
        phase_web_and_test_util(sk, label))
    phase_done(label, 28)

    check_no_jax(label)
    by_path = {
        "ground16": launches, "limb16": limb_launches, "flux16": flux_launches,
        "pol4": pol4_launches, "pol16": pol16_launches,
        "limbpol16": limbpol_launches, "brdf16": brdf_launches,
        "thermal16": thermal_launches, "thermallimb16": thermallimb_launches,
        "generic16": generic_launches, "polbrdf4": polbrdf_launches,
        "polflux4": polflux_launches, "polthermallimb4": polthermal_launches,
        "solimb16_doinit": sodo_launches, "o2a16": o2a_launches,
        "dayglowlimb16": dayglow_launches, "amf16": amf_launches,
        "tomo2d": tomo_launches, "ground16_mesh2": mesh_launches,
        "web_ground16": web_launches, "fd_ground16_f64": fd_ground_launches,
        "fd_pol16_f64": fd_pol_launches, **fd_cell_launches,
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
        {"name": "thomas_block_tridiag_solve K=48 (pol16; pivoting branch)",
         **thomas, **instance("thomas", 48, "pol16"), **thomas48_rec},
        {"name": "jacobi_eigh", **jacobi,
         **instance("jacobi", 8, "ground16"), **jacobi_rec},
        {"name": "jacobi_eigh n=6 (pol4)", **jacobi,
         **instance("jacobi", 6, "pol4"), **jacobi6_rec},
        {"name": "jacobi_eigh n=24 (pol16)", **jacobi,
         **instance("jacobi", 24, "pol16"), **jacobi24_rec},
        {"name": "thomas_block_tridiag_solve K=16 (solimb16_doinit)",
         **thomas, **instance("thomas", 16, "solimb16_doinit"),
         **thomas_do_rec},
        {"name": "jacobi_eigh n=8 (solimb16_doinit)", **jacobi,
         **instance("jacobi", 8, "solimb16_doinit"), **jacobi_do_rec},
        {"name": "thomas_block_tridiag_solve K=16 (o2a16)", **thomas,
         **instance("thomas", 16, "o2a16"), **thomas_o2a_rec},
        {"name": "jacobi_eigh n=8 (o2a16)", **jacobi,
         **instance("jacobi", 8, "o2a16"), **jacobi_o2a_rec},
    ]
    torch_op_paths = [
        {"name": "so_transport_step",
         "route": "torch ops (sparse CSR products); the JAX package's "
                  "transport is XLA gathers, no Pallas kernel",
         "source": "sasktran2_tpu_torch/rt/successive.py (transport_step)",
         "calls": solimb_launches["so_transport_steps"],
         "calls_by_path": {
             "solimb16": solimb_launches["so_transport_steps"],
             "solimb16_doinit": sodo_launches["so_transport_steps"],
             "polsolimb16": polso_launches["so_transport_steps"]},
         "ms": so_ms,
         "ms_by_path": {"solimb16": so_ms, "solimb16_doinit": sodo_ms,
                        "polsolimb16": polso_ms},
         "so_geometry_host_build_s": so_build_s},
    ]
    print(json.dumps({"kernels": kernels, "torch_op_paths": torch_op_paths}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
