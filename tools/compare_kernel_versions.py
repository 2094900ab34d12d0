"""Time two versions of the port's Thomas and Jacobi kernels on one GPU.

    python tools/compare_kernel_versions.py [--old-thomas OLD_thomas.cu] \
        [--old-jacobi OLD_jacobi.cu] [--build-dir tmp/old_kernels]

The old sources are earlier versions of ``sasktran2_tpu_torch/csrc/
thomas.cu`` and ``jacobi.cu``, for example from ``git show
<commit>:sasktran2_tpu_torch/csrc/jacobi.cu``; they are compiled with the
port's nvcc flags into ``--build-dir`` and never enter the package. Each
kernel whose old source is given is compared; the current sources are
built by the package. An old ``jacobi.cu`` must have the current entry
points (``ops/jacobi_cuda._SIGNATURE``); the earlier local-memory
version's interface is not bound (its n = 12 and 24 times stay in
PERF.md's kernel table). In f32 at the engines' shapes (Thomas
[100, 16, 16, 1024]; Jacobi [100, n, n, 1024] with 7 sweeps at n = 6, 8, 12
and 24) the script times old, new, new, old, each by CUDA events, and
prints the card's name and power limit, the ptxas report of every build,
each time, and the largest difference between the two versions' outputs.
Needs a GPU.

Every change that makes one of these kernels faster runs it once, so
that PERF.md's kernel table keeps the earlier time beside the new one
from the same card and call.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _bind(path, fn_name, argtypes):
    fn = getattr(ctypes.CDLL(path), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-thomas")
    ap.add_argument("--old-jacobi")
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "tmp",
                                                        "old_kernels"))
    args = ap.parse_args()

    import numpy as np
    import torch

    from chip_smoke import card_label, cuda_ms, ptxas_summary, thomas_inputs
    from sasktran2_tpu_torch.ops import _build, jacobi_cuda, thomas_cuda

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    label = card_label()
    print(label, flush=True)
    dev = torch.device("cuda:0")

    olds = {"thomas": args.old_thomas, "jacobi": args.old_jacobi}
    libs = {}
    for name, src in olds.items():
        if src is None:
            continue
        out = os.path.join(os.path.abspath(args.build_dir), f"libold_{name}.so")
        libs["old", name] = _build.compile_library(os.path.abspath(src), out)
        libs["new", name] = _build.build(name)
    if not libs:
        sys.exit("give --old-thomas, --old-jacobi or both")
    for (version, name), path in sorted(libs.items()):
        for ln in ptxas_summary(path[:-3] + ".log"):
            print(f"[{label}] {version} ptxas {ln}", flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    f32 = torch.float32
    fns = {}

    # --- Thomas ---------------------------------------------------------------
    if args.old_thomas is not None:
        P, K, W = 100, 16, 1024
        lo, di, up, r = [t.to(f32) for t in thomas_inputs(
            P, K, W, 3, torch.float64, dev, 13.0)]
        sig = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
        outs = {}
        for version in ("old", "new"):
            fns[version] = _bind(libs[version, "thomas"], "thomas_solve_f32",
                                 sig)
            outs[version] = (torch.empty_like(di), torch.empty_like(r),
                             torch.empty_like(r))

        def thomas(version):
            c, y, x = outs[version]
            err = fns[version](lo.data_ptr(), di.data_ptr(), up.data_ptr(),
                               r.data_ptr(), c.data_ptr(), y.data_ptr(),
                               x.data_ptr(), P, K, W, stream)
            _build.check_launch(err, f"{version} thomas")

        times = [(v, cuda_ms(lambda v=v: thomas(v), 20))
                 for v in ("old", "new", "new", "old")]
        torch.cuda.synchronize()
        diff = float((outs["old"][2] - outs["new"][2]).abs().max())
        ref = thomas_cuda.thomas_solve_plain(
            *[t.double() for t in (lo, di, up, r)])
        errs = {v: float((outs[v][2].double() - ref).abs().max())
                for v in ("old", "new")}
        print(f"[{label}] thomas [{P}, {K}, {K}, {W}] f32, ms per launch in "
              "turns " + ", ".join(f"{v} {t:.4f}" for v, t in times)
              + f"; max |x_old - x_new| {diff:.3e}; error vs f64 plain: old "
              f"{errs['old']:.3e}, new {errs['new']:.3e}", flush=True)

    # --- Jacobi ---------------------------------------------------------------
    if args.old_jacobi is not None:
        for version in ("old", "new"):
            fns[version] = _bind(libs[version, "jacobi"], "jacobi_eigh_f32",
                                 jacobi_cuda._SIGNATURE)
        for P, n, W in [(100, 6, 1024), (100, 8, 1024), (100, 12, 1024),
                        (100, 24, 1024)]:
            a = np.random.default_rng(P + n).normal(size=(P, n, n, W))
            a = torch.as_tensor(0.5 * (a + np.swapaxes(a, -3, -2)), dtype=f32,
                                device=dev)
            jouts = {v: (torch.empty((P, n, W), dtype=f32, device=dev),
                         torch.empty_like(a)) for v in ("old", "new")}
            jargs = {v: jacobi_cuda.kernel_args(a, *jouts[v], 7)
                     for v in ("old", "new")}

            def jacobi(version, jargs=jargs):
                err = fns[version](*jargs[version], stream)
                _build.check_launch(err, f"{version} jacobi")

            reps = 20 if n <= 12 else 5
            times = [(v, cuda_ms(lambda v=v: jacobi(v), reps))
                     for v in ("old", "new", "new", "old")]
            torch.cuda.synchronize()
            wdiff = float((jouts["old"][0] - jouts["new"][0]).abs().max())
            wp, _ = jacobi_cuda.jacobi_eigh_plain(a, 7)
            print(f"[{label}] jacobi [{P}, {n}, {n}, {W}] f32 7 sweeps, ms per "
                  "launch in turns "
                  + ", ".join(f"{v} {t:.4f}" for v, t in times)
                  + f"; max |w_old - w_new| {wdiff:.3e}; max |w_new - w_plain| "
                  f"{float((jouts['new'][0] - wp).abs().max()):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
