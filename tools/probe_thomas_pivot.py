"""Where the Thomas kernel's pivoting branch spends its time, on one GPU.

    python tools/probe_thomas_pivot.py [--build-dir tmp/probe_thomas]

Builds variants of ``sasktran2_tpu_torch/csrc/thomas.cu`` made by text
substitution (each substitution must match the source once) with the
port's nvcc flags, all at once, into ``--build-dir`` (they never enter the
package), and times each at [100, 48, 48, 1024] f32 by CUDA events, in
turns (all variants, then all in reverse order), with its error against
the float64 plain twin and its ptxas report. Needs a GPU.

The variants of the design: the source as it is (a warp per lane, the
steps in unrolled chunks of 8); the pivot search beside the step's
update (ahead of it, on column s + 1 as the update will leave it)
instead of after it; the arg-max by butterfly shuffles instead of
``redux.sync``; chunks of 4 and of 16 steps; the next layer's copies in
one burst after the product instead of spread over the steps; the back
substitution reading its records from device memory instead of
from shared memory, where cp.async brings them a layer ahead. The
probes leave out one part: the pivot search (the diagonal is taken; the
inputs do not need pivoting, so the result stays right), the publishing
of the next pivot row, the step's update, the moving of the denom slots
between chunks, the product lo c[p-1], the whole elimination, the copies
of the next layer into shared memory, the back substitution; but for
the first, their results are wrong and their times say what that part
costs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COPY = ("        if (k < PPC && c0 / SC * PPC + k < PARTS && p + 1 < P) "
        "copy_part(p + 1, c0 / SC * PPC + k);\n")
SEARCH = """            T v[MR];
#pragma unroll
            for (int m = 0; m < MR; ++m) v[m] = a[m][c1 / CG];
            T vp;
            const int ps1 = find_pivot(v, c1 % 2, vp);
"""
PROW = "          const T* const prow = pr + (b * CG + hh) * PW;\n"

VARIANTS = {
    "as_is": [],
    "search_beside_update": [
        (PROW, PROW + """          const bool ahead0 = s + 1 < K;
          T v[MR];
          T vp = T(1);
          int ps1 = 0;
          if (ahead0 && wq == ((k + 1) % CG) / 2) {
            const T pv1 = prow[(k + 1) / CG];
#pragma unroll
            for (int m = 0; m < MR; ++m) v[m] = a[m][(k + 1) / CG] - f[m] * pv1;
            ps1 = find_pivot(v, (k + 1) % 2, vp);
          }
"""),
        (SEARCH, "")],
    "argmax_shuffles": [
        ("  return __reduce_max_sync(FULL, k);",
         "  for (int o = 16; o > 0; o >>= 1) {\n"
         "    const unsigned ok = __shfl_xor_sync(FULL, k, o);\n"
         "    k = ok > k ? ok : k;\n  }\n  return k;"),
        ("static_cast<int>(__reduce_min_sync(FULL, cand))",
         "static_cast<int>([&] {\n      unsigned c = cand;\n"
         "      for (int o = 16; o > 0; o >>= 1) {\n"
         "        const unsigned oc = __shfl_xor_sync(FULL, c, o);\n"
         "        c = oc < c ? oc : c;\n      }\n      return c;\n    }())"),
    ],
    "chunks_of_4": [("  constexpr int SC = 8;", "  constexpr int SC = 4;")],
    "chunks_of_16": [("  constexpr int SC = 8;", "  constexpr int SC = 16;")],
    "copies_in_a_burst": [
        (COPY, ""),
        ("    if (p + 1 < P) load_r(p + 1);",
         "    if (p + 1 < P) {\n      load_r(p + 1);\n"
         "      for (int part = 0; part < PARTS; ++part) copy_part(p + 1, part);\n    }")],
    "back_substitution_from_global": [
        ("      __syncwarp();  // layer p's record is in shared memory\n"
         "      const T* rec = rb + (p & 1) * S::REC;",
         "      __syncwarp();  // layer p's record is in shared memory\n"
         "      const T* rec = rec0 + p * rec_layer;")],
    # the probes: each leaves out one part
    "no_search": [(SEARCH, """            T v[MR];
#pragma unroll
            for (int m = 0; m < MR; ++m) v[m] = a[m][c1 / CG];
            T vp;
            const int ps1 = s + 1;
            {
              T vs = v[0];
#pragma unroll
              for (int m = 1; m < MR; ++m) vs = ps1 / RG == m ? v[m] : vs;
              vp = __shfl_sync(FULL, vs, 2 * (ps1 % RG) + c1 % 2);
            }
""")],
    "no_publish": [("            publish(ps1, b ^ 1, k == SC - 1 ? SH : 0);\n", "")],
    "denom_every_slot_every_chunk": [("            if (c0 < PK / 2) {\n", "            {\n")],
    "no_update": [
        ("a[m][q * V + d] -= f[m] * pv[d];", "a[m][q * V + d] += T(0);"),
        ("u[m][n] -= f[m] * pv[d];", "u[m][n] += T(0);"),
    ],
    "no_chunk_shift": [("a[m][n] = n + SH < MCL ? a[m][n + SH] : T(0);", "a[m][n] += T(0);")],
    "no_product": [("      for (int k = 0; k < K; ++k) {\n        T lv[MR], cv[MCL];",
                    "      for (int k = 0; k < 0; ++k) {\n        T lv[MR], cv[MCL];")],
    "no_elimination": [("    for (int c0 = 0; c0 < K; c0 += SC) {",
                        "    for (int c0 = 0; c0 < 0; c0 += SC) {")],
    "no_copies": [(COPY, "")],
    "no_back_substitution": [
        ("    for (int p = P - 1; p >= 0; --p) {\n      if (p > 0) {\n        fetch(p - 1);",
         "    for (int p = P - 1; p >= P; --p) {\n      if (p > 0) {\n        fetch(p - 1);")],
}


def variant_source(src, subs):
    for old, new in subs:
        if src.count(old) != 1:
            sys.exit(f"the source no longer has, once: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "tmp",
                                                        "probe_thomas"))
    args = ap.parse_args()

    import torch

    from chip_smoke import card_label, cuda_ms, ptxas_summary, thomas_inputs
    from sasktran2_tpu_torch.ops import _build, thomas_cuda

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    label = card_label()
    print(label, flush=True)
    build = os.path.abspath(args.build_dir)
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "thomas.cu")) as f:
        src = f.read()
    paths = {}
    for name, subs in VARIANTS.items():
        paths[name] = os.path.join(build, f"thomas_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(variant_source(src, subs))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda n: _build.compile_library(paths[n], paths[n][:-3] + ".so"),
            paths)))
    print(f"[{label}] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    P, K, W = 100, 48, 1024
    a64 = thomas_inputs(P, K, W, 49, torch.float64, dev, 5.0 + 2.0 * K**0.5)
    a32 = [t.float() for t in a64]
    truth = thomas_cuda.thomas_solve_plain(*a64)
    del a64
    stream = torch.cuda.current_stream().cuda_stream
    sig = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
    runs = {}
    for name, path in libs.items():
        for ln in ptxas_summary(path[:-3] + ".log"):
            if ln.startswith("thomas_pivot_kernel<float"):
                print(f"[{label}] {name} ptxas {ln}", flush=True)
        lib = ctypes.CDLL(path)
        fn = lib.thomas_solve_f32
        fn.argtypes, fn.restype = list(sig), ctypes.c_int
        scratch = lib.thomas_scratch_per_layer
        scratch.argtypes, scratch.restype = [ctypes.c_int] * 3, ctypes.c_int
        c = torch.empty(P * scratch(K, W, 0), dtype=torch.float32, device=dev)
        x = torch.empty_like(a32[3])

        def run(fn=fn, c=c, x=x, name=name):
            err = fn(*(t.data_ptr() for t in a32), c.data_ptr(), c.data_ptr(),
                     x.data_ptr(), P, K, W, stream)
            _build.check_launch(err, name)

        run()
        torch.cuda.synchronize()
        rel = float((x.double() - truth).abs().max() / truth.abs().max())
        runs[name] = (run, rel)
    times = {name: [] for name in runs}
    for order in (list(runs), list(reversed(runs))):
        for name in order:
            times[name].append(cuda_ms(runs[name][0], 5))
    for name, ts in times.items():
        print(f"[{label}] {name}: {', '.join(f'{t:.3f}' for t in ts)} ms per "
              f"solve [{P}, {K}, {K}, {W}] f32 (in turns); rel err vs f64 "
              f"{runs[name][1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
