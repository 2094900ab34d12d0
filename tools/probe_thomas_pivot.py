"""Where the Thomas kernel's pivoting branch spends its time, on one GPU.

    python tools/probe_thomas_pivot.py [--build-dir tmp/probe_thomas]

Builds variants of ``sasktran2_tpu_torch/csrc/thomas.cu`` made by text
substitution (each substitution must match the source once) with the
port's nvcc flags, all at once, into ``--build-dir`` (they never enter the
package), and times each at [100, 48, 48, 1024] f32 by CUDA events, in
turns (all variants, then all in reverse order), with its error against
the float64 plain twin and its ptxas report. Needs a GPU.

The variants: the source as it is; the other thread tilings of a lane's
system (8 x 8 and 4 x 16 row x column groups); one warp per lane finding
the pivot and publishing it through shared memory (a third barrier a
step) instead of every warp finding it; and probes that leave out one
part (the arg-max, with the pivot taken on the diagonal; the next
column's publishing; the row update; the product lo c[p-1]; the whole
elimination; the back substitution), whose results are wrong and whose
times say what that part costs.
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

ARGMAX_SCAN = """      T best = T(-1);
      int bi = PK;
#pragma unroll
      for (int rr = 0; rr < PK / TW; ++rr) {
        const int i = qq + TW * rr;
        const T v = ((pivoted >> i) & 1ull) ? T(-1) : fabs(col[i * LW + l]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int o = LW; o < 32; o <<= 1) {
        const T ob = __shfl_xor_sync(FULL, best, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int piv = bi < PK ? bi : __ffsll(static_cast<long long>(~pivoted)) - 1;
      pivoted |= 1ull << piv;
      const T inv = T(1) / col[piv * LW + l];
"""

# warp lw < LW finds lane lw's pivot over all 48 rows (the published
# column lane-major, [lane][PK + 1], so that its reads do not collide in
# the banks) and publishes it, 1 / pivot and the lane's pivoted rows
WARP_ARGMAX = """      if (t / 32 < LW) {
        const int lw = t / 32;
        const int j = t % 32;
        const unsigned long long pivoted = masks[lw];
        T best = T(-1);
        int bi = PK;
        for (int i = j; i < PK; i += 32) {
          const T v = ((pivoted >> i) & 1ull) ? T(-1) : fabs(col[lw * CL + i]);
          if (v > best) {
            best = v;
            bi = i;
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const T ob = __shfl_xor_sync(FULL, best, o);
          const int oi = __shfl_xor_sync(FULL, bi, o);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
        }
        if (j == 0) {
          const int pv = bi < PK ? bi : __ffsll(static_cast<long long>(~pivoted)) - 1;
          masks[lw] = pivoted | (1ull << pv);
          pvs[lw] = T(pv);
          pvs[LW + lw] = T(1) / col[lw * CL + pv];
        }
      }
      __syncthreads();  // the pivots are published
      const int piv = static_cast<int>(pvs[l]);
      const T inv = pvs[LW + l];
"""

VARIANTS = {
    "as_is": [],
    "tiling_8x8": [("Pivot<float, 8, 16, 4>", "Pivot<float, 8, 8, 8>")],
    "tiling_4x16": [("Pivot<float, 8, 16, 4>", "Pivot<float, 8, 4, 16>")],
    "warp_argmax": [
        ("  static constexpr int ROW = COL + 2 * PK * LW;",
         "  static constexpr int ROW = COL + 2 * LW * (PK + 1);"),
        ("  static constexpr int TOTAL = XS + 2 * PK * LW;",
         "  static constexpr int PV = XS + 2 * PK * LW;\n"
         "  static constexpr int MASK = PV + 2 * LW;\n"
         "  static constexpr int TOTAL = MASK + LW * 8 / static_cast<int>(sizeof(T));"),
        ("  T* xs = sm + S::XS;\n",
         "  T* xs = sm + S::XS;\n  T* pvs = sm + S::PV;\n"
         "  auto* masks = reinterpret_cast<unsigned long long*>(sm + S::MASK);\n"
         "  constexpr int CL = PK + 1;\n"),
        ("      for (int m = 0; m < MR; ++m) colb[(g + RG * m) * LW + l] = a[m][0];",
         "      for (int m = 0; m < MR; ++m) colb[l * CL + g + RG * m] = a[m][0];"),
        ("    unsigned long long pivoted = ~((1ull << K) - 1ull);\n",
         "    if (t < LW) masks[t] = ~((1ull << K) - 1ull);\n"),
        ("      const T* col = colb + (s & 1) * PK * LW;",
         "      const T* col = colb + (s & 1) * LW * CL;"),
        ("      // the pivot: the largest |column s| over the unpivoted rows, the\n"
         "      // lowest row on ties; NaN is never chosen\n" + ARGMAX_SCAN,
         WARP_ARGMAX),
        ("        f[m] = i == piv ? T(0) : col[i * LW + l];",
         "        f[m] = i == piv ? T(0) : col[l * CL + i];"),
        ("      T* cn = colb + ((s + 1) & 1) * PK * LW;",
         "      T* cn = colb + ((s + 1) & 1) * LW * CL;"),
        ("          for (int m = 0; m < MR; ++m) cn[(g + RG * m) * LW + l] = a[m][n];",
         "          for (int m = 0; m < MR; ++m) cn[l * CL + g + RG * m] = a[m][n];"),
    ],
    "no_argmax": [(ARGMAX_SCAN, "      const int piv = s;\n"
                   "      pivoted |= 1ull << piv;\n"
                   "      const T inv = T(1) / col[piv * LW + l];\n")],
    "no_column_publish": [("        if (h + CG * n == s + 1) {",
                           "        if (h + CG * n == s + 1 && K < 0) {")],
    "no_row_update": [
        ("a[m][n] -= f[m] * rv;", "a[m][n] += T(0) * f[m];"),
        ("u[m][n] -= f[m] * rv;", "u[m][n] += T(0) * f[m];"),
        ("bb[m] -= f[m] * rv;", "bb[m] += T(0) * f[m];"),
    ],
    "no_product": [("    if (p > 0) {\n#pragma unroll 4", "    if (p < 0) {\n#pragma unroll 4")],
    "no_elimination": [("    for (int s = 0; s < K; ++s) {\n      const T* col",
                        "    for (int s = 0; s < 0; ++s) {\n      const T* col")],
    "no_back_substitution": [("  for (int p = P - 1; p >= 0; --p) {\n    const T* cy_p",
                              "  for (int p = P - 1; p >= P; --p) {\n    const T* cy_p")],
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
