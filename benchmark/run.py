"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name (``BENCHMARK.json``, then the files
under ``benchmark/``; see ``benchmark/README.md``). Exits 2 without a
result where the cell cannot run (no CUDA device, a missing file), and
with the exception's code where the program fails.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# kernel and compiler caches at fixed paths inside the checkout, so that
# only the first run of a cell there builds; libraries that would load
# JAX by themselves are told not to
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one host thread for BLAS and torch's CPU pool: the host's part of a
# call spreads less from run to run
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# and the process on two fixed cores of those it may use, so that the
# host's part of a call does not move between cores
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
sys.path[:0] = [HERE, ROOT]

import core  # noqa: E402

if __name__ == "__main__":
    try:
        sys.exit(core.main(sys.argv[1:], T_START))
    except core.BenchError as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        sys.exit(2)
