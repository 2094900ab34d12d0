"""The traced run's instruments, all from the benchmark's side.

* ``HostSpans`` wraps, on the objects of one run, ``Atmosphere.
  internal_object`` (span ``atmosphere``), ``Engine._compute``
  (``compute``: the forward model and the Jacobian rows),
  ``Engine._jacobian_row`` (``rows``) and ``Engine._assemble_wfs``
  (``assembly``) with a host timer that synchronizes the device before
  and after; the harness adds ``call`` around every call.
* ``Launches`` wraps the Python entries of the two CUDA kernels,
  ``ops.thomas_cuda.thomas_solve`` and ``ops.jacobi_cuda.jacobi_eigh``,
  and records each launch's shape.
* ``DeviceTrace`` runs ``torch.profiler`` (CUDA activity only, kept in
  memory) over the window and reduces it to the device's busy intervals,
  kernel time by name and the idle gaps, each named by the host span
  that was running.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

# host layers, innermost first: an idle gap is named by the first that
# covers its midpoint; inside a call but outside all of them is the host
# copy of the outputs and the output dataset
GAP_LAYERS = (("rows", "rows"), ("compute", "forward"),
              ("atmosphere", "atmosphere"), ("assembly", "assembly"),
              ("call", "copy"))
KERNELS = {"thomas": re.compile(r"\bthomas(_pivot)?_kernel\b"),
           "jacobi": re.compile(r"\bjacobi(_group)?_kernel\b")}


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class HostSpans:
    """Host-clock spans (perf_counter ns) of the wrapped methods."""

    def __init__(self):
        self.spans = []                # (name, t0_ns, t1_ns)
        self._undo = []

    def timed(self, name, fn):
        def wrapper(*args, **kwargs):
            _sync()
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync()
                self.spans.append((name, t0, time.perf_counter_ns()))
        return wrapper

    def install(self, engine, atmosphere):
        for obj, attr, name in ((atmosphere, "internal_object", "atmosphere"),
                                (engine, "_compute", "compute"),
                                (engine, "_jacobian_row", "rows"),
                                (engine, "_assemble_wfs", "assembly")):
            setattr(obj, attr, self.timed(name, getattr(obj, attr)))
            self._undo.append((obj, attr))

    def remove(self):
        for obj, attr in self._undo:
            vars(obj).pop(attr, None)
        self._undo = []

    def totals(self):
        """{name: (seconds, count)}."""
        out = defaultdict(lambda: [0.0, 0])
        for name, t0, t1 in self.spans:
            out[name][0] += (t1 - t0) / 1e9
            out[name][1] += 1
        return {k: tuple(v) for k, v in out.items()}


class Launches:
    """The shape of every launch of the two CUDA kernels."""

    def __init__(self):
        self.thomas = []               # (P, K, W, itemsize)
        self.jacobi = []               # (P, n, W, sweeps, itemsize)
        self._undo = []

    def install(self):
        from sasktran2_tpu_torch.ops import jacobi_cuda, thomas_cuda

        def wrap(mod, attr, record):
            fn = getattr(mod, attr)

            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if args[0].is_cuda:
                    record(*args)
                return out
            # the kernels' own launch counters live on the entry
            for k, v in vars(fn).items():
                setattr(wrapper, k, v)
            setattr(mod, attr, wrapper)
            self._undo.append((mod, attr, fn, wrapper))

        def thomas(lo, di, up, r):
            P, K, _, W = di.shape
            self.thomas.append((P, K, W, di.element_size()))

        def jacobi(a, sweeps):
            P, n, _, W = a.shape
            self.jacobi.append((P, n, W, sweeps, a.element_size()))

        wrap(thomas_cuda, "thomas_solve", thomas)
        wrap(jacobi_cuda, "jacobi_eigh", jacobi)

    def remove(self):
        for mod, attr, fn, wrapper in self._undo:
            for k in vars(wrapper):
                setattr(fn, k, getattr(wrapper, k))
            setattr(mod, attr, fn)
        self._undo = []


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only."""

    def __init__(self):
        self.intervals = []            # (t0_ns, t1_ns, name, kind) host clock
        self._prof = None
        self._marker = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        # the profiler's clock against the host's: this synchronize is
        # the first runtime call of the trace
        self._marker = (time.perf_counter_ns(), time.time_ns())
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self):
        import torch

        events = self._prof.profiler.kineto_results.events()
        syncs = []
        raw = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                kind = str(getattr(e, "activity_type", lambda: "")()).lower()
                name = e.name()
                if "memcpy" in kind or name.startswith("Memcpy"):
                    kind = "copy"
                elif "memset" in kind or name.startswith("Memset"):
                    kind = "memset"
                else:
                    kind = "kernel"
                raw.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name, kind))
            elif e.name() == "cudaDeviceSynchronize":
                syncs.append(e.start_ns() + e.duration_ns())
        # the profiler stamps events with the wall clock; the end of the
        # synchronize that the marker follows pins it to within a few us
        perf0, wall0 = self._marker
        near = [s for s in syncs if abs(s - wall0) < 50_000_000]
        end = min(near, key=lambda s: abs(s - wall0)) if near else wall0
        offset = end - perf0
        self.intervals = sorted((a - offset, b - offset, n, k)
                                for a, b, n, k in raw)

    def busy(self, t0, t1):
        """Merged busy intervals of kernels, copies and memsets clipped
        to [t0, t1] (host ns)."""
        merged = []
        for a, b, _, _ in self.intervals:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def kernel_time(self):
        """{short kernel name: (seconds, launches)} of the window."""
        out = defaultdict(lambda: [0.0, 0])
        for a, b, name, kind in self.intervals:
            key = _short(name)
            out[key][0] += (b - a) / 1e9
            out[key][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def count(self, kind):
        return sum(1 for *_, k in self.intervals if k == kind)

    def kernel_seconds(self, family):
        pat = KERNELS[family]
        hits = [(b - a) for a, b, n, k in self.intervals
                if k == "kernel" and pat.search(n)]
        return sum(hits) / 1e9, len(hits)


def _short(name):
    """A kernel's name without its return type, arguments and anonymous
    namespaces, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:120]


def idle_gaps(busy, t0, t1, spans):
    """{host layer: idle seconds} over [t0, t1], each gap between busy
    intervals named by the innermost host span around its midpoint."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    by_name = {}
    for name, a, b in spans:
        by_name.setdefault(name, []).append((a, b))
    index = {k: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)])
             for k, v in by_name.items()}
    out = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "harness"
        for span, layer in GAP_LAYERS:
            starts, ends = index.get(span, ((), ()))
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and ends[j] >= mid:
                label = layer
                break
        out[label] += (b - a) / 1e9
    return dict(out)
