"""The port's own spans (``sasktran2_tpu_torch.spans``) read against a
traced window.

The port records its spans while a ``torch.profiler`` runs, which in a
traced run is the window (``tracing.DeviceTrace``); the readers of the
per-layer metrics built on them run in the same process after the window
and take the spans from the port's recorder. A reader gives nothing where
the port has no recorder (an older tree) or where the recorder's count of
``call`` roots in the window differs from the window's calls.

Device work is tied to the span that launched it by the CUPTI
correlation id that a kernel shares with its runtime launch event; the
launch events' stamps are put on ``perf_counter_ns`` with the marker
offset of ``DeviceTrace``, and a kernel is credited to the innermost span
(the open span that started last) whose interval holds its launch stamp.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

profiles a cold call of the cell, then runs one traced run of it (as
``run.py --trace 1`` does) and prints, as JSON: the cold call's spans, the
window's per-layer metrics, device time and idle time by program span,
the share of kernels with no launch event, and a span's cost off and on.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

# the name of device work and idle time outside every program span
HARNESS = "harness"


def recorder():
    """The port's span recorder, or None where the port has none."""
    try:
        from sasktran2_tpu_torch.spans import RECORDER
    except ImportError:
        return None
    return RECORDER


def window_spans(rec):
    """The recorded spans that start inside the window, or None where there
    is no recorder or its ``call`` roots there are not ``rec.calls``."""
    r = recorder()
    if r is None or rec.calls <= 0:
        return None
    t0, t1 = rec.window_ns
    got = [s for s in list(r.spans) if t0 <= s.start_ns <= t1]
    roots = sum(1 for s in got if s.name == "call" and s.parent is None)
    return got if roots == rec.calls else None


def per_call_ms(rec, names):
    """Host milliseconds a call in the spans named ``names``."""
    got = window_spans(rec)
    if not got:
        return None
    ns = sum(s.end_ns - s.start_ns for s in got if s.name in names)
    return ns / 1e6 / rec.calls if ns else None


def per_call_count(rec, name, key, default=None):
    """Sum over the spans named ``name`` of their count ``key`` (``default``
    where they lack it), a call."""
    got = window_spans(rec)
    if not got:
        return None
    vals = [s.counts.get(key, default) for s in got if s.name == name]
    vals = [v for v in vals if v is not None]
    return sum(vals) / rec.calls if vals else None


def _offset(dev, syncs):
    """``tracing.DeviceTrace``'s shift from the profiler's stamps to
    ``perf_counter_ns``, found again from the same marker."""
    perf0, wall0 = dev._marker
    near = [s for s in syncs if abs(s - wall0) < 50_000_000]
    end = min(near, key=lambda s: abs(s - wall0)) if near else wall0
    return end - perf0


def launches(dev):
    """(kernels, unmatched) of a traced window: for each device kernel
    whose runtime launch event is in the trace, (launch stamp on the host
    clock, device ns), sorted by stamp; and the count of kernels with
    none. Read once per trace."""
    cached = getattr(dev, "_program_launches", None)
    if cached is not None:
        return cached
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    runtime, kernels, syncs = {}, [], []
    for e in dev._prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            kind = str(getattr(e, "activity_type", lambda: "")()).lower()
            if ("memcpy" in kind or "memset" in kind or "annotation" in kind
                    or name.startswith(("Memcpy", "Memset"))
                    or e.is_user_annotation()):
                continue
            kernels.append((e.correlation_id(), e.duration_ns()))
        elif name.startswith("cu"):
            runtime.setdefault(e.correlation_id(), e.start_ns())
            if name == "cudaDeviceSynchronize":
                syncs.append(e.start_ns() + e.duration_ns())
    offset = _offset(dev, syncs)
    matched = sorted((runtime[c] - offset, d) for c, d in kernels
                     if c in runtime)
    dev._program_launches = (matched, len(kernels) - len(matched))
    return dev._program_launches


def innermost(spans, stamps):
    """For each of the ascending ``stamps``, the innermost span whose
    interval holds it (of those open, the one that started last), or
    None."""
    order = sorted(spans, key=lambda s: s.start_ns)
    out, active, i = [], [], 0
    for t in stamps:
        while i < len(order) and order[i].start_ns <= t:
            active.append(order[i])
            i += 1
        if any(s.end_ns < t for s in active):
            active = [s for s in active if s.end_ns >= t]
        out.append(active[-1] if active else None)
    return out


def _ancestry(spans):
    """{span id: the names (and recompute flags) of it and its parents}."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        chain, p = [], s
        while p is not None:
            chain.append((p.name, p.counts.get("recompute", 0)))
            p = by_id.get(p.parent)
        out[s.id] = chain
    return out


def credited(rec):
    """(list of (span or None, device ns) per matched kernel of the window,
    unmatched kernels), or None without spans or a trace."""
    got = window_spans(rec)
    if not got or rec.device is None:
        return None
    kernels, unmatched = launches(rec.device)
    t0, t1 = rec.window_ns
    kernels = [k for k in kernels if t0 <= k[0] <= t1]
    owners = innermost(got, [t for t, _ in kernels])
    return [(s, d) for s, (_, d) in zip(owners, kernels)], unmatched


def recompute_share(rec):
    """Percent of the device time of the kernels launched inside ``rows``
    spans that was launched inside recomputed ``do_mode`` spans."""
    got = credited(rec)
    if got is None:
        return None
    chains = _ancestry(window_spans(rec))
    rows = recomputed = 0
    for s, d in got[0]:
        chain = chains[s.id] if s is not None else ()
        if any(name == "rows" for name, _ in chain):
            rows += d
            if any(name == "do_mode" and rc for name, rc in chain):
                recomputed += d
    return 100.0 * recomputed / rows if rows else None


def device_by_span(rec):
    """{innermost span name: device seconds of the kernels it launched}
    over the window (``harness`` for launches outside every span)."""
    got = credited(rec)
    if got is None:
        return None
    out = defaultdict(float)
    for s, d in got[0]:
        out[s.name if s is not None else HARNESS] += d / 1e9
    return dict(out)


def pieces(spans, t0, t1):
    """[t0, t1] cut at every span's start and end: [(a, b, the innermost
    span over the piece, or None)], in order."""
    cuts = {t0, t1}
    cuts.update(t for s in spans for t in (s.start_ns, s.end_ns)
                if t0 < t < t1)
    cuts = sorted(cuts)
    owners = innermost(spans, [(a + b) / 2 for a, b in zip(cuts, cuts[1:])])
    return [(a, b, o) for a, b, o in zip(cuts, cuts[1:], owners)]


def idle_by_span(rec):
    """{innermost span name: idle seconds} over the window: every stretch
    of each gap between the device's busy intervals put down to the
    innermost program span over it (``harness`` outside all)."""
    got = window_spans(rec)
    if not got or rec.device is None:
        return None
    t0, t1 = rec.window_ns
    edges = [t0] + [x for iv in rec.device.busy(t0, t1) for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out = defaultdict(float)
    j = 0
    cut = pieces(got, t0, t1)
    for a, b in gaps:
        while cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            pa, pb, s = cut[k]
            overlap = min(b, pb) - max(a, pa)
            if overlap > 0:
                out[s.name if s is not None else HARNESS] += overlap / 1e9
            k += 1
    return dict(out)


def span_cost(n=20000):
    """Seconds a span costs inside a call, off and on (the profiler
    running, CUDA activity only, as in a traced window)."""
    from torch.profiler import ProfilerActivity, profile

    from sasktran2_tpu_torch import spans

    rec = spans.Recorder(capacity=16)

    def loop():
        with rec.call():
            t = time.perf_counter_ns()
            for i in range(n):
                with rec.span("do_mode", mode=i, recompute=0):
                    pass
            return (time.perf_counter_ns() - t) / 1e9 / n

    off = loop()
    with profile(activities=[ProfilerActivity.CUDA]):
        on = loop()
    with rec.call():        # off again: lets go of the collector's callback
        pass
    return {"off_s": off, "on_s": on}


def main(argv):
    import argparse

    import run  # noqa: F401 - the harness's environment: caches, threads, cores

    import core
    import scene
    import system
    from tracing import DeviceTrace

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch.spans import totals

    cell = core.resolve(core.load_json(f"{core.ROOT}/BENCHMARK.json"),
                        args.workload)
    r = recorder()
    report = {"workload": args.workload, "seed": args.seed,
              "card": core.card_info(torch)}
    state = scene.make_state(cell.config, cell.traffic, args.seed)
    engine, cfg, geometry = system.build_engine(sk, cell.config, "cuda:0")
    atmo = system.build_atmosphere(sk, cfg, geometry, state,
                                   bool(cell.traffic["jacobians"]))
    r.clear()
    with DeviceTrace() as cold:
        t0 = time.perf_counter_ns()
        engine.calculate_radiance(atmo)
        t1 = time.perf_counter_ns()
    cold_spans = [s for s in r.spans if t0 <= s.start_ns <= t1]
    report["cold_call"] = {
        "seconds": (t1 - t0) / 1e9,
        "device_busy_s": sum(b - a for a, b in cold.busy(t0, t1)) / 1e9,
        "spans": totals(cold_spans),
        "one_offs": [[s.name, s.seconds, s.counts] for s in cold_spans
                     if s.name in ("kernel_load", "tables")],
    }
    del engine, atmo, cold
    report["span_cost"] = span_cost()
    r.clear()

    result, rec, lines = core.run_cell(cell, args.seed, args.seconds, True,
                                       "cuda:0", time.perf_counter())
    got = window_spans(rec) or []
    c = credited(rec)
    report.update({
        "correct": result["correct"], "calls": rec.calls,
        "window_s": rec.window_s,
        "call_roots": sum(1 for s in got if s.name == "call"
                          and s.parent is None),
        "metrics": core.metrics_of(cell, rec, True),
        "spans_per_call": len(got) / max(rec.calls, 1),
        "spans": totals(got),
        "constituents": totals(
            [s for s in got if s.name == "constituent"],
            key=lambda s: f"{s.counts['key']}.{s.counts['phase']}"),
        "device_by_span": device_by_span(rec),
        "idle_by_span": idle_by_span(rec),
        "idle_by_host_layer": core.breakdown(rec)["idle_gaps"],
        "kernels_matched": len(c[0]) if c else None,
        "kernels_unmatched": c[1] if c else None,
        "gc_between_calls": [[s.seconds, s.counts] for s in got
                             if s.name == "gc" and s.parent is None],
    })
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
