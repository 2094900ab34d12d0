"""One run of one cell: set-up, the measured window, the check of its
answers against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the check's limits), ``metrics/<metric>.py``
(or, for a metric named ``<base>.<suffix>``, ``metrics/<base>.py``) and
``reference/<config>.py``. ``BENCHMARK.json`` at the root of the checkout
says which cells exist and which metrics each reports.
"""

from __future__ import annotations

import ast
import gc
import glob
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

import scene
import system

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FOREIGN = ("jax", "jaxlib", "flax", "sasktran2_tpu")
PORT = "sasktran2_tpu_torch"


class BenchError(Exception):
    """A run that cannot be made: no card, a missing file, a bad name."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(kind, name, exts=(".json",)):
    """The file of ``kind`` (a folder of this benchmark) named ``name``."""
    for ext in exts:
        path = os.path.join(HERE, kind, name + ext)
        if os.path.isfile(path):
            return path
    msg = f"no {kind} file for {name!r} under {os.path.join(HERE, kind)}"
    raise BenchError(msg)


def metric_reader(name):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    msg = f"no reader for metric {name!r} under {os.path.join(HERE, 'metrics')}"
    raise BenchError(msg)


def reference_module(config_name):
    """``reference/<config>.py``, loaded inside the ``reference`` package
    so that it can import the shared plain modules."""
    path = find("reference", config_name, (".py",))
    importlib.import_module("reference")
    key = "reference._" + "".join(c if c.isalnum() else "_" for c in config_name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_imports():
    """Top-level names imported by the reference's files."""
    names = set()
    for path in glob.glob(os.path.join(HERE, "reference", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
    return names


def foreign_modules():
    """Loaded modules whose top-level name, whole, is one of FOREIGN."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


@dataclass
class Cell:
    """A workload of the manifest with its files and metric lists."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(manifest, workload) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        msg = f"unknown workload {workload!r}; the manifest has {sorted(cells)}"
        raise BenchError(msg)
    w = cells[workload]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload,
        entry=w,
        config=load_json(find("configs", w["config"])),
        traffic=load_json(find("traffic", w["traffic"])),
        limits=load_json(find("limits", workload)),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
    )


@dataclass
class Record:
    """What the metric readers read: one run's counts and timings."""

    config: dict
    traffic: dict
    num_wavelengths: int
    jacobians: bool
    calls: int = 0
    window_s: float = 0.0
    setup: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    span_list: list = field(default_factory=list)
    launches: object = None
    device: object = None
    window_ns: tuple = (0, 0)
    memory: dict = field(default_factory=dict)


def card_info(torch):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip().splitlines()[0]
        info["power_limit"] = line.strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def compare(got, ref):
    """The numbers the check compares, over every checked answer:
    ``radiance_max`` the largest relative error of a radiance, and for
    each ``wf_*`` ``<name>_max`` the largest error of an element over the
    variable's largest magnitude."""
    out = {}
    for name, r in ref.items():
        scale = np.abs(r) if name == "radiance" else np.max(np.abs(r))
        out[f"{name}_max"] = float(np.max(np.abs(got[name] - r) / scale))
    return out


def stack_answers(answers, names):
    """Concatenate the checked calls' picks along their wavelength axis."""
    out = {}
    for name in names:
        parts = [a[name] for a in answers]
        axis = 0 if parts[0].ndim == 2 else 1
        out[name] = np.concatenate(parts, axis=axis)
    return out


def check_answers(cell, state, kept, seed, device):
    """(program's answers, reference's answers, lanes, checked calls):
    the calls the seed picks, at their sampled wavelengths."""
    import torch

    calls = scene.check_calls(cell.traffic, seed, len(kept))
    picks = [(w, kept[i][1], kept[i][2]) for i in calls for w in kept[i][0]]
    lanes = scene.lanes(state, picks)
    ref = reference_module(cell.entry["config"]).reference(
        cell.config, lanes, dtype=torch.float64, device=device,
        jacobians=cell.traffic["jacobians"])
    got = stack_answers([kept[i][3] for i in calls], ref.keys())
    return got, ref, lanes, calls


def check(cell, state, kept, seed, device):
    """(numbers, checked calls) of a run against the reference."""
    got, ref, _, calls = check_answers(cell, state, kept, seed, device)
    return compare(got, ref), calls


def run_window(engine, atmo, state, cell, seed, seconds, spans=None,
               min_calls=0):
    """The closed loop: calls start while the elapsed time is under
    ``seconds`` (or fewer than ``min_calls`` were made). Returns (kept
    answers of the calls that returned, calls, failed, window_s,
    (t0_ns, t1_ns), errors)."""
    kept, errors = [], []
    failed = 0
    i = 0
    t0 = time.perf_counter_ns()
    while time.perf_counter_ns() - t0 < seconds * 1e9 or i < min_calls:
        vmr, albedo = scene.call_inputs(state, cell.traffic, seed, i)
        system.set_call_inputs(atmo, vmr, albedo)
        c0 = time.perf_counter_ns()
        try:
            out = engine.calculate_radiance(atmo)
        except Exception:  # noqa: BLE001 - a failed call is counted and the loop goes on
            failed += 1
            errors.append(traceback.format_exc(limit=3))
            i += 1
            continue
        if spans is not None:
            spans.spans.append(("call", c0, time.perf_counter_ns()))
        idx = scene.check_wavelengths(cell.traffic, seed, i, state)
        kept.append((idx, vmr, albedo, system.pick(out, idx)))
        del out
        i += 1
    t1 = time.perf_counter_ns()
    return kept, i, failed, (t1 - t0) / 1e9, (t0, t1), errors


def run_cell(cell, seed, seconds, trace, device, t_start, log=sys.stderr):
    """Set-up, window and check of one run: (result dict, the metric
    readers' ``Record``, check lines (name, value, limit))."""
    import torch

    import sasktran2_tpu_torch as sk

    on_card = device.startswith("cuda")
    state = scene.make_state(cell.config, cell.traffic, seed)
    jac = bool(cell.traffic["jacobians"])
    rec = Record(cell.config, cell.traffic, len(state.wavelengths_nm), jac)
    t = time.perf_counter()
    engine, cfg, geometry = system.build_engine(sk, cell.config, device)
    rec.setup["engine_init_s"] = time.perf_counter() - t
    atmo = system.build_atmosphere(sk, cfg, geometry, state, jac)
    t = time.perf_counter()
    engine.calculate_radiance(atmo)
    rec.setup["first_call_s"] = time.perf_counter() - t
    for _ in range(cell.traffic["warmup_calls"]):
        engine.calculate_radiance(atmo)
    if on_card:
        torch.cuda.synchronize()
    rec.setup["setup_s"] = time.perf_counter() - t_start
    print(f"[{cell.name}] set-up {rec.setup['setup_s']:.3f} s (engine "
          f"{rec.setup['engine_init_s']:.3f} s, first call "
          f"{rec.setup['first_call_s']:.3f} s)", file=log, flush=True)

    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spans = launches = dtrace = None
    if trace:
        from tracing import DeviceTrace, HostSpans, Launches

        spans, launches = HostSpans(), Launches()
        spans.install(engine, atmo)
        launches.install()
        dtrace = DeviceTrace() if on_card else None
    try:
        if dtrace is not None:
            with dtrace:
                got = run_window(engine, atmo, state, cell, seed, seconds, spans)
        else:
            got = run_window(engine, atmo, state, cell, seed, seconds, spans)
    finally:
        if trace:
            spans.remove()
            launches.remove()
    kept, calls, failed, window_s, window_ns, errors = got
    for e in errors[:3]:
        print(e, file=log, flush=True)
    rec.calls, rec.window_s, rec.window_ns = calls - failed, window_s, window_ns
    if on_card:
        window_peak = torch.cuda.max_memory_allocated()
        rec.memory = {"peak_bytes": max(setup_peak, window_peak),
                      "window_peak_bytes": window_peak}
    if trace:
        rec.spans = spans.totals()
        rec.span_list = spans.spans
        rec.launches = launches
        rec.device = dtrace
    print(f"[{cell.name}] window {window_s:.3f} s, {calls} calls, "
          f"{failed} failed", file=log, flush=True)

    # the program's state goes before the reference runs
    del engine, atmo
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, checked = ({}, [])
    if kept and not failed:
        t = time.perf_counter()
        numbers, checked = check(cell, state, kept, seed, device)
        print(f"[{cell.name}] reference {time.perf_counter() - t:.3f} s over "
              f"calls {checked}", file=log, flush=True)
    lines = []
    correct = bool(kept) and failed == 0 and set(cell.limits) <= set(numbers)
    for name in sorted(cell.limits):
        value = numbers.get(name)
        limit = cell.limits[name]["limit"]
        ok = value is not None and np.isfinite(value) and value <= limit
        correct = correct and ok
        lines.append((name, value, limit))
    result = {"correct": bool(correct), "attempted": calls, "failed": failed}
    return result, rec, lines


def metrics_of(cell, rec, trace):
    """{metric: {"value", "unit"}} of the cell's metrics for this run:
    the end-to-end ones untraced, the per-layer ones traced; a reader
    that finds nothing leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(rec):
    from tracing import idle_gaps

    dev = rec.device
    ops = sorted(dev.kernel_time().items(), key=lambda kv: -kv[1][0])[:10]
    t0, t1 = rec.window_ns
    gaps = idle_gaps(dev.busy(t0, t1), t0, t1, rec.span_list)
    return {
        "device_ops": [[f"{k} x{n}", s] for k, (s, n) in ops],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def main(argv, t_start):
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(manifest_path):
        raise BenchError(f"no BENCHMARK.json at {ROOT}")
    cell = resolve(load_json(manifest_path), args.workload)
    bad = reference_imports() & {*FOREIGN, PORT}
    if bad:
        raise BenchError(f"the reference imports {sorted(bad)}")

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise BenchError(
            f"{args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = card_info(torch)
    result, rec, lines = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", t_start)
    foreign = foreign_modules()
    if foreign:
        raise BenchError(f"modules of JAX or the JAX package are loaded: {foreign}")
    result["metrics"] = metrics_of(cell, rec, bool(args.trace))
    dev.update({"count": chips, "memory_peak_bytes": int(rec.memory["peak_bytes"])})
    if args.trace:
        t0, t1 = rec.window_ns
        busy = rec.device.busy(t0, t1)
        dev["busy_s"] = sum(b - a for a, b in busy) / 1e9
        dev["window_s"] = rec.window_s
        result["device"] = dev
        result["breakdown"] = breakdown(rec)
    else:
        result["device"] = dev
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in lines}
    print(json.dumps(result), flush=True)
    for name, value, limit in lines:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr,
              flush=True)
    return 0
