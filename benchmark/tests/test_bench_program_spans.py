"""The readers of the port's own spans (``program_spans`` and the metrics
built on it), on synthetic records and on a tiny window on the CPU."""

import types

import pytest

import core
import program_spans
import tracing
from conftest import ROOT, tiny_cell

MANIFEST = core.load_json(core.os.path.join(ROOT, "BENCHMARK.json"))
NEW = ["constituents_ms.wf", "constituents_ms.rad", "storage_ms.wf",
       "storage_ms.rad", "do_solves_per_call.wf", "do_solves_per_call.rad",
       "recompute_share.wf", "host_copy_mb.wf", "host_copy_mb.rad"]


def _span(sid, name, a, b, parent=None, call=1, **counts):
    from sasktran2_tpu_torch.spans import Span

    s = Span(name, counts)
    s.id, s.parent, s.call, s.start_ns, s.end_ns = sid, parent, call, a, b
    return s


def _record(spans, calls, window=(0, 1000), device=None):
    rec = core.Record({}, {}, 8, True)
    rec.calls, rec.window_ns, rec.device = calls, window, device
    rec.window_s = (window[1] - window[0]) / 1e9
    return rec


@pytest.fixture
def fake_recorder(monkeypatch):
    holder = types.SimpleNamespace(spans=[])
    monkeypatch.setattr(program_spans, "recorder", lambda: holder)
    return holder


def _tree():
    """Two calls: the first with a row that replays a mode."""
    return [
        _span(1, "call", 0, 400, None, 1),
        _span(2, "atmosphere", 10, 100, 1),
        _span(3, "constituent", 20, 50, 2, key="rayleigh", phase="add"),
        _span(4, "zero", 10, 15, 2),
        _span(5, "layout", 80, 95, 2),
        _span(6, "forward", 100, 200, 1),
        _span(7, "do_mode", 110, 150, 6, mode=0, recompute=0),
        _span(8, "rows", 200, 300, 1, row=0),
        _span(9, "do_mode", 220, 260, 8, mode=0, recompute=1),
        _span(10, "copy", 300, 320, 1, bytes=2_000_000),
        _span(11, "call", 500, 900, None, 11),
        _span(12, "constituent", 510, 540, 11, call=11, key="rayleigh",
              phase="add"),
        _span(13, "copy", 800, 820, 11, call=11, bytes=4_000_000),
        _span(14, "gc", 950, 960, None, None, generation=2, collected=5),
    ]


def test_readers_give_nothing_without_the_ports_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    rec = _record([], 2)
    for name in NEW:
        assert core.metric_reader(name)(rec) is None, name


def test_call_count_mismatch_gives_nothing(fake_recorder):
    fake_recorder.spans = _tree()
    for calls in (1, 3):
        rec = _record([], calls)
        assert program_spans.window_spans(rec) is None
        for name in NEW:
            assert core.metric_reader(name)(rec) is None, name
    rec = _record([], 2)
    assert core.metric_reader("constituents_ms.wf")(rec) == pytest.approx(
        (30 + 30) / 1e6 / 2)
    assert core.metric_reader("storage_ms.rad")(rec) == pytest.approx(
        (5 + 15) / 1e6 / 2)
    assert core.metric_reader("do_solves_per_call.wf")(rec) == 1.0
    assert core.metric_reader("host_copy_mb.rad")(rec) == 3.0


def test_spans_outside_the_window_are_left_out(fake_recorder):
    fake_recorder.spans = _tree()
    rec = _record([], 1, window=(0, 450))
    assert [s.id for s in program_spans.window_spans(rec)] == list(range(1, 11))


def test_kernels_are_credited_to_the_innermost_span(fake_recorder):
    spans = _tree()
    fake_recorder.spans = spans
    by_id = {s.id: s for s in spans}
    stamps = [5, 12, 25, 120, 210, 230, 270, 310, 450, 955]
    owners = program_spans.innermost(spans, stamps)
    assert [s.id if s else None for s in owners] == [
        1, 4, 3, 7, 8, 9, 8, 10, None, 14]
    assert by_id[9].parent == 8
    # launch stamps and device ns, as ``launches`` reads them from a trace
    dev = types.SimpleNamespace(_program_launches=(
        [(120, 7), (210, 10), (230, 30), (235, 50), (270, 10), (310, 99),
         (1200, 5)], 0))
    rec = _record([], 2, device=dev)
    assert program_spans.recompute_share(rec) == pytest.approx(
        100 * 80 / 100)
    assert core.metric_reader("recompute_share.wf")(rec) == pytest.approx(80)
    assert program_spans.device_by_span(rec) == pytest.approx(
        {"do_mode": 87e-9, "rows": 20e-9, "copy": 99e-9})


def test_idle_gaps_are_named_by_the_innermost_span(fake_recorder):
    fake_recorder.spans = _tree()
    dev = tracing.DeviceTrace()
    dev.intervals = [(0, 12, "k", "kernel"), (18, 120, "k", "kernel"),
                     (130, 210, "k", "kernel"), (250, 290, "k", "kernel"),
                     (600, 700, "k", "kernel")]
    rec = _record([], 2, window=(0, 1000), device=dev)
    got = program_spans.idle_by_span(rec)
    # gaps 12-18 (zero 12-15, atmosphere 15-18), 120-130 (do_mode),
    # 210-250 (rows 210-220, replayed do_mode 220-250), 290-600 (rows
    # 290-300, copy 300-320, call 320-400, none 400-500, call 500-510,
    # constituent 510-540, call 540-600), 700-1000 (call 700-800, copy
    # 800-820, call 820-900, none 900-950, gc 950-960, none 960-1000)
    assert got == pytest.approx({
        "zero": 3e-9, "atmosphere": 3e-9, "do_mode": 40e-9,
        "rows": 20e-9, "copy": 40e-9, "call": 330e-9,
        "constituent": 30e-9, "gc": 10e-9, "harness": 190e-9})
    assert sum(got.values()) == pytest.approx(
        (6 + 10 + 40 + 310 + 300) * 1e-9)


def test_the_new_metrics_are_in_the_manifest():
    names = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        assert name in names and names[name]["workloads"] == [
            "ground16_f64." + name.split(".")[1]]


def test_readers_on_a_cpu_window():
    """A tiny ``ground16_f64.wf`` window on the CPU under a CPU profiler
    (a traced run's window records the same way under its CUDA one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import scene
    import system
    import sasktran2_tpu_torch as sk
    from sasktran2_tpu_torch.spans import RECORDER

    cell = tiny_cell("ground16_f64.wf", num_wavelengths=8, rays=2)
    state = scene.make_state(cell.config, cell.traffic, 5)
    engine, cfg, geometry = system.build_engine(sk, cell.config, "cpu")
    atmo = system.build_atmosphere(sk, cfg, geometry, state, True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine.calculate_radiance(atmo)
        RECORDER.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            _, calls, failed, window_s, window_ns, _ = core.run_window(
                engine, atmo, state, cell, 5, 0.0, min_calls=2)
    finally:
        torch.set_num_threads(n)
    rec = core.Record(cell.config, cell.traffic, 8, True)
    rec.calls, rec.window_s, rec.window_ns = calls - failed, window_s, window_ns
    assert calls == 2 and failed == 0
    read = {name: core.metric_reader(name)(rec) for name in NEW}
    assert read["constituents_ms.wf"] > 0 and read["storage_ms.wf"] > 0
    # Rayleigh's 3 azimuth modes, solved once and replayed under each of
    # the 2 rays' rows
    assert read["do_solves_per_call.wf"] == 3 * (1 + 2)
    # radiance [8, 2] and the rows of extinction, ssa, leg_coeff and
    # albedo, float64
    nalt, nleg = cell.config["geometry"]["num_altitudes"], 16
    per_out = 1 + nalt + nalt + nalt * nleg + 1
    assert read["host_copy_mb.wf"] * 1e6 <= 8 * 2 * per_out * 8
    assert read["host_copy_mb.wf"] > 0
    assert read["recompute_share.wf"] is None       # no device trace
