"""The port's spans (``sasktran2_tpu_torch.spans``) on the CPU: they
record only inside a ``torch.profiler`` window, form one tree per
``Engine.calculate_radiance`` call with the Jacobian rows' recomputed
azimuth modes under their rows, count the host copy's bytes, leave the
outputs bit-identical, never synchronize the device, and stay bounded.

The case is ground16's shape at a small size: 4 streams, 11 levels,
8 wavelengths, 4 ground-viewing rays, Rayleigh (3 azimuth modes), with
Jacobians.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sasktran2_tpu_torch as sk
from sasktran2_tpu_torch import spans
from tests.torch_support import one_torch_thread  # noqa: F401

NRAYS = 4
NMODES = 3      # Rayleigh's azimuth modes (the engine truncates to them)


def _case():
    config = sk.Config(
        num_streams=4,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
        dtype="float64",
    )
    geometry = sk.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 11),
        geometry_type=sk.GeometryType.PlaneParallel,
    )
    viewing = sk.ViewingGeometry()
    for mu in np.linspace(0.4, 1.0, NRAYS):
        viewing.add_ray(sk.GroundViewingSolar(
            cos_sza=0.6, relative_azimuth=0.5, cos_viewing_zenith=mu,
            observer_altitude_m=200000.0))
    atmo = sk.Atmosphere(geometry, config,
                         wavelengths_nm=np.linspace(300.0, 600.0, 8))
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    engine = sk.Engine(config, geometry, viewing, device="cpu")
    engine.calculate_radiance(atmo)      # the cold call, not recorded
    return engine, atmo


@pytest.fixture(scope="module")
def case():
    return _case()


def _profiled(fn):
    spans.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, list(spans.RECORDER.spans)


@pytest.fixture(scope="module")
def recorded(case):
    engine, atmo = case
    host = {}
    dataset = engine._dataset

    def keep_flat(atmosphere, blocks, flat, *args):
        host["nbytes"] = flat.nbytes
        return dataset(atmosphere, blocks, flat, *args)

    engine._dataset = keep_flat
    try:
        out, got = _profiled(lambda: engine.calculate_radiance(atmo))
    finally:
        del engine._dataset
    return out, got, host


def test_nothing_is_recorded_outside_a_profiler(case):
    engine, atmo = case
    spans.RECORDER.clear()
    engine.calculate_radiance(atmo)
    assert len(spans.RECORDER.spans) == 0
    assert spans.span("call") is spans.NULL and not spans.NULL


def test_one_call_is_one_tree(recorded):
    _, got, _ = recorded
    by_id = {s.id: s for s in got}
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == ["call"]
    root = roots[0]
    assert {s.call for s in got} == {root.id}
    assert all(s.parent in by_id for s in got if s is not root)
    for s in got:
        if s is root or s.name == "gc":
            continue
        p = by_id[s.parent]
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        expected = {
            "atmosphere": "call", "validate": "call", "upload": "call",
            "forward": "call", "rows": "call", "copy": "call",
            "dataset": "call", "zero": "atmosphere",
            "constituent": "atmosphere", "normalize": "atmosphere",
            "layout": "atmosphere", "assembly": "dataset",
        }.get(s.name)
        if s.name == "do_mode":
            expected = "rows" if s.counts["recompute"] else "forward"
        assert p.name == expected, (s, p)
    names = [s.name for s in got]
    for name in ("atmosphere", "validate", "upload", "forward", "copy",
                 "dataset", "assembly", "zero", "normalize", "layout"):
        assert names.count(name) == 1, name
    phases = sorted((s.counts["key"], s.counts["phase"]) for s in got
                    if s.name == "constituent")
    assert phases == [("rayleigh", "add"), ("rayleigh", "derivative"),
                      ("surface", "add"), ("surface", "derivative")]


def test_rows_and_recomputed_modes(recorded):
    out, got, _ = recorded
    rows = [s for s in got if s.name == "rows"]
    nout = out["radiance"].to_numpy().shape[1]
    assert nout == NRAYS
    assert sorted(s.counts["row"] for s in rows) == list(range(nout))
    modes = [s for s in got if s.name == "do_mode"]
    assert len(modes) == NMODES * (1 + len(rows))
    fwd = [s for s in modes if not s.counts["recompute"]]
    assert sorted(s.counts["mode"] for s in fwd) == list(range(NMODES))
    assert all(s.counts["table_bytes"] > 0 for s in fwd)
    by_id = {s.id: s for s in got}
    for r in rows:
        under = sorted(s.counts["mode"] for s in modes
                       if s.parent == r.id)
        assert under == list(range(NMODES))
    assert all(by_id[s.parent].name == "rows" for s in modes
               if s.counts["recompute"])


def test_copy_counts_the_host_arrays_bytes(recorded):
    _, got, host = recorded
    (copy,) = [s for s in got if s.name == "copy"]
    assert copy.counts["bytes"] == host["nbytes"]
    (upload,) = [s for s in got if s.name == "upload"]
    assert upload.counts["bytes"] > 0


def test_outputs_are_bit_identical_on_and_off(case, recorded):
    engine, atmo = case
    on = recorded[0]
    off = engine.calculate_radiance(atmo)
    assert sorted(on.keys()) == sorted(off.keys())
    for k in off.keys():
        assert np.array_equal(on[k].to_numpy(), off[k].to_numpy()), k


def test_no_span_synchronizes(case, monkeypatch):
    engine, atmo = case

    def forbidden(*args, **kwargs):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    _, got = _profiled(lambda: engine.calculate_radiance(atmo))
    assert sum(s.name == "call" for s in got) == 1


def test_a_thread_without_spans_adopts_the_calls_innermost_span():
    """What autograd's device thread sees when it replays a mode under a
    Jacobian row on the card: the row as its parent."""
    rec = spans.Recorder()
    seen = {}

    def device_thread():
        with rec.span("do_mode", mode=0, recompute=1) as s:
            seen["parent"], seen["call"] = s.span.parent, s.span.call

    with profile(activities=[ProfilerActivity.CPU]):
        with rec.call() as call, rec.span("rows", row=0) as row:
            t = threading.Thread(target=device_thread)
            t.start()
            t.join(timeout=30)
    with rec.call():        # off: lets go of the collector's callback
        pass
    assert not t.is_alive()
    assert seen == {"parent": row.span.id, "call": call.span.id}
    assert [s.name for s in rec.spans if s.name != "gc"] == [
        "do_mode", "rows", "call"]


def test_buffer_stays_bounded():
    rec = spans.Recorder(capacity=8)
    with profile(activities=[ProfilerActivity.CPU]), rec.call():
        for i in range(100):
            with rec.span("x", i=i):
                pass
    with rec.call():
        pass
    assert len(rec.spans) == 8
    assert rec.spans[-1].name == "call"
    kept = [s.counts["i"] for s in rec.spans if s.name == "x"]
    assert kept == list(range(100 - len(kept), 100)) and len(kept) >= 4


def test_totals_subtract_children():
    made = []
    for sid, name, a, b, parent in [(1, "call", 0, 400, None),
                                    (2, "atmosphere", 10, 100, 1),
                                    (3, "constituent", 20, 50, 2),
                                    (4, "zero", 10, 15, 2),
                                    (5, "constituent", 60, 70, 2)]:
        s = spans.Span(name, {})
        s.id, s.parent, s.start_ns, s.end_ns = sid, parent, a, b
        made.append(s)
    got = spans.totals(made)
    assert list(got) == ["call", "atmosphere", "constituent", "zero"]
    assert got["atmosphere"] == pytest.approx([1, 90e-9, 45e-9])
    assert got["constituent"] == pytest.approx([2, 40e-9, 40e-9])
    assert got["call"] == pytest.approx([1, 400e-9, 310e-9])


def test_threads_share_one_recorder():
    """Calls on 16 threads at once, under a profiler opened on this one:
    unique ids, every span under its own thread's call, the switch let go
    at the end."""
    rec = spans.Recorder()
    threads = []

    def work():
        for i in range(200):
            with rec.call(), rec.span("x", i=i):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]), rec.call():
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    with rec.call():
        pass
    assert not any(t.is_alive() for t in threads)
    got = [s for s in rec.spans if s.name != "gc"]
    assert len({s.id for s in got}) == len(got) == 1 + 16 * 200 * 2
    by_id = {s.id: s for s in got}
    xs = [s for s in got if s.name == "x"]
    assert all(by_id[s.parent].name == "call" for s in xs)
    assert all(s.call == s.parent for s in xs)
    assert rec._calls == 0 and rec._on is None and rec._root is None
