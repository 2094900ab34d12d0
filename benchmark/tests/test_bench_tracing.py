"""The traced run's reductions, on synthetic intervals and on the CPU."""

import pytest

import tracing


def _trace(intervals):
    t = tracing.DeviceTrace()
    t.intervals = sorted(intervals)
    return t


def test_busy_merges_and_clips():
    t = _trace([(0, 10, "k", "kernel"), (5, 20, "k", "kernel"),
                (30, 40, "Memcpy DtoH", "copy"), (90, 200, "k", "kernel")])
    assert t.busy(2, 100) == [[2, 20], [30, 40], [90, 100]]
    assert t.count("kernel") == 3 and t.count("copy") == 1


def test_idle_gaps_are_named_by_the_innermost_span():
    t = _trace([(0, 10, "k", "kernel"), (20, 30, "k", "kernel"),
                (60, 70, "k", "kernel"), (100, 110, "k", "kernel"),
                (114, 116, "k", "kernel")])
    spans = [("call", 0, 105), ("compute", 0, 50), ("rows", 12, 18),
             ("assembly", 80, 90), ("call", 111, 113)]
    gaps = tracing.idle_gaps(t.busy(0, 120), 0, 120, spans)
    assert gaps == pytest.approx({"rows": 10e-9, "forward": 30e-9,
                                  "assembly": 30e-9, "copy": 4e-9,
                                  "harness": 4e-9})


def test_kernel_families_and_short_names():
    t = _trace([(0, 1000, "void thomas_kernel<float, 16, 4, 1>(float const*)", "kernel"),
                (0, 500, "void thomas_pivot_kernel<float, 1, 1>(float*)", "kernel"),
                (0, 250, "void jacobi_kernel<float, 8>(float const*)", "kernel"),
                (0, 125, "void (anonymous namespace)::foo<int>(int)", "kernel")])
    assert t.kernel_seconds("thomas") == (1500e-9, 2)
    assert t.kernel_seconds("jacobi") == (250e-9, 1)
    assert "foo<int>" in t.kernel_time()


def test_launch_wrappers_keep_the_counters():
    import torch

    from sasktran2_tpu_torch.ops import jacobi_cuda, thomas_cuda

    fn = thomas_cuda.thomas_solve
    before = fn.launches
    launches = tracing.Launches()
    launches.install()
    assert thomas_cuda.thomas_solve is not fn
    lo = torch.zeros(2, 2, 2, 3, dtype=torch.float64)
    di = torch.eye(2, dtype=torch.float64)[None, :, :, None].expand(2, 2, 2, 3).clone()
    r = torch.ones(2, 2, 3, dtype=torch.float64)
    x = thomas_cuda.thomas_solve(lo, di, lo, r)
    launches.remove()
    assert thomas_cuda.thomas_solve is fn and fn.launches == before
    assert launches.thomas == []          # CPU tensors run the plain twin
    assert torch.allclose(x, r)
    assert jacobi_cuda.jacobi_eigh.launches_by_n is not None
