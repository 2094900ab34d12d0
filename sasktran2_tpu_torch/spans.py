"""Spans and counts at the port's layer boundaries, recorded while a
``torch.profiler`` runs.

A span is one layer's interval: its name, its start and end on
``time.perf_counter_ns()`` (the host clock on which the benchmark lays
the profiler's device events), its own id, the id of the span that caused
it, the id of its call (the root ``call`` span's id, shared by every span
of one ``Engine.calculate_radiance``) and its counts. The names, from the
root down:

* ``call``: ``Engine.calculate_radiance``;
* ``atmosphere``: ``Atmosphere.internal_object``, with ``zero``,
  ``constituent`` (one per constituent and phase, counts ``key`` and
  ``phase``: ``add`` or ``derivative``), ``normalize`` and ``layout``
  (count ``host_bytes``, the bytes copied on the host: 0 on the engine's
  path, which takes the storage's arrays as they lie);
* ``validate``; ``upload`` (count ``bytes`` sent to the device);
* ``forward``: ``Engine._outputs``, with ``los_sources``, ``do_mode``
  (one per azimuth mode solved; counts ``mode``, ``recompute`` (1 where
  autograd's backward replays a checkpointed mode), ``table_bytes`` (the
  mode tables copied to the device) and, on the generic route, which
  solves every mode at once, ``modes``), ``limb_source``, ``flux``, ``so``;
* ``rows``: one per Jacobian row (count ``row``);
* ``copy``: the one device-to-host copy (count ``bytes``);
* ``dataset``: the output ``Dataset``, with ``assembly``
  (``Engine._assemble_wfs``);
* one-off: ``kernel_load`` (a CUDA kernel's first load, count ``nvcc``: 1
  where it was compiled), ``tables`` (a lazily built table, count
  ``table``) and ``gc`` (Python's collector, counts ``generation`` and
  ``collected``), recorded between calls too.

The only switch is the profiler. ``calculate_radiance`` reads
``torch.autograd._profiler_enabled()`` once per call, and every span of
the call, on any thread, reads that one flag; a span outside any call
reads the profiler's state itself. Off, a span is that one flag read and
the shared no-op span ``NULL``. On, each span is also a
``torch.profiler.record_function`` range (``gc`` spans excepted), so a
profile with CPU activity shows it on its own timeline. No span
synchronizes the device: a span holds the host's part of its layer, and
the device's part is found by the launch events of the profiler's trace
that fall inside it.

A thread with no open span of its own (autograd's device thread
replaying a checkpointed mode under a Jacobian row, a ``mesh=`` block's
thread) takes as parent the innermost open span of the thread that
opened the outermost call. The finished spans stay in memory,
``RECORDER.spans``, the newest ``CAPACITY`` of them, the oldest dropped
first; nothing is written to disk.
"""

from __future__ import annotations

import functools
import gc
import itertools
import threading
import time
from collections import deque

import torch

CAPACITY = 1 << 16


class Span:
    """One finished (or, while it runs, open) span."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call",
                 "counts")

    def __init__(self, name, counts):
        self.name = name
        self.counts = counts
        self.start_ns = self.end_ns = 0
        self.id = self.parent = self.call = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, {self.seconds * 1e3:.3f} ms, "
                f"{self.counts})")


class _Null:
    """The span of a call that does not record: does nothing, is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, **counts):
        pass


NULL = _Null()


class _Open:
    """A recording span: pushed on its thread's stack and entered as a
    ``record_function`` range while it runs, kept when it ends."""

    __slots__ = ("rec", "span", "root", "_range")

    def __init__(self, rec, name, counts, root=False):
        self.rec = rec
        self.span = Span(name, counts)
        self.root = root

    def __bool__(self):
        return True

    def count(self, **counts):
        c = self.span.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v

    def __enter__(self):
        rec, s = self.rec, self.span
        stack = rec._stack()
        parent = stack[-1] if stack else (None if self.root else rec._adopt())
        s.id = next(rec._ids)
        if parent is not None:
            s.parent, s.call = parent.id, parent.call
        elif self.root:
            s.call = s.id
        self._range = torch.profiler.record_function(s.name)
        self._range.__enter__()
        stack.append(s)
        s.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.perf_counter_ns()
        self.rec._stack().pop()
        self._range.__exit__(*exc)
        self.rec.spans.append(s)
        return False


class _CallScope:
    """One ``calculate_radiance``: reads the switch (the outermost open
    call), watches the collector while it records, opens ``call``."""

    __slots__ = ("rec", "open")

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        rec = self.rec
        with rec._lock:
            if rec._calls == 0:
                rec._on = torch.autograd._profiler_enabled()
                rec._root = rec._stack()
                rec._watch_gc(rec._on)
            rec._calls += 1
        self.open = _Open(rec, "call", {}, root=True) if rec._on else NULL
        self.open.__enter__()
        return self.open

    def __exit__(self, *exc):
        rec = self.rec
        try:
            self.open.__exit__(*exc)
        finally:
            with rec._lock:
                rec._calls -= 1
                if rec._calls == 0:
                    rec._on = None
                    rec._root = None
        return False


class Recorder:
    """The spans of one process (``RECORDER``)."""

    def __init__(self, capacity=CAPACITY):
        self.spans = deque(maxlen=capacity)
        self._on = None          # the open calls' switch; None outside calls
        self._calls = 0          # calls open, nested or on other threads
        self._root = None        # the stack of the outermost call's thread
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._gc_hooked = False

    def recording(self) -> bool:
        on = self._on
        return torch.autograd._profiler_enabled() if on is None else on

    def span(self, name, **counts):
        """A context manager: span ``name`` with ``counts`` where this
        call records (true), else ``NULL`` (false); either takes more
        counts with ``.count(**counts)``."""
        on = self._on
        if on is None:
            on = torch.autograd._profiler_enabled()
        return _Open(self, name, counts) if on else NULL

    def call(self):
        return _CallScope(self)

    def clear(self):
        self.spans.clear()

    def _stack(self):
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            return local.stack

    def _adopt(self):
        root = self._root
        try:
            return root[-1] if root is not None else None
        except IndexError:
            return None

    def _watch_gc(self, on):
        # under self._lock
        if on and not self._gc_hooked:
            gc.callbacks.append(self._gc)
        elif not on and self._gc_hooked:
            gc.callbacks.remove(self._gc)
        self._gc_hooked = on

    def _gc(self, phase, info):
        local = self._local
        if phase == "start":
            local.gc_start = (time.perf_counter_ns() if self.recording()
                              else None)
            return
        t0 = getattr(local, "gc_start", None)
        if t0 is None:
            return
        local.gc_start = None
        s = Span("gc", {"generation": info.get("generation", -1),
                        "collected": info.get("collected", 0)})
        s.start_ns, s.end_ns = t0, time.perf_counter_ns()
        stack = self._stack()
        parent = stack[-1] if stack else self._adopt()
        s.id = next(self._ids)
        if parent is not None:
            s.parent, s.call = parent.id, parent.call
        self.spans.append(s)


RECORDER = Recorder()
span = RECORDER.span


def spanned(name):
    """Decorator: every call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def root_call(fn):
    """Decorator of ``Engine.calculate_radiance``: one call, one switch,
    one ``call`` root."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with RECORDER.call():
            return fn(*args, **kwargs)
    return inner


def replayed_mode(fn):
    """A checkpointed azimuth-mode solve ``fn(m, ...)``: where autograd's
    backward replays it, a ``do_mode`` span with ``recompute`` 1. Its
    first run, in the forward pass, is spanned by its caller."""

    @functools.wraps(fn)
    def inner(*args):
        if RECORDER.recording() and torch._C._current_graph_task_id() != -1:
            with RECORDER.span("do_mode", mode=args[0], recompute=1):
                return fn(*args)
        return fn(*args)
    return inner


def nbytes(tensors):
    """Bytes held by ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors)


def totals(spans, key=lambda s: s.name):
    """{``key(span)``, by default its name: [count, seconds, self
    seconds]} of finished spans, largest first; a span's self time is its
    duration less its children's (on its own thread or adopted)."""
    child = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + s.end_ns - s.start_ns
    out = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        t = out.setdefault(key(s), [0, 0.0, 0.0])
        t[0] += 1
        t[1] += d / 1e9
        t[2] += (d - child.get(s.id, 0)) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))
