"""The two caches of host-built tables: a bounded per-process memo of the
ray tracers' geometries, and the lazily built tables of one object."""

from __future__ import annotations

import threading
from collections import OrderedDict

from . import spans


def bounded_memo(cache: OrderedDict, key, build, size: int):
    """``cache[key]``, built by ``build()`` where it is missing. ``cache``
    holds its most recently used entry last and keeps the ``size`` most
    recently used ones."""
    value = cache.pop(key, None)
    if value is None:
        value = build()
    cache[key] = value
    while len(cache) > size:
        cache.popitem(last=False)
    return value


class LazyTables:
    """Tables built at their first request and kept, behind one lock: the
    ``mesh=`` blocks ask for them from one host thread each, and no table
    is built twice."""

    def __init__(self):
        self._tables = {}
        self._lock = threading.RLock()

    def get(self, key, build):
        """The table ``key``, built by ``build()`` at the first request."""
        with self._lock:
            if key not in self._tables:
                with spans.span("tables", table=key if isinstance(key, str)
                                else key[0]):
                    self._tables[key] = build()
            return self._tables[key]

    def keys(self) -> list:
        with self._lock:
            return list(self._tables)
