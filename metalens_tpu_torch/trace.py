"""The port's tracing: named spans and counters at the layers' boundaries,
kept in memory in one registry.

Tracing is on while a torch profiler records, and inside a
:func:`collect` block; never otherwise.  Off, :func:`span` returns one
shared null context and :func:`count` returns at once, so the program pays
one flag read per span or counter.

On, a span records its name, host start and end
(``time.perf_counter_ns``), the time its child spans cover (a stack of
open spans per host thread, for the self time), a pair of CUDA
events once CUDA is initialized in the process (device milliseconds, read
after a synchronize), and, while a profiler records, a
``torch.profiler.record_function("span:<name>")`` range, so that the
profiler's timeline names the program's stage.  Names are
``<layer>.<stage>``.  :func:`snapshot` sums the records by name, adds the
counters and the hits and misses since the first record of each
``lru_cache`` that its module registered with :func:`watch_cache`, and
:func:`reset` clears them.  There is no exporter:
``prof.export_chrome_trace`` writes the timeline.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
import torch.autograd.profiler as _prof

_NULL = contextlib.nullcontext()
_collecting = 0
_records: list = []
_counters: dict = {}
_caches: list = []          # the lru_caches registered by watch_cache
_cache_base = None          # cache_info() at the first record since reset
_local = threading.local()
_lock = threading.Lock()


def enabled() -> bool:
    """True while a torch profiler records or a :func:`collect` block
    runs."""
    return bool(_collecting or _prof._is_profiler_enabled)


def watch_cache(fn):
    """Decorator over a ``functools.lru_cache``: :func:`snapshot` reports
    its hits and misses as ``<module>.<function>``."""
    _caches.append(fn)
    return fn


def _cache_infos() -> dict:
    return {f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}":
            tuple(fn.cache_info()[:2]) for fn in _caches}


def _first_record() -> None:
    global _cache_base
    if _cache_base is None:
        _cache_base = _cache_infos()


class _Record:
    __slots__ = ("name", "start", "end", "child", "events")

    def __init__(self, name):
        self.name = name
        self.child = 0      # ns covered by the span's child spans
        self.end = None
        self.events = None


class _Span:
    __slots__ = ("name", "rec", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _first_record()
        stack = _local.__dict__.setdefault("stack", [])
        self.fn = None
        if _prof._is_profiler_enabled:
            self.fn = torch.profiler.record_function("span:" + self.name)
            self.fn.__enter__()
        rec = _Record(self.name)
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        _records.append(rec)
        stack.append(rec)
        self.rec = rec
        rec.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.end = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += rec.end - rec.start
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the span ``name`` while tracing is
    on, and the shared null context otherwise."""
    if not (_collecting or _prof._is_profiler_enabled):
        return _NULL
    return _Span(name)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_collecting or _prof._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_collecting or _prof._is_profiler_enabled):
        return
    _first_record()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """``spans``: for each span name, ``count``, ``host_ms``, ``self_ms``
    and ``device_ms`` (the CUDA events' milliseconds, None where none were
    recorded; the device is synchronized to read them); ``counters``;
    ``caches``: the hits and misses of each watched cache since the first
    record.  All three are empty when nothing was recorded."""
    done = [r for r in list(_records) if r.end is not None]
    if any(r.events is not None for r in done):
        torch.cuda.synchronize()
    spans = {}
    for r in done:
        s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += (r.end - r.start) * 1e-6
        s["self_ms"] += (r.end - r.start - r.child) * 1e-6
        if r.events is not None:
            s["device_ms"] = ((s["device_ms"] or 0.0)
                              + r.events[0].elapsed_time(r.events[1]))
    caches = {}
    if _cache_base is not None:
        for name, (hits, misses) in _cache_infos().items():
            h0, m0 = _cache_base.get(name, (0, 0))
            caches[name] = {"hits": hits - h0, "misses": misses - m0}
    return {"spans": spans, "counters": dict(_counters), "caches": caches}


def reset() -> None:
    """Clear the spans, the counters and the caches' baseline."""
    global _records, _cache_base
    _records = []
    _counters.clear()
    _cache_base = None


@contextlib.contextmanager
def collect():
    """Tracing on for the block, with the registry reset on entry."""
    global _collecting
    reset()
    _collecting += 1
    try:
        yield
    finally:
        _collecting -= 1
