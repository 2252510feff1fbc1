"""Span tracing — Chrome trace-event JSON export (Perfetto-loadable).

Lightweight spans around the engine's pipeline stages:

    parse → plan → jit-compile → ingest chunk → kernel step →
    match scatter → callback

Dapper-style: each span is one complete ("ph": "X") trace event with
microsecond ``ts``/``dur``, the thread id as ``tid`` and the span's
payload (stream id, batch size, …) in ``args``.  Export with
``SiddhiAppRuntime.dump_trace(path)`` and load the file in Perfetto /
chrome://tracing.

Off by default: ``span()`` returns a shared no-op context manager when
disabled (no allocation, no clock read), so the hot path pays a single
attribute check per chunk.  The tracer is process-global for the same
reason the kernel profiler is — compiled plan objects outlive and
predate individual app runtimes.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": (self._t0 - tr._epoch) / 1e3,
              "dur": (t1 - self._t0) / 1e3,
              "pid": tr.pid, "tid": threading.get_ident()}
        if self.args:
            ev["args"] = self.args
        with tr._lock:
            tr._events.append(ev)
            if len(tr._events) > tr.max_events:
                # bound memory: drop the oldest half
                del tr._events[:len(tr._events) // 2]
        return False


class Tracer:
    def __init__(self, pid: int = 0, max_events: int = 500_000):
        self.enabled = False
        self.pid = pid
        self.max_events = max_events
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter_ns()

    # ------------------------------------------------------------ control

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events.clear()

    # ------------------------------------------------------------ recording

    def span(self, name: str, cat: str = "engine", **args):
        """``with tracer.span("ingest.chunk", stream="S", n=1024): ...``"""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args or None)

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 cat: str = "engine", **args):
        """Record an already-measured interval (perf_counter_ns pair) —
        used by the kernel profiler so a profiled call shows up as a
        span without a second clock read."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0_ns - self._epoch) / 1e3,
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str = "engine", **args):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, value: float, cat: str = "engine"):
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                {"name": name, "cat": cat, "ph": "C",
                 "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
                 "pid": self.pid, "tid": 0, "args": {"value": value}})

    # ------------------------------------------------------------ export

    def to_dict(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """Chrome-trace document.  ``limit`` keeps only the newest N
        events — incident bundles embed the trace, and a full buffer
        (up to 500k events) would dwarf everything else in the dump."""
        with self._lock:
            if limit is not None and len(self._events) > limit:
                events = list(self._events)[-limit:]
            else:
                events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"engine": "siddhi_tpu_torch"}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


_GLOBAL = Tracer()


def tracer() -> Tracer:
    return _GLOBAL


def trace_span(name: str, cat: str = "engine", **args):
    """Module-level shortcut bound to the process-global tracer."""
    t = _GLOBAL
    if not t.enabled:
        return _NULL
    return _Span(t, name, cat, args or None)


def enable_tracing():
    _GLOBAL.enable()


def disable_tracing():
    _GLOBAL.disable()
