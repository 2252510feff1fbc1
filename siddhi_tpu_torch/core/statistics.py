"""Statistics / metrics subsystem.

(reference: util/statistics/** — Codahale metrics-core trackers behind
StatisticsManager / StatisticsTrackerFactory SPIs; throughput per junction,
latency per query, memory gauges; console/JMX reporters configured by
`@app:statistics(reporter='console', interval='5')`.)

Grown into a full metrics core (observability PR):

  * ``Histogram`` — log-bucketed HDR-style value recorder (32 sub-buckets
    per octave → ≤ ~6% relative error) with p50/p95/p99/max, the shape a
    p99-latency headline metric needs (BASELINE.json).
  * ``LatencyTracker`` — histogram-backed, safe under nesting and
    concurrent queries (per-thread mark stacks; the old single `_mark`
    field dropped legitimate 0-ns marks and let interleaved queries
    corrupt each other).
  * ``ThroughputTracker`` — lifetime AND windowed (since-last-snapshot)
    rates, so a reporter interval sees current load, not the lifetime
    average.
  * ``Counter`` / ``Gauge`` — label-carrying primitives for everything
    that isn't one of the four classic tracker kinds.
  * Prometheus/OpenMetrics text rendering (``prometheus_text``) consumed
    by the service's ``GET /metrics`` endpoint (service/rest.py).

Metric naming keeps the reference's
``io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name>`` scheme internally;
the Prometheus renderer maps it onto ``siddhi_*{app=,kind=,name=}``
series.  Everything stays off the hot path when ``@app:statistics`` is
disabled: no trackers are registered at all (core/runtime.py wires them
only when enabled).
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .threads import engine_thread_name

# ------------------------------------------------------------------ histogram

_SUB_BITS = 5                    # 2^5 sub-buckets per octave
_SUB = 1 << _SUB_BITS            # values < 32 are exact
_HALF = _SUB >> 1


def _bucket_index(v: int) -> int:
    """Value → log-bucket index.  Exact below _SUB; above, one bucket per
    (octave, sub-bucket) pair — HDR-histogram math with 2^(1-_SUB_BITS)
    (~6%) worst-case relative error."""
    if v < _SUB:
        return v if v >= 0 else 0
    s = v.bit_length() - _SUB_BITS
    return _SUB + ((s - 1) << (_SUB_BITS - 1)) + ((v >> s) - _HALF)


def _bucket_bounds(idx: int) -> Tuple[int, int]:
    """Bucket index → half-open value range [lo, hi)."""
    if idx < _SUB:
        return idx, idx + 1
    s = ((idx - _SUB) >> (_SUB_BITS - 1)) + 1
    sub = (idx - _SUB) & (_HALF - 1)
    lo = (_HALF + sub) << s
    return lo, lo + (1 << s)


class Histogram:
    """Log-bucketed value recorder with percentile estimation.

    ``record`` is O(1) (a bit_length + one list increment); percentile
    reads walk the bucket array.  Thread-safe: records take a lock —
    callers record per *chunk*, not per event, so contention is nil.
    """

    __slots__ = ("counts", "count", "total", "min", "max", "_lock")

    def __init__(self):
        self.counts: List[int] = []
        self.count = 0
        self.total = 0
        self.min: Optional[int] = None
        self.max = 0
        self._lock = threading.Lock()

    def record(self, v: int) -> None:
        v = int(v)
        if v < 0:
            v = 0
        idx = _bucket_index(v)
        with self._lock:
            if idx >= len(self.counts):
                self.counts.extend([0] * (idx + 1 - len(self.counts)))
            self.counts[idx] += 1
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """q in [0, 100] → bucket-midpoint estimate (≤ ~6% rel error)."""
        with self._lock:
            n = self.count
            if n == 0:
                return 0.0
            target = max(1, int(round(q / 100.0 * n)))
            cum = 0
            for idx, c in enumerate(self.counts):
                if not c:
                    continue
                cum += c
                if cum >= target:
                    lo, hi = _bucket_bounds(idx)
                    return (lo + hi - 1) / 2.0
            return float(self.max)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def buckets(self) -> List[Tuple[int, int]]:
        """Non-empty (upper_bound, count) pairs in increasing order —
        feed for cumulative Prometheus ``_bucket`` series."""
        with self._lock:
            return [(_bucket_bounds(i)[1], c)
                    for i, c in enumerate(self.counts) if c]

    def summary(self, scale: float = 1.0) -> Dict[str, float]:
        return {"count": self.count,
                "mean": self.mean() * scale,
                "p50": self.percentile(50) * scale,
                "p95": self.percentile(95) * scale,
                "p99": self.percentile(99) * scale,
                "min": (self.min or 0) * scale,
                "max": self.max * scale}


# ------------------------------------------------------------------ trackers

class ThroughputTracker:
    __slots__ = ("name", "count", "_t0", "_win_count", "_win_t0")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._t0 = time.time()
        self._win_count = 0
        self._win_t0 = self._t0

    def event_in(self, n: int = 1):
        self.count += n

    def rate(self) -> float:
        dt = time.time() - self._t0
        return self.count / dt if dt > 0 else 0.0

    def windowed_rate(self) -> float:
        """Rate since the previous ``windowed_rate`` call (the reporter
        interval), falling back to the lifetime rate on the first read."""
        now = time.time()
        dt = now - self._win_t0
        dn = self.count - self._win_count
        self._win_t0, self._win_count = now, self.count
        if dt <= 0:
            return 0.0
        return dn / dt


class LatencyTracker:
    """Histogram-backed latency tracker.

    Marks nest via a per-thread stack (``mark_in``/``mark_out`` pairs can
    recurse — e.g. a query feeding another query on the same thread — and
    concurrent queries on different threads never see each other's
    marks).  A 0-ns duration is recorded, not dropped."""

    __slots__ = ("name", "total_ns", "count", "hist", "_tls")

    def __init__(self, name: str):
        self.name = name
        self.total_ns = 0
        self.count = 0
        self.hist = Histogram()
        self._tls = threading.local()

    def mark_in(self):
        stack = getattr(self._tls, "marks", None)
        if stack is None:
            stack = self._tls.marks = []
        stack.append(time.perf_counter_ns())

    def mark_out(self):
        stack = getattr(self._tls, "marks", None)
        if not stack:
            return              # unmatched mark_out: ignore
        dt = time.perf_counter_ns() - stack.pop()
        self.total_ns += dt
        self.count += 1
        self.hist.record(dt)

    def avg_ms(self) -> float:
        return (self.total_ns / self.count) / 1e6 if self.count else 0.0

    def percentiles_ms(self) -> Dict[str, float]:
        return {"p50_ms": self.hist.percentile(50) / 1e6,
                "p95_ms": self.hist.percentile(95) / 1e6,
                "p99_ms": self.hist.percentile(99) / 1e6,
                "max_ms": self.hist.max / 1e6}


class MemoryTracker:
    """Gauge over registered state holders exposing `memory_bytes()`."""

    def __init__(self, name: str):
        self.name = name
        self._holders: List[Callable[[], int]] = []

    def register(self, fn: Callable[[], int]):
        self._holders.append(fn)

    def bytes(self) -> int:
        return sum(f() for f in self._holders)


class BufferedEventsTracker:
    """Queue-depth gauge over registered suppliers — wired to @Async
    junction queues (core/stream.py) so backpressure is visible before it
    becomes an @OnError drop."""

    def __init__(self, name: str):
        self.name = name
        self._suppliers: List[Callable[[], int]] = []

    def register(self, fn: Callable[[], int]):
        self._suppliers.append(fn)

    @property
    def buffered(self) -> int:
        total = 0
        for f in self._suppliers:
            try:
                total += int(f())
            except Exception:   # noqa: BLE001 — a dying junction reads as 0
                pass
        return total


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter with label support: ``c.inc(3, stream='S')``."""

    __slots__ = ("name", "_series", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._series: Dict[Tuple, int] = {}
        self._lock = threading.Lock()

    def inc(self, n: int = 1, **labels):
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> int:
        return self._series.get(_label_key(labels), 0)

    def series(self) -> Dict[Tuple, int]:
        return dict(self._series)


class Gauge:
    """Point-in-time value with label support; a labelset can also be
    bound to a supplier callable (read at snapshot time)."""

    __slots__ = ("name", "_series", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._series: Dict[Tuple, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = lambda v=value: v

    def set_fn(self, fn: Callable[[], float], **labels):
        with self._lock:
            self._series[_label_key(labels)] = fn

    def value(self, **labels) -> float:
        fn = self._series.get(_label_key(labels))
        return float(fn()) if fn is not None else 0.0

    def series(self) -> Dict[Tuple, float]:
        out = {}
        for key, fn in list(self._series.items()):
            try:
                out[key] = float(fn())
            except Exception:   # noqa: BLE001 — supplier died with its owner
                out[key] = 0.0
        return out


# ------------------------------------------------------------------ manager

class StatisticsManager:
    """Registry + reporter.  Metric naming mirrors the reference:
    io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name>
    (reference SiddhiAppRuntime.java:720-727)."""

    def __init__(self, app_name: str, reporter: str = "console",
                 interval_s: int = 60):
        self.app_name = app_name
        self.reporter = reporter
        self.interval_s = interval_s
        self.throughput: Dict[str, ThroughputTracker] = {}
        self.latency: Dict[str, LatencyTracker] = {}
        self.memory: Dict[str, MemoryTracker] = {}
        self.buffered: Dict[str, BufferedEventsTracker] = {}
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.enabled = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lifecycle_lock = threading.Lock()

    def _metric(self, kind: str, name: str) -> str:
        return f"io.siddhi.SiddhiApps.{self.app_name}.Siddhi.{kind}.{name}"

    def throughput_tracker(self, kind: str, name: str) -> ThroughputTracker:
        key = self._metric(kind, name)
        return self.throughput.setdefault(key, ThroughputTracker(key))

    def latency_tracker(self, kind: str, name: str) -> LatencyTracker:
        key = self._metric(kind, name)
        return self.latency.setdefault(key, LatencyTracker(key))

    def memory_tracker(self, kind: str, name: str) -> MemoryTracker:
        key = self._metric(kind, name)
        return self.memory.setdefault(key, MemoryTracker(key))

    def buffered_tracker(self, kind: str, name: str) -> BufferedEventsTracker:
        key = self._metric(kind, name)
        return self.buffered.setdefault(key, BufferedEventsTracker(key))

    def counter(self, kind: str, name: str) -> Counter:
        key = self._metric(kind, name)
        return self.counters.setdefault(key, Counter(key))

    def gauge(self, kind: str, name: str) -> Gauge:
        key = self._metric(kind, name)
        return self.gauges.setdefault(key, Gauge(key))

    def snapshot(self) -> dict:
        return {
            "throughput": {k: {"count": t.count, "rate_eps": t.rate(),
                               "rate_windowed_eps": t.windowed_rate()}
                           for k, t in self.throughput.items()},
            "latency_ms": {k: {"avg_ms": t.avg_ms(), "count": t.count,
                               **t.percentiles_ms()}
                           for k, t in self.latency.items()},
            "memory_bytes": {k: m.bytes() for k, m in self.memory.items()},
            "buffered": {k: b.buffered for k, b in self.buffered.items()},
            "counters": {k: {"|".join("=".join(p) for p in key) or "_": v
                             for key, v in c.series().items()}
                         for k, c in self.counters.items()},
            "gauges": {k: {"|".join("=".join(p) for p in key) or "_": v
                           for key, v in g.series().items()}
                       for k, g in self.gauges.items()},
        }

    # -------------------------------------------------------- prometheus

    def _parse_key(self, key: str) -> Dict[str, str]:
        """io.siddhi.SiddhiApps.<app>.Siddhi.<kind>.<name> → labels."""
        prefix = "io.siddhi.SiddhiApps."
        rest = key[len(prefix):] if key.startswith(prefix) else key
        app, sep, tail = rest.partition(".Siddhi.")
        if not sep:
            return {"app": self.app_name, "kind": "", "name": rest}
        kind, _, name = tail.partition(".")
        return {"app": app, "kind": kind, "name": name}

    def prometheus_lines(self) -> List[str]:
        lines: List[str] = []
        for key, t in self.throughput.items():
            lb = _fmt_labels(self._parse_key(key))
            lines.append(f"siddhi_throughput_events_total{lb} {t.count}")
            lines.append(
                f"siddhi_throughput_events_per_second{lb} {t.rate():.6g}")
        for key, t in self.latency.items():
            lb_map = self._parse_key(key)
            lb = _fmt_labels(lb_map)
            cum = 0
            for hi_ns, c in t.hist.buckets():
                cum += c
                le = hi_ns / 1e9
                lines.append("siddhi_latency_seconds_bucket"
                             f"{_fmt_labels(lb_map, le=f'{le:.9g}')} {cum}")
            lines.append("siddhi_latency_seconds_bucket"
                         f"{_fmt_labels(lb_map, le='+Inf')} {t.hist.count}")
            lines.append(
                f"siddhi_latency_seconds_sum{lb} {t.total_ns / 1e9:.9g}")
            lines.append(f"siddhi_latency_seconds_count{lb} {t.hist.count}")
        for key, m in self.memory.items():
            lb = _fmt_labels(self._parse_key(key))
            lines.append(f"siddhi_memory_bytes{lb} {m.bytes()}")
        for key, b in self.buffered.items():
            lb = _fmt_labels(self._parse_key(key))
            lines.append(f"siddhi_buffered_events{lb} {b.buffered}")
        for key, c in self.counters.items():
            base = self._parse_key(key)
            for lkey, v in c.series().items():
                lb = _fmt_labels({**base, **dict(lkey)})
                lines.append(f"siddhi_counter_total{lb} {v}")
        for key, g in self.gauges.items():
            base = self._parse_key(key)
            for lkey, v in g.series().items():
                lb = _fmt_labels({**base, **dict(lkey)})
                lines.append(f"siddhi_gauge{lb} {v:.9g}")
        return lines

    # ------------------------------------------------------------ lifecycle

    def start_reporting(self):
        self.enabled = True
        if self.reporter not in ("console", "json") or self.interval_s <= 0:
            return
        with self._lifecycle_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    if self.enabled:
                        print(json.dumps({"siddhi_stats": self.snapshot()}),
                              file=sys.stderr)
            self._thread = threading.Thread(
                target=loop, daemon=True,
                name=engine_thread_name("siddhi-stats-reporter"))
            self._thread.start()

    def stop_reporting(self):
        self.enabled = False
        with self._lifecycle_lock:
            self._stop.set()
            t = self._thread
            if t is not None:
                # join, don't abandon: the old `_thread = None` without a
                # join let a racing start_reporting spawn a second
                # reporter while the first still printed
                t.join(timeout=5.0)
                self._thread = None


# ------------------------------------------------------------------ exposition

def _fmt_labels(labels: Dict[str, str], **extra) -> str:
    merged = {**labels, **extra}
    merged = {k: v for k, v in merged.items() if v != ""}
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_TYPES = [
    ("siddhi_throughput_events_total",
     "counter", "Events entering a stream junction"),
    ("siddhi_throughput_events_per_second",
     "gauge", "Lifetime event rate of a stream junction"),
    ("siddhi_latency_seconds",
     "histogram", "Per-query processing latency"),
    ("siddhi_memory_bytes", "gauge", "State-holder buffer footprint"),
    ("siddhi_buffered_events",
     "gauge", "Queued events in @Async junction buffers"),
    ("siddhi_counter_total", "counter", "App-defined counters"),
    ("siddhi_gauge", "gauge", "App-defined gauges"),
    ("siddhi_kernel_calls_total",
     "counter", "Device kernel invocations"),
    ("siddhi_kernel_compile_count",
     "gauge", "XLA compiles (incl. retraces) of a kernel"),
    ("siddhi_kernel_device_time_seconds_total",
     "gauge", "Blocked device time per kernel (profiling mode)"),
    ("siddhi_kernel_dispatch_time_seconds_total",
     "gauge", "Host-side dispatch time per kernel"),
    ("siddhi_kernel_h2d_bytes_total",
     "counter", "Host->device bytes fed to a kernel"),
    ("siddhi_kernel_d2h_bytes_total",
     "counter", "Device->host bytes retired from a kernel"),
    ("siddhi_kernel_batch_events_total",
     "counter", "Events carried through a kernel"),
    ("siddhi_kernel_dispatches_total",
     "counter", "Device executions launched by a kernel"),
    ("siddhi_kernel_scan_ticks_total",
     "counter", "lax.scan ticks executed inside a kernel"),
    ("siddhi_kernel_live_bytes",
     "gauge", "Live device-buffer bytes owned by a kernel"),
    ("siddhi_kernel_batch_b", "gauge", "Events folded per scan tick (B)"),
    ("siddhi_app_dispatches_per_block",
     "gauge", "Device dispatches per ingest block (running average)"),
]

#: Always-on host-rim accounting (core/profiling.RimStats): rendered on
#: every /metrics scrape regardless of @app:statistics — the zero-copy
#: columnar path is asserted against these counters.
RIM_TYPES = [
    ("siddhi_events_materialized_total",
     "counter", "Per-event Event objects built from columnar chunks"),
    ("siddhi_host_rim_seconds_total",
     "counter", "Host-rim wall time (ingress conversion + egress "
     "delivery)"),
]

#: Always-on per-stage latency ledger + lag watermarks + SLO engine
#: (core/ledger.py): rendered on every /metrics scrape regardless of
#: @app:statistics; SIDDHI_TPU_LEDGER=0 freezes the counters.
LEDGER_TYPES = [
    ("siddhi_ledger_stage_seconds_total",
     "counter", "Exclusive wall time attributed to a pipeline stage"),
    ("siddhi_ledger_stage_spans_total",
     "counter", "Ledger span exits per pipeline stage"),
    ("siddhi_ledger_stage_latency_ms",
     "gauge", "Per-app per-block stage latency quantiles (ms)"),
    ("siddhi_event_time_lag_ms",
     "gauge", "Max admitted event timestamp vs wall/playback clock"),
    ("siddhi_processing_lag_ms",
     "gauge", "Wall time since a stream last admitted a chunk"),
    ("siddhi_slo_burn_rate",
     "gauge", "Observed / target ratio per @app:slo objective"),
    ("siddhi_slo_breach_active",
     "gauge", "1 while an app's SLO breach is active"),
    ("siddhi_slo_breach_total",
     "counter", "SLO breach transitions (SLO001 incidents)"),
]

#: Opt-in on-device state telemetry (@app:statistics(telemetry='true')).
#: Accumulated in-kernel (ops/nfa.py, ops/dwin.py) and read out through
#: the fused-egress slab — see DeviceTelemetry.
TELEMETRY_TYPES = [
    ("siddhi_nfa_state_occupancy",
     "gauge", "Live NFA slot occupancy per automaton state"),
    ("siddhi_nfa_gate_pass_total",
     "counter", "Condition-gate passes per automaton state"),
    ("siddhi_nfa_gate_fail_total",
     "counter", "Condition-gate failures per automaton state"),
    ("siddhi_nfa_within_drops_total",
     "counter", "Partial matches expired by the within clause"),
    ("siddhi_dwin_ring_fill", "gauge", "Device window ring occupancy"),
    ("siddhi_dwin_evictions_total",
     "counter", "Events evicted/expired from a device window"),
    ("siddhi_dwin_overflow_total",
     "counter", "Device window ring overflow trips"),
]


#: Always-on process-level series: resident set, uptime, and Python GC
#: tallies.  The GC-amplification finding (egress allocation storms
#: triggering gen-2 collections) previously had no resident gauge to
#: correlate against — these render on every scrape, app stats or not.
PROCESS_TYPES = [
    ("siddhi_process_rss_bytes", "gauge",
     "Resident set size of the engine process"),
    ("siddhi_process_uptime_seconds", "gauge",
     "Seconds since this process imported the engine"),
    ("siddhi_gc_collections_total", "counter",
     "Python GC collections per generation"),
    ("siddhi_gc_collected_total", "counter",
     "Objects collected by the Python GC per generation"),
    ("siddhi_gc_uncollectable_total", "counter",
     "Uncollectable objects found by the Python GC per generation"),
]

_PROCESS_START = time.time()


def _rss_bytes() -> int:
    """Resident set in bytes: /proc/self/status VmRSS (kB) where it
    exists, else getrusage (Linux reports KiB there too)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:   # noqa: BLE001 — exotic platform: report zero
        return 0


def process_lines() -> List[str]:
    import gc
    lines = [f"siddhi_process_rss_bytes {_rss_bytes()}",
             "siddhi_process_uptime_seconds "
             f"{time.time() - _PROCESS_START:.3f}"]
    for gen, st in enumerate(gc.get_stats()):
        lb = f'{{generation="{gen}"}}'
        lines.append(f"siddhi_gc_collections_total{lb} "
                     f"{st.get('collections', 0)}")
        lines.append(f"siddhi_gc_collected_total{lb} "
                     f"{st.get('collected', 0)}")
        lines.append(f"siddhi_gc_uncollectable_total{lb} "
                     f"{st.get('uncollectable', 0)}")
    return lines


class DeviceTelemetry:
    """Host-side holder for the opt-in on-device telemetry blocks.

    NFA carries contribute a ``[P, 3S+1]`` int32 leaf per query
    (per-state occupancy gauge, cumulative gate pass/fail counts, within
    drops); device windows contribute ``[fill, evictions, overflow]``.
    The device runtimes push the latest host copy here on retire; REST
    ``/metrics``, ``rt.statistics`` and the flight ring read it out."""

    def __init__(self, app_name: str):
        self.app_name = app_name
        self._lock = threading.Lock()
        self._nfa: Dict[str, Dict[str, Any]] = {}
        self._windows: Dict[str, Dict[str, int]] = {}

    def update_nfa(self, query: str, telem, n_states: int,
                   unit_kinds=None) -> None:
        import numpy as np
        t = np.asarray(telem)
        if t.ndim == 2:             # [P, 3S+1] → totals across partitions
            t = t.sum(axis=0)
        S = int(n_states)
        with self._lock:
            self._nfa[query] = {
                "occupancy": [int(v) for v in t[:S]],
                "gate_pass": [int(v) for v in t[S:2 * S]],
                "gate_fail": [int(v) for v in t[2 * S:3 * S]],
                "within_drops": int(t[3 * S]),
                "state_kinds": list(unit_kinds or []),
            }

    def update_window(self, name: str, telem3) -> None:
        import numpy as np
        t = np.asarray(telem3).reshape(-1)
        with self._lock:
            self._windows[name] = {"fill": int(t[0]),
                                   "evictions": int(t[1]),
                                   "overflow": int(t[2])}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"nfa": {q: dict(v) for q, v in self._nfa.items()},
                    "windows": {w: dict(v)
                                for w, v in self._windows.items()}}

    def prometheus_lines(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            for query, rec in self._nfa.items():
                for i, occ in enumerate(rec["occupancy"]):
                    lb = _fmt_labels({"app": self.app_name, "query": query,
                                      "state": str(i)})
                    lines.append(f"siddhi_nfa_state_occupancy{lb} {occ}")
                for i, v in enumerate(rec["gate_pass"]):
                    lb = _fmt_labels({"app": self.app_name, "query": query,
                                      "state": str(i)})
                    lines.append(f"siddhi_nfa_gate_pass_total{lb} {v}")
                for i, v in enumerate(rec["gate_fail"]):
                    lb = _fmt_labels({"app": self.app_name, "query": query,
                                      "state": str(i)})
                    lines.append(f"siddhi_nfa_gate_fail_total{lb} {v}")
                lb = _fmt_labels({"app": self.app_name, "query": query})
                lines.append("siddhi_nfa_within_drops_total"
                             f"{lb} {rec['within_drops']}")
            for name, rec in self._windows.items():
                lb = _fmt_labels({"app": self.app_name, "window": name})
                lines.append(f"siddhi_dwin_ring_fill{lb} {rec['fill']}")
                lines.append("siddhi_dwin_evictions_total"
                             f"{lb} {rec['evictions']}")
                lines.append("siddhi_dwin_overflow_total"
                             f"{lb} {rec['overflow']}")
        return lines


def prometheus_text(managers: List[StatisticsManager],
                    kernel_profiler=None, resilience=None,
                    ingest=None, telemetry=None, tenants=None) -> str:
    """Full Prometheus/OpenMetrics text exposition over any number of app
    StatisticsManagers plus the (process-global) kernel profiler, the
    per-runtime ResilienceMetrics (core/resilience.py), the per-runtime
    IngestMetrics (core/overload.py) and the per-runtime DeviceTelemetry
    holders.  Every series family gets its # HELP/# TYPE header exactly
    once, before any samples."""
    from .ledger import ledger
    from .numguard import NUMERIC_TYPES, all_numeric_sentinels
    from .overload import INGEST_TYPES, TENANT_TYPES
    from .profiling import rim_stats
    from .resilience import RESILIENCE_TYPES
    from ..plan.xtenant import XTENANT_TYPES
    from ..plan.shapes import SHAPES_TYPES, shape_registry
    lines: List[str] = []
    for name, typ, help_ in (_TYPES + RIM_TYPES + LEDGER_TYPES +
                             TELEMETRY_TYPES + RESILIENCE_TYPES +
                             INGEST_TYPES + TENANT_TYPES + XTENANT_TYPES +
                             SHAPES_TYPES + NUMERIC_TYPES + PROCESS_TYPES):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")
    lines.extend(rim_stats().prometheus_lines())
    lines.extend(ledger().prometheus_lines())
    lines.extend(shape_registry().prometheus_lines())
    for ns in all_numeric_sentinels():
        # numeric sentinels (core/numguard.py, SIDDHI_TPU_NUMGUARD):
        # process-global registry like the flight recorder
        lines.extend(ns.prometheus_lines())
    lines.extend(process_lines())
    for sm in managers:
        lines.extend(sm.prometheus_lines())
    if kernel_profiler is not None:
        lines.extend(kernel_profiler.prometheus_lines())
    for rm in (resilience or []):
        lines.extend(rm.prometheus_lines())
    for im in (ingest or []):
        lines.extend(im.prometheus_lines())
    for dt in (telemetry or []):
        lines.extend(dt.prometheus_lines())
    for tn in (tenants or []):
        # fair-share quotas (overload.FairShare) and the cross-tenant
        # packer (plan/xtenant.TenantPacker): per-tenant / per-bucket
        lines.extend(tn.prometheus_lines())
    return "\n".join(lines) + "\n"
