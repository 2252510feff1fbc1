"""Ingest protection: overload admission control, poison-event
quarantine, and the dispatch-storm watchdog.

The egress side got production armor in the resilience PR (sink retry
queues, circuit breakers, error stores); this module is the matching
ingest armor:

  * ``OverloadConfig`` — per-stream @Async admission policy
    (``@Async(overload='BLOCK'|'SHED_OLDEST'|'SHED_NEW'|'STORE')``) with
    high/low watermarks on queue depth.  BLOCK bounds the formerly
    infinite ``Queue.put()`` with a timeout + typed
    ``BufferOverflowError``; the shedding policies keep the engine alive
    at 10x offered load by dropping (and exactly counting) events
    instead of wedging.
  * ``QuarantineConfig`` / ``IngestValidator`` — opt-in per-stream
    (``@quarantine(...)``) vectorized validation of ingested events:
    NaN/Inf numerics, non-coercible payload types, timestamps that
    regress beyond a configurable slack or sit so far from the
    high-water mark that they would overflow the ts32 window math.
    Rejects are routed to the error store with a typed reason (origin
    ``'ingest'``) and are replayable through the normal
    ``/errors/replay`` path — a replay re-validates.
  * ``DispatchWatchdog`` — an always-on tripwire for runaway
    timer/dispatch loops (the session-timer incident class: a 1 ms
    re-arm crawl dispatching 50k+ times on a 60-event stream with zero
    ingest progress).  When one timer target re-fires past a threshold
    with no ingest progress, the watchdog trips, force-disarms that
    target, records a ``WD0xx`` incident (surfaced on ``GET /health``
    and the error store), and lets the app keep running degraded
    instead of spinning.
  * ``IngestMetrics`` — always-on admit/shed/overflow/quarantine
    counters and a saturation gauge, rendered on ``GET /metrics``
    (deliberately independent of ``@app:statistics``, like
    ResilienceMetrics).

Kill switch: ``SIDDHI_TPU_INGEST_GUARD=0`` disables the whole subsystem
(admission falls back to the legacy unbounded blocking put, no
validator, no watchdog).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.errors import DispatchStormError, PoisonEventError
from .statistics import Counter, Gauge

log = logging.getLogger(__name__)

#: Kill switch for the whole ingest-protection subsystem.
GUARD_ENV = "SIDDHI_TPU_INGEST_GUARD"

OVERLOAD_POLICIES = ("BLOCK", "SHED_OLDEST", "SHED_NEW", "STORE")


def guard_enabled() -> bool:
    raw = os.environ.get(GUARD_ENV, "").strip().lower()
    return raw not in ("0", "false", "off", "no")


# ------------------------------------------------------------------ admission


class OverloadConfig:
    """Admission policy for one @Async junction.

    Watermarks are fractions of ``buffer.size`` (chunks).  Shedding
    policies engage at the high watermark and (for SHED_OLDEST) evict
    down to the low watermark, giving hysteresis; BLOCK ignores the
    watermarks except for /health saturation reporting.
    """

    __slots__ = ("policy", "high", "low", "high_chunks", "low_chunks",
                 "block_timeout_s", "drain_timeout_s")

    def __init__(self, policy: str = "BLOCK", high: float = 0.8,
                 low: float = 0.5, buffer_size: int = 1024,
                 block_timeout_ms: float = 60_000.0,
                 drain_timeout_ms: float = 600_000.0):
        policy = (policy or "BLOCK").upper()
        if policy not in OVERLOAD_POLICIES:
            log.warning("unknown overload policy %r: falling back to BLOCK "
                        "(see analyzer diagnostic SA060)", policy)
            policy = "BLOCK"
        if not (0.0 < high <= 1.0) or not (0.0 <= low <= 1.0) or low >= high:
            log.warning("invalid overload watermarks high=%s low=%s: using "
                        "0.8/0.5 (see analyzer diagnostic SA061)", high, low)
            high, low = 0.8, 0.5
        if block_timeout_ms <= 0:
            block_timeout_ms = 60_000.0
        if drain_timeout_ms <= 0:
            drain_timeout_ms = 600_000.0
        self.policy = policy
        self.high = high
        self.low = low
        self.high_chunks = max(1, int(high * buffer_size))
        self.low_chunks = min(max(0, int(low * buffer_size)),
                              self.high_chunks - 1)
        self.block_timeout_s = block_timeout_ms / 1000.0
        self.drain_timeout_s = drain_timeout_ms / 1000.0

    @staticmethod
    def from_annotation(ann, buffer_size: int) -> "OverloadConfig":
        def num(key, default):
            raw = ann.get(key, None)
            if raw is None:
                return default
            try:
                return float(raw)
            except (TypeError, ValueError):
                log.warning("@Async(%s=%r) on stream is not numeric: using "
                            "%s (see analyzer diagnostic SA061)",
                            key, raw, default)
                return default
        return OverloadConfig(
            policy=ann.get("overload", "BLOCK"),
            high=num("overload.high", 0.8),
            low=num("overload.low", 0.5),
            buffer_size=buffer_size,
            block_timeout_ms=num("block.timeout.ms", 60_000.0),
            drain_timeout_ms=num("drain.timeout.ms", 600_000.0))


# ------------------------------------------------------------------ quarantine


def _parse_bool(raw, default: bool) -> bool:
    if raw is None:
        return default
    v = str(raw).strip().lower()
    if v in ("0", "false", "off", "no"):
        return False
    if v in ("1", "true", "on", "yes"):
        return True
    return default      # malformed: analyzer diagnostic SA063


class QuarantineConfig:
    """Validation policy for one stream's ingest, from ``@quarantine(...)``.

    Opt-in by design: apps that deliberately feed NaN/Inf through the
    engine (outer-join null lanes, sentinel payloads) keep today's
    bit-identical behavior unless the annotation is present.
    """

    __slots__ = ("ts_slack_ms", "check_nan", "check_wrap")

    def __init__(self, ts_slack_ms: Optional[int] = None,
                 check_nan: bool = True, check_wrap: bool = True):
        self.ts_slack_ms = ts_slack_ms
        self.check_nan = check_nan
        self.check_wrap = check_wrap

    @staticmethod
    def from_annotation(ann) -> "QuarantineConfig":
        slack = None
        raw = ann.get("ts.slack.ms", None)
        if raw is not None:
            try:
                slack = int(raw)
                if slack < 0:
                    raise ValueError
            except (TypeError, ValueError):
                log.warning("@quarantine(ts.slack.ms=%r) is not a "
                            "non-negative integer: timestamp-regression "
                            "check disabled (see analyzer diagnostic "
                            "SA063)", raw)
                slack = None
        return QuarantineConfig(
            ts_slack_ms=slack,
            check_nan=_parse_bool(ann.get("nan", None), True),
            check_wrap=_parse_bool(ann.get("wrap", None), True))


class IngestValidator:
    """Vectorized poison-event filter for one stream.

    ``filter_chunk`` splits an ingest chunk into (admitted, rejects) by
    reason; ``salvage_rows`` isolates non-coercible rows when the bulk
    ``EventChunk.from_rows`` coercion fails.  The timestamp high-water
    mark advances only on admitted events, so a single wrap-poison
    timestamp cannot drag the admissible window with it.
    """

    REASON_NAN = "nan"
    REASON_TYPE = "type"
    REASON_TS_REGRESS = "ts_regress"
    REASON_TS_WRAP = "ts_wrap"

    def __init__(self, definition, config: QuarantineConfig):
        self.definition = definition
        self.config = config
        self._hwm: Optional[int] = None
        self._lock = threading.Lock()

    def salvage_rows(self, rows, stamps) -> Tuple[list, list, list]:
        """Per-row fallback when the whole-chunk dtype coercion raised:
        returns (good_rows, good_stamps, bad_events)."""
        from .event import Event, EventChunk
        good_rows: list = []
        good_stamps: list = []
        bad: list = []
        for r, ts in zip(rows, stamps):
            try:
                EventChunk.from_rows(self.definition, [r], [ts])
            except (TypeError, ValueError):
                bad.append(Event(ts, list(r)))
            else:
                good_rows.append(r)
                good_stamps.append(ts)
        return good_rows, good_stamps, bad

    def filter_chunk(self, chunk) -> Tuple[Any, List[Tuple[str, Any]]]:
        """Split `chunk` into (admitted_chunk, [(reason, reject_chunk)]).
        Vectorized: one boolean mask pass per enabled check."""
        cfg = self.config
        n = len(chunk)
        if n == 0:
            return chunk, []
        bad = np.zeros(n, bool)
        reasons = np.empty(n, object)
        if cfg.check_nan:
            for name in chunk.names:
                col = chunk.columns[name]
                if np.issubdtype(col.dtype, np.floating):
                    m = ~np.isfinite(col) & ~bad
                    reasons[m] = self.REASON_NAN
                    bad |= m
        ts = chunk.timestamps
        with self._lock:
            hwm = self._hwm
            if hwm is not None:
                if cfg.ts_slack_ms is not None:
                    m = (ts < hwm - cfg.ts_slack_ms) & ~bad
                    reasons[m] = self.REASON_TS_REGRESS
                    bad |= m
                if cfg.check_wrap:
                    from ..ops.ts32 import safe_max
                    lim = safe_max(cfg.ts_slack_ms or 0)
                    m = (np.abs(ts - hwm) > lim) & ~bad
                    reasons[m] = self.REASON_TS_WRAP
                    bad |= m
            good = chunk.mask(~bad)
            if len(good) > 0:
                mx = int(good.timestamps.max())
                if hwm is None or mx > hwm:
                    self._hwm = mx
        rejects: List[Tuple[str, Any]] = []
        if bad.any():
            for reason in (self.REASON_NAN, self.REASON_TS_REGRESS,
                           self.REASON_TS_WRAP):
                m = bad & (reasons == reason)
                if m.any():
                    rejects.append((reason, chunk.mask(m)))
        return good, rejects


def route_rejects(junction, events_by_reason: List[Tuple[str, list]]):
    """Deliver quarantined events to their destination: honor @OnError
    STREAM routing; otherwise the error store (origin='ingest'); last
    resort a log line.  Always counts ingest_quarantined_total."""
    from .resilience import make_entry
    rt = getattr(junction.app_ctx, "runtime", None)
    app_name = rt.name if rt is not None else ""
    im = getattr(rt, "ingest_metrics", None)
    store = getattr(rt, "error_store", None)
    sid = junction.definition.id
    total = sum(len(events) for _r, events in events_by_reason)
    from .flight import flight, quarantine_burst_threshold
    if total >= quarantine_burst_threshold():
        flight().emit(
            "quarantine_burst", app=app_name,
            detail={"stream": sid, "rejected": total,
                    "reasons": {r: len(e) for r, e in events_by_reason
                                if e}},
            runtime=rt)
    for reason, events in events_by_reason:
        if not events:
            continue
        if im is not None:
            im.ingest_quarantined_total.inc(len(events), stream=sid,
                                            reason=reason)
        err = PoisonEventError(
            f"quarantined {len(events)} event(s) on '{sid}': {reason}")
        if junction.on_error_action == "STREAM" \
                and junction.fault_junction is not None:
            from .event import EventChunk
            fd = junction.fault_junction.definition
            rows = [list(e.data) + [repr(err)] for e in events]
            stamps = [e.timestamp for e in events]
            junction.fault_junction.send(
                EventChunk.from_rows(fd, rows, stamps))
        elif store is not None:
            store.store(make_entry(app_name, sid, "ingest", err, events))
            rm = getattr(rt, "resilience_metrics", None)
            if rm is not None:
                rm.errors_stored_total.inc(len(events), stream=sid,
                                           origin="ingest")
        else:
            log.error("dropping %d quarantined event(s) on '%s' (%s): no "
                      "error store configured", len(events), sid, reason)


# ------------------------------------------------------------------ fair share


class TenantQuota:
    """Token-bucket ingest quota for one tenant app (``@app:quota``).

    ``rate`` is the sustained external-ingest budget in events/second;
    ``burst`` is the bucket capacity (default ``2*rate``, floor 1).
    ``admit(n)`` returns how many of the next ``n`` events may pass —
    the ingest boundary sheds the rest (reason ``'quota'``), so one
    greedy tenant saturating its own budget can never starve the shared
    device of co-tenants' dispatch slots.

    ``now`` is injectable for deterministic tests; production callers
    use the monotonic clock.  ``breach`` latches per episode so the
    flight recorder emits ONE quota_breach bundle per excursion instead
    of one per shed chunk.
    """

    __slots__ = ("app_name", "rate", "burst", "tokens", "_last",
                 "_lock", "breach")

    def __init__(self, app_name: str, rate: float,
                 burst: Optional[float] = None):
        self.app_name = app_name
        self.rate = max(float(rate), 0.0)
        b = float(burst) if burst is not None else self.rate * 2.0
        self.burst = max(b, 1.0)
        self.tokens = self.burst
        self._last: Optional[float] = None
        self._lock = threading.Lock()
        self.breach = False

    @staticmethod
    def from_annotation(app_name: str, ann) -> Optional["TenantQuota"]:
        def num(key):
            raw = ann.get(key, None)
            if raw is None:
                return None
            try:
                return float(raw)
            except (TypeError, ValueError):
                log.warning("@app:quota(%s=%r) is not numeric: ignored "
                            "(see analyzer diagnostic SA064)", key, raw)
                return None
        pos = ann.positional()
        rate = num("rate")
        if rate is None and pos:
            try:
                rate = float(pos[0])
            except (TypeError, ValueError):
                rate = None
        if rate is None or rate <= 0:
            log.warning("@app:quota on '%s' has no positive rate: quota "
                        "disabled (see analyzer diagnostic SA064)", app_name)
            return None
        return TenantQuota(app_name, rate, num("burst"))

    def admit(self, n: int, now: Optional[float] = None) -> int:
        """How many of ``n`` offered events fit the budget right now."""
        if n <= 0:
            return 0
        with self._lock:
            t = time.monotonic() if now is None else now
            if self._last is None:
                self._last = t
            dt = t - self._last
            if dt > 0:
                self.tokens = min(self.burst, self.tokens + dt * self.rate)
                self._last = t
            take = int(min(n, self.tokens))
            self.tokens -= take
            return take

    def level(self) -> float:
        """Remaining token fraction (1.0 = idle budget, 0.0 = exhausted)
        — the per-tenant saturation gauge on /metrics."""
        with self._lock:
            return self.tokens / self.burst if self.burst > 0 else 0.0


class FairShare:
    """Process-global fair-share registry: one ``TenantQuota`` per app
    plus the per-tenant admitted/shed counters rendered on /metrics.

    Registration rides ``@app:quota`` parsing (before junctions exist),
    eviction rides app shutdown; the ingest boundary caches the quota
    object at InputHandler construction, so the hot path never touches
    this registry's lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._quotas: Dict[str, TenantQuota] = {}
        self.tenant_admitted_total = Counter("tenant_admitted_total")
        self.tenant_shed_total = Counter("tenant_shed_total")

    def register(self, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[quota.app_name] = quota

    def unregister(self, app_name: str) -> None:
        with self._lock:
            self._quotas.pop(app_name, None)

    def quota_for(self, app_name: str) -> Optional[TenantQuota]:
        with self._lock:
            return self._quotas.get(app_name)

    def note(self, app_name: str, admitted: int, shed: int) -> None:
        if admitted:
            self.tenant_admitted_total.inc(admitted, app=app_name)
        if shed:
            self.tenant_shed_total.inc(shed, app=app_name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            quotas = list(self._quotas.values())
        return {q.app_name: {"rate": q.rate, "burst": q.burst,
                             "level": q.level(),
                             "admitted": self.tenant_admitted_total.value(
                                 app=q.app_name),
                             "shed": self.tenant_shed_total.value(
                                 app=q.app_name)}
                for q in quotas}

    def prometheus_lines(self) -> List[str]:
        from .statistics import _fmt_labels
        out: List[str] = []
        with self._lock:
            quotas = list(self._quotas.values())
        for q in quotas:
            lb = _fmt_labels({"app": q.app_name})
            out.append(f"siddhi_tenant_quota_rate{lb} {q.rate:.9g}")
            out.append(f"siddhi_tenant_quota_burst{lb} {q.burst:.9g}")
            out.append(f"siddhi_tenant_quota_level{lb} {q.level():.9g}")
        for lkey, v in self.tenant_admitted_total.series().items():
            out.append(
                f"siddhi_tenant_admitted_total{_fmt_labels(dict(lkey))} {v}")
        for lkey, v in self.tenant_shed_total.series().items():
            out.append(
                f"siddhi_tenant_shed_total{_fmt_labels(dict(lkey))} {v}")
        return out


_FAIR_SHARE = FairShare()


def fair_share() -> FairShare:
    return _FAIR_SHARE


#: HELP/TYPE headers for the fair-share series (statistics.prometheus_text)
TENANT_TYPES = [
    ("siddhi_tenant_quota_rate", "gauge",
     "Configured @app:quota sustained ingest rate (events/second)"),
    ("siddhi_tenant_quota_burst", "gauge",
     "Configured @app:quota burst capacity (events)"),
    ("siddhi_tenant_quota_level", "gauge",
     "Remaining quota-bucket fraction per tenant (1 = idle budget)"),
    ("siddhi_tenant_admitted_total", "counter",
     "Events admitted under a tenant's fair-share quota"),
    ("siddhi_tenant_shed_total", "counter",
     "Events shed at the ingest boundary by fair-share quota "
     "enforcement"),
]


# ------------------------------------------------------------------ watchdog

#: Incident catalog (mirrors the SAxxx diagnostic catalog shape).
WD_CATALOG = {
    "WD001": "dispatch storm: a timer target re-fired repeatedly with "
             "zero ingest progress; the target was force-disarmed and "
             "the app continues degraded",
}


class DispatchWatchdog:
    """Tripwire for runaway timer/dispatch loops.

    Rides the scheduler fire path (always-on — the kernel profiler's
    dispatch counters only count when profiling is enabled): every timer
    fire is checked against a per-target streak of fires with an
    unchanged ingest-progress counter.  The streak deliberately ignores
    the fire instant: the round-5 session re-arm pathology was a 1 ms
    timer *crawl* (the re-arm instant advanced by one guard-bumped
    millisecond per fire, 50k+ dispatches on a 60-event stream), so a
    same-instant key would never see it.  A streak reaching
    ``threshold`` trips the watchdog: the target is disarmed (its
    pending and future ``notify_at`` registrations are dropped), a
    WD001 incident is recorded for ``GET /health``, and an error-store
    entry (origin='watchdog') is written when a store is configured.

    ``note_progress`` is called by every junction send and device
    pipeline submission; any event movement resets the streak, so only
    a genuinely stuck loop can trip it.  Legitimate fire bursts are
    bounded by the number of distinctly armed instants per chunk (a few
    per event), far below the 256-fire threshold, and emitting fires
    feed a junction — which itself notes progress.
    """

    def __init__(self, app_name: str, metrics: Optional["IngestMetrics"]
                 = None, threshold: int = 256):
        self.app_name = app_name
        self.metrics = metrics
        self.threshold = threshold
        self.incidents: List[Dict[str, Any]] = []
        self._disarmed: set = set()
        self._streaks: Dict[Any, list] = {}   # target -> [fires, first_ts, progress]
        self._progress = 0
        self._lock = threading.Lock()

    # hot path: junction.send / pipeline submit.  A lost increment under
    # a race only delays one streak reset; equality (not magnitude) is
    # what the streak check consumes.
    def note_progress(self, n: int = 1):
        self._progress += n

    def is_disarmed(self, target) -> bool:
        return target in self._disarmed

    def allow(self, target, now: int) -> bool:
        """Scheduler consult before invoking `target(now)`.  Returns
        False when the target is (or just became) disarmed."""
        with self._lock:
            if target in self._disarmed:
                return False
            p = self._progress
            st = self._streaks.get(target)
            if st is None or st[2] != p:
                self._streaks[target] = [1, now, p]
                return True
            st[0] += 1
            if st[0] < self.threshold:
                return True
            self._disarmed.add(target)
            fires, since = st[0], st[1]
        self._trip(target, now, fires, since)
        return False

    def _describe(self, target) -> str:
        owner = getattr(target, "__self__", None)
        fn = getattr(target, "__func__", target)
        name = getattr(fn, "__name__", repr(fn))
        if owner is not None:
            return f"{type(owner).__name__}.{name}"
        return name

    def _trip(self, target, now: int, fires: int, since: int):
        desc = self._describe(target)
        incident: Dict[str, Any] = {
            "code": "WD001", "app": self.app_name, "target": desc,
            "at": int(now), "since": int(since), "fires": fires,
            "detail": WD_CATALOG["WD001"],
        }
        from .profiling import profiler, storm_snapshot
        if profiler().enabled:
            incident["kernel_dispatches"] = storm_snapshot()
        self.incidents.append(incident)
        if self.metrics is not None:
            self.metrics.watchdog_trips_total.inc(target=desc)
        log.error("WD001 dispatch-storm watchdog tripped on app '%s': "
                  "target %s fired %d times over t=[%d..%d] with zero "
                  "ingest progress; timer disarmed", self.app_name, desc,
                  fires, since, now)
        try:
            from .resilience import make_entry
            # the owning runtime attaches itself as self.runtime
            rt = getattr(self, "runtime", None)
            rt_store = getattr(rt, "error_store", None)
            if rt_store is not None:
                rt_store.store(make_entry(
                    self.app_name, desc, "watchdog",
                    DispatchStormError(
                        f"WD001: {desc} fired {fires}x at t={now}"),
                    []))
        except Exception:   # noqa: BLE001 — tripping must never raise
            log.exception("watchdog error-store write failed")
        try:
            from .flight import flight
            flight().emit("watchdog_trip", app=self.app_name,
                          detail=incident,
                          runtime=getattr(self, "runtime", None))
        except Exception:   # noqa: BLE001
            log.exception("watchdog flight-bundle emit failed")


# ------------------------------------------------------------------ metrics


class IngestMetrics:
    """Always-on ingest-protection counters (ResilienceMetrics pattern:
    independent of @app:statistics, rendered on GET /metrics)."""

    def __init__(self, app_name: str):
        self.app_name = app_name
        self.ingest_admitted_total = Counter("ingest_admitted_total")
        self.ingest_shed_total = Counter("ingest_shed_total")
        self.ingest_overflow_total = Counter("ingest_overflow_total")
        self.ingest_quarantined_total = Counter("ingest_quarantined_total")
        self.ingest_saturation = Gauge("ingest_saturation")
        self.watchdog_trips_total = Counter("watchdog_trips_total")

    def prometheus_lines(self) -> List[str]:
        from .statistics import _fmt_labels
        out: List[str] = []

        def emit(metric: str, series, fmt=str):
            for lkey, v in series.items():
                lb = _fmt_labels({"app": self.app_name, **dict(lkey)})
                out.append(f"siddhi_{metric}{lb} {fmt(v)}")

        emit("ingest_admitted_total", self.ingest_admitted_total.series())
        emit("ingest_shed_total", self.ingest_shed_total.series())
        emit("ingest_overflow_total", self.ingest_overflow_total.series())
        emit("ingest_quarantined_total",
             self.ingest_quarantined_total.series())
        emit("ingest_saturation", self.ingest_saturation.series(),
             lambda v: f"{v:.9g}")
        emit("watchdog_trips_total", self.watchdog_trips_total.series())
        return out


#: HELP/TYPE headers merged into statistics._TYPES-driven exposition
INGEST_TYPES = [
    ("siddhi_ingest_admitted_total", "counter",
     "Events admitted into an @Async junction buffer"),
    ("siddhi_ingest_shed_total", "counter",
     "Events shed by overload policy (reason: shed_oldest | shed_new | "
     "stored | drain_timeout)"),
    ("siddhi_ingest_overflow_total", "counter",
     "Events rejected after the bounded BLOCK admission timeout"),
    ("siddhi_ingest_quarantined_total", "counter",
     "Events rejected by the @quarantine ingest validator (reason: nan | "
     "type | ts_regress | ts_wrap)"),
    ("siddhi_ingest_saturation", "gauge",
     "@Async buffer depth as a fraction of buffer.size"),
    ("siddhi_watchdog_trips_total", "counter",
     "Dispatch-storm watchdog trips (WD0xx incidents)"),
]
