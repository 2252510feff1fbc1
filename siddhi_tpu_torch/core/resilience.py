"""Resilience subsystem: retry policies, circuit breakers, error stores,
non-blocking sink retry queues, and the periodic checkpoint scheduler.

(reference: Siddhi's `core.util.transport` back-off retries on
ConnectionUnavailableException, `core.util.error.handler.ErrorStore` with
`@OnError(action='STORE')`, and the periodic `PersistenceService` started
from SiddhiAppRuntime.startPeriodicPersistence.)

Design notes, in the order they matter:

  * **Nothing here blocks the junction thread.**  A sink's first publish
    attempt runs inline; every subsequent attempt runs on that sink's
    dedicated retry worker, which backs off via ``RetryPolicy``.  A sink
    that stays down trips its ``CircuitBreaker`` so the junction
    fast-fails (event → error store or counted drop) instead of queueing
    behind a dead endpoint.
  * **Determinism for tests.**  Every time source is injectable: the
    retry policy takes a ``seed`` for jitter, the breaker takes a
    ``clock`` callable, and the retry worker waits on an Event (so
    shutdown interrupts sleeps immediately and tests can use 0-delay
    policies).  ``SinkRetryWorker.join`` gives tests a sleep-free
    rendezvous with "every queued retry has been resolved".
  * **At-least-once, never silent loss.**  Every terminal failure path
    either lands the events in the ``ErrorStore`` (replayable) or
    increments a drop counter that tests and ``/metrics`` can see.
"""
from __future__ import annotations

import logging
import pickle
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from .lockwitness import maybe_wrap
from .statistics import Counter, Gauge
from .threads import engine_thread_name

log = logging.getLogger(__name__)


# ------------------------------------------------------------------ retry


def _opt_float(options: Dict[str, str], key: str, default: float) -> float:
    v = options.get(key)
    return float(v) if v is not None else default


def _opt_int(options: Dict[str, str], key: str, default: int) -> int:
    v = options.get(key)
    return int(v) if v is not None else default


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter, a per-attempt cap
    and an overall time budget.

    ``delay(attempt)`` is pure: attempt ``k`` (0-based, i.e. the k-th
    *retry*) waits ``base * multiplier**k`` seconds, capped at
    ``max_delay_s``, then spread by ``jitter`` (a fraction: 0.2 → final
    delay in [0.9d, 1.1d]) keyed off ``seed`` so runs are repeatable.
    """

    max_attempts: int = 6              # total attempts incl. the first
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.2
    budget_s: Optional[float] = 30.0   # total time across all retries
    seed: int = 0

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay_s * (self.multiplier ** attempt),
                self.max_delay_s)
        if self.jitter > 0 and d > 0:
            # deterministic per-(seed, attempt) spread around d
            r = random.Random((self.seed << 16) ^ attempt).random()
            d *= 1.0 + self.jitter * (r - 0.5)
        return d

    def delays(self) -> List[float]:
        """The full retry ladder (len == max_attempts - 1), budget-capped."""
        out, spent = [], 0.0
        for k in range(max(self.max_attempts - 1, 0)):
            d = self.delay(k)
            if self.budget_s is not None and spent + d > self.budget_s:
                break
            out.append(d)
            spent += d
        return out

    @classmethod
    def from_options(cls, options: Dict[str, str],
                     defaults: "RetryPolicy" = None) -> "RetryPolicy":
        """Build from sink/source annotation options.  Delay knobs are in
        milliseconds (``retry.base.delay.ms='50'``) to match the
        reference transports' ms-denominated options."""
        base = defaults or cls()
        return replace(
            base,
            max_attempts=_opt_int(options, "retry.max.attempts",
                                  base.max_attempts),
            base_delay_s=_opt_float(options, "retry.base.delay.ms",
                                    base.base_delay_s * 1000.0) / 1000.0,
            multiplier=_opt_float(options, "retry.multiplier",
                                  base.multiplier),
            max_delay_s=_opt_float(options, "retry.max.delay.ms",
                                   base.max_delay_s * 1000.0) / 1000.0,
            jitter=_opt_float(options, "retry.jitter", base.jitter),
            budget_s=(_opt_float(options, "retry.budget.ms",
                                 (base.budget_s or 0.0) * 1000.0) / 1000.0
                      if (options.get("retry.budget.ms") is not None
                          or base.budget_s is not None) else None),
            seed=_opt_int(options, "retry.seed", base.seed),
        )


# ------------------------------------------------------------------ breaker

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """CLOSED → (failure_threshold consecutive failures) → OPEN →
    (reset_timeout elapses) → HALF_OPEN probe → success closes /
    failure re-opens.  ``clock`` is injectable for deterministic tests."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str], None] = None):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self.on_transition = on_transition
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._lock = maybe_wrap(
            threading.Lock(), "core.resilience.CircuitBreaker._lock")
        self._pending: list = []     # transitions awaiting callback

    @classmethod
    def from_options(cls, options: Dict[str, str],
                     **kw) -> "CircuitBreaker":
        return cls(
            failure_threshold=_opt_int(options, "circuit.failure.threshold",
                                       5),
            reset_timeout_s=_opt_float(options, "circuit.reset.ms",
                                       5000.0) / 1000.0,
            **kw)

    def _transition(self, new: str):
        """Record a state change; the callback fires AFTER the lock is
        released (_fire_pending) — on_transition hooks may read breaker
        state (the circuit_state gauge does, and the flight-recorder
        incident bundle renders that gauge), which would self-deadlock
        on this non-reentrant lock if called inline."""
        old, self._state = self._state, new
        if old != new and self.on_transition is not None:
            self._pending.append((old, new))

    def _fire_pending(self):
        while True:
            with self._lock:
                if not self._pending:
                    return
                old, new = self._pending.pop(0)
            cb = self.on_transition
            if cb is None:
                continue
            try:
                cb(old, new)
            except Exception:   # noqa: BLE001 — metrics must not break flow
                pass

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            st = self._state
        self._fire_pending()
        return st

    @property
    def state_code(self) -> int:
        """0=closed 1=open 2=half_open (the /metrics encoding)."""
        return _STATE_CODE[self.state]

    def _maybe_half_open(self):
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.reset_timeout_s:
            self._transition(HALF_OPEN)

    def allow(self) -> bool:
        """May a publish attempt proceed right now?"""
        with self._lock:
            self._maybe_half_open()
            ok = self._state != OPEN
        self._fire_pending()
        return ok

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._transition(CLOSED)
        self._fire_pending()

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._transition(OPEN)
        self._fire_pending()


# ------------------------------------------------------------------ metrics


class ResilienceMetrics:
    """Always-on, allocation-light counters for the resilience layer.

    Deliberately independent of ``@app:statistics`` (which gates the
    perf trackers): you want to know about dropped events even when
    latency profiling is off.  Rendered onto ``GET /metrics`` for every
    runtime by service/rest.py.
    """

    def __init__(self, app_name: str):
        self.app_name = app_name
        self.sink_retry_total = Counter("sink_retry_total")
        self.sink_publish_failed_total = Counter("sink_publish_failed_total")
        self.sink_dropped_total = Counter("sink_dropped_total")
        self.circuit_transitions_total = Counter("circuit_transitions_total")
        self.circuit_state = Gauge("circuit_state")
        self.errors_stored_total = Counter("errors_stored_total")
        self.errors_replayed_total = Counter("errors_replayed_total")
        self.errors_purged_total = Counter("errors_purged_total")
        self.onerror_wait_retries_total = Counter(
            "onerror_wait_retries_total")
        self.checkpoints_total = Counter("checkpoints_total")
        self.checkpoint_failures_total = Counter("checkpoint_failures_total")
        self.recovered = Gauge("recovered")   # 1 after recover=True restore

    def prometheus_lines(self) -> List[str]:
        from .statistics import _fmt_labels
        out: List[str] = []

        def emit(metric: str, series, fmt=str):
            for lkey, v in series.items():
                lb = _fmt_labels({"app": self.app_name, **dict(lkey)})
                out.append(f"siddhi_{metric}{lb} {fmt(v)}")

        emit("sink_retry_total", self.sink_retry_total.series())
        emit("sink_publish_failed_total",
             self.sink_publish_failed_total.series())
        emit("sink_dropped_total", self.sink_dropped_total.series())
        emit("circuit_transitions_total",
             self.circuit_transitions_total.series())
        emit("circuit_state", self.circuit_state.series(),
             lambda v: f"{v:.9g}")
        emit("errors_stored_total", self.errors_stored_total.series())
        emit("errors_replayed_total", self.errors_replayed_total.series())
        emit("errors_purged_total", self.errors_purged_total.series())
        emit("onerror_wait_retries_total",
             self.onerror_wait_retries_total.series())
        emit("checkpoints_total", self.checkpoints_total.series())
        emit("checkpoint_failures_total",
             self.checkpoint_failures_total.series())
        emit("recovered", self.recovered.series(), lambda v: f"{v:.9g}")
        return out


#: HELP/TYPE headers merged into statistics._TYPES-driven exposition
RESILIENCE_TYPES = [
    ("siddhi_sink_retry_total", "counter",
     "Sink publish retry attempts (off the junction thread)"),
    ("siddhi_sink_publish_failed_total", "counter",
     "Sink publish attempts that raised ConnectionUnavailableError"),
    ("siddhi_sink_dropped_total", "counter",
     "Events terminally dropped by a sink (no error store configured)"),
    ("siddhi_circuit_transitions_total", "counter",
     "Circuit-breaker state transitions per sink"),
    ("siddhi_circuit_state", "gauge",
     "Per-sink circuit state: 0=closed 1=open 2=half_open"),
    ("siddhi_errors_stored_total", "counter",
     "Events captured by the error store"),
    ("siddhi_errors_replayed_total", "counter",
     "Events replayed out of the error store"),
    ("siddhi_errors_purged_total", "counter",
     "Error-store entries purged"),
    ("siddhi_onerror_wait_retries_total", "counter",
     "@OnError(action='WAIT') bounded-blocking retry attempts"),
    ("siddhi_checkpoints_total", "counter",
     "Periodic checkpoints persisted by @app:persist"),
    ("siddhi_checkpoint_failures_total", "counter",
     "Periodic checkpoints that raised"),
    ("siddhi_recovered", "gauge",
     "1 once a runtime restored state via recover=True"),
]


# ------------------------------------------------------------------ error store


@dataclass
class ErrorEntry:
    """One failed delivery: the events plus enough context to replay them."""

    id: int
    app_name: str
    stream_id: str
    origin: str     # 'sink' | 'stream' | 'ingest' | 'overload' | 'watchdog'
    error: str
    timestamp_ms: int
    events: List[Tuple[int, tuple]]   # (event timestamp, data row)
    attempts: int = 0

    def summary(self) -> Dict[str, Any]:
        return {"id": self.id, "app": self.app_name,
                "stream": self.stream_id, "origin": self.origin,
                "error": self.error, "timestamp": self.timestamp_ms,
                "events": len(self.events), "attempts": self.attempts}


class ErrorStore:
    """Store/list/purge failed events.  Implementations must be
    thread-safe: junction workers and retry workers both store."""

    def store(self, entry: ErrorEntry) -> int:
        raise NotImplementedError

    def list(self, app_name: str = None,
             stream_id: str = None) -> List[ErrorEntry]:
        raise NotImplementedError

    def purge(self, app_name: str = None, ids: List[int] = None) -> int:
        raise NotImplementedError

    def count(self, app_name: str = None) -> int:
        return len(self.list(app_name))


class InMemoryErrorStore(ErrorStore):
    def __init__(self, capacity: int = 10_000):
        self.capacity = capacity
        self._entries: "deque[ErrorEntry]" = deque(maxlen=capacity)
        self._next_id = 1
        self._lock = maybe_wrap(
            threading.Lock(), "core.resilience.InMemoryErrorStore._lock")

    def store(self, entry: ErrorEntry) -> int:
        with self._lock:
            entry.id = self._next_id
            self._next_id += 1
            self._entries.append(entry)
            return entry.id

    def list(self, app_name=None, stream_id=None):
        with self._lock:
            return [e for e in self._entries
                    if (app_name is None or e.app_name == app_name)
                    and (stream_id is None or e.stream_id == stream_id)]

    def purge(self, app_name=None, ids=None):
        with self._lock:
            keep, purged = deque(maxlen=self.capacity), 0
            id_set = set(ids) if ids is not None else None
            for e in self._entries:
                match = (app_name is None or e.app_name == app_name) and \
                        (id_set is None or e.id in id_set)
                if match:
                    purged += 1
                else:
                    keep.append(e)
            self._entries = keep
            return purged


def serialize_events(events) -> List[Tuple[int, tuple]]:
    """Event objects → picklable (timestamp, data-row) pairs."""
    return [(int(e.timestamp), tuple(e.data)) for e in events]


def make_entry(app_name: str, stream_id: str, origin: str, error: Exception,
               events, now_ms: int = None, attempts: int = 0) -> ErrorEntry:
    return ErrorEntry(
        id=0, app_name=app_name, stream_id=stream_id, origin=origin,
        error=f"{type(error).__name__}: {error}",
        timestamp_ms=now_ms if now_ms is not None
        else int(time.time() * 1000),
        events=serialize_events(events), attempts=attempts)


def pickle_events(events: List[Tuple[int, tuple]]) -> bytes:
    return pickle.dumps(events, protocol=pickle.HIGHEST_PROTOCOL)


def unpickle_events(blob: bytes) -> List[Tuple[int, tuple]]:
    return pickle.loads(blob)


# ------------------------------------------------------------------ sink retry


@dataclass
class _RetryTask:
    payload: Any
    event: Any
    events: List[Any]
    attempt: int = 0
    first_failed_at: float = 0.0
    last_error: Optional[Exception] = None


class SinkRetryWorker:
    """Bounded per-sink retry queue + worker thread.

    The junction thread calls ``submit`` (non-blocking); the worker
    owns every delay.  Terminal outcomes go through ``on_exhausted``
    (→ error store / counted drop).  ``join`` blocks until the queue is
    empty *and* no task is in flight — the sleep-free way for tests and
    shutdown to wait for "all retries resolved".
    """

    def __init__(self, name: str,
                 publish_fn: Callable[[Any, Any], None],
                 policy: RetryPolicy,
                 breaker: Optional[CircuitBreaker],
                 on_exhausted: Callable[[_RetryTask], None],
                 on_retry: Callable[[_RetryTask], None] = None,
                 capacity: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.publish_fn = publish_fn
        self.policy = policy
        self.breaker = breaker
        self.on_exhausted = on_exhausted
        self.on_retry = on_retry
        self.capacity = capacity
        self.clock = clock
        self._tasks: "deque[_RetryTask]" = deque()
        self._in_flight = 0
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- junction side ------------------------------------------------

    def submit(self, payload, event, events, error: Exception) -> bool:
        """Queue a failed publish for retry.  Returns False when the
        queue is full (caller routes to the exhausted path instead)."""
        task = _RetryTask(payload=payload, event=event, events=events,
                          attempt=1, first_failed_at=self.clock(),
                          last_error=error)
        with self._cond:
            if self._stop.is_set() or len(self._tasks) >= self.capacity:
                return False
            self._tasks.append(task)
            self._ensure_thread()
            self._cond.notify()
            return True

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run,
                name=engine_thread_name("siddhi-retry-", self.name),
                daemon=True)
            self._thread.start()

    # ---- worker side --------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while not self._tasks and not self._stop.is_set():
                    self._cond.wait(timeout=0.5)
                if self._stop.is_set() and not self._tasks:
                    self._cond.notify_all()
                    return
                task = self._tasks.popleft()
                self._in_flight += 1
            try:
                self._process(task)
            finally:
                with self._cond:
                    self._in_flight -= 1
                    self._cond.notify_all()

    def _process(self, task: _RetryTask):
        while True:
            budget = self.policy.budget_s
            over_budget = (budget is not None and
                           self.clock() - task.first_failed_at > budget)
            if task.attempt >= self.policy.max_attempts or over_budget:
                self._exhaust(task)
                return
            # back off before the next attempt; stop() interrupts.
            # On stop we fall through to one last immediate attempt so
            # shutdown drains the queue instead of losing it.
            self._stop.wait(self.policy.delay(task.attempt - 1))
            if self.breaker is not None and not self.breaker.allow():
                if self._stop.is_set():
                    self._exhaust(task)
                    return
                task.attempt += 1
                continue
            try:
                if self.on_retry is not None:
                    self.on_retry(task)
                self.publish_fn(task.payload, task.event)
                if self.breaker is not None:
                    self.breaker.record_success()
                return
            except Exception as e:     # noqa: BLE001 — any failure retries
                task.last_error = e
                task.attempt += 1
                if self.breaker is not None:
                    self.breaker.record_failure()
                if self._stop.is_set():
                    self._exhaust(task)
                    return

    def _exhaust(self, task: _RetryTask):
        try:
            self.on_exhausted(task)
        except Exception:       # noqa: BLE001 — last-resort path must not die
            log.exception("sink %s: exhausted-handler failed", self.name)

    # ---- lifecycle ----------------------------------------------------

    def pending(self) -> int:
        with self._cond:
            return len(self._tasks) + self._in_flight

    def join(self, timeout: float = 30.0) -> bool:
        """Wait until every queued/in-flight task has been resolved."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._tasks or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def stop(self, drain_timeout: float = 5.0):
        """Interrupt backoff sleeps; give queued tasks one immediate
        final attempt each (failures land in on_exhausted), then stop."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
            t = self._thread
        if t is not None and t.is_alive():
            self.join(timeout=drain_timeout)
            t.join(timeout=1.0)


# ------------------------------------------------------------------ checkpoints


class CheckpointScheduler:
    """Drives ``SnapshotService.persist`` every ``interval_ms`` through the
    app's Scheduler (so `@app:playback` virtual time works and tests can
    advance it deterministically).  Serialization with external
    ``persist()`` callers is inherited from the single
    ``SnapshotService._lock`` — both paths funnel through it."""

    def __init__(self, runtime, interval_ms: int, incremental: bool = False):
        self.runtime = runtime
        self.interval_ms = max(int(interval_ms), 1)
        self.incremental = incremental
        self.metrics: Optional[ResilienceMetrics] = None
        self._stopped = threading.Event()

    def start(self):
        self._stopped.clear()
        self._arm(self.runtime.app_ctx.current_time())

    def _arm(self, now_ms: int):
        if not self._stopped.is_set():
            self.runtime.app_ctx.scheduler.notify_at(
                now_ms + self.interval_ms, self._fire)

    def _fire(self, now_ms: int):
        if self._stopped.is_set():
            return
        try:
            self.runtime.persist(incremental=self.incremental)
            if self.metrics is not None:
                self.metrics.checkpoints_total.inc()
        except Exception:       # noqa: BLE001 — keep checkpointing
            if self.metrics is not None:
                self.metrics.checkpoint_failures_total.inc()
            log.exception("periodic checkpoint failed for app %s",
                          self.runtime.name)
        self._arm(now_ms)

    def stop(self):
        # the armed heap entry stays queued but _fire no-ops once stopped
        self._stopped.set()
