"""Stream junctions, input handlers and callbacks.

(reference: stream/StreamJunction.java — per-stream pub/sub hub with sync mode
and @Async disruptor ring-buffer mode, @OnError fault-stream routing;
stream/input/{InputManager,InputHandler,InputEntryValve,InputDistributor}.java;
stream/output/StreamCallback.java; query/output/callback/QueryCallback.java.)

TPU-native shape: receivers exchange columnar EventChunks, so one `send` can
carry a whole micro-batch.  @Async mode replaces the LMAX disruptor with a
bounded queue + worker thread that re-batches pending events into larger chunks
(the host-side analogue of double-buffered device feeding).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..query_api.annotation import find_annotation
from ..query_api.definition import StreamDefinition
from ..utils.errors import BufferOverflowError, SiddhiAppRuntimeException
from .context import SiddhiAppContext
from .event import CURRENT, EXPIRED, Event, EventChunk, LazyEvents
from .ledger import ledger as _ledger, ledger_enabled
from .hotpath import hot_path
from .lockwitness import maybe_wrap
from .profiling import rim_stats
from .threads import engine_thread_name
from .tracing import tracer as _tracer

log = logging.getLogger(__name__)

FAULT_PREFIX = "!"

_RIM = rim_stats()
_LED = _ledger()


class StreamCallback:
    """User callback attached to a stream (reference
    stream/output/StreamCallback.java).  Subclass and override `receive`.

    This is the legacy per-event compatibility shim: ``receive`` gets a
    list-like ``LazyEvents`` view of the delivered chunk that builds the
    ``Event`` objects on first element access — a callback that only
    counts or ignores its events stays on the zero-materialization fast
    path.  Subscribe a ``ColumnarStreamCallback`` instead to receive the
    columns themselves with no per-event decode at all."""

    def __init__(self, fn: Optional[Callable[[Sequence[Event]], None]] = None):
        self._fn = fn
        self.stream_definition: Optional[StreamDefinition] = None

    def receive(self, events: Sequence[Event]):
        if self._fn is not None:
            self._fn(events)

    # junction-facing
    def receive_chunk(self, chunk: EventChunk):
        ev = LazyEvents(chunk.only(CURRENT, EXPIRED))
        if ev:
            with _LED.span("publish"):
                self.receive(ev)


class ColumnarStreamCallback:
    """Columnar stream callback: receives the delivered ``EventChunk``
    itself (CURRENT/EXPIRED lanes), no per-event materialization — the
    egress counterpart of ``InputHandler.send_batch``.  Subclass and
    override ``receive``, or pass ``fn(chunk)``.  Registers through the
    same ``add_callback`` as the legacy ``StreamCallback``."""

    def __init__(self, fn: Optional[Callable[[EventChunk], None]] = None):
        self._fn = fn
        self.stream_definition: Optional[StreamDefinition] = None

    def receive(self, chunk: EventChunk):
        if self._fn is not None:
            self._fn(chunk)

    # junction-facing
    def receive_chunk(self, chunk: EventChunk):
        c = chunk.only(CURRENT, EXPIRED)
        if not c.is_empty:
            with _LED.span("publish"):
                self.receive(c)


class QueryCallback:
    """Per-query callback with (timestamp, current[], expired[]) signature
    (reference query/output/callback/QueryCallback.java)."""

    def __init__(self, fn: Optional[Callable[[int, Optional[List[Event]],
                                              Optional[List[Event]]], None]] = None):
        self._fn = fn

    def receive(self, timestamp: int, current: Optional[List[Event]],
                expired: Optional[List[Event]]):
        if self._fn is not None:
            self._fn(timestamp, current, expired)

    def receive_chunk(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        cur = LazyEvents(chunk.only(CURRENT))
        exp = LazyEvents(chunk.only(EXPIRED))
        if not cur and not exp:
            return
        ts = int(chunk.timestamps[-1])
        with _LED.span("publish"):
            self.receive(ts, cur or None, exp or None)


class _FlushBarrier:
    """Queue sentinel for StreamJunction.flush: one copy is enqueued per
    worker; workers rendezvous at an internal barrier (so every in-hand
    delivery has finished), then exactly one flushes the receivers and
    signals done.  Exact for any worker count."""

    def __init__(self, n_workers: int):
        self.sync = threading.Barrier(max(n_workers, 1))
        self.done = threading.Event()

    def __len__(self):          # rides the chunk queue
        return 0

    def arrive(self, flush_fn):
        try:
            i = self.sync.wait(timeout=600.0)
        except threading.BrokenBarrierError:
            i = 0               # a peer died (drain race): flush anyway
        if i == 0:
            try:
                flush_fn()
            finally:
                self.done.set()


class StreamJunction:
    """Pub/sub hub for one stream."""

    def __init__(self, definition: StreamDefinition,
                 app_ctx: SiddhiAppContext, fault_junction=None):
        self.definition = definition
        self.app_ctx = app_ctx
        self.receivers: List[Any] = []   # objects with receive_chunk(chunk)
        self.fault_junction: Optional[StreamJunction] = fault_junction
        self.on_error_action = "LOG"
        self.throughput_tracker = None
        # async config (reference @Async(buffer.size, workers, batch.size.max))
        self.is_async = False
        self.buffer_size = 1024
        self.workers = 1
        self.batch_size_max = 256
        # ingest protection (core/overload.py; None when the
        # SIDDHI_TPU_INGEST_GUARD kill switch is off)
        self.overload = None        # OverloadConfig for @Async admission
        self.validator = None       # IngestValidator from @quarantine(...)
        self._queue: Optional[queue.Queue] = None
        self._worker_threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._flush_lock = maybe_wrap(
            threading.Lock(), "core.stream.StreamJunction._flush_lock")
        self._configure_from_annotations()

    @property
    def quiescent(self) -> bool:
        """No queued chunks and no delivery in flight (async mode).
        Queue.unfinished_tasks is atomic under the queue's own lock: a
        put increments it and the worker's task_done() (after delivery
        completes) decrements — no popped-but-undelivered window."""
        q = self._queue
        if not self.is_async or q is None:
            return True
        return q.unfinished_tasks == 0

    def queue_depth(self) -> int:
        """Chunks waiting in the @Async buffer right now — the
        BufferedEventsTracker supplier (core/statistics.py)."""
        q = self._queue
        return q.qsize() if q is not None else 0

    def _configure_from_annotations(self):
        from .overload import (IngestValidator, OverloadConfig,
                               QuarantineConfig, guard_enabled)
        guarded = guard_enabled()
        ann = find_annotation(self.definition.annotations, "async")
        if ann is not None:
            self.is_async = True
            self.buffer_size = int(ann.get("buffer.size", "1024"))
            self.workers = int(ann.get("workers", "1"))
            self.batch_size_max = int(ann.get("batch.size.max", "256"))
            if guarded:
                self.overload = OverloadConfig.from_annotation(
                    ann, self.buffer_size)
        q_ann = find_annotation(self.definition.annotations, "quarantine")
        if q_ann is not None and guarded:
            self.validator = IngestValidator(
                self.definition, QuarantineConfig.from_annotation(q_ann))
        on_err = find_annotation(self.definition.annotations, "onerror")
        if on_err is not None:
            self.on_error_action = (on_err.get("action", "LOG") or "LOG").upper()
            if self.on_error_action == "WAIT":
                from .resilience import RetryPolicy
                self.wait_policy = RetryPolicy.from_options(
                    on_err.as_dict(),
                    RetryPolicy(max_attempts=8, base_delay_s=0.01,
                                max_delay_s=0.5, budget_s=10.0))

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self.is_async and self._queue is None:
            self._queue = queue.Queue(maxsize=self.buffer_size)
            self._stop.clear()
            self._drain.clear()
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name=engine_thread_name(
                        "siddhi-junction-", self.definition.id, i))
                t.start()
                self._worker_threads.append(t)

    def stop(self):
        """Drain-then-stop: every queued chunk is delivered before workers
        exit (the reference's shutdown drains the disruptor ring; setting
        the stop flag first would drop whatever is still queued).
        Sentinel-free: workers keep consuming until the queue is empty AND
        the drain flag is up, so no worker can starve another.

        The drain is bounded by a TOTAL deadline (@Async(drain.timeout.ms),
        default 600s — generous because a queued first delivery can hide a
        remote AOT compile).  A receiver wedged past the deadline gets a
        forced stop: the stop flag goes up, leftover queued chunks are
        discarded (counted as shed reason='drain_timeout') and barriers
        released, so shutdown cannot loop indefinitely on a dead consumer."""
        if self._queue is not None:
            q = self._queue
            self._drain.set()
            total_s = (self.overload.drain_timeout_s
                       if self.overload is not None else 600.0)
            deadline = time.monotonic() + total_s
            for t in self._worker_threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            wedged = [t for t in self._worker_threads if t.is_alive()]
            if wedged:
                self._stop.set()
                dropped = self._discard_queued(q, reason="drain_timeout")
                log.error(
                    "@Async drain on '%s' timed out after %.1fs with %d "
                    "wedged worker(s); force-stopped, dropping %d queued "
                    "event(s) (%s)", self.definition.id, total_s,
                    len(wedged), dropped, BufferOverflowError.__name__)
                for t in wedged:
                    t.join(timeout=0.5)
            self._worker_threads.clear()
            self._queue = None
        self._stop.set()

    def _discard_queued(self, q: queue.Queue, reason: str) -> int:
        """Empty `q`, releasing any flush barriers and counting dropped
        events as shed; returns the dropped-event count."""
        dropped = 0
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _FlushBarrier):
                item.done.set()
            else:
                dropped += len(item)
            q.task_done()
        if dropped:
            m = self._ingest_metrics()
            if m is not None:
                m.ingest_shed_total.inc(dropped, stream=self.definition.id,
                                        reason=reason)
        return dropped

    def _worker_loop(self):
        """Re-batches queued chunks up to batch_size_max before delivery
        (reference util/event/handler/StreamHandler.java re-batching).
        When the queue goes idle (or on drain), flushes receivers that
        pipeline device work (plan/planner.py DevicePatternRuntime) so
        deferred matches never hang waiting for the next event."""
        q = self._queue     # local ref: stop() clears the attribute on a
        delivered = False   # forced drain-timeout stop while we may still
        while not self._stop.is_set():  # be wedged inside a receiver
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                if delivered:
                    self._flush_receivers()
                    delivered = False
                if self._drain.is_set():
                    break       # drained: queue empty after drain request
                continue
            if isinstance(item, _FlushBarrier):
                delivered = False
                try:
                    item.arrive(self._flush_receivers)
                finally:
                    q.task_done()
                continue
            batch = [item]
            n = len(item)
            barrier = None
            while n < self.batch_size_max:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(nxt, _FlushBarrier):
                    barrier = nxt
                    break
                batch.append(nxt)
                n += len(nxt)
            merged = EventChunk.concat(batch) if len(batch) > 1 else batch[0]
            if ledger_enabled():
                # queue stage: enqueue stamp -> this dequeue, per popped
                # chunk; the merged chunk restarts its timeline here so
                # _deliver's dispatch gap starts at the dequeue boundary
                now_ns = time.perf_counter_ns()
                for c in batch:
                    if c.ledger_ns is not None:
                        _LED.record("queue", now_ns - c.ledger_ns)
                merged.ledger_ns = now_ns
            try:
                self._deliver(merged)
                delivered = True
                if barrier is not None:
                    delivered = False
                    barrier.arrive(self._flush_receivers)
            finally:
                # one task_done per popped item: the batch's extra pops
                # and a trailing barrier pop all complete here
                for _ in range(len(batch) + (1 if barrier is not None
                                             else 0)):
                    q.task_done()
        if delivered:
            self._flush_receivers()

    def _flush_receivers(self):
        for r in list(self.receivers):
            f = getattr(r, "flush", None)
            if f is not None:
                try:
                    f()
                except Exception as e:  # noqa: BLE001 — @OnError boundary
                    self._handle_error(
                        EventChunk.empty(self.definition.attribute_names), e)

    def flush(self):
        """Synchronous flush: when this returns, every chunk already sent
        has been delivered and any pipelined device work retired (matches
        handed to callbacks).  Async mode rides one barrier copy per
        worker through the queue (exact for any worker count — workers
        rendezvous before one flushes); falls back to a direct receiver
        flush when the workers are gone (racing stop()/shutdown).  The
        wait is generous because a first delivery can hide a remote AOT
        compile."""
        q = self._queue
        workers = list(self._worker_threads)
        if threading.current_thread() in workers:
            # a worker calling flush() from inside its own delivery (e.g.
            # persist() from a callback) would wait forever for its own
            # barrier copy — its in-hand delivery IS finished from the
            # caller's perspective, so flush receivers directly
            self._flush_receivers()
            return
        if self.is_async and q is not None and workers and \
                not self._drain.is_set():
            # serialize concurrent flushes: two barriers' copies
            # interleaved across workers would stall both rendezvous
            with self._flush_lock:
                b = _FlushBarrier(len(workers))
                for _ in workers:
                    q.put(b)
                while not b.done.wait(timeout=1.0):
                    if not any(t.is_alive() for t in workers):
                        self._flush_receivers()   # stop() won the race
                        return
        else:
            self._flush_receivers()

    # ------------------------------------------------------------ sending

    def subscribe(self, receiver):
        if receiver not in self.receivers:
            self.receivers.append(receiver)

    def unsubscribe(self, receiver):
        if receiver in self.receivers:
            self.receivers.remove(receiver)

    def send(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        if self.throughput_tracker is not None:
            self.throughput_tracker.event_in(len(chunk))
        wd = getattr(self.app_ctx, "watchdog", None)
        if wd is not None:
            # any event movement counts as ingest progress: a dispatch
            # storm is, by definition, dispatching with none
            wd.note_progress(len(chunk))
        if chunk.ledger_ns is None and ledger_enabled():
            # internal producers (query output fan-in, fault routes)
            # start their timeline here: queue-wait / dispatch-gap
            # attribution needs a boundary stamp on every chunk
            chunk.ledger_ns = time.perf_counter_ns()
        if self.is_async and self._queue is not None:
            if self.overload is not None:
                self._admit(chunk)
            else:
                # kill switch off: legacy unbounded blocking put
                self._queue.put(chunk)
        else:
            self._deliver(chunk)

    # ------------------------------------------------------ admission control

    def saturation(self) -> float:
        """@Async buffer depth as a fraction of buffer.size (0.0 sync)."""
        q = self._queue
        if not self.is_async or q is None or self.buffer_size <= 0:
            return 0.0
        return q.qsize() / self.buffer_size

    def saturated(self) -> bool:
        """Above the high watermark right now (GET /health 'degraded')."""
        ov = self.overload
        if ov is None or self._queue is None:
            return False
        return self._queue.qsize() >= ov.high_chunks

    def _admit(self, chunk: EventChunk):
        """Policy-driven admission (@Async(overload=...)).  Every path is
        bounded: the engine can shed, store, or raise — never wedge."""
        q = self._queue
        ov = self.overload
        m = self._ingest_metrics()
        sid = self.definition.id
        n = len(chunk)
        if ov.policy == "SHED_OLDEST":
            self._shed_to_low(q, m)
        elif ov.policy == "SHED_NEW":
            if q.qsize() >= ov.high_chunks:
                if m is not None:
                    m.ingest_shed_total.inc(n, stream=sid, reason="shed_new")
                return
        elif ov.policy == "STORE":
            if q.qsize() >= ov.high_chunks:
                store = self._error_store()
                if store is not None:
                    from .resilience import make_entry
                    rt = getattr(self.app_ctx, "runtime", None)
                    store.store(make_entry(
                        rt.name if rt is not None else "", sid, "overload",
                        BufferOverflowError(
                            f"@Async buffer on '{sid}' above high watermark "
                            f"({q.qsize()}/{self.buffer_size} chunks)"),
                        chunk.to_events()))
                    if m is not None:
                        m.ingest_shed_total.inc(n, stream=sid,
                                                reason="stored")
                    return
                # no store configured: degrade to bounded BLOCK below
                # (the analyzer flags this config as SA062)
        try:
            q.put(chunk, timeout=ov.block_timeout_s)
        except queue.Full:
            if m is not None:
                m.ingest_overflow_total.inc(n, stream=sid)
            self._handle_error(chunk, BufferOverflowError(
                f"@Async buffer on '{sid}' still full after "
                f"{ov.block_timeout_s:.3f}s ({self.buffer_size} chunks, "
                f"policy {ov.policy})"))
        else:
            if m is not None:
                m.ingest_admitted_total.inc(n, stream=sid)

    def _shed_to_low(self, q: queue.Queue, m):
        """SHED_OLDEST: at/above the high watermark, evict queued chunks
        down to the low watermark (hysteresis).  Flush barriers ride
        through: they are re-enqueued behind the survivors, never shed."""
        ov = self.overload
        if q.qsize() < ov.high_chunks:
            return
        shed = 0
        while q.qsize() > ov.low_chunks:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _FlushBarrier):
                # guaranteed room: we just popped an entry and only
                # producers racing us could have refilled it — the put
                # below can block at most momentarily
                q.put(item)
                q.task_done()
                continue
            shed += len(item)
            q.task_done()
        if shed and m is not None:
            m.ingest_shed_total.inc(shed, stream=self.definition.id,
                                    reason="shed_oldest")

    def _ingest_metrics(self):
        rt = getattr(self.app_ctx, "runtime", None)
        return getattr(rt, "ingest_metrics", None)

    @hot_path("per-block fan-out to every subscriber")
    def _deliver(self, chunk: EventChunk):
        tr = _tracer()
        led = _LED if ledger_enabled() else None
        if led is not None and chunk.ledger_ns is not None:
            # dispatch gap: boundary stamp (dequeue / junction entry) ->
            # delivery start; consumed so a re-routed chunk (fault
            # junction) does not double count
            led.record("dispatch", time.perf_counter_ns() - chunk.ledger_ns)
            chunk.ledger_ns = None
        for r in list(self.receivers):
            try:
                if tr.enabled:
                    with tr.span("callback" if isinstance(
                            r, (StreamCallback, QueryCallback))
                            else "deliver",
                            stream=self.definition.id, n=len(chunk),
                            receiver=type(r).__name__):
                        self._recv_one(r, chunk, led)
                else:
                    self._recv_one(r, chunk, led)
            except Exception as e:  # noqa: BLE001 — @OnError boundary
                self._handle_error(chunk, e, receiver=r)

    @staticmethod
    def _recv_one(r, chunk: EventChunk, led):
        if led is None:
            r.receive_chunk(chunk)
            return
        # dispatch stage (exclusive): junction fan-out + host-side query
        # processing; the device/decode/publish work nested inside the
        # receiver carries its own spans and is subtracted automatically
        with led.span("dispatch"):
            r.receive_chunk(chunk)

    def _handle_error(self, chunk: EventChunk, e: Exception, receiver=None):
        from .flight import flight
        rt = getattr(self.app_ctx, "runtime", None)
        app_name = rt.name if rt is not None else ""
        flight().note_error(app_name, self.definition.id, e)
        if isinstance(e, BufferOverflowError):
            # incident bus: an admission overflow means load shedding is
            # losing events — dump a bundle while the ring still shows
            # the blocks leading up to it
            flight().emit("buffer_overflow", app=app_name,
                          detail={"stream": self.definition.id,
                                  "error": str(e)}, runtime=rt)
        action = self.on_error_action
        if action == "WAIT" and receiver is not None:
            # bounded blocking until downstream recovers: retry THIS
            # receiver with backoff; on budget/attempt exhaustion fall
            # through to STORE (when configured) else LOG
            if self._wait_retry(chunk, e, receiver):
                return
            action = "STORE"
        if action == "STREAM" and self.fault_junction is not None:
            # route into !stream with an extra _error attribute
            fault_def = self.fault_junction.definition
            cols = dict(chunk.columns)
            cols["_error"] = np.asarray([repr(e)] * len(chunk), object)
            fchunk = EventChunk(fault_def.attribute_names, chunk.timestamps,
                                chunk.types, cols)
            self.fault_junction.send(fchunk)
            return
        if action == "STORE" and self._error_store() is not None:
            from .resilience import make_entry
            rt = getattr(self.app_ctx, "runtime", None)
            app_name = rt.name if rt is not None else ""
            self._error_store().store(make_entry(
                app_name, self.definition.id, "stream", e,
                chunk.to_events()))
            m = self._metrics()
            if m is not None:
                m.errors_stored_total.inc(len(chunk),
                                          stream=self.definition.id,
                                          origin="stream")
            return
        log.error("Error processing stream '%s': %s\n%s",
                  self.definition.id, e, traceback.format_exc())
        if not isinstance(e, BufferOverflowError):
            # uncaught junction exception (no @OnError route absorbed it)
            flight().emit("junction_exception", app=app_name,
                          detail={"stream": self.definition.id,
                                  "error": f"{type(e).__name__}: {e}"},
                          runtime=rt)
        for listener in self.app_ctx.exception_listeners:
            listener(e)

    def _error_store(self):
        rt = getattr(self.app_ctx, "runtime", None)
        return getattr(rt, "error_store", None)

    def _metrics(self):
        rt = getattr(self.app_ctx, "runtime", None)
        return getattr(rt, "resilience_metrics", None)

    def _wait_retry(self, chunk: EventChunk, first_err: Exception,
                    receiver) -> bool:
        """@OnError(action='WAIT'): block (bounded) re-offering the chunk
        to the failed receiver until it recovers.  Returns True when the
        delivery eventually succeeded."""
        policy = getattr(self, "wait_policy", None)
        if policy is None:
            from .resilience import RetryPolicy
            policy = self.wait_policy = RetryPolicy(
                max_attempts=8, base_delay_s=0.01, max_delay_s=0.5,
                budget_s=10.0)
        m = self._metrics()
        for delay in policy.delays():
            if self._stop.wait(delay):
                return False
            if m is not None:
                m.onerror_wait_retries_total.inc(stream=self.definition.id)
            try:
                receiver.receive_chunk(chunk)
                return True
            except Exception as e:  # noqa: BLE001 — keep waiting
                first_err = e
        log.error("@OnError(WAIT) on '%s' gave up after %d attempts: %s",
                  self.definition.id, policy.max_attempts, first_err)
        return False


class InputHandler:
    """User-facing ingestion for one stream (reference
    stream/input/InputHandler.java:51-85: send(Object[]), send(Event),
    send(Event[]) — here additionally columnar `send_batch`).

    ``send_batch`` is the native path: columns flow junction-ward with no
    row detour.  ``send`` is a thin row-normalizing shim that coerces its
    rows into the same chunk shape and joins the shared chunk core
    (``_send_chunk``) — validation, clock observation, delivery and
    playback advance are one code path for both."""

    def __init__(self, junction: StreamJunction, app_ctx: SiddhiAppContext):
        self.junction = junction
        self.app_ctx = app_ctx
        self.definition = junction.definition
        # fair-share quota (@app:quota, core/overload.py) cached at
        # construction: the registry registers during annotation parsing
        # — before any handler exists — so the hot path below never
        # takes the process-global FairShare lock
        rt = getattr(app_ctx, "runtime", None)
        self.quota = getattr(rt, "quota", None)
        if self.quota is not None:
            from .overload import fair_share
            self._fair = fair_share()

    def send(self, data, timestamp: Optional[int] = None):
        """send(Object[]) / send(Event) / send([Event,...]) /
        send([Object[],...]) — per-event compatibility shim over the
        columnar core."""
        self.app_ctx.thread_barrier.pass_through()
        t0 = time.perf_counter_ns()
        rows: List[Sequence[Any]]
        stamps: List[int]
        if isinstance(data, Event):
            rows, stamps = [data.data], [data.timestamp]
        elif isinstance(data, (list, tuple)) and data and \
                isinstance(data[0], Event):
            rows = [e.data for e in data]
            stamps = [e.timestamp for e in data]
        else:
            now = timestamp if timestamp is not None \
                else self.app_ctx.current_time()
            rows, stamps = [list(data)], [now]
        if timestamp is not None:
            stamps = [timestamp] * len(rows)
        width = len(self.definition.attributes)
        for r in rows:
            if len(r) != width:
                raise SiddhiAppRuntimeException(
                    f"Stream '{self.definition.id}' expects {width} "
                    f"attributes {self.definition.attribute_names}, got "
                    f"{len(r)}: {list(r)!r}")
        v = self.junction.validator
        if v is None:
            chunk = EventChunk.from_rows(self.definition, rows, stamps)
        else:
            # quarantine path: coerce (with per-row salvage), split off
            # poison, and only let ADMITTED timestamps advance the clock
            # — a wrap-poison stamp must not drag virtual time with it
            from .overload import route_rejects
            rejects = []
            try:
                chunk = EventChunk.from_rows(self.definition, rows, stamps)
            except (TypeError, ValueError):
                rows, stamps, bad = v.salvage_rows(rows, stamps)
                rejects.append((v.REASON_TYPE, bad))
                chunk = EventChunk.from_rows(self.definition, rows, stamps)
            chunk, chunk_rejects = v.filter_chunk(chunk)
            rejects.extend((reason, c.to_events())
                           for reason, c in chunk_rejects)
            if rejects:
                route_rejects(self.junction, rejects)
        self._send_chunk(chunk, t0)

    def send_batch(self, columns, timestamps=None):
        """Columnar native path: dict name→array (+ optional int64
        timestamps)."""
        self.app_ctx.thread_barrier.pass_through()
        t0 = time.perf_counter_ns()
        names = self.definition.attribute_names
        n = len(next(iter(columns.values())))
        if timestamps is None:
            timestamps = np.full(n, self.app_ctx.current_time(), np.int64)
        ts_arr = np.asarray(timestamps, np.int64)
        chunk = EventChunk.from_columns(names, ts_arr, dict(columns))
        v = self.junction.validator
        if v is not None:
            from .overload import route_rejects
            chunk, chunk_rejects = v.filter_chunk(chunk)
            if chunk_rejects:
                route_rejects(self.junction,
                              [(reason, c.to_events())
                               for reason, c in chunk_rejects])
        self._send_chunk(chunk, t0)

    def _quota_shed(self, shed: int) -> None:
        """Per-tenant shed accounting + ONE flight bundle per breach
        episode (the latch resets when a send fully admits again)."""
        qt = self.quota
        rt = getattr(self.app_ctx, "runtime", None)
        m = getattr(rt, "ingest_metrics", None)
        if m is not None:
            m.ingest_shed_total.inc(shed, stream=self.definition.id,
                                    reason="quota")
        if not qt.breach:
            qt.breach = True
            try:
                from .flight import flight
                flight().emit(
                    "quota_breach", app=qt.app_name,
                    detail={"stream": self.definition.id, "shed": shed,
                            "rate": qt.rate, "burst": qt.burst},
                    runtime=rt)
            except Exception:   # noqa: BLE001 — shedding must never raise
                log.exception("quota-breach flight emit failed")

    @hot_path("per-block ingest core: clock observe + deliver")
    def _send_chunk(self, chunk: EventChunk, t0: int) -> None:
        """Shared chunk core: observe the clock, deliver, advance
        playback.  ``t0`` is the caller's entry stamp — everything up to
        delivery is host-rim time (RimStats)."""
        n = len(chunk)
        if n == 0:
            _RIM.rim_ns += time.perf_counter_ns() - t0
            return
        qt = self.quota
        if qt is not None:
            # fair-share admission (@app:quota): shed the tail of the
            # chunk that exceeds this tenant's token budget — UNDER the
            # per-stream @Async overload policies, which still apply to
            # whatever is admitted here
            take = qt.admit(n)
            self._fair.note(qt.app_name, take, n - take)
            if take < n:
                self._quota_shed(n - take)
                if take == 0:
                    _RIM.rim_ns += time.perf_counter_ns() - t0
                    return
                chunk = chunk.mask(np.arange(n) < take)
                n = take
            elif qt.breach:
                qt.breach = False     # budget recovered: episode closed
        mx = int(chunk.timestamps.max())
        self.app_ctx.timestamp_generator.observe_event_time(mx)
        now = time.perf_counter_ns()
        _RIM.rim_ns += now - t0
        if ledger_enabled():
            # ingress stage (validate/encode up to delivery) + the
            # event-time lag watermark: max admitted timestamp vs the
            # playback clock when replaying history, else the wall clock
            clock_ms = (self.app_ctx.current_time()
                        if self.app_ctx.timestamp_generator.in_playback
                        else time.time() * 1000.0)
            _LED.note_ingress(self.app_ctx.name, self.definition.id,
                              mx, clock_ms, now - t0)
            chunk.ledger_ns = now
        with _tracer().span("ingest.chunk", stream=self.definition.id, n=n):
            self.junction.send(chunk)
        if self.app_ctx.timestamp_generator.in_playback:
            self.app_ctx.scheduler.advance_to(mx)
