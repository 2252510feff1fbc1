"""Sources, sinks, mappers and the in-memory transport.

(reference: stream/input/source/{Source,SourceMapper}.java lifecycle with
backoff retry, stream/output/sink/{Sink,SinkMapper}.java, InMemory transport
util/transport/InMemoryBroker.java, sink option {{templates}} via
TemplateBuilder/OptionHolder, distributed sinks
stream/output/sink/distributed/*.)

Wired from `@source(type='inMemory', topic='t', @map(type='passThrough'))` /
`@sink(...)` annotations on stream definitions.
"""
from __future__ import annotations

import json
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..query_api.annotation import Annotation, find_all, find_annotation
from ..utils.errors import (ConnectionUnavailableError, MappingFailedError,
                            SiddhiAppCreationError)
from .event import CURRENT, Event, EventChunk, LazyEvents, dtype_for
from .hotpath import hot_path
from .ledger import ledger as _ledger
from .resilience import (CircuitBreaker, RetryPolicy, SinkRetryWorker,
                         make_entry)

log = logging.getLogger(__name__)


# ===================================================================== broker

class InMemoryBroker:
    """Global topic bus (reference util/transport/InMemoryBroker.java)."""

    _subscribers: Dict[str, List[Any]] = {}
    _lock = threading.Lock()

    @classmethod
    def subscribe(cls, subscriber):
        """subscriber: object with .topic and .on_message(obj)."""
        with cls._lock:
            cls._subscribers.setdefault(subscriber.topic, []).append(subscriber)

    @classmethod
    def unsubscribe(cls, subscriber):
        with cls._lock:
            subs = cls._subscribers.get(subscriber.topic, [])
            if subscriber in subs:
                subs.remove(subscriber)

    @classmethod
    def publish(cls, topic: str, obj):
        for s in list(cls._subscribers.get(topic, [])):
            s.on_message(obj)


# ===================================================================== mappers

def _vals_to_column(attr_type, vals) -> np.ndarray:
    """Python value list → one attribute column, same dtype/None policy as
    ``EventChunk.from_rows`` (object lane for string/object, None → 0)."""
    dt = dtype_for(attr_type)
    if dt is object:
        arr = np.empty(len(vals), object)
        for i, v in enumerate(vals):
            arr[i] = v
        return arr
    try:
        return np.asarray(vals, dtype=dt)
    except (TypeError, ValueError):
        return np.asarray([0 if v is None else v for v in vals], dtype=dt)


class SourceMapper:
    """format → Event[] (reference stream/input/source/SourceMapper.java)."""

    def __init__(self, definition, options: Dict[str, str]):
        self.definition = definition
        self.options = options

    def map(self, obj) -> List[Event]:
        raise NotImplementedError

    def map_batch(self, obj):
        """Columnar counterpart of ``map``: payload → (timestamps,
        name→column dict) for ``InputHandler.send_batch`` — no per-event
        Event objects.  ``None`` means this mapper (or this payload shape)
        has no columnar path and the caller falls back to ``map``."""
        return None


class PassThroughSourceMapper(SourceMapper):
    def map(self, obj) -> List[Event]:
        if isinstance(obj, EventChunk):
            # chunk published by a columnar sink looping back in-memory
            return obj.only(CURRENT).to_events()
        if isinstance(obj, Event):
            return [obj]
        if isinstance(obj, (list, tuple)):
            if obj and isinstance(obj[0], Event):
                return list(obj)
            now = int(time.time() * 1000)
            if obj and isinstance(obj[0], (list, tuple)):
                return [Event(now, list(r)) for r in obj]   # batch of rows
            return [Event(now, list(obj))]
        raise MappingFailedError(f"passThrough cannot map {type(obj)}")

    def map_batch(self, obj):
        if not self.definition.attributes:
            return None
        if isinstance(obj, EventChunk):
            # zero-copy re-ingest of a columnar sink's chunk payload
            cur = obj.only(CURRENT)
            return cur.timestamps, cur.columns
        if isinstance(obj, (list, tuple)) and obj \
                and isinstance(obj[0], (list, tuple)):
            now = int(time.time() * 1000)
            cols = {a.name: _vals_to_column(a.type, [r[j] for r in obj])
                    for j, a in enumerate(self.definition.attributes)}
            return np.full(len(obj), now, np.int64), cols
        return None   # single event / row: per-event shim is fine


class JsonSourceMapper(SourceMapper):
    """{"event": {attr: value, ...}} or a list of such (reference
    siddhi-map-json extension behaviour)."""

    def map(self, obj) -> List[Event]:
        data = json.loads(obj) if isinstance(obj, (str, bytes)) else obj
        if isinstance(data, dict):
            data = [data]
        out = []
        for item in data:
            payload = item.get("event", item)
            row = [payload.get(a.name) for a in self.definition.attributes]
            out.append(Event(int(item.get("timestamp",
                                          time.time() * 1000)), row))
        return out

    def map_batch(self, obj):
        """Vectorized decode: one json.loads for the whole payload, then
        column-at-a-time extraction straight into numpy lanes."""
        if not self.definition.attributes:
            return None
        data = json.loads(obj) if isinstance(obj, (str, bytes)) else obj
        if isinstance(data, dict):
            data = [data]
        if not (isinstance(data, list) and data
                and all(isinstance(it, dict) for it in data)):
            return None
        now = int(time.time() * 1000)
        payloads = [it.get("event", it) for it in data]
        ts = np.asarray([int(it.get("timestamp", now)) for it in data],
                        np.int64)
        cols = {a.name: _vals_to_column(a.type,
                                        [p.get(a.name) for p in payloads])
                for a in self.definition.attributes}
        return ts, cols


class SinkMapper:
    def __init__(self, definition, options: Dict[str, str]):
        self.definition = definition
        self.options = options

    def map(self, events: List[Event]):
        raise NotImplementedError

    def map_chunk(self, chunk: EventChunk):
        """Chunk-level counterpart of ``map``: serialize a columnar batch
        without materializing Event objects.  ``None`` means no chunk path
        — the sink falls back to ``to_events()`` + ``map``."""
        return None


class PassThroughSinkMapper(SinkMapper):
    def map(self, events: List[Event]):
        return events

    def map_chunk(self, chunk: EventChunk):
        return chunk      # zero-copy: the chunk itself is the payload


class JsonSinkMapper(SinkMapper):
    def map(self, events: List[Event]):
        names = [a.name for a in self.definition.attributes]
        return json.dumps([{"event": dict(zip(names, e.data)),
                            "timestamp": e.timestamp} for e in events])

    def map_chunk(self, chunk: EventChunk):
        names = [a.name for a in self.definition.attributes]
        ts = chunk.timestamps.tolist()
        cols = [chunk.columns[n].tolist() for n in names]
        return json.dumps([{"event": dict(zip(names, row)), "timestamp": t}
                           for t, row in zip(ts, zip(*cols))])


class TextSinkMapper(SinkMapper):
    def map(self, events: List[Event]):
        names = [a.name for a in self.definition.attributes]
        return "\n".join(
            ", ".join(f"{n}:{v}" for n, v in zip(names, e.data))
            for e in events)

    def map_chunk(self, chunk: EventChunk):
        names = [a.name for a in self.definition.attributes]
        cols = [chunk.columns[n].tolist() for n in names]
        return "\n".join(
            ", ".join(f"{n}:{v}" for n, v in zip(names, row))
            for row in zip(*cols))


SOURCE_MAPPERS = {"passthrough": PassThroughSourceMapper,
                  "json": JsonSourceMapper}
SINK_MAPPERS = {"passthrough": PassThroughSinkMapper,
                "json": JsonSinkMapper, "text": TextSinkMapper}


# ===================================================================== source

class SourceHandler:
    """HA hook between a source and its input handler: an outer platform
    subclasses this to gate events on passive nodes (reference
    stream/input/source/SourceHandler.java + SourceHandlerManager — the
    active/passive coordination SPI)."""

    def handle(self, events):
        """Return the events to forward (possibly filtered), or None to
        drop (passive node)."""
        return events


class SinkHandler:
    """HA hook before a sink publishes (reference
    stream/output/sink/SinkHandler.java)."""

    def handle(self, payload, event):
        """Return the payload to publish, or None to suppress."""
        return payload


class SourceHandlerManager:
    def generate_source_handler(self, source) -> SourceHandler:
        return SourceHandler()


class SinkHandlerManager:
    def generate_sink_handler(self, sink) -> SinkHandler:
        return SinkHandler()


class Source:
    """Base source with connect-retry lifecycle
    (reference Source.connectWithRetry:128-157 + BackoffRetryCounter).

    The old fixed ``RETRIES`` ladder is replaced by a per-source
    ``RetryPolicy`` (exponential backoff + jitter) configurable through
    ``retry.*`` annotation options."""

    def __init__(self, stream_def, options: Dict[str, str],
                 mapper: SourceMapper, input_handler):
        self.stream_def = stream_def
        self.options = options
        self.mapper = mapper
        self.input_handler = input_handler
        self.connected = False
        self.retry_policy = RetryPolicy.from_options(options)
        self._stop_retry = threading.Event()

    def connect(self):
        raise NotImplementedError

    def disconnect(self):
        pass

    def connect_with_retry(self):
        delays = [0.0] + self.retry_policy.delays()
        for i, delay in enumerate(delays):
            if delay:
                if self._stop_retry.wait(delay):
                    return
            try:
                self.connect()
                self.connected = True
                return
            except ConnectionUnavailableError as e:
                log.warning("source connect failed (attempt %d): %s", i + 1, e)
        log.error("source for %s could not connect", self.stream_def.id)

    def shutdown(self):
        self._stop_retry.set()
        try:
            self.disconnect()
        finally:
            self.connected = False

    def deliver(self, obj):
        handler = getattr(self, "handler", None)
        if handler is None:
            # columnar fast path: mapper decodes straight to columns and
            # the batch enters the junction without Event materialization.
            # An attached HA handler speaks Event[] — it keeps the shim.
            try:
                batch = self.mapper.map_batch(obj)
            except MappingFailedError as e:
                log.error("mapping failed on %s: %s", self.stream_def.id, e)
                return
            if batch is not None:
                ts, cols = batch
                if len(ts):
                    self.input_handler.send_batch(cols, timestamps=ts)
                return
        try:
            events = self.mapper.map(obj)
        except MappingFailedError as e:
            log.error("mapping failed on %s: %s", self.stream_def.id, e)
            return
        if handler is not None and events:
            events = handler.handle(events)
        if events:
            self.input_handler.send(events)


class InMemorySource(Source):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.topic = self.options.get("topic", self.stream_def.id)

    def connect(self):
        InMemoryBroker.subscribe(self)

    def disconnect(self):
        InMemoryBroker.unsubscribe(self)

    def on_message(self, obj):
        self.deliver(obj)


# ===================================================================== sink

_TEMPLATE_RE = re.compile(r"\{\{(\w+)\}\}")


class Sink:
    """Base sink; junction subscriber publishing mapped events
    (reference Sink.java:49-167).

    Publish resilience: the first attempt runs inline on the junction
    thread; a ``ConnectionUnavailableError`` hands the payload to this
    sink's bounded retry worker (exponential backoff, off-thread) and a
    ``CircuitBreaker`` turns a persistently dead endpoint into fast-fail
    (events → error store when one is configured, else a counted drop).
    Knobs ride the ``@sink`` annotation: ``retry.max.attempts``,
    ``retry.base.delay.ms``, ``retry.max.delay.ms``, ``retry.multiplier``,
    ``retry.budget.ms``, ``retry.queue.size``,
    ``circuit.failure.threshold``, ``circuit.reset.ms``."""

    def __init__(self, stream_def, options: Dict[str, str], mapper: SinkMapper):
        self.stream_def = stream_def
        self.options = options
        self.mapper = mapper
        self.connected = False
        self.retry_policy = RetryPolicy.from_options(options)
        self.breaker = CircuitBreaker.from_options(options)
        self._retry_capacity = int(options.get("retry.queue.size", "1024"))
        self._retry_worker_inst = None
        self._retry_lock = threading.Lock()
        self._stop_retry = threading.Event()
        self._runtime = None      # set by attach_sources_and_sinks

    # ---- runtime binding (error store + metrics) ----------------------

    def bind_runtime(self, app_runtime):
        self._runtime = app_runtime
        m = self.resilience
        if m is not None:
            sid = self.stream_def.id
            m.circuit_state.set_fn(
                lambda b=self.breaker: b.state_code, sink=sid)

            def _on_transition(old, new, m=m, sid=sid, rt=app_runtime):
                m.circuit_transitions_total.inc(sink=sid, to=new)
                if new == "open":
                    # incident bus: a sink fast-failing is exactly the
                    # moment the operator wants the recent flight ring
                    from .flight import flight
                    flight().emit("circuit_open",
                                  app=getattr(rt, "name", ""),
                                  detail={"sink": sid, "from": old},
                                  runtime=rt)
            self.breaker.on_transition = _on_transition

    @property
    def app_name(self) -> str:
        return self._runtime.name if self._runtime is not None else ""

    @property
    def error_store(self):
        return getattr(self._runtime, "error_store", None)

    @property
    def resilience(self):
        return getattr(self._runtime, "resilience_metrics", None)

    # dynamic option templating: topic='{{symbol}}' resolved per event
    def resolve_option(self, key: str, event: Event) -> Optional[str]:
        raw = self.options.get(key)
        if raw is None:
            return None
        names = [a.name for a in self.stream_def.attributes]

        def sub(m):
            try:
                return str(event.data[names.index(m.group(1))])
            except ValueError:
                return m.group(0)
        return _TEMPLATE_RE.sub(sub, raw)

    def connect(self):
        pass

    def disconnect(self):
        pass

    def connect_with_retry(self):
        delays = [0.0] + self.retry_policy.delays()
        for i, delay in enumerate(delays):
            if delay:
                # interruptible backoff (mirrors Source.connect_with_retry):
                # a time.sleep here pinned shutdown for the full remaining
                # ladder — CE003's one real engine hit
                if self._stop_retry.wait(delay):
                    return
            try:
                self.connect()
                self.connected = True
                return
            except ConnectionUnavailableError as e:
                log.warning("sink connect failed (attempt %d): %s", i + 1, e)

    def shutdown(self):
        self._stop_retry.set()
        worker = self._retry_worker_inst
        if worker is not None:
            # graceful drain: let pending retry ladders run their natural
            # backoff course (they self-terminate on max_attempts/budget)
            # so a transiently-down endpoint still gets every attempt;
            # only then interrupt, giving stragglers one final attempt.
            worker.join(timeout=5.0)
            worker.stop()
        try:
            self.disconnect()
        finally:
            self.connected = False

    def publish(self, payload, event: Event):
        raise NotImplementedError

    def publish_chunk(self, payload, chunk: EventChunk):
        """Chunk-level publish counterpart.  The default adapts to the
        per-event ``publish`` with a first-row representative Event —
        options are static on this path, so the event argument is only a
        template placeholder.  Batch-native transports override this."""
        ts, row = chunk.row(0)
        self.publish(payload, Event(ts, row))

    # junction-facing
    @hot_path("per-block egress: map + publish")
    def receive_chunk(self, chunk: EventChunk):
        cur = chunk.only(CURRENT)
        if cur.is_empty:
            # nothing publishable (all-EXPIRED/TIMER traffic): return
            # before any Event materialization
            return
        with _ledger().span("publish"):
            self._receive_cur(cur)

    def _receive_cur(self, cur: EventChunk):
        if self._is_dynamic():
            # per-event {{attr}} option templating forces the event path
            for e in cur.to_events():
                self._publish_with_retry(self.mapper.map([e]), e, [e])
            return
        payload = self.mapper.map_chunk(cur)
        if payload is None:     # mapper has no chunk path
            events = cur.to_events()
            self._publish_with_retry(self.mapper.map(events), events[0],
                                     events)
            return
        self._publish_with_retry(payload, None, LazyEvents(cur), chunk=cur)

    def _is_dynamic(self) -> bool:
        return any(isinstance(v, str) and _TEMPLATE_RE.search(v)
                   for v in self.options.values())

    def _publish_any(self, payload, target):
        """Publish dispatch shared with the retry worker: ``target`` is
        the representative Event (per-event path) or the EventChunk."""
        if isinstance(target, EventChunk):
            self.publish_chunk(payload, target)
        else:
            self.publish(payload, target)

    def _publish_with_retry(self, payload, event, events=None, chunk=None):
        """First attempt inline; failures go to the off-thread retry
        worker so the junction never blocks on a sick endpoint."""
        handler = getattr(self, "handler", None)
        if handler is not None:
            if event is None and chunk is not None:
                # the HA SPI speaks per-event: hand it a first-row
                # representative (cold: only when a handler is attached)
                ts, row = chunk.row(0)
                event = Event(ts, row)
            payload = handler.handle(payload, event)
            if payload is None:
                return
        events = events if events is not None else [event]
        if not self.breaker.allow():
            # OPEN circuit: fast-fail without touching the endpoint
            self._terminal_failure(events, ConnectionUnavailableError(
                f"circuit open for sink on {self.stream_def.id}"))
            return
        target = chunk if chunk is not None else event
        try:
            self._publish_any(payload, target)
            self.breaker.record_success()
        except ConnectionUnavailableError as e:
            self.connected = False
            self.breaker.record_failure()
            m = self.resilience
            if m is not None:
                m.sink_publish_failed_total.inc(sink=self.stream_def.id)
            log.warning("sink publish failed on %s (queued for retry): %s",
                        self.stream_def.id, e)
            if not self._retry_worker().submit(payload, target, events, e):
                self._terminal_failure(events, e)

    def _retry_worker(self) -> SinkRetryWorker:
        with self._retry_lock:
            if self._retry_worker_inst is None:
                m = self.resilience
                sid = self.stream_def.id

                def on_retry(task, m=m, sid=sid):
                    if m is not None:
                        m.sink_retry_total.inc(sink=sid)

                self._retry_worker_inst = SinkRetryWorker(
                    name=sid,
                    publish_fn=self._publish_any,
                    policy=self.retry_policy,
                    breaker=self.breaker,
                    on_exhausted=lambda task: self._terminal_failure(
                        task.events, task.last_error, attempts=task.attempt),
                    on_retry=on_retry,
                    capacity=self._retry_capacity)
            return self._retry_worker_inst

    def _terminal_failure(self, events, error, attempts: int = 0):
        """All retries spent (or circuit open / queue full): error store
        when configured, otherwise a counted, logged drop."""
        store = self.error_store
        m = self.resilience
        sid = self.stream_def.id
        if store is not None:
            store.store(make_entry(self.app_name, sid, "sink",
                                   error or ConnectionUnavailableError(
                                       "publish failed"),
                                   events, attempts=attempts))
            if m is not None:
                m.errors_stored_total.inc(len(events), stream=sid,
                                          origin="sink")
        else:
            if m is not None:
                m.sink_dropped_total.inc(len(events), sink=sid)
            log.error("sink for %s dropped %d events after retries: %s",
                      sid, len(events), error)


class InMemorySink(Sink):
    def publish(self, payload, event: Event):
        topic = self.resolve_option("topic", event) or self.stream_def.id
        InMemoryBroker.publish(topic, payload)


class LogSink(Sink):
    """@sink(type='log') (reference LogSink.java)."""

    def publish(self, payload, event: Event):
        prefix = self.options.get("prefix", self.stream_def.id)
        log.info("%s : %s", prefix, payload)


SOURCES = {"inmemory": InMemorySource}
SINKS = {"inmemory": InMemorySink, "log": LogSink}


# ============================================================ distributed sinks

class DistributionStrategy:
    """(reference stream/output/sink/distributed/DistributionStrategy.java +
    RoundRobin/Broadcast/Partitioned implementations)."""

    def __init__(self, n: int):
        self.n = n

    def destinations_for(self, event: Event, key=None) -> List[int]:
        raise NotImplementedError


class RoundRobinStrategy(DistributionStrategy):
    def __init__(self, n):
        super().__init__(n)
        self._i = 0

    def destinations_for(self, event, key=None):
        d = self._i % self.n
        self._i += 1
        return [d]


class BroadcastStrategy(DistributionStrategy):
    def destinations_for(self, event, key=None):
        return list(range(self.n))


class PartitionedStrategy(DistributionStrategy):
    def __init__(self, n, key_index: int):
        super().__init__(n)
        self.key_index = key_index

    def destinations_for(self, event, key=None):
        return [hash(event.data[self.key_index]) % self.n]


class DistributedSink(Sink):
    """Multi-destination sink wrapper (reference
    util/transport/{Single,Multi}ClientDistributedSink.java)."""

    def __init__(self, stream_def, options, mapper, destinations: List[Sink],
                 strategy: DistributionStrategy):
        super().__init__(stream_def, options, mapper)
        self.destinations = destinations
        self.strategy = strategy

    def connect(self):
        for d in self.destinations:
            d.connect_with_retry()

    def disconnect(self):
        for d in self.destinations:
            d.disconnect()

    def receive_chunk(self, chunk: EventChunk):
        cur = chunk.only(CURRENT)
        if cur.is_empty:
            return      # all-EXPIRED/TIMER: nothing to materialize
        with _ledger().span("publish"):
            self._publish_cur(cur)

    def _publish_cur(self, cur: EventChunk):
        if isinstance(self.strategy, BroadcastStrategy) and self.destinations \
                and not any(d._is_dynamic() for d in self.destinations):
            # broadcast with static options fans the mapped chunk to every
            # destination — destinations share the mapper config, so probe
            # the chunk path once
            payload = self.destinations[0].mapper.map_chunk(cur)
            if payload is not None:
                lazy = LazyEvents(cur)
                for d in self.destinations:
                    d._publish_with_retry(payload, None, lazy, chunk=cur)
                return
        # routed strategies pick destinations per event
        for e in cur.to_events():
            for di in self.strategy.destinations_for(e):
                self.destinations[di]._publish_with_retry(
                    self.destinations[di].mapper.map([e]), e)


# ===================================================================== wiring

def attach_sources_and_sinks(app_runtime):
    """Scan stream definitions for @source/@sink annotations."""
    ctx = app_runtime.siddhi_context
    shm = getattr(ctx, "source_handler_manager", None)
    khm = getattr(ctx, "sink_handler_manager", None)
    for sid, d in list(app_runtime.stream_definitions.items()):
        for ann in find_all(d.annotations, "source"):
            src = _build_source(app_runtime, d, ann)
            if shm is not None:
                src.handler = shm.generate_source_handler(src)
            app_runtime.sources.append(src)
        for ann in find_all(d.annotations, "sink"):
            sink = _build_sink(app_runtime, d, ann)
            if khm is not None:
                sink.handler = khm.generate_sink_handler(sink)
            sink.bind_runtime(app_runtime)
            for dest in getattr(sink, "destinations", []):
                dest.bind_runtime(app_runtime)
            app_runtime.sinks.append(sink)
            app_runtime.junctions[sid].subscribe(sink)


def _map_options(ann: Annotation) -> (str, Dict[str, str]):
    m = find_annotation(ann.annotations, "map")
    if m is None:
        return "passthrough", {}
    return (m.get("type", "passThrough") or "passThrough").lower(), m.as_dict()


def _build_source(app_runtime, d, ann: Annotation) -> Source:
    stype = (ann.get("type", "inMemory") or "inMemory").lower()
    opts = ann.as_dict()
    map_type, map_opts = _map_options(ann)
    mapper_cls = SOURCE_MAPPERS.get(map_type)
    if mapper_cls is None:
        raise SiddhiAppCreationError(f"Unknown source mapper '{map_type}'")
    mapper = mapper_cls(d, map_opts)
    handler = app_runtime.get_input_handler(d.id)
    cls = SOURCES.get(stype)
    if cls is None and app_runtime.extension_registry is not None:
        cls = app_runtime.extension_registry.find_source(stype)
    if cls is None:
        raise SiddhiAppCreationError(f"Unknown source type '{stype}'")
    return cls(d, opts, mapper, handler)


def _build_sink(app_runtime, d, ann: Annotation) -> Sink:
    stype = (ann.get("type", "inMemory") or "inMemory").lower()
    opts = ann.as_dict()
    map_type, map_opts = _map_options(ann)
    mapper_cls = SINK_MAPPERS.get(map_type)
    if mapper_cls is None:
        raise SiddhiAppCreationError(f"Unknown sink mapper '{map_type}'")
    mapper = mapper_cls(d, map_opts)
    dist = find_annotation(ann.annotations, "distribution")
    cls = SINKS.get(stype)
    if cls is None and app_runtime.extension_registry is not None:
        cls = app_runtime.extension_registry.find_sink(stype)
    if cls is None:
        raise SiddhiAppCreationError(f"Unknown sink type '{stype}'")
    if dist is not None:
        dests = []
        for dest_ann in find_all(dist.annotations, "destination"):
            dopts = dict(opts)
            dopts.update(dest_ann.as_dict())
            dests.append(cls(d, dopts, mapper_cls(d, map_opts)))
        strategy_name = (dist.get("strategy", "roundRobin") or "").lower()
        if strategy_name == "broadcast":
            strategy = BroadcastStrategy(len(dests))
        elif strategy_name == "partitioned":
            key = dist.get("partitionKey", d.attributes[0].name)
            idx = d.index_of(key)
            strategy = PartitionedStrategy(len(dests), max(idx, 0))
        else:
            strategy = RoundRobinStrategy(len(dests))
        return DistributedSink(d, opts, mapper, dests, strategy)
    return cls(d, opts, mapper)
