"""Columnar event batch model.

TPU-native replacement for the reference's event model
(siddhi-core event/: Event.java, ComplexEvent.java, StreamEvent.java,
StateEvent.java, ComplexEventChunk.java, StreamEventPool.java).

The reference represents in-flight events as pooled, linked-list node objects
(`StreamEvent.next`) walked one at a time.  Here an event micro-batch is a
struct-of-arrays `EventChunk`: one numpy/JAX column per attribute + a timestamp
column + an event-type lane implementing the CURRENT/EXPIRED/TIMER/RESET
temporal algebra (reference ComplexEvent.Type, docs/siddhi-architecture.md:243-259).
Chunks are what processors exchange; device kernels consume the numeric columns
directly (strings are dictionary-encoded before shipping to device).
"""
from __future__ import annotations

import time

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..query_api.definition import AbstractDefinition, AttrType
from .profiling import rim_stats

_RIM = rim_stats()

# ComplexEvent.Type lanes
CURRENT = 0
EXPIRED = 1
TIMER = 2
RESET = 3

TYPE_NAMES = {CURRENT: "CURRENT", EXPIRED: "EXPIRED", TIMER: "TIMER",
              RESET: "RESET"}

_DTYPES = {
    AttrType.INT: np.int32,
    AttrType.LONG: np.int64,
    AttrType.FLOAT: np.float32,
    AttrType.DOUBLE: np.float64,
    AttrType.BOOL: np.bool_,
    AttrType.STRING: object,
    AttrType.OBJECT: object,
}


def dtype_for(t: AttrType):
    return _DTYPES[t]


def zero_for(t: AttrType):
    if t in (AttrType.STRING, AttrType.OBJECT):
        return None
    return dtype_for(t)(0)


class Event:
    """User-facing event (reference event/Event.java: timestamp + Object[]).

    A plain ``__slots__`` class rather than a dataclass: the legacy
    per-event rim builds millions of these per second and the dataclass
    constructor is ~1.6x slower.  Like the eq-without-frozen dataclass it
    replaced, instances are unhashable."""

    __slots__ = ("timestamp", "data")

    def __init__(self, timestamp: int, data: List[Any]):
        self.timestamp = timestamp
        self.data = data

    def __iter__(self):
        return iter(self.data)

    def __eq__(self, other):
        return (other.__class__ is Event and
                self.timestamp == other.timestamp and
                self.data == other.data)

    def __repr__(self):
        return f"Event(timestamp={self.timestamp!r}, data={self.data!r})"


class EventChunk:
    """A columnar micro-batch of events flowing through a query pipeline.

    `qualified` (optional) carries per-(stream_ref, index) attribute columns
    for multi-stream events — the columnar analogue of the reference's
    StateEvent (join/pattern output rows, event/state/StateEvent.java)."""

    __slots__ = ("timestamps", "types", "columns", "names", "qualified",
                 "is_batch", "ledger_ns")

    def __init__(self, names: Sequence[str], timestamps: np.ndarray,
                 types: np.ndarray, columns: Dict[str, np.ndarray],
                 qualified: Optional[Dict] = None, is_batch: bool = False):
        self.names = list(names)
        self.timestamps = timestamps
        self.types = types
        self.columns = columns
        self.qualified = qualified
        # batch-marked chunks summarize in aggregated selects (reference
        # ComplexEventChunk.isBatch, set by tumbling-batch windows); the
        # transforms below all carry it so intervening processors (filters,
        # stream functions) don't strip batch semantics
        self.is_batch = is_batch
        # latency-ledger boundary stamp (monotonic ns): set at ingress
        # admit / junction enqueue, consumed at the next stage boundary
        # (queue-wait and dispatch-gap attribution, core/ledger.py); NOT
        # carried by transforms — a derived chunk is a new timeline
        self.ledger_ns = None

    # ------------------------------------------------------------ constructors

    @staticmethod
    def empty(names: Sequence[str]) -> "EventChunk":
        return EventChunk(names, np.empty(0, np.int64), np.empty(0, np.int8),
                          {n: np.empty(0, object) for n in names})

    @staticmethod
    def from_rows(definition: AbstractDefinition, rows: Sequence[Sequence[Any]],
                  timestamps: Sequence[int],
                  types: Optional[Sequence[int]] = None) -> "EventChunk":
        n = len(rows)
        names = definition.attribute_names
        cols: Dict[str, np.ndarray] = {}
        for j, attr in enumerate(definition.attributes):
            dt = dtype_for(attr.type)
            if dt is object:
                arr = np.empty(n, object)
                for i, r in enumerate(rows):
                    arr[i] = r[j]
            else:
                try:
                    arr = np.asarray([r[j] for r in rows], dtype=dt)
                except (TypeError, ValueError):
                    # None payloads fall back to zeros (null lane not modelled
                    # per column; Siddhi nulls only arise from outer joins /
                    # absent captures which are handled there)
                    arr = np.asarray(
                        [0 if r[j] is None else r[j] for r in rows], dtype=dt)
            cols[attr.name] = arr
        ts = np.asarray(timestamps, np.int64)
        tp = (np.asarray(types, np.int8) if types is not None
              else np.zeros(n, np.int8))
        return EventChunk(names, ts, tp, cols)

    @staticmethod
    def from_columns(names: Sequence[str], timestamps: np.ndarray,
                     columns: Dict[str, np.ndarray],
                     types: Optional[np.ndarray] = None) -> "EventChunk":
        if types is None:
            types = np.zeros(len(timestamps), np.int8)
        return EventChunk(names, np.asarray(timestamps, np.int64), types,
                          {k: np.asarray(v) for k, v in columns.items()})

    # ------------------------------------------------------------ accessors

    def __len__(self) -> int:
        return len(self.timestamps)

    @property
    def is_empty(self) -> bool:
        return len(self.timestamps) == 0

    def col(self, name: str) -> np.ndarray:
        return self.columns[name]

    def row(self, i: int) -> Tuple[int, List[Any]]:
        return int(self.timestamps[i]), [_to_py(self.columns[n][i])
                                         for n in self.names]

    def to_events(self) -> List[Event]:
        # vectorized row materialization: ndarray.tolist() converts each
        # column to python scalars in C, and zip/map build the row lists
        # and Event objects without per-row bytecode.  Every call feeds
        # the always-on events-materialized counter — the columnar fast
        # path is asserted to never reach here (bench --smoke rim phase)
        n = len(self)
        if n == 0:
            return []
        _RIM.events_materialized += n
        ts_list = self.timestamps.tolist()
        col_lists = [self.columns[name].tolist() for name in self.names]
        return list(map(Event, ts_list, map(list, zip(*col_lists))))

    # ------------------------------------------------------------ transforms

    def mask(self, m: np.ndarray) -> "EventChunk":
        return EventChunk(self.names, self.timestamps[m], self.types[m],
                          {k: v[m] for k, v in self.columns.items()},
                          _sel_qualified(self.qualified, m), self.is_batch)

    def take(self, idx: np.ndarray) -> "EventChunk":
        return EventChunk(self.names, self.timestamps[idx], self.types[idx],
                          {k: v[idx] for k, v in self.columns.items()},
                          _sel_qualified(self.qualified, idx), self.is_batch)

    def slice(self, start: int, stop: int) -> "EventChunk":
        return EventChunk(self.names, self.timestamps[start:stop],
                          self.types[start:stop],
                          {k: v[start:stop] for k, v in self.columns.items()},
                          _sel_qualified(self.qualified, slice(start, stop)),
                          self.is_batch)

    def with_types(self, t: int) -> "EventChunk":
        return EventChunk(self.names, self.timestamps,
                          np.full(len(self), t, np.int8), self.columns,
                          self.qualified, self.is_batch)

    def with_timestamps(self, ts: np.ndarray) -> "EventChunk":
        return EventChunk(self.names, np.asarray(ts, np.int64), self.types,
                          self.columns, self.qualified, self.is_batch)

    def rename(self, names: Sequence[str]) -> "EventChunk":
        assert len(names) == len(self.names)
        return EventChunk(list(names), self.timestamps, self.types,
                          {new: self.columns[old]
                           for old, new in zip(self.names, names)},
                          self.qualified, self.is_batch)

    def only(self, *event_types: int) -> "EventChunk":
        m = (self.types == event_types[0] if len(event_types) == 1
             else np.isin(self.types, event_types))
        if m.all():
            # all-match fast path: chunks are treated as immutable values
            # by every processor, so the filter can return self — match
            # slabs are all-CURRENT and this sits on the delivery rim
            return self
        return self.mask(m)

    def copy(self) -> "EventChunk":
        return EventChunk(self.names, self.timestamps.copy(), self.types.copy(),
                          {k: v.copy() for k, v in self.columns.items()},
                          _sel_qualified(self.qualified, slice(None)),
                          self.is_batch)

    @staticmethod
    def concat(chunks: Sequence["EventChunk"]) -> "EventChunk":
        chunks = [c for c in chunks if c is not None and not c.is_empty]
        if not chunks:
            return EventChunk.empty([])
        if len(chunks) == 1:
            return chunks[0]
        names = chunks[0].names
        qualified = None
        if any(c.qualified is not None for c in chunks):
            qualified = {}
            keys = set()
            for c in chunks:
                keys |= set((c.qualified or {}).keys())
            for key in keys:
                attrs = set()
                for c in chunks:
                    attrs |= set((c.qualified or {}).get(key, {}).keys())
                qualified[key] = {
                    a: np.concatenate([
                        (c.qualified or {}).get(key, {}).get(
                            a, np.full(len(c), None, object))
                        for c in chunks])
                    for a in attrs}
        return EventChunk(
            names,
            np.concatenate([c.timestamps for c in chunks]),
            np.concatenate([c.types for c in chunks]),
            {n: np.concatenate([c.columns[n] for c in chunks]) for n in names},
            qualified,
            # conservative: merging a batch flush with non-batch traffic
            # (e.g. async junction re-batching) must not batch-mark the result
            all(c.is_batch for c in chunks))

    def __repr__(self):
        return (f"EventChunk(n={len(self)}, names={self.names}, "
                f"types={[TYPE_NAMES.get(int(t), t) for t in self.types[:8]]})")


class LazyEvents:
    """Deferred chunk→``Event[]`` materialization for cold paths.

    The legacy ``StreamCallback``/``QueryCallback`` rim, the sink retry
    queue and the error stores carry "the events" of a chunk; handing
    them this wrapper instead of an eager ``to_events()`` keeps every
    path that never touches an element zero-materialization — the Event
    objects (and the counter increment) only exist on first element
    access.  Sized/iterable/indexable like the list it stands in for."""

    __slots__ = ("chunk", "_events")

    def __init__(self, chunk: EventChunk):
        self.chunk = chunk
        self._events: Optional[List[Event]] = None

    def materialize(self) -> List[Event]:
        if self._events is None:
            t0 = time.perf_counter_ns()
            self._events = self.chunk.to_events()
            _RIM.rim_ns += time.perf_counter_ns() - t0
        return self._events

    def __len__(self) -> int:
        return len(self.chunk)

    def __bool__(self) -> bool:
        return len(self.chunk) > 0

    def __iter__(self):
        return iter(self.materialize())

    def __getitem__(self, i):
        return self.materialize()[i]

    def __repr__(self):
        # must NOT materialize: repr of a pending view is a debugging /
        # logging path and the zero-copy property (events_materialized
        # == 0) has to survive it
        state = ("pending" if self._events is None
                 else f"materialized={len(self._events)}")
        return f"LazyEvents(n={len(self.chunk)}, {state})"


def _sel_qualified(q, sel):
    if q is None:
        return None
    return {key: {a: col[sel] for a, col in d.items()} for key, d in q.items()}


def _to_py(v):
    """numpy scalar → python scalar for user-facing Event payloads."""
    if isinstance(v, np.generic):
        return v.item()
    return v


def timer_chunk(names: Sequence[str], timestamp: int) -> EventChunk:
    """A single TIMER event (reference: Scheduler-injected timer StreamEvents,
    util/Scheduler.java:180-211).  Data columns are empty placeholders."""
    cols = {}
    for n in names:
        cols[n] = np.array([None], object)
    return EventChunk(names, np.asarray([timestamp], np.int64),
                      np.asarray([TIMER], np.int8), cols)
