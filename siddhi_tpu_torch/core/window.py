"""Window processors.

(reference: query/processor/stream/window/*.java — 24 files: length,
lengthBatch, time, timeBatch, timeLength, externalTime, externalTimeBatch,
batch, session, sort, frequent, lossyFrequent, cron, delay ... each keeping a
SnapshotableStreamEventQueue buffer and emitting CURRENT on arrival plus
EXPIRED/RESET on eviction, per the temporal event algebra of
docs/siddhi-architecture.md:243-268.)

TPU-native design: window contents are columnar EventChunks (struct-of-arrays)
rather than linked lists of pooled objects; evictions are computed as array
slices per *batch* rather than per event, and the CURRENT/EXPIRED interleaving
the reference produces event-by-event is reconstructed with one permutation
(`_interleave`) so downstream batched aggregators observe the identical order.
Windows are FindableProcessors: joins probe their buffer columns directly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx
from ..utils.errors import SiddhiAppCreationError
from .event import (CURRENT, EXPIRED, RESET, TIMER, EventChunk)
from .processor import Processor
from .stateschema import (Chunk, ListOf, MapOf, Opt, Scalar, Struct,
                          persistent_schema)


@persistent_schema("window-buffer",
                   schema=Struct(buffer=Opt(Chunk())))
class WindowProcessor(Processor):
    """Base: keeps a columnar buffer; subclasses implement `on_data`."""

    requires_scheduler = False

    def __init__(self, app_ctx, names: List[str]):
        super().__init__()
        self.app_ctx = app_ctx
        self.names = names
        self.buffer: Optional[EventChunk] = None
        self.lock: Optional[threading.RLock] = None  # set by query wiring

    # -------------------------------------------------------------- helpers

    def _buf_len(self) -> int:
        return 0 if self.buffer is None else len(self.buffer)

    def _buf_append(self, chunk: EventChunk):
        chunk = chunk.with_types(CURRENT)
        self.buffer = chunk if self.buffer is None \
            else EventChunk.concat([self.buffer, chunk])

    def _buf_take_front(self, k: int) -> EventChunk:
        assert self.buffer is not None
        front = self.buffer.slice(0, k)
        self.buffer = self.buffer.slice(k, len(self.buffer))
        return front

    def process(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        timer_mask = chunk.types == TIMER
        if timer_mask.any():
            self.on_timer_event(int(chunk.timestamps[timer_mask][-1]))
        data = chunk.mask(~timer_mask)
        if not data.is_empty:
            self.on_data(data)

    def on_data(self, chunk: EventChunk):
        raise NotImplementedError

    def on_timer_event(self, ts: int):
        pass

    def _locked(self, fn, *args):
        if self.lock is not None:
            with self.lock:
                fn(*args)
        else:
            fn(*args)

    # -------------------------------------------------------------- find (joins)

    def find_chunk(self) -> Optional[EventChunk]:
        """Current window contents for join probing / store queries."""
        return self.buffer

    # -------------------------------------------------------------- state

    def current_state(self):
        if self.buffer is None:
            return {"buffer": None}
        return {"buffer": _chunk_state(self.buffer)}

    def restore_state(self, state):
        self.buffer = _chunk_restore(state["buffer"], self.names)


@persistent_schema("window-grouped",
                   schema=Struct(keys=ListOf("key"),
                                 inners=ListOf("window-state")))
class GroupingWindowProcessor(WindowProcessor):
    """Extension base: window state partitioned per group key (reference
    query/processor/stream/window/GroupingWindowProcessor.java — the
    `_groupingKey` SPI base its grouping window extensions subclass).

    Subclasses declare `make_inner() -> WindowProcessor` (a fresh inner
    window per key) and get one isolated inner instance per group-key
    value; emissions from every inner flow to this processor's `next`."""

    def __init__(self, app_ctx, names, key_expr: CompiledExpr):
        super().__init__(app_ctx, names)
        self.key_expr = key_expr
        self._inners: Dict = {}

    def make_inner(self) -> "WindowProcessor":
        raise NotImplementedError

    def _inner_for(self, key) -> "WindowProcessor":
        w = self._inners.get(key)
        if w is None:
            w = self.make_inner()
            w.lock = self.lock
            w.next = _GroupForward(self)
            self._inners[key] = w
        return w

    _NAN_KEY = "__nan__"

    def on_data(self, chunk: EventChunk):
        n = len(chunk)
        ctx = EvalCtx(dict(chunk.columns), chunk.timestamps, n)
        keys = np.asarray(self.key_expr.fn(ctx))
        if keys.ndim == 0:
            keys = np.full(n, keys)
        # NaN != NaN would both defeat the dedup (a leaked inner per
        # occurrence) and zero the mask (events silently dropped) — fold
        # every NaN into one sentinel bucket
        key_list = [self._NAN_KEY if k != k else k for k in keys.tolist()]
        for key in dict.fromkeys(key_list):          # first-seen order
            m = np.asarray([k == key for k in key_list])
            self._inner_for(key).process(chunk.mask(m))

    def on_timer_event(self, ts: int):
        for w in self._inners.values():
            w.on_timer_event(ts)

    def find_chunk(self) -> Optional[EventChunk]:
        parts = [w.find_chunk() for w in self._inners.values()]
        parts = [p for p in parts if p is not None and not p.is_empty]
        return EventChunk.concat(parts) if parts else None

    def current_state(self):
        return {"keys": list(self._inners),
                "inners": [w.current_state()
                           for w in self._inners.values()]}

    def restore_state(self, state):
        self._inners = {}
        for key, s in zip(state["keys"], state["inners"]):
            self._inner_for(key).restore_state(s)


class _GroupForward(Processor):
    """Routes a per-key inner window's emissions to the group processor's
    downstream."""

    def __init__(self, owner: GroupingWindowProcessor):
        super().__init__()
        self.owner = owner

    def process(self, chunk: EventChunk):
        if self.owner.next is not None:
            self.owner.next.process(chunk)


def _chunk_state(c: EventChunk) -> dict:
    return {"names": c.names,
            "timestamps": c.timestamps.tolist(),
            "types": c.types.tolist(),
            "columns": {k: v.tolist() for k, v in c.columns.items()},
            "dtypes": {k: str(v.dtype) for k, v in c.columns.items()}}


def _chunk_restore(s: Optional[dict], names) -> Optional[EventChunk]:
    if s is None:
        return None
    cols = {}
    for k, vals in s["columns"].items():
        dt = s["dtypes"][k]
        cols[k] = np.asarray(vals, object) if dt == "object" \
            else np.asarray(vals, np.dtype(dt))
    return EventChunk(s["names"], np.asarray(s["timestamps"], np.int64),
                      np.asarray(s["types"], np.int8), cols)


def _interleave(expired: EventChunk, current: EventChunk,
                pair_from: int) -> EventChunk:
    """Reconstruct the reference's per-event emission order: current events
    [0..pair_from) emit alone; current event pair_from+j is preceded by
    expired[j].  Result: [c_0..c_{pf-1}, e_0, c_pf, e_1, c_{pf+1}, ...]."""
    if expired.is_empty:
        return current
    m, k = len(current), len(expired)
    total = m + k
    # build gather order over concat([expired, current])
    order = np.empty(total, np.int64)
    pos = 0
    ci, ei = 0, 0
    # vectorised construction
    head = pair_from
    order[:head] = k + np.arange(head)                       # leading currents
    body = np.empty((m - head) * 2, np.int64)
    body[0::2] = np.arange(k)                                # expired j
    body[1::2] = k + head + np.arange(m - head)              # current pf+j
    order[head:] = body[:total - head]
    both = EventChunk.concat([expired, current])
    return both.take(order)


# ===================================================================== length

class LengthWindowProcessor(WindowProcessor):
    """Sliding length(n) (reference LengthWindowProcessor.java)."""

    def __init__(self, app_ctx, names, length: int):
        super().__init__(app_ctx, names)
        self.length = length

    def on_data(self, chunk: EventChunk):
        m = len(chunk)
        b = self._buf_len()
        combined = EventChunk.concat([self.buffer, chunk.with_types(CURRENT)]) \
            if self.buffer is not None else chunk.with_types(CURRENT)
        overflow = max(0, b + m - self.length)
        expired = combined.slice(0, overflow).with_types(EXPIRED)
        self.buffer = combined.slice(overflow, b + m)
        # expired event timestamps = displacing event's timestamp
        if overflow:
            c0 = max(0, self.length - b)   # currents that displace nothing
            disp_ts = chunk.timestamps[c0:c0 + overflow]
            expired = expired.with_timestamps(disp_ts)
            out = _interleave(expired, chunk, c0)
        else:
            out = chunk
        self.send_next(out)


@persistent_schema("window-length-batch",
                   schema=Struct(buffer=Opt(Chunk()),
                                 expired_batch=Opt(Chunk())))
class LengthBatchWindowProcessor(WindowProcessor):
    """Tumbling lengthBatch(n): emits [prev batch EXPIRED, RESET, new batch
    CURRENT] when n events collect (reference LengthBatchWindowProcessor)."""

    def __init__(self, app_ctx, names, length: int):
        super().__init__(app_ctx, names)
        self.length = length
        self.expired_batch: Optional[EventChunk] = None

    def on_data(self, chunk: EventChunk):
        pending = EventChunk.concat([self.buffer, chunk]) \
            if self.buffer is not None else chunk
        flushes = []
        while len(pending) >= self.length:
            batch = pending.slice(0, self.length)
            pending = pending.slice(self.length, len(pending))
            ts = int(batch.timestamps[-1])
            outs = []
            if self.expired_batch is not None:
                outs.append(self.expired_batch.with_types(EXPIRED)
                            .with_timestamps(np.full(len(self.expired_batch),
                                                     ts, np.int64)))
            outs.append(_reset_row(batch, ts))
            outs.append(batch.with_types(CURRENT))
            self.expired_batch = batch
            flushes.append(outs)
        self.buffer = pending if len(pending) else None
        # one chunk PER batch flush — aggregated selects summarize each
        # batch-marked chunk to a single row (reference setBatch(true)), so
        # merging flushes would drop all but the last batch's aggregate
        for outs in flushes:
            out = EventChunk.concat(outs)
            out.is_batch = True
            self.send_next(out)

    def current_state(self):
        s = super().current_state()
        s["expired_batch"] = None if self.expired_batch is None \
            else _chunk_state(self.expired_batch)
        return s

    def restore_state(self, state):
        super().restore_state(state)
        self.expired_batch = _chunk_restore(state.get("expired_batch"),
                                            self.names)


def _reset_row(proto: EventChunk, ts: int) -> EventChunk:
    cols = {n: np.asarray([None], object) if proto.columns[n].dtype == object
            else np.zeros(1, proto.columns[n].dtype) for n in proto.names}
    return EventChunk(proto.names, np.asarray([ts], np.int64),
                      np.asarray([RESET], np.int8), cols)


# ===================================================================== time

class TimeWindowProcessor(WindowProcessor):
    """Sliding time(t): events expire t ms after arrival, driven by the
    scheduler (reference TimeWindowProcessor.java)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, window_ms: int):
        super().__init__(app_ctx, names)
        self.window_ms = window_ms

    def on_data(self, chunk: EventChunk):
        now = int(chunk.timestamps[-1])
        expired = self._collect_expired(now)
        self._buf_append(chunk)
        self.app_ctx.scheduler.notify_at(now + self.window_ms, self._on_timer)
        # all expired here predate the whole batch → emit before currents
        if expired is not None and not expired.is_empty:
            self.send_next(EventChunk.concat([expired, chunk]))
        else:
            self.send_next(chunk)

    def _collect_expired(self, now: int) -> Optional[EventChunk]:
        if self.buffer is None or self.buffer.is_empty:
            return None
        cutoff = now - self.window_ms
        k = int(np.searchsorted(self.buffer.timestamps, cutoff, side="right"))
        if k <= 0:
            return None
        ex = self._buf_take_front(k)
        return ex.with_types(EXPIRED).with_timestamps(
            ex.timestamps + self.window_ms)

    def _on_timer(self, now: int):
        def run():
            expired = self._collect_expired(now)
            if expired is not None and not expired.is_empty:
                self.send_next(expired)
            if self._buf_len():
                nxt = int(self.buffer.timestamps[0]) + self.window_ms
                self.app_ctx.scheduler.notify_at(nxt, self._on_timer)
        self._locked(run)

    def on_timer_event(self, ts: int):
        expired = self._collect_expired(ts)
        if expired is not None and not expired.is_empty:
            self.send_next(expired)


class ExternalTimeWindowProcessor(TimeWindowProcessor):
    """Sliding externalTime(ts_attr, t): driven purely by event timestamps
    (reference ExternalTimeWindowProcessor.java)."""

    requires_scheduler = False

    def __init__(self, app_ctx, names, ts_expr: CompiledExpr, window_ms: int):
        WindowProcessor.__init__(self, app_ctx, names)
        self.window_ms = window_ms
        self.ts_expr = ts_expr

    def on_data(self, chunk: EventChunk):
        ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
        etimes = np.asarray(self.ts_expr.fn(ctx), np.int64)
        chunk = chunk.with_timestamps(etimes)
        outs = []
        # per-event: expire then current (event time strictly ordered)
        for i in range(len(chunk)):
            now = int(etimes[i])
            expired = self._collect_expired_lte(now)
            if expired is not None:
                outs.append(expired)
            row = chunk.slice(i, i + 1)
            self._buf_append(row)
            outs.append(row)
        self.send_next(EventChunk.concat(outs))

    def _collect_expired_lte(self, now: int) -> Optional[EventChunk]:
        if self.buffer is None or self.buffer.is_empty:
            return None
        cutoff = now - self.window_ms
        k = int(np.searchsorted(self.buffer.timestamps, cutoff, side="right"))
        if k <= 0:
            return None
        ex = self._buf_take_front(k)
        return ex.with_types(EXPIRED).with_timestamps(
            np.full(len(ex), now, np.int64))


class TimeBatchWindowProcessor(WindowProcessor):
    """Tumbling timeBatch(t) (reference TimeBatchWindowProcessor.java)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, window_ms: int,
                 start_time: Optional[int] = None):
        super().__init__(app_ctx, names)
        self.window_ms = window_ms
        self.next_emit: Optional[int] = None
        self.start_time = start_time
        self.expired_batch: Optional[EventChunk] = None

    def on_data(self, chunk: EventChunk):
        now = int(chunk.timestamps[-1])
        if self.next_emit is None:
            base = self.start_time if self.start_time is not None else \
                int(chunk.timestamps[0])
            self.next_emit = base + self.window_ms
            self.app_ctx.scheduler.notify_at(self.next_emit, self._on_timer)
        self._emit_due(now)
        self._buf_append(chunk)

    def _emit_due(self, now: int):
        while self.next_emit is not None and now >= self.next_emit:
            self._flush(self.next_emit)
            self.next_emit += self.window_ms

    def _flush(self, ts: int):
        outs = []
        batch = self.buffer
        self.buffer = None
        if self.expired_batch is not None:
            outs.append(self.expired_batch.with_types(EXPIRED)
                        .with_timestamps(np.full(len(self.expired_batch), ts,
                                                 np.int64)))
        if batch is not None and not batch.is_empty:
            outs.append(_reset_row(batch, ts))
            outs.append(batch.with_types(CURRENT))
        self.expired_batch = batch
        if outs:
            out = EventChunk.concat(outs)
            out.is_batch = True
            self.send_next(out)

    def _on_timer(self, now: int):
        def run():
            self._emit_due(now)
            if self.next_emit is not None:
                self.app_ctx.scheduler.notify_at(self.next_emit, self._on_timer)
        self._locked(run)

    def on_timer_event(self, ts: int):
        self._emit_due(ts)


@persistent_schema("window-hopping",
                   schema=Struct(buffer=Opt(Chunk()),
                                 next_emit=Scalar("opt_int"),
                                 last_emitted=Opt(Chunk())))
class HopingWindowProcessor(WindowProcessor):
    """Hopping time window: every hop(t2) emit the events of the last
    window(t1) as CURRENT and those that slid out as EXPIRED (reference
    HopingWindowProcessor.java — 'hoping' spelling kept for SiddhiQL
    compatibility; `hopping` is accepted too)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, window_ms: int, hop_ms: int):
        super().__init__(app_ctx, names)
        self.window_ms = window_ms
        self.hop_ms = hop_ms
        self.next_emit: Optional[int] = None
        self.last_emitted: Optional[EventChunk] = None

    def on_data(self, chunk: EventChunk):
        if self.next_emit is None:
            self.next_emit = int(chunk.timestamps[0]) + self.hop_ms
            self.app_ctx.scheduler.notify_at(self.next_emit, self._on_timer)
        # a batch may span hop boundaries: events at or before a due hop
        # belong to that hop's window, so split-append before each emission
        while not chunk.is_empty and \
                int(chunk.timestamps[-1]) >= self.next_emit:
            pre = chunk.timestamps <= self.next_emit
            if pre.any():
                self._buf_append(chunk.mask(pre))
                chunk = chunk.mask(~pre)
            self._hop(self.next_emit)
            self.next_emit += self.hop_ms
        if not chunk.is_empty:
            self._buf_append(chunk)

    def _emit_due(self, now: int):
        while self.next_emit is not None and now >= self.next_emit:
            self._hop(self.next_emit)
            self.next_emit += self.hop_ms

    def _hop(self, ts: int):
        # window contents at this hop = events with ts in (ts - window, ts]
        outs = []
        if self.buffer is not None and not self.buffer.is_empty:
            keep = self.buffer.timestamps > ts - self.window_ms
            self.buffer = self.buffer.mask(keep)
        current = self.buffer
        if self.last_emitted is not None and not self.last_emitted.is_empty:
            gone = self.last_emitted.timestamps <= ts - self.window_ms
            expired = self.last_emitted.mask(gone)
            if not expired.is_empty:
                outs.append(expired.with_types(EXPIRED).with_timestamps(
                    np.full(len(expired), ts, np.int64)))
        if current is not None and not current.is_empty:
            outs.append(_reset_row(current, ts))
            outs.append(current.with_types(CURRENT))
        self.last_emitted = current.copy() if current is not None else None
        if outs:
            self.send_next(EventChunk.concat(outs))

    def _on_timer(self, now: int):
        def run():
            self._emit_due(now)
            if self.next_emit is not None:
                self.app_ctx.scheduler.notify_at(self.next_emit,
                                                 self._on_timer)
        self._locked(run)

    def on_timer_event(self, ts: int):
        self._emit_due(ts)

    def current_state(self):
        s = super().current_state()
        s["next_emit"] = self.next_emit
        s["last_emitted"] = (_chunk_state(self.last_emitted)
                             if self.last_emitted is not None else None)
        return s

    def restore_state(self, state):
        super().restore_state(state)
        self.next_emit = state.get("next_emit")
        le = state.get("last_emitted")
        self.last_emitted = _chunk_restore(le, self.names) if le else None


class ExternalTimeBatchWindowProcessor(WindowProcessor):
    """Tumbling externalTimeBatch(ts_attr, t [, start])
    (reference ExternalTimeBatchWindowProcessor.java)."""

    def __init__(self, app_ctx, names, ts_expr: CompiledExpr, window_ms: int,
                 start_time: Optional[int] = None):
        super().__init__(app_ctx, names)
        self.ts_expr = ts_expr
        self.window_ms = window_ms
        self.start_time = start_time
        self.window_end: Optional[int] = None
        self.expired_batch: Optional[EventChunk] = None

    def on_data(self, chunk: EventChunk):
        ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
        etimes = np.asarray(self.ts_expr.fn(ctx), np.int64)
        outs = []
        for i in range(len(chunk)):
            t = int(etimes[i])
            if self.window_end is None:
                base = self.start_time if self.start_time is not None else t
                self.window_end = base + self.window_ms
            while t >= self.window_end:
                flushed = self._flush(self.window_end)
                if flushed is not None:
                    outs.append(flushed)
                self.window_end += self.window_ms
            row = chunk.slice(i, i + 1)
            self._buf_append(row)
        # one chunk per window flush (see LengthBatchWindowProcessor.on_data)
        for out in outs:
            out.is_batch = True
            self.send_next(out)

    def _flush(self, ts: int) -> Optional[EventChunk]:
        outs = []
        batch = self.buffer
        self.buffer = None
        if self.expired_batch is not None:
            outs.append(self.expired_batch.with_types(EXPIRED)
                        .with_timestamps(np.full(len(self.expired_batch), ts,
                                                 np.int64)))
        if batch is not None and not batch.is_empty:
            outs.append(_reset_row(batch, ts))
            outs.append(batch.with_types(CURRENT))
            self.expired_batch = batch
        if not outs:
            return None
        return EventChunk.concat(outs)


class TimeLengthWindowProcessor(WindowProcessor):
    """timeLength(t, n): sliding, bounded by both time and count
    (reference TimeLengthWindowProcessor.java)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, window_ms: int, length: int):
        super().__init__(app_ctx, names)
        self.window_ms = window_ms
        self.length = length

    def on_data(self, chunk: EventChunk):
        outs = []
        for i in range(len(chunk)):
            row = chunk.slice(i, i + 1)
            now = int(row.timestamps[0])
            ex_t = self._expire_time(now)
            if ex_t is not None:
                outs.append(ex_t)
            if self._buf_len() >= self.length:
                ex = self._buf_take_front(1)
                outs.append(ex.with_types(EXPIRED).with_timestamps(
                    np.asarray([now], np.int64)))
            self._buf_append(row)
            outs.append(row)
            self.app_ctx.scheduler.notify_at(now + self.window_ms,
                                             self._on_timer)
        self.send_next(EventChunk.concat(outs))

    def _expire_time(self, now: int) -> Optional[EventChunk]:
        if self.buffer is None or self.buffer.is_empty:
            return None
        cutoff = now - self.window_ms
        k = int(np.searchsorted(self.buffer.timestamps, cutoff, side="right"))
        if k <= 0:
            return None
        ex = self._buf_take_front(k)
        return ex.with_types(EXPIRED).with_timestamps(
            ex.timestamps + self.window_ms)

    def _on_timer(self, now: int):
        def run():
            ex = self._expire_time(now)
            if ex is not None and not ex.is_empty:
                self.send_next(ex)
        self._locked(run)

    def on_timer_event(self, ts: int):
        ex = self._expire_time(ts)
        if ex is not None and not ex.is_empty:
            self.send_next(ex)


# ===================================================================== batch

class BatchWindowProcessor(WindowProcessor):
    """batch(): each arriving chunk replaces the window; previous chunk expires
    (reference WindowBatchWindowProcessor / batch window)."""

    def on_data(self, chunk: EventChunk):
        outs = []
        ts = int(chunk.timestamps[-1])
        if self.buffer is not None and not self.buffer.is_empty:
            outs.append(self.buffer.with_types(EXPIRED)
                        .with_timestamps(np.full(self._buf_len(), ts,
                                                 np.int64)))
        outs.append(_reset_row(chunk, ts))
        outs.append(chunk.with_types(CURRENT))
        self.buffer = chunk.with_types(CURRENT)
        out = EventChunk.concat(outs)
        out.is_batch = True
        self.send_next(out)


# ===================================================================== session

@persistent_schema("window-session",
                   schema=Struct(sessions=MapOf("session")))
class SessionWindowProcessor(WindowProcessor):
    """session(gap [, key_attr [, allowedLatency]]): per-key session batches
    emitted as EXPIRED on gap timeout (reference SessionWindowProcessor)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, gap_ms: int,
                 key_expr: Optional[CompiledExpr] = None):
        super().__init__(app_ctx, names)
        self.gap_ms = gap_ms
        self.key_expr = key_expr
        self.sessions: Dict[object, List] = {}   # key -> [chunks, last_ts]

    def on_data(self, chunk: EventChunk):
        now = int(chunk.timestamps[-1])
        self._expire_sessions(now, emit=True)
        if self.key_expr is not None:
            ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
            keys = np.asarray(self.key_expr.fn(ctx))
        else:
            keys = np.full(len(chunk), "", object)
        for i in range(len(chunk)):
            k = keys[i].item() if hasattr(keys[i], "item") else keys[i]
            row = chunk.slice(i, i + 1)
            sess = self.sessions.setdefault(k, [[], 0])
            sess[0].append(row)
            sess[1] = int(row.timestamps[0])
        self.app_ctx.scheduler.notify_at(now + self.gap_ms, self._on_timer)
        self.send_next(chunk)

    def _expire_sessions(self, now: int, emit: bool):
        done = [k for k, (chunks, last) in self.sessions.items()
                if now - last >= self.gap_ms]
        outs = []
        for k in done:
            chunks, last = self.sessions.pop(k)
            ex = EventChunk.concat(chunks).with_types(EXPIRED)
            outs.append(ex.with_timestamps(
                np.full(len(ex), last + self.gap_ms, np.int64)))
        if outs and emit:
            self.send_next(EventChunk.concat(outs))
        elif outs:
            self.send_next(EventChunk.concat(outs))

    def _on_timer(self, now: int):
        self._locked(self._expire_sessions, now, True)

    def on_timer_event(self, ts: int):
        self._expire_sessions(ts, True)

    def current_state(self):
        return {"sessions": {repr(k): ([_chunk_state(c) for c in chunks], last)
                             for k, (chunks, last) in self.sessions.items()}}

    def restore_state(self, state):
        import ast
        self.sessions.clear()
        for k, (chunks, last) in state["sessions"].items():
            try:
                key = ast.literal_eval(k)
            except (ValueError, SyntaxError):
                key = k
            self.sessions[key] = [[_chunk_restore(c, self.names)
                                   for c in chunks], last]


# ===================================================================== sort

class SortWindowProcessor(WindowProcessor):
    """sort(n, attr [, 'asc'|'desc', attr2, ...]): keeps the top-n events by
    sort order; evicted extremum emitted EXPIRED (reference
    SortWindowProcessor.java)."""

    def __init__(self, app_ctx, names, length: int,
                 sort_keys: List[Tuple[CompiledExpr, bool]]):
        super().__init__(app_ctx, names)
        self.length = length
        self.sort_keys = sort_keys

    def on_data(self, chunk: EventChunk):
        outs = []
        for i in range(len(chunk)):
            row = chunk.slice(i, i + 1)
            self._buf_append(row)
            outs.append(row)
            if self._buf_len() > self.length:
                idx = self._sorted_indices()
                # evict the LAST element in sort order
                evict = int(idx[-1])
                ex = self.buffer.slice(evict, evict + 1)
                keep = np.concatenate([np.arange(evict),
                                       np.arange(evict + 1, self._buf_len())])
                self.buffer = self.buffer.take(keep)
                outs.append(ex.with_types(EXPIRED).with_timestamps(
                    row.timestamps))
        self.send_next(EventChunk.concat(outs))

    def _sorted_indices(self) -> np.ndarray:
        b = self.buffer
        ctx = EvalCtx(b.columns, b.timestamps, len(b))
        idx = np.arange(len(b))
        for ce, asc in reversed(self.sort_keys):
            col = np.asarray(ce.fn(ctx))
            order = np.argsort(col[idx], kind="stable")
            if not asc:
                order = order[::-1]
            idx = idx[order]
        return idx


# ===================================================================== frequent

@persistent_schema("window-frequent",
                   schema=Struct(counts=MapOf("int"),
                                 latest=MapOf("chunk")))
class FrequentWindowProcessor(WindowProcessor):
    """frequent(n [, attrs...]): Misra-Gries heavy hitters; evicted events
    emitted EXPIRED (reference FrequentWindowProcessor.java)."""

    def __init__(self, app_ctx, names, count: int,
                 key_exprs: List[CompiledExpr]):
        super().__init__(app_ctx, names)
        self.count = count
        self.key_exprs = key_exprs
        self.counts: Dict[object, int] = {}
        self.latest: Dict[object, EventChunk] = {}

    def _keys(self, chunk: EventChunk) -> List:
        if not self.key_exprs:
            return [tuple(chunk.row(i)[1]) for i in range(len(chunk))]
        ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
        cols = [np.asarray(ce.fn(ctx)) for ce in self.key_exprs]
        return [tuple(c[i].item() if hasattr(c[i], "item") else c[i]
                      for c in cols) for i in range(len(chunk))]

    def on_data(self, chunk: EventChunk):
        outs = []
        keys = self._keys(chunk)
        for i, k in enumerate(keys):
            row = chunk.slice(i, i + 1)
            if k in self.counts:
                self.counts[k] += 1
                self.latest[k] = row
                outs.append(row)
            elif len(self.counts) < self.count:
                self.counts[k] = 1
                self.latest[k] = row
                outs.append(row)
            else:
                # new key at capacity: decrement the resident keys, evict
                # zeros (EXPIRED); admit the new key only if space opened,
                # else drop the arriving event unemitted (reference
                # FrequentWindowProcessor.process)
                evicted = []
                for kk in list(self.counts):
                    self.counts[kk] -= 1
                    if self.counts[kk] <= 0:
                        del self.counts[kk]
                        ev = self.latest.pop(kk)
                        evicted.append(ev.with_types(EXPIRED)
                                       .with_timestamps(row.timestamps))
                outs.extend(evicted)
                if len(self.counts) < self.count:
                    self.counts[k] = 1
                    self.latest[k] = row
                    outs.append(row)
        self.send_next(EventChunk.concat(outs))

    def current_state(self):
        return {"counts": {repr(k): v for k, v in self.counts.items()},
                "latest": {repr(k): _chunk_state(v)
                           for k, v in self.latest.items()}}

    def restore_state(self, state):
        import ast
        self.counts = {}
        self.latest = {}
        for k, v in state["counts"].items():
            self.counts[ast.literal_eval(k)] = v
        for k, v in state["latest"].items():
            self.latest[ast.literal_eval(k)] = _chunk_restore(v, self.names)


class LossyFrequentWindowProcessor(FrequentWindowProcessor):
    """lossyFrequent(support [, error, attrs...]) — lossy counting
    (reference LossyFrequentWindowProcessor.java)."""

    def __init__(self, app_ctx, names, support: float, error: float,
                 key_exprs: List[CompiledExpr]):
        WindowProcessor.__init__(self, app_ctx, names)
        self.support = support
        self.error = error
        self.key_exprs = key_exprs
        self.counts: Dict[object, int] = {}
        self.deltas: Dict[object, int] = {}
        self.latest: Dict[object, EventChunk] = {}
        self.total = 0

    def on_data(self, chunk: EventChunk):
        outs = []
        keys = self._keys(chunk)
        width = int(np.ceil(1.0 / self.error)) if self.error > 0 else 1000
        for i, k in enumerate(keys):
            row = chunk.slice(i, i + 1)
            self.total += 1
            bucket = int(np.ceil(self.total / width))
            if k in self.counts:
                self.counts[k] += 1
            else:
                self.counts[k] = 1
                self.deltas[k] = bucket - 1
            self.latest[k] = row
            outs.append(row)
            if self.total % width == 0:
                for kk in list(self.counts):
                    if self.counts[kk] + self.deltas.get(kk, 0) <= bucket:
                        del self.counts[kk]
                        self.deltas.pop(kk, None)
                        ev = self.latest.pop(kk, None)
                        if ev is not None:
                            outs.append(ev.with_types(EXPIRED)
                                        .with_timestamps(row.timestamps))
        self.send_next(EventChunk.concat(outs))


# ===================================================================== delay

class DelayWindowProcessor(WindowProcessor):
    """delay(t): events re-emitted as CURRENT after t ms
    (reference DelayWindowProcessor.java)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, delay_ms: int):
        super().__init__(app_ctx, names)
        self.delay_ms = delay_ms

    def on_data(self, chunk: EventChunk):
        now = int(chunk.timestamps[-1])
        due = self._due(now)
        self._buf_append(chunk)
        self.app_ctx.scheduler.notify_at(now + self.delay_ms, self._on_timer)
        if due is not None and not due.is_empty:
            self.send_next(due)

    def _due(self, now: int) -> Optional[EventChunk]:
        if self.buffer is None or self.buffer.is_empty:
            return None
        cutoff = now - self.delay_ms
        k = int(np.searchsorted(self.buffer.timestamps, cutoff, side="right"))
        if k <= 0:
            return None
        out = self._buf_take_front(k)
        return out.with_types(CURRENT)

    def _on_timer(self, now: int):
        def run():
            due = self._due(now)
            if due is not None and not due.is_empty:
                self.send_next(due)
            if self._buf_len():
                self.app_ctx.scheduler.notify_at(
                    int(self.buffer.timestamps[0]) + self.delay_ms,
                    self._on_timer)
        self._locked(run)

    def on_timer_event(self, ts: int):
        due = self._due(ts)
        if due is not None and not due.is_empty:
            self.send_next(due)


# ===================================================================== cron

class CronWindowProcessor(WindowProcessor):
    """cron('expr'): emits the collected batch on each cron fire
    (reference CronWindowProcessor.java, Quartz-driven)."""

    requires_scheduler = True

    def __init__(self, app_ctx, names, cron_expr: str):
        super().__init__(app_ctx, names)
        from ..utils.cron import CronSchedule
        self.cron = CronSchedule(cron_expr)
        self.expired_batch: Optional[EventChunk] = None
        self._armed = False

    def on_data(self, chunk: EventChunk):
        self._buf_append(chunk)
        if not self._armed:
            self._armed = True
            nxt = self.cron.next_after(self.app_ctx.current_time())
            self.app_ctx.scheduler.notify_at(nxt, self._on_timer)

    def _on_timer(self, now: int):
        def run():
            outs = []
            batch = self.buffer
            self.buffer = None
            if self.expired_batch is not None:
                outs.append(self.expired_batch.with_types(EXPIRED)
                            .with_timestamps(np.full(len(self.expired_batch),
                                                     now, np.int64)))
            if batch is not None and not batch.is_empty:
                outs.append(batch.with_types(CURRENT))
                self.expired_batch = batch
            if outs:
                self.send_next(EventChunk.concat(outs))
            nxt = self.cron.next_after(now)
            self.app_ctx.scheduler.notify_at(nxt, self._on_timer)
        self._locked(run)


# ===================================================================== factory

def create_window_processor(name: str, params: List, app_ctx, names,
                            compile_expr, namespace: str = "",
                            extension_registry=None) -> WindowProcessor:
    """Factory mapping window names to processors.  `params` are query-api
    Expressions; `compile_expr` compiles one against the input scope.
    Namespaced (or unknown) names resolve through the extension registry
    (reference: SiddhiExtensionLoader window holders) — the registered
    class either subclasses WindowProcessor (instantiated as
    cls(app_ctx, names, params, compile_expr)) or provides a
    create(app_ctx, names, params, compile_expr) factory."""
    from ..query_api.expression import Constant, TimeConstant

    def _extension():
        if extension_registry is None:
            return None
        ext = extension_registry.find_window(namespace or "", name)
        if ext is None:
            return None
        # the registry is kind-unsegregated: only window-shaped classes
        # qualify, so a colliding function/source name falls through to
        # the proper "Unknown window type" error
        if hasattr(ext, "create"):
            return ext.create(app_ctx, names, params, compile_expr)
        if isinstance(ext, type) and issubclass(ext, WindowProcessor):
            return ext(app_ctx, names, params, compile_expr)
        return None

    if namespace:
        wp = _extension()
        if wp is None:
            raise SiddhiAppCreationError(
                f"Unknown window type '{namespace}:{name}'")
        return wp

    def const(i, default=None):
        if i >= len(params):
            return default
        p = params[i]
        if isinstance(p, Constant):
            return p.value
        raise SiddhiAppCreationError(
            f"window {name}: parameter {i} must be a constant")

    def time_ms(i, default=None):
        if i >= len(params):
            return default
        p = params[i]
        if isinstance(p, TimeConstant):
            return p.value
        if isinstance(p, Constant):
            return int(p.value)
        raise SiddhiAppCreationError(
            f"window {name}: parameter {i} must be a time constant")

    low = name.lower()
    if low == "length":
        return LengthWindowProcessor(app_ctx, names, int(const(0)))
    if low == "lengthbatch":
        return LengthBatchWindowProcessor(app_ctx, names, int(const(0)))
    if low == "time":
        return TimeWindowProcessor(app_ctx, names, time_ms(0))
    if low == "timebatch":
        return TimeBatchWindowProcessor(app_ctx, names, time_ms(0),
                                        const(1, None))
    if low == "timelength":
        return TimeLengthWindowProcessor(app_ctx, names, time_ms(0),
                                         int(const(1)))
    if low == "externaltime":
        return ExternalTimeWindowProcessor(app_ctx, names,
                                           compile_expr(params[0]),
                                           time_ms(1))
    if low == "externaltimebatch":
        return ExternalTimeBatchWindowProcessor(app_ctx, names,
                                                compile_expr(params[0]),
                                                time_ms(1), const(2, None))
    if low == "batch":
        return BatchWindowProcessor(app_ctx, names)
    if low == "session":
        key = compile_expr(params[1]) if len(params) > 1 else None
        return SessionWindowProcessor(app_ctx, names, time_ms(0), key)
    if low == "sort":
        n = int(const(0))
        keys: List[Tuple[CompiledExpr, bool]] = []
        i = 1
        while i < len(params):
            p = params[i]
            if isinstance(p, Constant) and isinstance(p.value, str) and \
                    p.value.lower() in ("asc", "desc"):
                if keys:
                    keys[-1] = (keys[-1][0], p.value.lower() == "asc")
            else:
                keys.append((compile_expr(p), True))
            i += 1
        return SortWindowProcessor(app_ctx, names, n, keys)
    if low == "frequent":
        key_exprs = [compile_expr(p) for p in params[1:]]
        return FrequentWindowProcessor(app_ctx, names, int(const(0)), key_exprs)
    if low == "lossyfrequent":
        support = float(const(0))
        error = float(const(1, support / 10.0))
        key_exprs = [compile_expr(p) for p in params[2:]]
        return LossyFrequentWindowProcessor(app_ctx, names, support, error,
                                            key_exprs)
    if low in ("hoping", "hopping"):
        return HopingWindowProcessor(app_ctx, names, time_ms(0), time_ms(1))
    if low == "delay":
        return DelayWindowProcessor(app_ctx, names, time_ms(0))
    if low == "cron":
        return CronWindowProcessor(app_ctx, names, str(const(0)))
    wp = _extension()
    if wp is not None:
        return wp
    raise SiddhiAppCreationError(f"Unknown window type '{name}'")
