"""Output rate limiting.

(reference: query/output/ratelimit/** — 19 classes: pass-through, per-event-
count first/last/all (+ group-by variants), per-time-window first/last/all
(+ group-by), and snapshot re-emission.)

Implemented as one processor per strategy sitting between QuerySelector and the
output callback.  Time-based limiters register with the app Scheduler; in
playback mode virtual time drives the flushes deterministically.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..query_api.query import OutputRate, OutputRateType
from .event import CURRENT, EXPIRED, EventChunk
from .processor import Processor


class PassThroughRateLimiter(Processor):
    def process(self, chunk: EventChunk):
        self.send_next(chunk)


class _EventCountLimiter(Processor):
    """`output {all|first|last} every N events`."""

    def __init__(self, n: int, mode: str, group_by_names: Optional[List[str]]):
        super().__init__()
        self.n = n
        self.mode = mode
        self.group_by_names = group_by_names or []
        self.counter = 0
        self.pending: List[EventChunk] = []
        self.last_per_group: Dict[Tuple, Tuple[EventChunk, int]] = {}

    def process(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        if self.mode == "all":
            self.pending.append(chunk)
            self.counter += len(chunk)
            if self.counter >= self.n:
                out = EventChunk.concat(self.pending)
                self.pending = []
                self.counter = 0
                self.send_next(out)
            return
        # first / last need per-event window positions
        for i in range(len(chunk)):
            row = chunk.slice(i, i + 1)
            pos = self.counter % self.n
            if self.mode == "first":
                if pos == 0:
                    if self.group_by_names:
                        key = self._key(chunk, i)
                        self.send_next(row)
                    else:
                        self.send_next(row)
                elif self.group_by_names:
                    key = self._key(chunk, i)
                    if key not in self.last_per_group:
                        self.last_per_group[key] = (row, self.counter)
                        self.send_next(row)
            else:  # last
                if self.group_by_names:
                    self.last_per_group[self._key(chunk, i)] = (row, self.counter)
                else:
                    self.last_per_group[()] = (row, self.counter)
            self.counter += 1
            if self.counter % self.n == 0:
                if self.mode == "last":
                    for (r, _) in self.last_per_group.values():
                        self.send_next(r)
                self.last_per_group.clear()

    def _key(self, chunk: EventChunk, i: int) -> Tuple:
        return tuple(chunk.columns[g][i] for g in self.group_by_names
                     if g in chunk.columns)


class _TimeLimiter(Processor):
    """`output {all|first|last} every T` — flush on scheduler ticks."""

    def __init__(self, ms: int, mode: str, app_ctx,
                 group_by_names: Optional[List[str]]):
        super().__init__()
        self.ms = ms
        self.mode = mode
        self.app_ctx = app_ctx
        self.group_by_names = group_by_names or []
        self.pending: List[EventChunk] = []
        self.first_sent: Dict[Tuple, bool] = {}
        self.last_rows: Dict[Tuple, EventChunk] = {}
        self._armed = False

    def _arm(self, now: int):
        if not self._armed:
            self._armed = True
            self.app_ctx.scheduler.notify_at(now + self.ms, self._flush)

    def process(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        now = int(chunk.timestamps[-1])
        if self.mode == "all":
            self.pending.append(chunk)
        elif self.mode == "first":
            for i in range(len(chunk)):
                key = self._key(chunk, i)
                if not self.first_sent.get(key):
                    self.first_sent[key] = True
                    self.send_next(chunk.slice(i, i + 1))
        else:  # last
            for i in range(len(chunk)):
                self.last_rows[self._key(chunk, i)] = chunk.slice(i, i + 1)
        self._arm(now)

    def _key(self, chunk, i):
        return tuple(chunk.columns[g][i] for g in self.group_by_names
                     if g in chunk.columns)

    def _flush(self, now: int):
        self._armed = False
        if self.mode == "all" and self.pending:
            out = EventChunk.concat(self.pending)
            self.pending = []
            self.send_next(out)
        elif self.mode == "first":
            self.first_sent.clear()
        elif self.mode == "last" and self.last_rows:
            rows = list(self.last_rows.values())
            self.last_rows.clear()
            self.send_next(EventChunk.concat(rows))
        # re-arm only when new events arrive (reference keeps a running timer;
        # arming lazily avoids idle wakeups)


class SnapshotRateLimiter(Processor):
    """`output snapshot every T`.

    Reference dispatch (ratelimit/snapshot/WrappedSnapshotOutputRateLimiter
    .java:86-125): windowed query WITHOUT aggregators re-emits the full
    current window contents each tick (WindowedPerSnapshotOutputRateLimiter
    .java:75-104 — CURRENT adds, EXPIRED removes the first equal event, RESET
    clears); queries with aggregators (or no window) re-emit the latest value
    per group-by key (GroupByPerSnapshotOutputRateLimiter / PerSnapshot…)."""

    def __init__(self, ms: int, app_ctx, group_by_names: Optional[List[str]],
                 windowed: bool = False, has_aggregates: bool = True):
        super().__init__()
        self.ms = ms
        self.app_ctx = app_ctx
        self.group_by_names = group_by_names or []
        self.window_mode = windowed and not has_aggregates
        self.snapshot: Dict[Tuple, EventChunk] = {}
        self.window_events: List[EventChunk] = []   # single-row chunks
        self._armed = False

    @staticmethod
    def _row_key(chunk: EventChunk, i: int) -> Tuple:
        return tuple(np.asarray(chunk.columns[c][i]).item()
                     for c in sorted(chunk.columns))

    def process(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        if self.window_mode:
            # the QuerySelector upstream masks chunks to CURRENT|EXPIRED, so
            # window tracking needs only add/remove (batch windows clear via
            # their per-row EXPIRED emission, never via RESET)
            for i in range(len(chunk)):
                t = chunk.types[i]
                if t == CURRENT:
                    self.window_events.append(chunk.slice(i, i + 1))
                elif t == EXPIRED:
                    key = self._row_key(chunk, i)
                    for j, row in enumerate(self.window_events):
                        if self._row_key(row, 0) == key:
                            del self.window_events[j]
                            break
        else:
            cur = chunk.only(CURRENT)
            for i in range(len(cur)):
                key = tuple(cur.columns[g][i] for g in self.group_by_names
                            if g in cur.columns)
                self.snapshot[key] = cur.slice(i, i + 1)
        now = int(chunk.timestamps[-1])
        if not self._armed:
            self._armed = True
            self.app_ctx.scheduler.notify_at(now + self.ms, self._tick)

    def _tick(self, now: int):
        rows = self.window_events if self.window_mode \
            else list(self.snapshot.values())
        if rows:
            out = EventChunk.concat(list(rows))
            out = out.with_timestamps(np.full(len(out), now, np.int64))
            self.send_next(out)
            self.app_ctx.scheduler.notify_at(now + self.ms, self._tick)
        else:
            self._armed = False


def build_rate_limiter(rate: Optional[OutputRate], app_ctx,
                       group_by_names: Optional[List[str]],
                       windowed: bool = False,
                       has_aggregates: bool = True) -> Processor:
    if rate is None:
        return PassThroughRateLimiter()
    mode = {OutputRateType.ALL: "all", OutputRateType.FIRST: "first",
            OutputRateType.LAST: "last"}.get(rate.type, "all")
    if rate.type == OutputRateType.SNAPSHOT:
        return SnapshotRateLimiter(rate.every_ms, app_ctx, group_by_names,
                                   windowed, has_aggregates)
    if rate.every_events is not None:
        return _EventCountLimiter(rate.every_events, mode, group_by_names)
    return _TimeLimiter(rate.every_ms, mode, app_ctx, group_by_names)
