"""Pattern & sequence state-machine runtime — host oracle path.

This is the exact-semantics CEP pattern engine the TPU NFA kernel is
conformance-tested against (see plan/nfa_compiler.py + ops/nfa.py for the
batched TPU path).

Reference behavior mirrored from siddhi-core
query/input/stream/state/:
  - StreamPreStateProcessor.java:292-337 (pending-list stepping, within expiry,
    PATTERN vs SEQUENCE no-match handling)
  - StreamPostStateProcessor.java:53-72 (state advance, every re-arm)
  - LogicalPreStateProcessor.java / LogicalPostStateProcessor.java (and/or
    partner-linked pairs sharing partial-match objects)
  - CountPreStateProcessor.java / CountPostStateProcessor.java (kleene
    <m:n> accumulation into one partial, forward-at-min)
  - AbsentStreamPreStateProcessor.java / AbsentLogicalPreStateProcessor.java
    (scheduler-driven `not X for t`)
  - receiver/* + StateStreamRuntime.resetAndUpdate (per-event update/reset
    barriers; SEQUENCE strict contiguity)
and util/parser/StateInputStreamParser.java:76-404 (state graph wiring:
`->` next links, `every` loops, logical partners, within start-state ids).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx, Scope
from ..query_api import (AbsentStreamStateElement, CountStateElement,
                         EveryStateElement, Filter, LogicalOp,
                         LogicalStateElement, NextStateElement,
                         StateInputStream, StateType, StreamStateElement)
from ..query_api.definition import Attribute, StreamDefinition
from ..utils.errors import SiddhiAppCreationError
from .event import CURRENT, EventChunk
from .stateschema import ListOf, Struct, persistent_schema

Row = Tuple[int, Dict[str, Any]]  # (timestamp, {attr: python value})

_UNSET = -0x7FFFFFFF


class StateEvent:
    """A partial match: one slot per state unit (reference
    event/state/StateEvent.java — StreamEvent[] streamEvents).

    Slot contents: None (not matched), a Row, or a list of Rows for count
    states.  Objects are shared between partner/next pending lists exactly
    like the reference shares StateEvent instances."""

    __slots__ = ("events", "timestamp")

    def __init__(self, n_states: int):
        self.events: List[Any] = [None] * n_states
        self.timestamp: int = -1

    def clone(self) -> "StateEvent":
        se = StateEvent(len(self.events))
        se.timestamp = self.timestamp
        se.events = [list(e) if isinstance(e, list) else e
                     for e in self.events]
        return se

    def first_row(self, sid: int) -> Optional[Row]:
        e = self.events[sid]
        if e is None:
            return None
        if isinstance(e, list):
            return e[0] if e else None
        return e

    def last_row(self, sid: int) -> Optional[Row]:
        e = self.events[sid]
        if e is None:
            return None
        if isinstance(e, list):
            return e[-1] if e else None
        return e


class StateUnit:
    """One pattern condition = pre+post state processor pair fused.

    (reference: Stream/Logical/Count/Absent Pre+PostStateProcessor pairs)"""

    def __init__(self, engine: "StateStreamRuntime", state_id: int, ref: str,
                 stream_id: str, definition, state_type: StateType):
        self.engine = engine
        self.state_id = state_id
        self.ref = ref
        self.stream_id = stream_id
        self.definition = definition
        self.state_type = state_type

        self.filter: Optional[CompiledExpr] = None
        self.is_start = False
        self.is_last = False
        self.within_ms: Optional[int] = None
        self.start_state_ids: List[int] = []

        # wiring (reference post-processor links)
        self.next_pre: Optional["StateUnit"] = None
        self.next_every_pre: Optional["StateUnit"] = None
        self.within_every_pre: Optional["StateUnit"] = None

        # count (kleene) configuration
        self.is_count = False
        self.min_count = 1
        self.max_count = 1

        # logical pair configuration
        self.logical_op: Optional[LogicalOp] = None
        self.partner: Optional["StateUnit"] = None

        # absent configuration
        self.is_absent = False
        self.waiting_ms: Optional[int] = None
        self.active = True
        self.last_scheduled = -1
        self.last_arrival = 0

        # runtime state
        self.pending: List[StateEvent] = []
        self.new_list: List[StateEvent] = []
        self.initialized = False
        self.state_changed = False

    # ------------------------------------------------------------ pre side

    def init_start(self):
        """reference StreamPreStateProcessor.init():162-173"""
        if self.is_start and (
                not self.initialized or self.next_every_pre is not None or
                (self.state_type == StateType.SEQUENCE and
                 self.next_pre is not None and self.next_pre.is_absent)):
            self.add_state(StateEvent(self.engine.n_states))
            self.initialized = True

    def add_state(self, se: StateEvent):
        """reference addState :203-216 (+Logical :18-35, +Absent, +Count min0)"""
        if self.is_absent and not self.active:
            return
        if self.logical_op is not None:
            if self.is_start or self.state_type == StateType.SEQUENCE:
                if not self.new_list:
                    self.new_list.append(se)
                if self.partner is not None and not self.partner.new_list:
                    self.partner.new_list.append(se)
            else:
                self.new_list.append(se)
                if self.partner is not None:
                    self.partner.new_list.append(se)
            if self.is_absent and not self.is_start and \
                    self.waiting_ms is not None:
                self._schedule(se.timestamp + self.waiting_ms)
                if self.partner is not None and self.partner.is_absent and \
                        self.partner.waiting_ms is not None:
                    self.partner._schedule(se.timestamp +
                                           self.partner.waiting_ms)
            return
        if self.is_absent and self.state_type == StateType.SEQUENCE:
            self.new_list.clear()
            self.new_list.append(se)
        elif self.state_type == StateType.SEQUENCE:
            if not self.new_list:
                self.new_list.append(se)
        else:
            self.new_list.append(se)
        if self.is_absent and not self.is_start:
            self.last_scheduled = se.timestamp + (self.waiting_ms or 0)
            self._schedule(self.last_scheduled)
        if self.is_count and self.min_count == 0 and \
                se.events[self.state_id] is None:
            # <0:n> — zero occurrences already satisfy (CountPreStateProcessor
            # addState min==0 branch)
            self._min_count_reached(se)

    def add_every_state(self, se: StateEvent):
        """reference addEveryState — clone for the every re-arm."""
        cl = se.clone()
        if self.logical_op is not None:
            if cl.events[self.state_id] is not None:
                row = cl.last_row(self.state_id)
                if row is not None:
                    cl.timestamp = row[0]
            cl.events[self.state_id] = None
            if self.partner is not None:
                cl.events[self.partner.state_id] = None
                self.partner.new_list.append(cl)
            self.new_list.append(cl)
            if self.is_absent and self.waiting_ms is not None:
                self.last_scheduled = (self.engine.now() + self.waiting_ms
                                       if cl.timestamp < 0
                                       else cl.timestamp + self.waiting_ms)
                self._schedule(self.last_scheduled)
            return
        self.new_list.append(cl)
        if self.is_absent:
            self.last_scheduled = se.timestamp + (self.waiting_ms or 0)
            self._schedule(self.last_scheduled)

    def update_state(self):
        self.pending.extend(self.new_list)
        self.new_list.clear()
        if self.logical_op is not None and self.partner is not None:
            self.partner.pending.extend(self.partner.new_list)
            self.partner.new_list.clear()

    def reset_state(self):
        """reference resetState — SEQUENCE per-event strictness barrier."""
        if self.logical_op is not None and self.partner is not None:
            if self.logical_op == LogicalOp.OR or \
                    len(self.pending) == len(self.partner.pending):
                self.pending.clear()
                self.partner.pending.clear()
                if self.is_start and not self.new_list:
                    if self._seq_next_busy():
                        return
                    self.init_start()
            return
        self.pending.clear()
        if self.is_start and not self.new_list:
            if self._seq_next_busy():
                return
            self.init_start()

    def _seq_next_busy(self) -> bool:
        return (self.state_type == StateType.SEQUENCE and
                self.next_every_pre is None and
                self.next_pre is not None and bool(self.next_pre.pending))

    def _expired(self, se: StateEvent, now: int) -> bool:
        """reference isExpired :104-113 — within vs start-state timestamps."""
        if self.is_start or self.within_ms is None:
            return False
        for sid in self.start_state_ids:
            row = se.first_row(sid)
            if row is not None and abs(row[0] - now) > self.within_ms:
                return True
        return False

    # ------------------------------------------------------------ stepping

    def process_and_return(self, row: Row):
        """Step all pending partials over one arriving event
        (reference processAndReturn :292-337)."""
        if self.is_absent and not self.active:
            return
        ts = row[0]
        kept: List[StateEvent] = []
        for se in self.pending:
            if self._expired(se, ts):
                # forward the expired partial to the every-group head
                # EXCEPT when that head is this very unit: the reference
                # would then addEveryState into the LinkedList it is
                # iterating (StreamPreStateProcessor.java:298-306 +
                # updateState :280-288 → ConcurrentModificationException),
                # i.e. the self-forward path is broken/unreachable
                # upstream — here the partial simply dies, matching the
                # device kernel's within-expiry (`A -> every B within t`
                # stops firing t after the chain start).  Forwards to a
                # DIFFERENT head (multi-unit groups, leading groups) keep
                # reference behavior.
                if self.within_every_pre is not None and \
                        self.within_every_pre is not self:
                    self.within_every_pre.add_every_state(se)
                    self.within_every_pre.update_state()
                continue
            if self.logical_op == LogicalOp.OR and self.partner is not None \
                    and se.events[self.partner.state_id] is not None:
                continue  # partner already satisfied this partial
            if self.is_count:
                if self._count_next_processed(se):
                    continue
                lst = se.events[self.state_id]
                if not isinstance(lst, list):
                    lst = []
                    se.events[self.state_id] = lst
                lst.append(row)
                self.state_changed = False
                success = False
                if self._filter_pass(se, row):
                    self._fire_count_post(se, row)
                    success = True
                if not success:
                    lst.pop()
                    if self.state_type == StateType.SEQUENCE:
                        continue  # drop partial
                if not self.state_changed:
                    kept.append(se)
                continue
            # normal / logical / absent unit
            se.events[self.state_id] = row
            self.state_changed = False
            if self._filter_pass(se, row):
                self._fire_post(se, row)
            if self.state_changed:
                continue  # advanced (or consumed) — leaves this pending list
            se.events[self.state_id] = None
            if self.state_type == StateType.SEQUENCE:
                if not (self.is_absent or self.logical_op is not None):
                    continue  # strict sequence: no match → drop partial
                kept.append(se)
            else:
                kept.append(se)
        self.pending = kept

    def _count_next_processed(self, se: StateEvent) -> bool:
        """reference removeIfNextStateProcessed — stop accumulating once a
        later state captured its event."""
        for off in (1, 2):
            pos = self.state_id + off
            if pos < len(se.events) and se.events[pos] is not None:
                return True
        return False

    def _filter_pass(self, se: StateEvent, row: Row) -> bool:
        if self.filter is None:
            return True
        ts, data = row
        cols = {k: v for k, v in data.items()}
        ctx = EvalCtx(cols, np.asarray([ts], np.int64), 1,
                      qualified=self.engine.qualified_of(se),
                      tables=self.engine.tables)
        v = self.filter.fn(ctx)
        arr = np.asarray(v).reshape(-1)
        return bool(arr[0]) if arr.size else bool(v)

    # ------------------------------------------------------------ post side

    def _fire_post(self, se: StateEvent, row: Row):
        """reference StreamPostStateProcessor.process :53-72 and
        Logical/Absent variants."""
        self.state_changed = True
        se.timestamp = row[0]
        if self.is_absent:
            # actual arrival of a `not` stream: kills/poisons the partial,
            # never advances (AbsentStream/AbsentLogical PostStateProcessor)
            self.last_arrival = row[0]
            if self.logical_op is None and self.is_start and \
                    self.next_every_pre is self:
                self.add_every_state(se)
            return
        if self.logical_op == LogicalOp.AND and self.partner is not None:
            can = (se.events[self.partner.state_id] is not None
                   if not self.partner.is_absent
                   else self.partner._partner_can_proceed(se))
            if not can:
                return  # stateChanged only; partner side still pending
        self._forward(se)

    def _partner_can_proceed(self, se: StateEvent) -> bool:
        """reference AbsentLogicalPreStateProcessor.partnerCanProceed."""
        if self.state_type == StateType.SEQUENCE and \
                self.next_every_pre is None and self.last_arrival > 0:
            return False
        if self.waiting_ms is None:
            if self.next_every_pre is None:
                return se.events[self.state_id] is None
            if self.last_arrival > 0:
                self.last_arrival = 0
                self.init_start()
                return False
            return True
        return se.events[self.state_id] is not None

    def _forward(self, se: StateEvent):
        if self.is_last:
            self.engine.collect_match(se)
        if self.next_pre is not None:
            self.next_pre.add_state(se)
        if self.next_every_pre is not None:
            self.next_every_pre.add_every_state(se)

    def _fire_count_post(self, se: StateEvent, row: Row):
        """reference CountPostStateProcessor.process."""
        cnt = len(se.events[self.state_id])
        se.timestamp = row[0]
        if cnt >= self.min_count:
            if self.state_type == StateType.SEQUENCE:
                # reference CountPostStateProcessor.process SEQUENCE branch:
                # forward + self re-add only — no every clone (sequences
                # restart via per-event start re-init)
                if self.is_last:
                    self.engine.collect_match(se)
                if self.next_pre is not None:
                    self.next_pre.add_state(se)
                if cnt != self.max_count:
                    self.add_state(se)
            elif cnt == self.min_count:
                self._min_count_reached(se)
            if cnt == self.max_count:
                self.state_changed = True

    def _min_count_reached(self, se: StateEvent):
        """reference CountPostStateProcessor.processMinCountReached."""
        if self.is_last:
            self.state_changed = True
            self.engine.collect_match(se)
        if self.next_pre is not None:
            self.next_pre.add_state(se)
        if self.next_every_pre is not None:
            self.next_every_pre.add_every_state(se)

    # ------------------------------------------------------------ absent timer

    def _schedule(self, ts: int):
        if ts < 0:
            return
        self.engine.schedule(ts, self)

    def start(self):
        """Arm start-state absent timers (reference
        AbsentStreamPreStateProcessor.start)."""
        if self.is_absent and self.is_start and self.waiting_ms is not None \
                and self.active:
            self.last_scheduled = self.engine.now() + self.waiting_ms
            self._schedule(self.last_scheduled)

    def absent_tick(self, now: int):
        """Timer wakeup (reference AbsentStreamPreStateProcessor.process and
        AbsentLogicalPreStateProcessor.process)."""
        if not self.active or self.waiting_ms is None:
            return
        if self.logical_op is not None:
            self._absent_logical_tick(now)
            return
        initialize = (self.is_start and not self.new_list and not self.pending)
        if initialize and self.state_type == StateType.SEQUENCE and \
                self.next_every_pre is None and self.last_scheduled > 0 and \
                self.initialized:
            initialize = False
        if initialize:
            se = StateEvent(self.engine.n_states)
            self.add_state(se)
            self.initialized = True
        elif self.state_type == StateType.SEQUENCE and self.new_list:
            self.reset_state()
        self.update_state()
        fired: List[StateEvent] = []
        kept: List[StateEvent] = []
        for se in self.pending:
            if self._expired(se, now):
                if self.within_every_pre is not None and \
                        self.next_every_pre is not self:
                    self.next_every_pre_or_within().add_every_state(se)
                    self.next_every_pre_or_within().update_state()
                continue
            if (se.timestamp == -1 and now >= self.last_scheduled) or \
                    (se.timestamp != -1 and
                     now >= se.timestamp + self.waiting_ms):
                se.timestamp = now
                fired.append(se)
                continue
            kept.append(se)
        self.pending = kept
        for se in fired:
            self._forward_absent(se)
        actual_now = self.engine.now()
        if actual_now > self.waiting_ms + now:
            self.last_scheduled = actual_now + self.waiting_ms
        if not fired and self.last_scheduled < now:
            self.last_scheduled = now + self.waiting_ms
            self._schedule(self.last_scheduled)

    def next_every_pre_or_within(self):
        return self.within_every_pre or self.next_every_pre

    def _absent_logical_tick(self, now: int):
        if now < self.last_arrival + self.waiting_ms:
            if self.next_every_pre is not None or self.is_start:
                self._schedule(self.last_arrival + self.waiting_ms)
            return
        if self.is_start and self.state_type == StateType.SEQUENCE and \
                not self.new_list and not self.pending:
            self.add_state(StateEvent(self.engine.n_states))
        elif self.state_type == StateType.SEQUENCE and self.new_list:
            self.reset_state()
        self.update_state()
        fired: List[StateEvent] = []
        kept: List[StateEvent] = []
        partner = self.partner
        for se in self.pending:
            if self._expired(se, now):
                # self-forward would mutate the list under iteration —
                # see process_and_return
                if self.within_every_pre is not None and \
                        self.within_every_pre is not self:
                    self.within_every_pre.add_every_state(se)
                    self.within_every_pre.update_state()
                continue
            passed = (now >= se.timestamp + self.waiting_ms
                      if se.events[self.state_id] is None else
                      now >= se.events[self.state_id][0] + self.waiting_ms) \
                if se.timestamp != -1 else now >= self.last_scheduled
            if passed:
                if self.logical_op == LogicalOp.OR and \
                        se.events[partner.state_id] is None:
                    se.events[self.state_id] = (now, {})
                    fired.append(se)
                    continue
                if self.logical_op == LogicalOp.AND and \
                        se.events[partner.state_id] is not None:
                    fired.append(se)
                    continue
                if self.logical_op == LogicalOp.AND and \
                        se.events[partner.state_id] is None:
                    se.events[self.state_id] = (now, {})
                    kept.append(se)
                    continue
            kept.append(se)
        self.pending = kept
        for se in fired:
            se.timestamp = now
            self._forward_absent(se)
        arrival = self.last_arrival
        self.last_arrival = 0
        if self.next_every_pre is not None or (not fired and self.is_start):
            nxt = (self.engine.now() + self.waiting_ms if arrival == 0
                   else arrival + self.waiting_ms)
            self._schedule(nxt)

    def _forward_absent(self, se: StateEvent):
        """reference sendEvent — absence confirmed, advance."""
        if self.is_last:
            self.engine.collect_match(se)
            self.engine.flush_matches()
        if self.next_pre is not None:
            self.next_pre.add_state(se)
            self.next_pre.update_state()
        if self.next_every_pre is not None:
            self.next_every_pre.add_every_state(se)
            self.next_every_pre.update_state()
        elif self.is_start and self.logical_op is None:
            self.active = False

    # ------------------------------------------------------------ snapshot

    def unit_state(self, enc) -> dict:
        return {"pending": [enc(se) for se in self.pending],
                "new": [enc(se) for se in self.new_list],
                "initialized": self.initialized,
                "active": self.active,
                "last_scheduled": self.last_scheduled,
                "last_arrival": self.last_arrival}

    def restore_unit_state(self, s: dict, dec):
        self.pending = [dec(x) for x in s["pending"]]
        self.new_list = [dec(x) for x in s["new"]]
        self.initialized = s["initialized"]
        self.active = s["active"]
        self.last_scheduled = s["last_scheduled"]
        self.last_arrival = s["last_arrival"]


class PatternReceiver:
    """Junction subscriber feeding one stream's events into the NFA
    (reference receiver/Pattern*|Sequence* ProcessStreamReceiver)."""

    def __init__(self, engine: "StateStreamRuntime", stream_id: str,
                 units: List[StateUnit]):
        self.engine = engine
        self.stream_id = stream_id
        # later states step first (reference reversed eventSequence)
        self.units = list(reversed(units))

    def receive_chunk(self, chunk: EventChunk):
        names = chunk.names
        with self.engine.lock:
            for i in range(len(chunk)):
                if chunk.types[i] != CURRENT:
                    continue
                ts = int(chunk.timestamps[i])
                data = {n: _py(chunk.columns[n][i]) for n in names}
                self.engine.process_event(self, (ts, data))


@persistent_schema("host-pattern",
                   schema=Struct(store=ListOf("state-event"),
                                 units=ListOf("unit-state")))
class StateStreamRuntime:
    """Compiled pattern/sequence input runtime for one query.

    Builds the state-unit graph from the StateElement tree
    (≙ StateInputStreamParser), subscribes per-stream receivers, and emits
    matched partials into the query's selector chain."""

    def __init__(self, query_runtime, sis: StateInputStream, factory):
        self.qr = query_runtime
        self.sis = sis
        self.app = query_runtime.app_runtime
        self.lock = query_runtime.lock
        self.state_type = sis.state_type
        self.units: List[StateUnit] = []
        self.tables = {tid: t for tid, t in self.app.tables.items()}
        self._matches: List[StateEvent] = []
        self._stream_units: Dict[str, List[StateUnit]] = {}
        self._refs_by_unit: Dict[int, str] = {}

        first, last, starts = self._build(sis.state, is_start=True)
        self.first_unit = first
        # mark last pair for emission
        last.is_last = True
        if last.logical_op is not None and last.partner is not None:
            last.partner.is_last = True
        self.n_states = len(self.units)
        for u in self.units:
            u.pending = []
        # top-level within
        if sis.within_ms is not None:
            start_ids = [u.state_id for u in self.units if u.is_start]
            for u in self.units:
                if u.within_ms is None:
                    u.within_ms = sis.within_ms
                if not u.start_state_ids:
                    u.start_state_ids = start_ids
        # compile per-unit filters now that all units exist
        self._compile_filters(factory)
        # selector scope + output definition
        scope, union_def = self._selector_scope()
        query_runtime._finish_chain([], scope, union_def, factory)
        self.selector_head = query_runtime._chain_head([])
        # receivers (one per distinct stream id)
        for stream_id, units in self._stream_units.items():
            recv = PatternReceiver(self, stream_id, units)
            junction = self.app.junction_of(stream_id)
            junction.subscribe(recv)
            query_runtime.receivers[stream_id] = recv
        # arm start states
        for u in self.units:
            u.init_start()

    # ------------------------------------------------------------ build

    def _new_unit(self, el: StreamStateElement) -> StateUnit:
        s = el.stream
        definition = self.app.definition_of(s.stream_id)
        sid = len(self.units)
        ref = s.stream_ref or f"__state_{sid}"
        unit = StateUnit(self, sid, ref, s.stream_id, definition,
                         self.state_type)
        if isinstance(el, AbsentStreamStateElement):
            unit.is_absent = True
            unit.waiting_ms = el.waiting_time_ms
        self.units.append(unit)
        self._stream_units.setdefault(s.stream_id, []).append(unit)
        unit._handlers = s.handlers  # compiled later
        return unit

    def _build(self, el, is_start: bool):
        """Recursive state-graph builder (≙ StateInputStreamParser.parse).
        Returns (first_unit, last_unit, start_units)."""
        if isinstance(el, StreamStateElement):  # includes Absent
            u = self._new_unit(el)
            u.is_start = is_start
            return u, u, [u]
        if isinstance(el, NextStateElement):
            f1, l1, s1 = self._build(el.state, is_start)
            f2, l2, s2 = self._build(el.next, False)
            l1.next_pre = f2
            if l1.logical_op is not None and l1.partner is not None:
                l1.partner.next_pre = f2
            return f1, l2, s1
        if isinstance(el, EveryStateElement):
            f, l, starts = self._build(el.state, is_start)
            l.next_every_pre = f
            if l.logical_op is not None and l.partner is not None:
                l.partner.next_every_pre = f
            group = self._subtree_units(el.state)
            for u in group:
                u.within_every_pre = f
            if el.within_ms is not None:
                self._apply_within(group, el.within_ms, starts)
            return f, l, starts
        if isinstance(el, LogicalStateElement):
            # element2 parsed first in the reference → lower state id
            u2 = self._new_unit(el.state2)
            u1 = self._new_unit(el.state1)
            for u, other in ((u1, u2), (u2, u1)):
                u.logical_op = el.op
                u.partner = other
                u.is_start = is_start
            return u1, u2, [u1, u2]
        if isinstance(el, CountStateElement):
            u = self._new_unit(el.state)
            u.is_count = True
            u.is_start = is_start
            u.min_count = el.min_count
            u.max_count = (el.max_count if el.max_count !=
                           CountStateElement.ANY else 0x7FFFFFFF)
            return u, u, [u]
        raise SiddhiAppCreationError(f"Unsupported state element {el!r}")

    def _subtree_units(self, el) -> List[StateUnit]:
        refs: List[StateUnit] = []

        def rec(e):
            if isinstance(e, StreamStateElement):
                refs.extend(u for u in self.units
                            if u.stream_id == e.stream.stream_id and
                            u._handlers is e.stream.handlers)
            elif isinstance(e, NextStateElement):
                rec(e.state)
                rec(e.next)
            elif isinstance(e, EveryStateElement):
                rec(e.state)
            elif isinstance(e, LogicalStateElement):
                rec(e.state1)
                rec(e.state2)
            elif isinstance(e, CountStateElement):
                rec(e.state)
        rec(el)
        return refs

    def _apply_within(self, units: List[StateUnit], within_ms: int,
                      starts: List[StateUnit]):
        ids = [u.state_id for u in starts]
        for u in units:
            if u.within_ms is None:
                u.within_ms = within_ms
                u.start_state_ids = ids

    # -------------------------------------------------- expression scopes

    def _index_range_used(self) -> Tuple[int, int]:
        """(highest, lowest) e1[i] index mentioned anywhere in the query
        (lowest covers `e1[last-N]` → -1-N; one extra for the self-state
        shift below)."""
        from ..query_api.expression import Variable
        hi, lo = 4, -3

        def scan(e):
            nonlocal hi, lo
            if isinstance(e, Variable) and e.stream_index is not None:
                if e.stream_index >= 0:
                    hi = max(hi, e.stream_index)
                else:
                    lo = min(lo, e.stream_index - 1)
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                if isinstance(v, list):
                    for x in v:
                        scan(x) if hasattr(x, "__dataclass_fields__") else None
                elif hasattr(v, "__dataclass_fields__"):
                    scan(v)
        q = self.qr.query
        for oa in q.selector.attributes:
            scan(oa.expr)
        if q.selector.having is not None:
            scan(q.selector.having)
        for u in self.units:
            for h in u._handlers:
                if isinstance(h, Filter):
                    scan(h.expr)
        return hi, lo

    def _register_qualified(self, scope: Scope, skip_unit=None,
                            max_idx: int = 4, min_idx: int = -3,
                            self_unit=None):
        """self_unit: inside a state's own condition, negative indexes
        exclude the just-appended candidate event — the reference keeps the
        raw LAST index for same-state references instead of shifting it to
        the chain tail (ExpressionParser.java:1366, StateEvent.java:158)."""
        stream_count: Dict[str, int] = {}
        for u in self.units:
            stream_count[u.stream_id] = stream_count.get(u.stream_id, 0) + 1
        for u in self.units:
            if u is skip_unit:
                continue
            qualifiers = [u.ref]
            if stream_count[u.stream_id] == 1 and u.stream_id != u.ref:
                qualifiers.append(u.stream_id)
            idxs = list(range(0, max_idx + 1)) + \
                list(range(-1, min_idx - 1, -1))
            for a in u.definition.attributes:
                for q in qualifiers:
                    for i in idxs:
                        eff = i - 1 if (u is self_unit and i < 0) else i
                        def g(ctx, _q=q, _i=eff, _a=a.name):
                            d = ctx.qualified.get((_q, _i))
                            if d is None:
                                return np.asarray([None], object)
                            return d.get(_a)
                        scope.add(q, a.name, a.type, g, index=i)

    def _compile_filters(self, factory):
        max_idx, min_idx = self._index_range_used()
        self._max_idx = max_idx
        self._min_idx = min_idx
        for u in self.units:
            filters = [h for h in u._handlers if isinstance(h, Filter)]
            others = [h for h in u._handlers if not isinstance(h, Filter)]
            if others:
                raise SiddhiAppCreationError(
                    "Only [filter] handlers are supported inside "
                    "pattern/sequence conditions")
            if not filters:
                u.filter = None
                continue
            scope = Scope()
            self._register_qualified(scope, skip_unit=None, max_idx=max_idx,
                                     min_idx=min_idx, self_unit=u)
            # current-event bindings override for this unit (added last)
            for a in u.definition.attributes:
                def g(ctx, _a=a.name):
                    return ctx.columns[_a]
                scope.add(None, a.name, a.type, g)
                scope.add(u.stream_id, a.name, a.type, g)
                scope.add(u.ref, a.name, a.type, g)
            compiler = factory(scope)
            from ..query_api.expression import And
            expr = filters[0].expr
            for f in filters[1:]:
                expr = And(expr, f.expr)
            u.filter = compiler.compile(expr)

    def _selector_scope(self):
        scope = Scope()
        max_idx = getattr(self, "_max_idx", 4)
        min_idx = getattr(self, "_min_idx", -3)
        self._register_qualified(scope, max_idx=max_idx, min_idx=min_idx)
        # unqualified fallback: first unit defining each attribute
        seen: Dict[str, StateUnit] = {}
        union_attrs: List[Attribute] = []
        for u in self.units:
            for a in u.definition.attributes:
                if a.name not in seen:
                    seen[a.name] = u
                    union_attrs.append(a)
                    def g(ctx, _q=u.ref, _a=a.name):
                        d = ctx.qualified.get((_q, 0))
                        if d is None:
                            return np.asarray([None], object)
                        return d.get(_a)
                    scope.add(None, a.name, a.type, g)
        union_def = StreamDefinition("__pattern", union_attrs)
        return scope, union_def

    # ------------------------------------------------------------ runtime

    def now(self) -> int:
        return self.app.app_ctx.timestamp_generator.current_time()

    def schedule(self, ts: int, unit: StateUnit):
        def fire(now, _u=unit):
            with self.lock:
                _u.absent_tick(now)
                self.flush_matches()
        self.app.app_ctx.scheduler.notify_at(ts, fire)

    def start(self):
        for u in self.units:
            u.start()

    def process_event(self, receiver: PatternReceiver, row: Row):
        # stabilize (reference stabilizeStates)
        if self.state_type == StateType.SEQUENCE:
            for u in reversed(self.units):
                u.reset_state()
            for u in self.units:
                u.update_state()
        else:
            for u in receiver.units:
                u.update_state()
        for u in receiver.units:
            u.process_and_return(row)
            self.flush_matches()

    def collect_match(self, se: StateEvent):
        self._matches.append(se)

    def flush_matches(self):
        if not self._matches:
            return
        matches, self._matches = self._matches, []
        for se in matches:
            self.selector_head.process(self._match_chunk(se))

    def qualified_of(self, se: StateEvent) -> Dict:
        q: Dict = {}
        for u in self.units:
            e = se.events[u.state_id]
            qualifiers = [u.ref]
            if u.stream_id not in [x.stream_id for x in self.units
                                   if x is not u]:
                qualifiers.append(u.stream_id)
            rows = e if isinstance(e, list) else ([e] if e is not None else [])
            min_idx = getattr(self, "_min_idx", -3) - 1
            for name in qualifiers:
                # a duplicated reference resolves to the FIRST unit carrying
                # it (reference position lookup breaks at the first
                # meta-stream hit, ExpressionParser.java parseVariable)
                for i, row in enumerate(rows):
                    if (name, i) not in q:
                        q[(name, i)] = row[1]
                n = len(rows)
                for neg in range(-1, min_idx - 1, -1):
                    if n + neg >= 0 and (name, neg) not in q:
                        q[(name, neg)] = rows[n + neg][1]
        return q

    def _match_chunk(self, se: StateEvent) -> EventChunk:
        qualified = {}
        for key, data in self.qualified_of(se).items():
            qualified[key] = {k: _col1(v) for k, v in data.items()}
        ts = se.timestamp if se.timestamp >= 0 else self.now()
        chunk = EventChunk([], np.asarray([ts], np.int64),
                           np.asarray([CURRENT], np.int8), {})
        chunk.qualified = qualified
        return chunk

    # ------------------------------------------------------------ snapshot

    def current_state(self):
        seen: Dict[int, int] = {}
        store: List[dict] = []

        def enc(se: StateEvent):
            key = id(se)
            if key in seen:
                return {"ref": seen[key]}
            n = len(store)
            seen[key] = n
            store.append({"ts": se.timestamp,
                          "events": [list(e) if isinstance(e, list) else e
                                     for e in se.events]})
            return {"ref": n}
        units = [u.unit_state(enc) for u in self.units]
        return {"store": store, "units": units}

    def restore_state(self, state):
        objs: List[StateEvent] = []
        for rec in state["store"]:
            se = StateEvent(self.n_states)
            se.timestamp = rec["ts"]
            se.events = [list(e) if isinstance(e, list) else
                         (tuple(e) if isinstance(e, tuple) else e)
                         for e in rec["events"]]
            se.events = [_fix_rows(e) for e in se.events]
            objs.append(se)

        def dec(x):
            return objs[x["ref"]]
        for u, s in zip(self.units, state["units"]):
            u.restore_unit_state(s, dec)


def _fix_rows(e):
    if e is None:
        return None
    if isinstance(e, list):
        out = []
        for r in e:
            if isinstance(r, (list, tuple)) and len(r) == 2 and \
                    isinstance(r[1], dict):
                out.append((r[0], r[1]))
            else:
                out.append(r)
        return out
    if isinstance(e, (list, tuple)) and len(e) == 2 and isinstance(e[1], dict):
        return (e[0], e[1])
    return e


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _col1(v) -> np.ndarray:
    """One-element column preserving python-object payloads."""
    if v is None or isinstance(v, (str, bytes, dict, list, set)):
        out = np.empty(1, object)
        out[0] = v
        return out
    return np.asarray([v])
