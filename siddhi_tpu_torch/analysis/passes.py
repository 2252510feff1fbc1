"""Analyzer passes 2–5: unbounded state, retrace hazards, partition
safety, dead code & host-fallback prediction.

Each pass is a pure function over the query_api object model plus the
:class:`~siddhi_tpu_torch.analysis.scope.SymbolTable`; none of them imports
jax or touches the planner — the hazard checks *mirror* the planner's
and nfa_compiler's documented reject/grow conditions statically, so the
CLI can run them on a laptop with no accelerator stack.  (The one plan/
import, plan.select_compiler.classify_selection, is itself jax-free by
contract — it is the shared static gate, not the compiled plan.)

  * state_pass    — SA020 within-less `every`, SA021 PK-less table
                    append, SA022 windowless grouped aggregation
  * partition_pass— SA030/SA031 shared-state writes from inside a
                    `partition` block
  * perf_pass     — SP001 slot-ring recompile storms, SP002 keyed-lane
                    growth retraces, SP003 dynamic window params, SP010
                    host pins (mirrors plan/nfa_compiler._reject sites),
                    SP011 >2^24 integer compares on float32 lanes,
                    SP012 selection tail (having/order/limit) pinned to
                    the host QuerySelector with the blocking reason
  * deadcode_pass — SA040 unused streams, SA041 unused attributes
"""
from __future__ import annotations

from typing import List, Optional, Set

from ..query_api import Partition, Query, find_annotation
from ..query_api.definition import AttrType
from ..query_api.expression import (Compare, Constant, TimeConstant,
                                    Variable, walk)
from ..query_api.position import nearest_pos, pos_of
from ..query_api.query import (CountStateElement, EveryStateElement, Filter,
                               InsertIntoStream, JoinInputStream,
                               LogicalStateElement, NextStateElement,
                               SingleInputStream, StateInputStream,
                               StateType, StreamStateElement,
                               AbsentStreamStateElement, UpdateOrInsertStream,
                               UpdateStream, DeleteStream, WindowHandler)
from .diagnostics import DiagnosticSink
from .scope import SymbolTable, has_primary_key

_INT_EXACT_LIMIT = 1 << 24


def _flatten(el) -> List:
    out = []

    def rec(e):
        if isinstance(e, NextStateElement):
            rec(e.state)
            rec(e.next)
        else:
            out.append(e)
    if el is not None:
        rec(el)
    return out


def _has_aggregate(q: Query) -> bool:
    from ..core.aggregator import is_aggregator
    from ..query_api.expression import AttributeFunction
    exprs = [oa.expr for oa in q.selector.attributes]
    if q.selector.having is not None:
        exprs.append(q.selector.having)
    for e in exprs:
        for n in walk(e):
            if isinstance(n, AttributeFunction) and \
                    is_aggregator(n.namespace, n.name, len(n.args)):
                return True
    return False


# ================================================================== state

def state_pass(table: SymbolTable, q: Query, qname: Optional[str],
               sink: DiagnosticSink) -> None:
    ins = q.input_stream

    # ---- SA020: every-pattern with no within bound
    if isinstance(ins, StateInputStream) and ins.within_ms is None:
        for el in _flatten(ins.state):
            if isinstance(el, EveryStateElement) and el.within_ms is None:
                sink.emit(
                    "SA020",
                    "`every` pattern has no `within` bound — partial-"
                    "match state grows without limit",
                    pos=pos_of(el) or nearest_pos(ins.state), query=qname)
                break

    # ---- SA021: continuous append into a PK-less table
    out = q.output_stream
    if type(out) is InsertIntoStream and out.target_id in table.tables:
        td = table.tables[out.target_id]
        if not has_primary_key(td):
            sink.emit(
                "SA021",
                f"table '{out.target_id}' has no @PrimaryKey — this "
                f"query appends a row per event, growing the table "
                f"without bound",
                pos=pos_of(out) or pos_of(q), query=qname)

    # ---- SA022: windowless group-by aggregation over a live stream
    if isinstance(ins, SingleInputStream) and q.selector.group_by and \
            _has_aggregate(q):
        windowed = any(isinstance(h, WindowHandler) for h in ins.handlers)
        src_is_stream = ins.stream_id in table.streams and not ins.is_inner
        if not windowed and src_is_stream and \
                ins.stream_id not in table.windows:
            sink.emit(
                "SA022",
                f"group-by aggregation over '{ins.stream_id}' with no "
                f"window — one running aggregate per distinct key is "
                f"kept forever",
                pos=pos_of(ins) or pos_of(q), query=qname)


# ============================================================== partition

def partition_pass(table: SymbolTable, part: Partition, q: Query,
                   qname: Optional[str], sink: DiagnosticSink) -> None:
    out = q.output_stream
    if out is None or getattr(out, "is_inner", False):
        return
    writes = isinstance(out, (InsertIntoStream, UpdateStream,
                              UpdateOrInsertStream, DeleteStream)) and \
        type(out).__name__ != "ReturnStream"
    if not writes:
        return
    target = out.target_id
    if target in table.tables:
        sink.emit(
            "SA030",
            f"query inside partition writes table '{target}', which is "
            f"shared across all partition instances (cross-partition "
            f"write hazard)",
            pos=pos_of(out) or pos_of(q), query=qname)
    elif target in table.windows:
        sink.emit(
            "SA031",
            f"query inside partition inserts into named window "
            f"'{target}', which is shared across all partition instances",
            pos=pos_of(out) or pos_of(q), query=qname)


def shard_pass(table: SymbolTable, part: Partition, q: Query,
               qname: Optional[str], sink: DiagnosticSink) -> None:
    """SA080: partition queries the shard-out runtime must keep
    monolithic.  Mirrors the planner's shard-eligibility gates
    (plan/planner.py DevicePatternRuntime.__init__): absent (`not ...
    for`) deadline timers and on-device telemetry both aggregate the
    whole key space through ONE engine's carry, so SIDDHI_TPU_SHARDS is
    recorded-and-ignored for the query.  INFO severity — the monolithic
    path is correct, just single-device."""
    blocker = None
    ins = q.input_stream
    if isinstance(ins, StateInputStream):
        if any(isinstance(el, AbsentStreamStateElement)
               for el in _flatten(ins.state)):
            blocker = ("absent (`not ... for`) deadline timers arm off "
                       "one engine's carry")
    if blocker is None:
        ann = find_annotation(table.app.annotations, "app:statistics") or \
            find_annotation(table.app.annotations, "statistics")
        if ann is not None and \
                str(ann.get("telemetry", "false")).lower() == "true":
            blocker = "on-device telemetry aggregates one engine's planes"
    if blocker is not None:
        sink.emit(
            "SA080",
            f"partitioned query is not shardable: {blocker} — with "
            f"SIDDHI_TPU_SHARDS set the keyed runtime stays one "
            f"monolithic slab (reason is also recorded on the runtime's "
            f"shard_report)",
            pos=pos_of(q) or pos_of(part), query=qname)


# ==================================================================== perf

def perf_pass(table: SymbolTable, q: Query, qname: Optional[str],
              sink: DiagnosticSink, engine: str,
              in_partition: bool) -> None:
    ins = q.input_stream
    # (SP003 dynamic-window-param lives in analyzer._check_window_params,
    # which knows per-window which parameter positions must be constant)

    if engine == "host":
        return      # device hazards are moot when the app pins the host

    # ---- SP001: slot-ring growth ⇒ recompilation storm
    if isinstance(ins, StateInputStream) and ins.within_ms is None:
        for el in _flatten(ins.state):
            if isinstance(el, EveryStateElement) and el.within_ms is None:
                sink.emit(
                    "SP001",
                    "within-less `every` pattern on the device path: "
                    "live partials grow the NFA slot ring, and every "
                    "doubling re-JITs the step kernel (KernelProfiler "
                    "compile_count rises per doubling)",
                    pos=pos_of(el) or nearest_pos(ins.state), query=qname)
                break

    # ---- SP002: keyed lane growth (bounded retraces)
    if in_partition:
        sink.emit(
            "SP002",
            "partitioned device query: partition keys map to device "
            "lanes that double on demand; each doubling retraces the "
            "kernels (log2(keys) compiles while the key population "
            "ramps)",
            pos=pos_of(q), query=qname)

    # ---- SP010 host pins + SP011 int-precision, pattern shapes only
    if isinstance(ins, StateInputStream):
        _pattern_host_pins(ins, q, qname, sink)
        _int_precision(table, ins, qname, sink)

    # ---- SP012: selection tail (having/order/limit) stays on host.
    # Queries whose selection compiles to the device egress kernel emit
    # NOTHING here — the old blanket "having/order-by/limit are
    # host-only" rejection is gone (plan/select_compiler.py).
    if isinstance(ins, SingleInputStream):
        from ..plan.select_compiler import classify_selection
        d = table.app.stream_definitions.get(ins.stream_id)
        attr_types = {a.name: a.type for a in d.attributes} \
            if d is not None else {}
        dec = classify_selection(q, attr_types, in_partition=in_partition)
        if dec.active and not dec.device:
            sink.emit(
                "SP012",
                f"selection tail stays on the host QuerySelector: "
                f"{dec.reason} — group-by aggregation may still run on "
                f"device, but every emission pays a per-event host "
                f"selection pass",
                pos=pos_of(dec.node) or pos_of(q), query=qname)


def _single_streams(ins) -> List[SingleInputStream]:
    if isinstance(ins, SingleInputStream):
        return [ins]
    if isinstance(ins, JoinInputStream):
        return [ins.left, ins.right]
    if isinstance(ins, StateInputStream):
        out = []
        for el in _flatten(ins.state):
            for sub in _state_streams(el):
                out.append(sub)
        return out
    return []


def _state_streams(el) -> List[SingleInputStream]:
    if isinstance(el, StreamStateElement):
        return [el.stream] if el.stream is not None else []
    if isinstance(el, (EveryStateElement, CountStateElement)):
        return _state_streams(el.state) if el.state is not None else []
    if isinstance(el, LogicalStateElement):
        return _state_streams(el.state1) + _state_streams(el.state2)
    if isinstance(el, NextStateElement):
        return _state_streams(el.state) + _state_streams(el.next)
    return []


def _unit_kind(el) -> str:
    if isinstance(el, AbsentStreamStateElement):
        return "absent"
    if isinstance(el, CountStateElement):
        return "count"
    if isinstance(el, LogicalStateElement):
        return ("absent" if isinstance(el.state1, AbsentStreamStateElement)
                or isinstance(el.state2, AbsentStreamStateElement)
                else "logical")
    if isinstance(el, EveryStateElement):
        return "every"
    return "simple"


def _pattern_host_pins(sis: StateInputStream, q: Query,
                       qname: Optional[str], sink: DiagnosticSink) -> None:
    """Statically mirror plan/nfa_compiler's reject sites: each hit means
    the planner will fall back to the host oracle (correct but slow)."""

    def pin(reason: str, node=None):
        sink.emit("SP010",
                  f"query will run on the host oracle: {reason}",
                  pos=(pos_of(node) if node is not None else None)
                  or pos_of(q), query=qname)

    sel = q.selector
    if sel.group_by or sel.having is not None or sel.order_by or \
            sel.limit is not None or sel.offset is not None:
        pin("group-by/having/order-by/limit on a pattern query is "
            "host-only")

    elements = _flatten(sis.state)
    kinds = [_unit_kind(el) for el in elements]

    # nested every
    for el in elements:
        if isinstance(el, EveryStateElement):
            if any(isinstance(s, EveryStateElement)
                   for s in _flatten(el.state)):
                pin("nested `every` is host-only", el)
            inner_kinds = [_unit_kind(s) for s in _flatten(el.state)]
            is_mid_or_tail = el is not elements[0]
            if is_mid_or_tail and el.within_ms is not None:
                pin("`within` on a mid-chain/trailing `every` group is "
                    "host-only", el)
            if is_mid_or_tail and any(k not in ("simple", "logical")
                                      for k in inner_kinds):
                pin("a mid-chain/trailing `every` group supports "
                    "simple/logical conditions only", el)

    for j in range(len(kinds) - 1):
        if kinds[j] == "count" and kinds[j + 1] == "count":
            pin("consecutive kleene counts are host-only", elements[j])
        if kinds[j] == "count" and kinds[j + 1] == "absent":
            pin("a kleene count directly before `not` is host-only",
                elements[j])

    if sis.state_type == StateType.SEQUENCE:
        if kinds and kinds[0] == "absent":
            pin("leading absent states in a sequence are host-only",
                elements[0])
        if kinds and kinds[0] == "count" and \
                isinstance(elements[0], CountStateElement):
            c0 = elements[0]
            if c0.min_count < 2 and sis.within_ms is not None:
                pin("`within` on a SEQUENCE leading kleene is host-only",
                    c0)
            if len(kinds) >= 2 and kinds[1] in ("absent", "logical"):
                pin("a SEQUENCE leading kleene directly before an "
                    "absent/logical unit is host-only", c0)


def _int_precision(table: SymbolTable, sis: StateInputStream,
                   qname: Optional[str], sink: DiagnosticSink) -> None:
    """SP011: pattern filters comparing int/long attrs above 2^24."""
    for s in _single_streams(sis):
        d = table.source_definition(s.stream_id)
        if d is None:
            continue
        int_attrs = {a.name for a in d.attributes
                     if a.type in (AttrType.INT, AttrType.LONG)}
        for h in s.handlers:
            if not isinstance(h, Filter):
                continue
            for n in walk(h.expr):
                if not isinstance(n, Compare):
                    continue
                sides = (n.left, n.right)
                has_int = any(isinstance(x, Variable)
                              and x.attribute in int_attrs for x in sides)
                big = any(isinstance(x, Constant)
                          and not isinstance(x, TimeConstant)
                          and isinstance(x.value, (int, float))
                          and abs(x.value) > _INT_EXACT_LIMIT
                          for x in sides)
                if has_int and big:
                    sink.emit(
                        "SP011",
                        f"pattern filter compares an int/long attribute "
                        f"of '{s.stream_id}' above 2^24 — float32 "
                        f"capture lanes need an exact-integer companion "
                        f"lane (extra state) or a host pin",
                        pos=nearest_pos(n) or pos_of(h), query=qname)


# ================================================================ deadcode

def deadcode_pass(table: SymbolTable, insert_targets: Set[str],
                  sink: DiagnosticSink) -> None:
    for sid, d in table.app.stream_definitions.items():
        has_io = any(find_annotation(d.annotations, n) is not None
                     for n in ("source", "sink", "export"))
        if has_io:
            continue
        if sid not in table.used_streams and sid not in insert_targets:
            sink.emit(
                "SA040",
                f"stream '{sid}' is defined but never read or written by "
                f"any query",
                pos=pos_of(d))
            continue
        if sid in table.whole_stream_use or sid in insert_targets:
            continue
        if sid not in table.used_streams:
            continue
        for a in d.attributes:
            if (sid, a.name) not in table.used_attrs:
                sink.emit(
                    "SA041",
                    f"attribute '{a.name}' of stream '{sid}' is never "
                    f"referenced",
                    pos=pos_of(a) or pos_of(d))
