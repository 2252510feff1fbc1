"""Name resolution for the semantic analyzer.

Builds the app-level symbol table (streams, tables, named windows,
triggers, aggregations, plus stream definitions *inferred* from insert
targets — the runtime auto-creates those junctions, so the analyzer must
know them too), and per-query scopes that map ``[stream_id.]attribute``
references to :class:`~siddhi_tpu_torch.query_api.definition.AttrType`.

Mirrors plan/expr_compiler.Scope's resolution order — unqualified unique
match across streams, alias support, pattern-ref indexing — but is pure
(no getters, no compilation) and *reports* instead of raising, so a
single analyze() run surfaces every problem at once.

Usage marks collected here feed the dead-code pass: every successful
resolve records (stream_id, attribute).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..query_api import (Partition, Query, SiddhiApp, SingleInputStream,
                         find_annotation)
from ..query_api.definition import (AbstractDefinition, Attribute, AttrType,
                                    StreamDefinition)
from ..query_api.expression import Variable
from ..query_api.position import nearest_pos, pos_of
from ..query_api.query import (InputStream, JoinInputStream,
                               StateInputStream)
from .diagnostics import DiagnosticSink


class SymbolTable:
    """App-wide view of every addressable source and its schema."""

    def __init__(self, app: SiddhiApp):
        self.app = app
        self.streams: Dict[str, AbstractDefinition] = dict(
            app.stream_definitions)
        self.tables: Dict[str, AbstractDefinition] = dict(
            app.table_definitions)
        self.windows: Dict[str, AbstractDefinition] = dict(
            app.window_definitions)
        self.aggregations: Set[str] = set(app.aggregation_definitions)
        # trigger streams carry a single long attribute
        for tid in app.trigger_definitions:
            d = StreamDefinition(tid)
            d.attribute("triggered_time", AttrType.LONG)
            self.streams.setdefault(tid, d)
        # inner streams (#Name) are scoped per partition block
        self.inner: Dict[int, Dict[str, AbstractDefinition]] = {}
        # streams whose schema the analyzer could not infer (select * over
        # joins/patterns, opaque selectors): existence known, attrs not
        self.opaque: Set[str] = set()
        # dead-code marks
        self.used_streams: Set[str] = set()
        self.used_attrs: Set[Tuple[str, str]] = set()
        self.whole_stream_use: Set[str] = set()   # select * / positional use

    # ------------------------------------------------------------ lookups

    def source_definition(self, sid: str,
                          partition: Optional[Partition] = None,
                          is_inner: bool = False
                          ) -> Optional[AbstractDefinition]:
        if is_inner and partition is not None:
            return self.inner.get(id(partition), {}).get(sid)
        for m in (self.streams, self.windows, self.tables):
            if sid in m:
                return m[sid]
        return None

    def knows(self, sid: str) -> bool:
        return (sid in self.streams or sid in self.tables
                or sid in self.windows or sid in self.aggregations
                or sid in self.opaque)

    def mark_used(self, sid: str, attr: Optional[str] = None):
        self.used_streams.add(sid)
        if attr is not None:
            self.used_attrs.add((sid, attr))

    def mark_whole(self, sid: str):
        self.used_streams.add(sid)
        self.whole_stream_use.add(sid)


class QueryScope:
    """Attribute resolution environment for one query's expressions."""

    def __init__(self, table: SymbolTable, sink: DiagnosticSink,
                 query_name: Optional[str] = None):
        self.table = table
        self.sink = sink
        self.query_name = query_name
        # stream_id/alias -> (canonical stream id, definition)
        self.bindings: Dict[str, Tuple[str, AbstractDefinition]] = {}
        self.order: List[str] = []           # binding insertion order

    def bind(self, name: str, canonical: str, d: AbstractDefinition):
        if name and name not in self.bindings:
            self.bindings[name] = (canonical, d)
            self.order.append(name)

    def bind_stream(self, s: SingleInputStream,
                    partition: Optional[Partition] = None) -> bool:
        """Bind a SingleInputStream (with alias) — False if unresolvable."""
        d = self.table.source_definition(s.stream_id, partition, s.is_inner)
        if d is None and not s.is_inner and \
                s.stream_id in self.table.aggregations:
            # aggregation join sources: schema is period-dependent; treat
            # as opaque but known
            self.table.mark_used(s.stream_id)
            self.bind(s.stream_id, s.stream_id, StreamDefinition(s.stream_id))
            self.table.opaque.add(s.stream_id)
            if s.stream_ref:
                self.bind(s.stream_ref, s.stream_id,
                          StreamDefinition(s.stream_id))
            return True
        if d is None:
            label = ("#" if s.is_inner else "") + s.stream_id
            self.sink.emit(
                "SA001", f"unknown stream/table/window '{label}'",
                pos=pos_of(s), query=self.query_name)
            return False
        self.table.mark_used(s.stream_id)
        self.bind(s.stream_id, s.stream_id, d)
        if s.stream_ref:
            self.bind(s.stream_ref, s.stream_id, d)
        return True

    # ------------------------------------------------------------ resolve

    def resolve(self, var: Variable) -> Optional[AttrType]:
        """Type of an attribute reference; emits SA001/SA002/SA003 and
        returns None when unresolvable."""
        opaque = self.table.opaque
        if var.stream_id is not None:
            b = self.bindings.get(var.stream_id)
            if b is None:
                # qualified ref to a table used in `update ... on` etc.
                d = self.table.source_definition(var.stream_id)
                if d is None:
                    self.sink.emit(
                        "SA001",
                        f"unknown stream reference '{var.stream_id}' in "
                        f"'{var.stream_id}.{var.attribute}'",
                        pos=pos_of(var), query=self.query_name)
                    return None
                b = (var.stream_id, d)
            sid, d = b
            if sid in opaque:
                self.table.mark_used(sid)
                return AttrType.OBJECT
            t = _attr_type(d, var.attribute)
            if t is None:
                self.sink.emit(
                    "SA002",
                    f"'{d.id}' has no attribute '{var.attribute}' "
                    f"(has: {', '.join(d.attribute_names)})",
                    pos=pos_of(var), query=self.query_name)
                return None
            self.table.mark_used(sid, var.attribute)
            return t
        # unqualified: unique match across bindings
        hits: List[Tuple[str, AttrType]] = []
        seen_ids: Set[str] = set()
        for name in self.order:
            sid, d = self.bindings[name]
            if sid in seen_ids:
                continue
            seen_ids.add(sid)
            if sid in opaque:
                continue
            t = _attr_type(d, var.attribute)
            if t is not None:
                hits.append((sid, t))
        if len(hits) == 1:
            self.table.mark_used(hits[0][0], var.attribute)
            return hits[0][1]
        if len(hits) > 1:
            self.sink.emit(
                "SA003",
                f"ambiguous attribute '{var.attribute}' (matches "
                f"{', '.join(sorted(s for s, _ in hits))})",
                pos=pos_of(var), query=self.query_name)
            return None
        if any(sid in opaque for sid, _ in
               (self.bindings[n] for n in self.order)):
            return AttrType.OBJECT      # can't judge against opaque scope
        self.sink.emit(
            "SA002",
            f"cannot resolve attribute '{var.attribute}' in scope "
            f"({', '.join(sorted(seen_ids)) or 'empty'})",
            pos=pos_of(var), query=self.query_name)
        return None


def _attr_type(d: AbstractDefinition, name: str) -> Optional[AttrType]:
    for a in d.attributes:
        if a.name == name:
            return a.type
    return None


# ---------------------------------------------------------------- builders

def scope_for_input(table: SymbolTable, q: Query, sink: DiagnosticSink,
                    qname: Optional[str],
                    partition: Optional[Partition] = None) -> QueryScope:
    """Build the resolution scope for a query's input side."""
    scope = QueryScope(table, sink, qname)
    ins = q.input_stream
    _bind_input(scope, ins, partition)
    return scope


def _bind_input(scope: QueryScope, ins: InputStream,
                partition: Optional[Partition]):
    if isinstance(ins, SingleInputStream):
        scope.bind_stream(ins, partition)
    elif isinstance(ins, JoinInputStream):
        scope.bind_stream(ins.left, partition)
        scope.bind_stream(ins.right, partition)
    elif isinstance(ins, StateInputStream):
        for el in _stream_states(ins):
            s = el.stream
            d = scope.table.source_definition(s.stream_id, partition,
                                              s.is_inner)
            if d is None:
                scope.sink.emit(
                    "SA001", f"unknown stream '{s.stream_id}' in pattern",
                    pos=pos_of(s) or nearest_pos(el),
                    query=scope.query_name)
                continue
            scope.table.mark_used(s.stream_id)
            scope.bind(s.stream_id, s.stream_id, d)
            if s.stream_ref:
                scope.bind(s.stream_ref, s.stream_id, d)


def _stream_states(sis: StateInputStream):
    """Every StreamStateElement in a pattern tree."""
    from ..query_api.query import (CountStateElement, EveryStateElement,
                                   LogicalStateElement, NextStateElement,
                                   StreamStateElement)
    out = []

    def rec(el):
        if isinstance(el, StreamStateElement):
            out.append(el)
        elif isinstance(el, NextStateElement):
            rec(el.state)
            rec(el.next)
        elif isinstance(el, EveryStateElement):
            rec(el.state)
        elif isinstance(el, LogicalStateElement):
            rec(el.state1)
            rec(el.state2)
        elif isinstance(el, CountStateElement):
            rec(el.state)
    if sis.state is not None:
        rec(sis.state)
    return out


def has_primary_key(d: AbstractDefinition) -> bool:
    ann = find_annotation(d.annotations, "primarykey")
    return ann is not None and bool(ann.positional())
