"""On-demand (store) query runtimes.

(reference: util/parser/StoreQueryParser.java + core/query/
{Find,Select,Insert,Update,Delete,UpdateOrInsert}StoreQueryRuntime.java —
synchronous pull queries over tables / named windows / aggregations.)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..plan.expr_compiler import EvalCtx, ExprCompiler, Scope
from ..query_api.query import InsertIntoStream, StoreQuery, StoreQueryType
from ..utils.errors import StoreQueryCreationError
from .event import CURRENT, Event, EventChunk
from .selector import QuerySelector


class _Collector:
    def __init__(self):
        self.chunks: List[EventChunk] = []

    def process(self, chunk: EventChunk):
        self.chunks.append(chunk)


class StoreQueryRuntime:
    def __init__(self, sq: StoreQuery, app_runtime):
        self.sq = sq
        self.app = app_runtime

    def _factory(self):
        app = self.app
        return lambda scope: ExprCompiler(
            scope, np, app.app_ctx.script_functions, app.extension_registry)

    def _source(self):
        sid = self.sq.input_store.store_id
        if self.app.has_table(sid):
            return "table", self.app.table_of(sid)
        if self.app.has_named_window(sid):
            return "window", self.app.named_window_of(sid)
        if sid in self.app.aggregations:
            return "aggregation", self.app.aggregations[sid]
        raise StoreQueryCreationError(f"No table/window/aggregation '{sid}'")

    def execute(self) -> Optional[List[Event]]:
        sq = self.sq
        if sq.type == StoreQueryType.INSERT and sq.input_store is None:
            return self._insert()
        kind, src = self._source()
        if kind == "table":
            definition = src.definition
            cond = src.compile_condition(sq.input_store.on, None,
                                         self._factory())
            if sq.type == StoreQueryType.FIND and \
                    getattr(src, "supports_query", False):
                pushed = self._try_query_pushdown(src, cond)
                if pushed is not None:
                    return pushed
            chunk = src.find(cond)
        elif kind == "window":
            definition = src.definition
            chunk = src.find_chunk()
            if chunk is None:
                chunk = EventChunk.empty(definition.attribute_names)
            chunk = self._apply_on(chunk, definition)
        else:  # aggregation: within/per bucket materialisation
            definition = src.output_definition
            chunk = src.find_chunk(sq.input_store.within, sq.input_store.per)
            chunk = self._apply_on(chunk, definition)

        if sq.type == StoreQueryType.FIND:
            return self._select(chunk, definition)
        if sq.type == StoreQueryType.DELETE:
            if kind != "table":
                raise StoreQueryCreationError("delete needs a table")
            out = sq.output_stream
            cc = src.compile_condition(out.on, None, self._factory())
            one = EventChunk.empty([])
            probe = EventChunk(
                [], np.asarray([self.app.app_ctx.current_time()], np.int64),
                np.zeros(1, np.int8), {})
            src.delete(probe, cc)
            return None
        if sq.type in (StoreQueryType.UPDATE, StoreQueryType.UPDATE_OR_INSERT):
            raise StoreQueryCreationError(
                "update store queries: use a query with `update TableName`")
        if sq.type == StoreQueryType.INSERT:
            return self._insert()
        return None

    def _try_query_pushdown(self, table, cond) -> Optional[List[Event]]:
        """Selection pushdown to a queryable record table (reference:
        AbstractQueryableRecordTable.query + StoreQueryParser's
        CompiledSelection path).  Returns None if the selector doesn't
        translate — the caller falls back to host-side selection."""
        from ..utils.errors import SiddhiAppCreationError
        try:
            selection = table.compile_selection(self.sq.selector,
                                                self._factory())
        except SiddhiAppCreationError:
            return None
        rows = table.query(cond, selection)
        names = [n for n, _ in selection.select]
        now = self.app.app_ctx.current_time()
        return [Event(now, [r.get(n) for n in names]) for r in rows]

    def _apply_on(self, chunk: EventChunk, definition) -> EventChunk:
        on = self.sq.input_store.on
        if on is None or chunk.is_empty:
            return chunk
        scope = Scope()
        scope.add_primary(definition.id, self.sq.input_store.store_ref,
                          definition)
        ce = self._factory()(scope).compile(on)
        ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
        m = np.asarray(ce.fn(ctx), bool)
        if m.ndim == 0:
            m = np.full(len(chunk), bool(m))
        return chunk.mask(m)

    def _select(self, chunk: EventChunk, definition) -> List[Event]:
        scope = Scope()
        scope.add_primary(definition.id, self.sq.input_store.store_ref
                          if self.sq.input_store else None, definition)
        sel = QuerySelector(self.sq.selector, scope, definition,
                            self._factory(), output_id="store")
        collector = _Collector()
        sel.next = collector
        # a pull query sees the table as one closed batch: group-by
        # aggregates summarize to one row per group (reference
        # SelectStoreQueryRuntime semantics — and what a queryable record
        # store's native GROUP BY pushdown returns)
        snapshot = chunk.with_types(CURRENT)
        snapshot.is_batch = True
        sel.process(snapshot)
        if not collector.chunks:
            return []
        return EventChunk.concat(collector.chunks).to_events()

    def _insert(self) -> None:
        """`select <literals> insert into Table` form."""
        out = self.sq.output_stream
        if not isinstance(out, InsertIntoStream) or \
                not self.app.has_table(out.target_id):
            raise StoreQueryCreationError("insert store query needs a table")
        table = self.app.table_of(out.target_id)
        scope = Scope()
        compiler = self._factory()(scope)
        now = self.app.app_ctx.current_time()
        cols = {}
        names = []
        ctx = EvalCtx({}, np.asarray([now], np.int64), 1)
        for oa, attr in zip(self.sq.selector.attributes,
                            table.definition.attributes):
            ce = compiler.compile(oa.expr)
            v = ce.fn(ctx)
            arr = np.asarray([v]) if not isinstance(v, np.ndarray) or \
                v.ndim == 0 else v
            if attr.type.name in ("STRING", "OBJECT"):
                a = np.empty(1, object)
                a[0] = arr.reshape(-1)[0] if isinstance(arr, np.ndarray) \
                    else arr
                arr = a
            cols[attr.name] = arr
            names.append(attr.name)
        chunk = EventChunk(names, np.asarray([now], np.int64),
                           np.zeros(1, np.int8), cols)
        table.insert(chunk)
        return None
