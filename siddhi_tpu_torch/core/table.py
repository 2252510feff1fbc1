"""In-memory tables with primary-key / index support and compiled conditions.

(reference: table/InMemoryTable.java + table/holder/{List,Index}EventHolder
(@PrimaryKey/@Index hash indexes), compiled-condition planning in
util/parser/CollectionExpressionParser.java + util/collection/executor/* —
index-scan vs exhaustive-scan plans, and table/record/* SPI for external
stores.)

Columnar design: rows live in numpy columns; a condition is compiled once into
a vectorised program evaluated over all table rows per probing stream event,
with a hash-index fast path when the condition is `table.pk == <stream expr>`.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx, Scope
from ..query_api.annotation import find_annotation
from ..query_api.definition import TableDefinition
from ..query_api.expression import (And, Compare, CompareOp, Expression,
                                    Variable)
from .event import EventChunk
from .stateschema import ListOf, MapOf, Struct, persistent_schema

STREAM_QUAL = "__stream__"


class CompiledTableCondition:
    """Compiled `on` condition: vectorised over table rows, with per-stream-row
    scalar bindings; equality fast paths on the primary key or on a secondary
    `@Index` attribute (reference: CollectionExpressionParser's index-scan vs
    exhaustive-scan CollectionExecutor plans, util/collection/executor/*)."""

    def __init__(self, fn: Optional[CompiledExpr],
                 pk_probe: Optional[List[Tuple[str, CompiledExpr]]] = None,
                 index_probe: Optional[Tuple[str, CompiledExpr]] = None):
        self.fn = fn
        self.pk_probe = pk_probe       # [(table_attr, stream_value_expr)]
        # (indexed_attr, stream_value_expr): hash-probe candidates, then
        # evaluate `fn` over the candidate subset only
        self.index_probe = index_probe


class CompiledSetUpdate:
    def __init__(self, assignments: List[Tuple[str, CompiledExpr]]):
        self.assignments = assignments


@persistent_schema("table",
                   schema=Struct(columns=MapOf("column"),
                                 timestamps=ListOf("int")))
class InMemoryTable:
    def __init__(self, definition: TableDefinition):
        self.definition = definition
        self.names = definition.attribute_names
        self.columns: Dict[str, list] = {n: [] for n in self.names}
        self.timestamps: List[int] = []
        self.lock = threading.RLock()
        pk_ann = find_annotation(definition.annotations, "primarykey")
        self.primary_key: List[str] = pk_ann.positional() if pk_ann else []
        idx_ann = find_annotation(definition.annotations, "index")
        self.index_attrs: List[str] = idx_ann.positional() if idx_ann else []
        self._pk_index: Dict[Tuple, int] = {}
        self._indexes: Dict[str, Dict[Any, List[int]]] = {
            a: {} for a in self.index_attrs}
        self._cols_cache: Optional[Dict[str, np.ndarray]] = None
        self._ts_cache: Optional[np.ndarray] = None

    # ------------------------------------------------------------ basics

    def __len__(self):
        return len(self.timestamps)

    def _invalidate(self):
        self._cols_cache = None
        self._ts_cache = None

    def _ts_array(self) -> np.ndarray:
        if self._ts_cache is None:
            self._ts_cache = np.asarray(self.timestamps, np.int64)
        return self._ts_cache

    def _materialise(self) -> Dict[str, np.ndarray]:
        if self._cols_cache is None:
            from .event import dtype_for
            out = {}
            for a in self.definition.attributes:
                dt = dtype_for(a.type)
                if dt is object:
                    arr = np.empty(len(self.timestamps), object)
                    arr[:] = self.columns[a.name]
                else:
                    arr = np.asarray(self.columns[a.name], dt)
                out[a.name] = arr
            self._cols_cache = out
        return self._cols_cache

    def _rebuild_indexes(self):
        self._pk_index.clear()
        for d in self._indexes.values():
            d.clear()
        for i in range(len(self.timestamps)):
            self._index_row(i)

    def _index_row(self, i: int):
        if self.primary_key:
            key = tuple(self.columns[a][i] for a in self.primary_key)
            self._pk_index[key] = i
        for a in self.index_attrs:
            self._indexes[a].setdefault(self.columns[a][i], []).append(i)

    # ------------------------------------------------------------ ops

    def insert(self, chunk: EventChunk):
        with self.lock:
            overwrote = False
            for i in range(len(chunk)):
                if self.primary_key:
                    key = tuple(_item(chunk.columns[a][i])
                                for a in self.primary_key)
                    if key in self._pk_index:
                        # primary-key clash: overwrite existing row (reference
                        # rejects; overwrite matches update-or-insert use)
                        r = self._pk_index[key]
                        for n in self.names:
                            self.columns[n][r] = _item(chunk.columns[n][i])
                        overwrote = True
                        continue
                for n in self.names:
                    self.columns[n].append(_item(chunk.columns[n][i]))
                self.timestamps.append(int(chunk.timestamps[i]))
                self._index_row(len(self.timestamps) - 1)
            if overwrote and self.index_attrs:
                # overwritten rows may have moved index buckets
                self._rebuild_indexes()
            self._invalidate()

    def all_rows_chunk(self) -> EventChunk:
        cols = self._materialise()
        n = len(self.timestamps)
        return EventChunk(self.names, self._ts_array(),
                          np.zeros(n, np.int8), dict(cols))

    def _match_rows(self, cond: Optional[CompiledTableCondition],
                    stream_chunk: Optional[EventChunk],
                    row_i: Optional[int]) -> np.ndarray:
        """Table-row indices matching `cond` for stream row `row_i`."""
        n = len(self.timestamps)
        if n == 0:
            return np.empty(0, np.int64)
        if cond is None or (cond.fn is None and not cond.pk_probe):
            return np.arange(n)
        qual = {}
        if stream_chunk is not None and row_i is not None:
            qual[(STREAM_QUAL, 0)] = {nm: _item(stream_chunk.columns[nm][row_i])
                                      for nm in stream_chunk.names}
        if cond.pk_probe is not None:
            sctx = EvalCtx({}, np.zeros(1, np.int64), 1, qualified=qual)
            key = tuple(_item(_scalar(ce.fn(sctx)))
                        for _, ce in cond.pk_probe)
            r = self._pk_index.get(key)
            return np.asarray([r] if r is not None else [], np.int64)
        cols = self._materialise()
        if cond.index_probe is not None:
            # hash-probe the secondary index, then run the full condition
            # over the candidate rows only (candidates are in ascending row
            # order, so results keep full-scan order)
            attr, ce = cond.index_probe
            sctx = EvalCtx({}, np.zeros(1, np.int64), 1, qualified=qual)
            key = _item(_scalar(ce.fn(sctx)))
            cand = self._indexes[attr].get(key)
            if not cand:
                return np.empty(0, np.int64)
            cand = np.asarray(cand, np.int64)
            cctx = EvalCtx({k: v[cand] for k, v in cols.items()},
                           self._ts_array()[cand],
                           len(cand), qualified=qual)
            m = np.asarray(cond.fn.fn(cctx), bool)
            if m.ndim == 0:
                m = np.full(len(cand), bool(m))
            return cand[np.flatnonzero(m)]
        ctx = EvalCtx(dict(cols), self._ts_array(), n, qualified=qual)
        m = np.asarray(cond.fn.fn(ctx), bool)
        if m.ndim == 0:
            m = np.full(n, bool(m))
        return np.flatnonzero(m)

    def find(self, cond: Optional[CompiledTableCondition],
             stream_chunk: Optional[EventChunk] = None,
             row_i: Optional[int] = None) -> EventChunk:
        with self.lock:
            idx = self._match_rows(cond, stream_chunk, row_i)
            return self.all_rows_chunk().take(idx)

    def delete(self, stream_chunk: EventChunk, cond: CompiledTableCondition):
        with self.lock:
            doomed = set()
            for i in range(len(stream_chunk)):
                doomed.update(self._match_rows(cond, stream_chunk, i).tolist())
            if not doomed:
                return
            keep = [i for i in range(len(self.timestamps)) if i not in doomed]
            for n in self.names:
                self.columns[n] = [self.columns[n][i] for i in keep]
            self.timestamps = [self.timestamps[i] for i in keep]
            self._rebuild_indexes()
            self._invalidate()

    def update(self, stream_chunk: EventChunk, cond: CompiledTableCondition,
               cset: CompiledSetUpdate):
        with self.lock:
            for i in range(len(stream_chunk)):
                rows = self._match_rows(cond, stream_chunk, i)
                if len(rows):
                    self._apply_set(rows, stream_chunk, i, cset)
                    if self.index_attrs:
                        # a SET may move rows between index buckets; later
                        # stream rows in this batch probe those buckets
                        self._rebuild_indexes()
            self._rebuild_indexes()
            self._invalidate()

    def update_or_insert(self, stream_chunk: EventChunk,
                         cond: CompiledTableCondition, cset: CompiledSetUpdate):
        with self.lock:
            for i in range(len(stream_chunk)):
                rows = self._match_rows(cond, stream_chunk, i)
                if len(rows):
                    self._apply_set(rows, stream_chunk, i, cset)
                    if self.index_attrs:
                        self._rebuild_indexes()
                else:
                    row = stream_chunk.slice(i, i + 1)
                    # insert maps same-named attributes
                    for n in self.names:
                        v = row.columns.get(n)
                        self.columns[n].append(_item(v[0]) if v is not None
                                               else None)
                    self.timestamps.append(int(row.timestamps[0]))
                    self._index_row(len(self.timestamps) - 1)
            self._rebuild_indexes()
            self._invalidate()

    def _apply_set(self, rows: np.ndarray, stream_chunk: EventChunk, i: int,
                   cset: CompiledSetUpdate):
        qual = {(STREAM_QUAL, 0): {nm: _item(stream_chunk.columns[nm][i])
                                   for nm in stream_chunk.names}}
        if cset.assignments:
            assigns = cset.assignments
        else:
            # no SET clause: overwrite same-named columns from the stream event
            assigns = None
        for r in rows.tolist():
            if assigns is None:
                for n in self.names:
                    if n in stream_chunk.columns:
                        self.columns[n][r] = _item(stream_chunk.columns[n][i])
            else:
                cols = self._materialise()
                rctx = EvalCtx({k: v[r:r + 1] for k, v in cols.items()},
                               np.asarray([self.timestamps[r]], np.int64), 1,
                               qualified=qual)
                for attr, ce in assigns:
                    self.columns[attr][r] = _item(_scalar(ce.fn(rctx)))
        self._invalidate()

    def contains_column(self, values, n: int) -> np.ndarray:
        """`expr in Table` membership (reference condition/InConditionExpressionExecutor)."""
        with self.lock:
            if isinstance(values, np.ndarray) and values.ndim > 0:
                vals = values
            else:
                vals = np.full(n, values)
            attr = self.primary_key[0] if len(self.primary_key) == 1 \
                else self.names[0]
            existing = set(self.columns[attr])
            return np.asarray([_item(v) in existing for v in vals], bool)

    # ------------------------------------------------------------ compile

    def _stream_scope(self, stream_def, shadow_table_attrs: bool) -> Scope:
        """Scope binding the probing stream's attributes as per-row scalars
        (qualified by stream id/alias; unqualified too, unless
        `shadow_table_attrs` and the table defines the same name)."""
        scope = Scope()
        if stream_def is not None:
            for a in stream_def.attributes:
                def g(ctx, name=a.name):
                    return ctx.qualified[(STREAM_QUAL, 0)][name]
                for qual in _stream_quals(stream_def, self.definition.id):
                    scope.add(qual, a.name, a.type, g)
                if not shadow_table_attrs or \
                        self.definition.index_of(a.name) < 0:
                    scope.add(None, a.name, a.type, g)
        return scope

    def compile_condition(self, on: Optional[Expression], stream_def,
                          factory) -> CompiledTableCondition:
        if on is None:
            return CompiledTableCondition(None)
        # stream attributes first; table attributes last: `T.x` (and
        # unqualified table columns) must resolve to the table even when
        # the flowing definition shares ids
        scope = self._stream_scope(stream_def, shadow_table_attrs=True)
        scope.add_primary(self.definition.id, None, self.definition)
        compiler = factory(scope)
        pk_probe = self._try_pk_probe(on, stream_def, factory)
        index_probe = None if pk_probe else \
            self._try_index_probe(on, stream_def, factory)
        return CompiledTableCondition(compiler.compile(on), pk_probe,
                                      index_probe)

    def _try_pk_probe(self, on: Expression, stream_def, factory):
        """Detect `table.pk == <stream expr>` (AND-combined for composite
        keys) → hash-index probe (reference: IndexEventHolder plans)."""
        if not self.primary_key:
            return None
        eqs: Dict[str, Expression] = {}

        def collect(e: Expression) -> bool:
            if isinstance(e, And):
                return collect(e.left) and collect(e.right)
            if isinstance(e, Compare) and e.op == CompareOp.EQ:
                for a, b in ((e.left, e.right), (e.right, e.left)):
                    if isinstance(a, Variable) and a.attribute in \
                            self.primary_key and not _mentions_table(
                                b, self.definition):
                        eqs[a.attribute] = b
                        return True
                return False
            return False

        if not collect(on) or set(eqs) != set(self.primary_key):
            return None
        compiler = factory(self._stream_scope(stream_def,
                                              shadow_table_attrs=False))
        return [(k, compiler.compile(v))
                for k, v in ((pk, eqs[pk]) for pk in self.primary_key)]

    def _try_index_probe(self, on: Expression, stream_def, factory):
        """Detect an AND-conjunct `table.indexed == <stream expr>` →
        secondary-index hash probe with residual filtering (reference:
        IndexEventHolder secondary indexes + CollectionExpressionParser's
        partial index plans)."""
        if not self.index_attrs:
            return None
        found: List[Tuple[str, Expression]] = []

        def collect(e: Expression):
            if isinstance(e, And):
                collect(e.left)
                collect(e.right)
                return
            if isinstance(e, Compare) and e.op == CompareOp.EQ:
                for a, b in ((e.left, e.right), (e.right, e.left)):
                    if isinstance(a, Variable) and \
                            a.attribute in self.index_attrs and \
                            a.stream_id in (None, self.definition.id) and \
                            not _mentions_table(b, self.definition):
                        found.append((a.attribute, b))
                        return

        collect(on)
        if not found:
            return None
        attr, value_expr = found[0]
        compiler = factory(self._stream_scope(stream_def,
                                              shadow_table_attrs=False))
        try:
            return (attr, compiler.compile(value_expr))
        except Exception:
            return None     # value expr needs table columns → full scan

    def compile_set(self, assignments, stream_def, factory) -> CompiledSetUpdate:
        out = []
        for a in assignments or []:
            scope = Scope()
            scope.add_primary(self.definition.id, None, self.definition)
            if stream_def is not None:
                for at in stream_def.attributes:
                    def g(ctx, name=at.name):
                        return ctx.qualified[(STREAM_QUAL, 0)][name]
                    for qual in _stream_quals(stream_def,
                                              self.definition.id):
                        scope.add(qual, at.name, at.type, g)
                    if self.definition.index_of(at.name) < 0:
                        scope.add(None, at.name, at.type, g)
            compiler = factory(scope)
            out.append((a.table_variable.attribute, compiler.compile(a.value)))
        return CompiledSetUpdate(out)

    # ------------------------------------------------------------ state

    def current_state(self):
        return {"columns": {k: list(v) for k, v in self.columns.items()},
                "timestamps": list(self.timestamps)}

    def restore_state(self, s):
        self.columns = {k: list(v) for k, v in s["columns"].items()}
        self.timestamps = list(s["timestamps"])
        self._rebuild_indexes()
        self._invalidate()


def _stream_quals(stream_def, table_id):
    """Qualifiers the `on`/`set` expressions may use for stream attributes:
    the flowing definition's id plus the query's source stream alias
    (set by QueryRuntime — reference matcher binds the input stream name).
    The table's own id never qualifies stream attributes."""
    quals = [stream_def.id]
    alias = getattr(stream_def, "source_alias", None)
    if alias and alias not in quals:
        quals.append(alias)
    return [q for q in quals if q != table_id]


def _item(v):
    return v.item() if hasattr(v, "item") else v


def _scalar(v):
    if isinstance(v, np.ndarray) and v.ndim > 0:
        return v[0]
    return v


def _mentions_table(e: Expression, table_def) -> bool:
    from ..query_api.expression import variables_of
    for v in variables_of(e):
        if v.stream_id == table_def.id:
            return True
        if v.stream_id is None and table_def.index_of(v.attribute) >= 0:
            return True
    return False
