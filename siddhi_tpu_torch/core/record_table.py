"""External record-table SPI with compiled-condition and selection pushdown.

(reference: table/record/AbstractRecordTable.java — external stores receive
store-neutral compiled conditions built by an ExpressionBuilder visitor over
the `on` expression, with per-probe stream values passed as parameters;
table/record/AbstractQueryableRecordTable.java — additionally pushes the
select/group-by/having/order-by/limit clause down as a CompiledSelection so
the store computes the projection natively.)

TPU-framework shape: the engine's columnar probes stay unchanged — a record
table quacks like core/table.py's InMemoryTable (insert/find/update/delete/
update_or_insert/contains_column/compile_condition), but instead of numpy
row scans every operation is forwarded through a small store-neutral
condition IR (`RecordExpr` trees) that concrete stores render into their
native query language (see stores/sqlite.py for the SQL rendering).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..query_api.definition import AttrType, TableDefinition
from ..query_api.expression import (And, AttributeFunction, Compare, Constant,
                                    Expression, IsNull, MathExpr, Not, Or,
                                    Variable, variables_of)
from ..utils.errors import SiddhiAppCreationError
from .event import EventChunk, dtype_for
from .stateschema import persistent_schema
from .table import STREAM_QUAL, _item, _scalar


# ---------------------------------------------------------------- condition IR
# Store-neutral expression nodes (≙ the reference's ExpressionBuilder visit
# stream: table/record/ExpressionBuilder.java builds per-store condition
# syntax from the same vocabulary — column refs, constants, stream-parameter
# placeholders, compare/math/bool operators, is-null, aggregates).

@dataclass(frozen=True)
class RecordExpr:
    pass


#: coarse value-type tags on IR nodes ('str' | 'int' | 'float' | 'bool' |
#: None=unknown) — stores use them to render type-correct native syntax
#: (e.g. SQL string concat is `||`, not `+`) or refuse an operator whose
#: native semantics diverge from the engine's.
def _tag_of(t: Optional[AttrType]) -> Optional[str]:
    if t in (AttrType.INT, AttrType.LONG):
        return "int"
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return "float"
    if t == AttrType.STRING:
        return "str"
    if t == AttrType.BOOL:
        return "bool"
    return None


@dataclass(frozen=True)
class Col(RecordExpr):
    """Table column reference."""
    name: str
    type: Optional[str] = None


@dataclass(frozen=True)
class Const(RecordExpr):
    value: Any

    @property
    def type(self) -> Optional[str]:
        if isinstance(self.value, bool):
            return "bool"
        if isinstance(self.value, int):
            return "int"
        if isinstance(self.value, float):
            return "float"
        if isinstance(self.value, str):
            return "str"
        return None


@dataclass(frozen=True)
class Param(RecordExpr):
    """Per-probe parameter: the engine evaluates the corresponding stream
    expression for each probing event and passes {name: value} to the store
    (≙ streamVariable placeholders in the reference's compiled conditions)."""
    name: str
    type: Optional[str] = None


@dataclass(frozen=True)
class Cmp(RecordExpr):
    op: str                    # '<' '>' '<=' '>=' '==' '!='
    left: RecordExpr
    right: RecordExpr


@dataclass(frozen=True)
class BoolAnd(RecordExpr):
    left: RecordExpr
    right: RecordExpr


@dataclass(frozen=True)
class BoolOr(RecordExpr):
    left: RecordExpr
    right: RecordExpr


@dataclass(frozen=True)
class BoolNot(RecordExpr):
    expr: RecordExpr


@dataclass(frozen=True)
class NullCheck(RecordExpr):
    expr: RecordExpr


@dataclass(frozen=True)
class Arith(RecordExpr):
    op: str                    # '+' '-' '*' '/' '%'
    left: RecordExpr
    right: RecordExpr

    @property
    def type(self) -> Optional[str]:
        lt = getattr(self.left, "type", None)
        rt = getattr(self.right, "type", None)
        if "str" in (lt, rt):
            return "str"
        if "float" in (lt, rt):
            return "float"
        if lt == rt == "int":
            return "int"
        return None


@dataclass(frozen=True)
class Agg(RecordExpr):
    """Aggregate over the selected/grouped rows (selection pushdown only)."""
    kind: str                  # 'sum' 'count' 'avg' 'min' 'max'
    arg: Optional[RecordExpr]  # None for count(*)


def record_expr_children(e: RecordExpr):
    """Direct RecordExpr children of a node — THE tree-walk for IR
    consumers (stores' validate_expr, _has_agg); new node shapes must keep
    children as direct dataclass fields or extend this."""
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, RecordExpr):
            yield v


# ---------------------------------------------------------------- compiled forms

class CompiledRecordCondition:
    """What compile_condition returns for a record table: the store-neutral
    tree plus the per-probe parameter evaluators (stream-side expressions
    compiled with the host expression compiler).

    pk_probe/index_probe mirror CompiledTableCondition's interface so
    engine call sites (core/join.py) can feature-test uniformly; record
    stores do their own indexing, so both stay None."""

    pk_probe = None
    index_probe = None

    def __init__(self, root: Optional[RecordExpr],
                 params: List[Tuple[str, Any]]):
        self.root = root
        self.params = params       # [(name, CompiledExpr)]

    def eval_params(self, stream_chunk: Optional[EventChunk],
                    row_i: Optional[int]) -> Dict[str, Any]:
        if not self.params:
            return {}
        from ..plan.expr_compiler import EvalCtx
        qual = {}
        if stream_chunk is not None and row_i is not None:
            qual[(STREAM_QUAL, 0)] = {
                nm: _item(stream_chunk.columns[nm][row_i])
                for nm in stream_chunk.names}
        ctx = EvalCtx({}, np.zeros(1, np.int64), 1, qualified=qual)
        return {name: _item(_scalar(ce.fn(ctx))) for name, ce in self.params}


class CompiledRecordSet:
    """Translated SET clause: [(column, RecordExpr)] — value expressions may
    reference table columns (Col) and per-probe parameters (Param)."""

    def __init__(self, assignments: List[Tuple[str, RecordExpr]],
                 params: List[Tuple[str, Any]]):
        self.assignments = assignments
        self.params = params

    def eval_params(self, stream_chunk, row_i) -> Dict[str, Any]:
        return CompiledRecordCondition(None, self.params) \
            .eval_params(stream_chunk, row_i)


@dataclass
class RecordSelection:
    """Pushed-down projection (≙ CompiledSelection,
    table/record/AbstractQueryableRecordTable.java): evaluated by the store
    over the condition's matching records."""
    select: List[Tuple[str, RecordExpr]]          # (output name, expr)
    group_by: List[str] = field(default_factory=list)
    having: Optional[RecordExpr] = None
    order_by: List[Tuple[str, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


# ---------------------------------------------------------------- builder

class _Translator:
    """query_api Expression → RecordExpr against one table definition.
    Sub-expressions that touch no table column become Params evaluated on
    the engine side per probing event."""

    def __init__(self, table_def: TableDefinition, stream_def, factory,
                 allow_aggregates: bool = False, prefix: str = "p"):
        self.table_def = table_def
        self.table_cols = {a.name for a in table_def.attributes}
        self.stream_def = stream_def
        self.allow_aggregates = allow_aggregates
        self.params: List[Tuple[str, Any]] = []
        self._factory = factory
        self._stream_compiler = None
        self._prefix = prefix

    # ---- stream-side scope (per-probe scalars)

    def _compiler(self):
        if self._stream_compiler is None:
            from ..plan.expr_compiler import Scope
            scope = Scope()
            if self.stream_def is not None:
                for a in self.stream_def.attributes:
                    def g(ctx, name=a.name):
                        return ctx.qualified[(STREAM_QUAL, 0)][name]
                    quals = [self.stream_def.id]
                    alias = getattr(self.stream_def, "source_alias", None)
                    if alias:
                        quals.append(alias)
                    for q in quals:
                        if q != self.table_def.id:
                            scope.add(q, a.name, a.type, g)
                    if a.name not in self.table_cols:
                        scope.add(None, a.name, a.type, g)
            self._stream_compiler = self._factory(scope)
        return self._stream_compiler

    def _is_table_free(self, e: Expression) -> bool:
        for v in variables_of(e):
            if v.stream_id == self.table_def.id:
                return False
            if v.stream_id is None and v.attribute in self.table_cols:
                return False
        return True

    def _param(self, e: Expression) -> Param:
        name = f"{self._prefix}{len(self.params)}"
        ce = self._compiler().compile(e)
        self.params.append((name, ce))
        return Param(name, _tag_of(getattr(ce, "type", None)))

    # ---- recursive translation

    def translate(self, e: Expression) -> RecordExpr:
        if isinstance(e, Constant):
            return Const(e.value)
        if isinstance(e, Variable):
            is_table = (e.stream_id == self.table_def.id or
                        (e.stream_id is None and
                         e.attribute in self.table_cols))
            if is_table:
                if e.attribute not in self.table_cols:
                    raise SiddhiAppCreationError(
                        f"record table '{self.table_def.id}' has no "
                        f"attribute '{e.attribute}'")
                t = next(a.type for a in self.table_def.attributes
                         if a.name == e.attribute)
                return Col(e.attribute, _tag_of(t))
            return self._param(e)
        if self._is_table_free(e):
            return self._param(e)
        if isinstance(e, Compare):
            return Cmp(e.op.value, self.translate(e.left),
                       self.translate(e.right))
        if isinstance(e, And):
            return BoolAnd(self.translate(e.left), self.translate(e.right))
        if isinstance(e, Or):
            return BoolOr(self.translate(e.left), self.translate(e.right))
        if isinstance(e, Not):
            return BoolNot(self.translate(e.expr))
        if isinstance(e, IsNull):
            if e.expr is None:
                raise SiddhiAppCreationError(
                    "record table condition: stream-state `is null` is a "
                    "pattern construct")
            return NullCheck(self.translate(e.expr))
        if isinstance(e, MathExpr):
            return Arith(e.op.value, self.translate(e.left),
                         self.translate(e.right))
        if isinstance(e, AttributeFunction) and self.allow_aggregates and \
                (e.namespace or "") == "" and \
                e.name.lower() in ("sum", "count", "avg", "min", "max"):
            arg = self.translate(e.args[0]) if e.args else None
            return Agg(e.name.lower(), arg)
        raise SiddhiAppCreationError(
            f"record table '{self.table_def.id}': cannot push down "
            f"{type(e).__name__} — store-native translation undefined")


# ---------------------------------------------------------------- SPI base

@persistent_schema("record-table", schema=None,
                   doc="the external store owns its own durability")
class AbstractRecordTable:
    """Base class for external stores (≙ AbstractRecordTable.java).

    Subclasses implement the `*_records` SPI on dict-shaped rows; the engine
    drives them through the same call surface as InMemoryTable.  State
    lives in the external system: snapshots skip record tables
    (current_state → None), exactly as the reference leaves @Store contents
    out of SnapshotService persistence.
    """

    supports_query = False          # flipped by AbstractQueryableRecordTable

    def __init__(self, definition: TableDefinition, store_annotation=None):
        self.definition = definition
        self.names = definition.attribute_names
        self.store_annotation = store_annotation
        self.lock = threading.RLock()
        self.init(definition, store_annotation)

    # ------------------------------------------------------------- SPI
    def init(self, definition: TableDefinition, store_annotation) -> None:
        """Connect to the backing store."""

    def add(self, records: List[Dict[str, Any]]) -> None:
        raise NotImplementedError

    def find_records(self, condition: Optional[RecordExpr],
                     params: Dict[str, Any]) -> Iterable[Dict[str, Any]]:
        raise NotImplementedError

    def update_records(self, condition: Optional[RecordExpr],
                       param_rows: List[Dict[str, Any]],
                       assignments: List[Tuple[str, RecordExpr]]) -> None:
        raise NotImplementedError

    def delete_records(self, condition: Optional[RecordExpr],
                       param_rows: List[Dict[str, Any]]) -> None:
        raise NotImplementedError

    def upsert_records(self, condition: Optional[RecordExpr],
                       param_rows: List[Dict[str, Any]],
                       assignments: List[Tuple[str, RecordExpr]],
                       add_records: List[Dict[str, Any]]) -> None:
        """Default: per-row update-if-present-else-add. Stores with a native
        upsert (SQL ON CONFLICT ...) override — SQLiteStore does when a
        primary key is declared.

        SINGLE-WRITER ASSUMPTION: the engine serializes its own calls
        under `self.lock`, but the find→write pair is not a store-level
        transaction — a concurrent EXTERNAL writer (another process on the
        same backing store) or a crash between the probe and the write can
        double-insert.  Stores shared with external writers must override
        this with their native atomic upsert."""
        for pr, rec in zip(param_rows, add_records):
            if any(True for _ in self.find_records(condition, pr)):
                self.update_records(condition, [pr], assignments)
            else:
                self.add([rec])

    def contains_records(self, condition: Optional[RecordExpr],
                         params: Dict[str, Any]) -> bool:
        return any(True for _ in self.find_records(condition, params))

    # ------------------------------------------------- engine call surface

    def __len__(self):
        return sum(1 for _ in self.find_records(None, {}))

    def _chunk_of(self, rows: List[Dict[str, Any]]) -> EventChunk:
        n = len(rows)
        cols: Dict[str, np.ndarray] = {}
        for a in self.definition.attributes:
            dt = dtype_for(a.type)
            vals = [r.get(a.name) for r in rows]
            if dt is object:
                arr = np.empty(n, object)
                arr[:] = vals
            else:
                arr = np.asarray([v if v is not None else 0 for v in vals],
                                 dt)
            cols[a.name] = arr
        ts = np.full(n, 0, np.int64)
        return EventChunk(self.names, ts, np.zeros(n, np.int8), cols)

    def all_rows_chunk(self) -> EventChunk:
        with self.lock:
            return self._chunk_of(list(self.find_records(None, {})))

    def insert(self, chunk: EventChunk) -> None:
        with self.lock:
            self.add(_records_of(chunk, self.names))

    def find(self, cond: Optional[CompiledRecordCondition],
             stream_chunk: Optional[EventChunk] = None,
             row_i: Optional[int] = None) -> EventChunk:
        with self.lock:
            root, params = (None, {}) if cond is None else \
                (cond.root, cond.eval_params(stream_chunk, row_i))
            return self._chunk_of(list(self.find_records(root, params)))

    def delete(self, stream_chunk: EventChunk,
               cond: CompiledRecordCondition) -> None:
        with self.lock:
            rows = [cond.eval_params(stream_chunk, i)
                    for i in range(len(stream_chunk))]
            self.delete_records(cond.root, rows)

    def update(self, stream_chunk: EventChunk, cond: CompiledRecordCondition,
               cset: "CompiledRecordSet") -> None:
        with self.lock:
            assignments, extra = self._effective_set(cset, stream_chunk)
            prs = []
            for i in range(len(stream_chunk)):
                pr = dict(cond.eval_params(stream_chunk, i))
                pr.update(cset.eval_params(stream_chunk, i))
                pr.update(extra(i))
                prs.append(pr)
            self.update_records(cond.root, prs, assignments)

    def update_or_insert(self, stream_chunk: EventChunk,
                         cond: CompiledRecordCondition,
                         cset: "CompiledRecordSet") -> None:
        with self.lock:
            adds = _records_of(stream_chunk, self.names)
            assignments, extra = self._effective_set(cset, stream_chunk)
            for i in range(len(stream_chunk)):
                pr = dict(cond.eval_params(stream_chunk, i))
                pr.update(cset.eval_params(stream_chunk, i))
                pr.update(extra(i))
                self.upsert_records(cond.root, [pr], assignments,
                                    [adds[i]])

    def contains_column(self, values, n: int) -> np.ndarray:
        """`expr in Table` membership (probes the first primary-key-like
        column: the reference routes In through the compiled condition of
        the store)."""
        from ..query_api.annotation import find_annotation
        pk_ann = find_annotation(self.definition.annotations, "primarykey")
        attr = (pk_ann.positional()[0] if pk_ann and pk_ann.positional()
                else self.names[0])
        cond = Cmp("==", Col(attr), Param("v"))
        with self.lock:
            if isinstance(values, np.ndarray) and values.ndim > 0:
                vals = values
            else:
                vals = np.full(n, values)
            cache: Dict[Any, bool] = {}
            out = np.zeros(n, bool)
            for i, v in enumerate(vals):
                v = _item(v)
                if v not in cache:
                    cache[v] = self.contains_records(cond, {"v": v})
                out[i] = cache[v]
            return out

    # ------------------------------------------------------------- compile

    def validate_expr(self, e: Optional[RecordExpr]) -> None:
        """Store hook, called at compile time: raise SiddhiAppCreationError
        for IR whose native execution would diverge from engine semantics
        (callers fall back to host-side evaluation where one exists)."""

    def compile_condition(self, on: Optional[Expression], stream_def,
                          factory) -> CompiledRecordCondition:
        if on is None:
            return CompiledRecordCondition(None, [])
        tr = _Translator(self.definition, stream_def, factory)
        root = tr.translate(on)
        self.validate_expr(root)
        return CompiledRecordCondition(root, tr.params)

    def compile_set(self, assignments, stream_def,
                    factory) -> "CompiledRecordSet":
        # distinct param namespace — SET params merge with the condition's
        # at probe time (AbstractRecordTable.update).  An empty SET clause
        # is synthesized per-row at apply time (_effective_set):
        # InMemoryTable._apply_set overwrites same-named columns.
        tr = _Translator(self.definition, stream_def, factory, prefix="s")
        out = [(a.table_variable.attribute, tr.translate(a.value))
               for a in assignments or []]
        for _, e in out:
            self.validate_expr(e)
        return CompiledRecordSet(out, tr.params)

    def _effective_set(self, cset: "CompiledRecordSet",
                       stream_chunk: EventChunk):
        """(assignments, per_row_extra(i)): explicit SET assignments, or —
        for a SET-less update — same-named stream columns shipped as
        synthetic per-row params."""
        if cset.assignments:
            return cset.assignments, lambda i: {}
        cols = [n for n in self.names if n in stream_chunk.columns]
        assignments = [(n, Param(f"sc_{n}")) for n in cols]

        def extra(i):
            return {f"sc_{n}": _item(stream_chunk.columns[n][i])
                    for n in cols}
        return assignments, extra

    # ------------------------------------------------------------- state

    def current_state(self):
        return None            # external store owns its own durability

    def restore_state(self, state):
        pass


class AbstractQueryableRecordTable(AbstractRecordTable):
    """Record store that additionally executes pushed-down selections
    (≙ AbstractQueryableRecordTable.java: compileSelection + query())."""

    supports_query = True

    def query_records(self, condition: Optional[RecordExpr],
                      params: Dict[str, Any],
                      selection: RecordSelection) -> Iterable[Dict[str, Any]]:
        raise NotImplementedError

    def compile_selection(self, selector, factory) -> RecordSelection:
        """Translate a query_api Selector; raises SiddhiAppCreationError on
        anything the store-neutral IR cannot express (caller falls back to
        host-side selection)."""
        tr = _Translator(self.definition, None, factory,
                         allow_aggregates=True)
        if selector.select_all:
            select = [(a.name, Col(a.name, _tag_of(a.type)))
                      for a in self.definition.attributes]
        else:
            select = [(oa.rename, tr.translate(oa.expr))
                      for oa in selector.attributes]
        for _, e in select:
            self.validate_expr(e)
        out_names = {name for name, _ in select}
        group_by = []
        for v in selector.group_by:
            if v.attribute not in {a.name for a in
                                   self.definition.attributes}:
                raise SiddhiAppCreationError(
                    f"selection pushdown: group-by '{v.attribute}' is not "
                    f"a table column")
            group_by.append(v.attribute)
        having = self._translate_having(selector.having, dict(select), tr) \
            if selector.having is not None else None
        order_by = []
        for ob in selector.order_by:
            a = ob.variable.attribute
            if a not in out_names:
                raise SiddhiAppCreationError(
                    f"selection pushdown: order-by '{a}' must be a "
                    f"selected output")
            order_by.append((a, ob.ascending))
        if tr.params:
            raise SiddhiAppCreationError(
                "selection pushdown: selector must not reference stream "
                "attributes")
        self.validate_expr(having)
        return RecordSelection(select, group_by, having, order_by,
                               selector.limit, selector.offset)

    def _translate_having(self, having: Expression,
                          sel_map: Dict[str, RecordExpr],
                          tr: "_Translator") -> RecordExpr:
        """Host semantics: HAVING reads the *output* row, so variables
        resolve to select aliases (substituted structurally — stores can't
        be trusted to bind aliases rather than same-named table columns);
        anything that isn't an alias refuses pushdown."""
        def t(e: Expression) -> RecordExpr:
            if isinstance(e, Variable):
                if e.stream_id in (None, self.definition.id) and \
                        e.attribute in sel_map:
                    return sel_map[e.attribute]
                raise SiddhiAppCreationError(
                    f"selection pushdown: having references '{e.attribute}' "
                    f"which is not a selected output")
            if isinstance(e, Constant):
                return Const(e.value)
            if isinstance(e, Compare):
                return Cmp(e.op.value, t(e.left), t(e.right))
            if isinstance(e, And):
                return BoolAnd(t(e.left), t(e.right))
            if isinstance(e, Or):
                return BoolOr(t(e.left), t(e.right))
            if isinstance(e, Not):
                return BoolNot(t(e.expr))
            if isinstance(e, IsNull) and e.expr is not None:
                return NullCheck(t(e.expr))
            if isinstance(e, MathExpr):
                return Arith(e.op.value, t(e.left), t(e.right))
            return tr.translate(e)
        return t(having)

    @staticmethod
    def _has_agg(e: RecordExpr) -> bool:
        if isinstance(e, Agg):
            return True
        return any(AbstractQueryableRecordTable._has_agg(c)
                   for c in record_expr_children(e))

    def query(self, cond: Optional[CompiledRecordCondition],
              selection: RecordSelection,
              stream_chunk: Optional[EventChunk] = None,
              row_i: Optional[int] = None) -> List[Dict[str, Any]]:
        with self.lock:
            root, params = (None, {}) if cond is None else \
                (cond.root, cond.eval_params(stream_chunk, row_i))
            rows = list(self.query_records(root, params, selection))
            # ungrouped aggregates over zero matching rows: SQL emits one
            # row (NULL sums, 0 counts — or arbitrary values for arithmetic
            # over them), the host selector emits nothing.  The returned
            # values cannot distinguish the cases, so the single-row
            # ungrouped-aggregate shape always pays one existence probe.
            if len(rows) == 1 and not selection.group_by and \
                    any(self._has_agg(e) for _, e in selection.select) and \
                    not self.contains_records(root, params):
                return []
            return rows


# ---------------------------------------------------------------- helpers

def _records_of(chunk: EventChunk, names) -> List[Dict[str, Any]]:
    out = []
    for i in range(len(chunk)):
        out.append({n: _item(chunk.columns[n][i])
                    for n in names if n in chunk.columns})
    return out
