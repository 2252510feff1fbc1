"""SQLite-backed queryable record table.

The proof-of-the-SPI store (reference analogue: the siddhi-store-rdbms
extension implementing table/record/AbstractQueryableRecordTable.java):
compiled conditions and selections arrive as store-neutral RecordExpr trees
(core/record_table.py) and are rendered here into parameterised SQL — the
store executes probes natively instead of shipping rows to the engine.

Usage::

    @Store(type='sqlite', database=':memory:', table='StockTable')
    define table StockTable (symbol string, price float, volume long);

The last executed SQL statements are kept in `self.sql_log` so tests (and
curious users) can verify pushdown actually happened.
"""
from __future__ import annotations

import sqlite3
from typing import Any, Dict, Iterable, List, Optional

from ..core.record_table import (AbstractQueryableRecordTable, Agg, Arith,
                                 BoolAnd, BoolNot, BoolOr, Cmp, Col, Const,
                                 NullCheck, Param, RecordExpr,
                                 RecordSelection, record_expr_children)
from ..query_api.definition import AttrType
from ..utils.errors import SiddhiAppCreationError
from ..utils.extension import extension

_SQL_TYPE = {
    AttrType.INT: "INTEGER", AttrType.LONG: "INTEGER",
    AttrType.FLOAT: "REAL", AttrType.DOUBLE: "REAL",
    AttrType.BOOL: "INTEGER", AttrType.STRING: "TEXT",
}

_CMP_SQL = {"==": "=", "!=": "<>", "<": "<", "<=": "<=", ">": ">", ">=": ">="}


def _q(ident: str) -> str:
    """Quote an SQL identifier (embedded quotes doubled)."""
    return '"' + ident.replace('"', '""') + '"'


def _render(e: Optional[RecordExpr]) -> str:
    """RecordExpr → SQL with :name parameter placeholders."""
    if e is None:
        return "1"
    if isinstance(e, Col):
        return _q(e.name)
    if isinstance(e, Const):
        v = e.value
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return repr(v)
    if isinstance(e, Param):
        return f":{e.name}"
    if isinstance(e, Cmp):
        return f"({_render(e.left)} {_CMP_SQL[e.op]} {_render(e.right)})"
    if isinstance(e, BoolAnd):
        return f"({_render(e.left)} AND {_render(e.right)})"
    if isinstance(e, BoolOr):
        return f"({_render(e.left)} OR {_render(e.right)})"
    if isinstance(e, BoolNot):
        return f"(NOT {_render(e.expr)})"
    if isinstance(e, NullCheck):
        return f"({_render(e.expr)} IS NULL)"
    if isinstance(e, Arith):
        if e.op == "+" and e.type == "str":
            # engine `+` on strings is concatenation; SQL `+` coerces to 0
            return f"({_render(e.left)} || {_render(e.right)})"
        return f"({_render(e.left)} {e.op} {_render(e.right)})"
    if isinstance(e, Agg):
        arg = "*" if e.arg is None else _render(e.arg)
        return f"{e.kind.upper()}({arg})"
    raise SiddhiAppCreationError(f"sqlite store: unrenderable {type(e)}")


def _clean_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (int(v) if isinstance(v, bool) else v)
            for k, v in params.items()}


@extension(namespace="store", name="sqlite",
           description="SQLite-backed queryable record table with full "
                       "condition and selection pushdown",
           parameters=[("database", "string",
                        "sqlite database path (default ':memory:')"),
                       ("table", "string",
                        "backing table name (default: the definition id)")])
class SQLiteStore(AbstractQueryableRecordTable):

    def init(self, definition, store_annotation) -> None:
        db = ":memory:"
        table = definition.id
        if store_annotation is not None:
            db = store_annotation.get("database", db) or db
            table = store_annotation.get("table", table) or table
        self._table = table
        self._bools = [a.name for a in definition.attributes
                       if a.type == AttrType.BOOL]
        self.sql_log: List[str] = []
        from ..query_api import find_annotation
        pk_ann = find_annotation(definition.annotations, "primarykey")
        self._pk: List[str] = pk_ann.positional() if pk_ann else []
        cols = []
        for a in definition.attributes:
            t = _SQL_TYPE.get(a.type)
            if t is None:
                raise SiddhiAppCreationError(
                    f"sqlite store: unsupported attribute type {a.type} "
                    f"for '{a.name}'")
            cols.append(f'{_q(a.name)} {t}')
        if self._pk:
            cols.append(f'PRIMARY KEY ({", ".join(_q(k) for k in self._pk)})')
        # engine probes may come from any junction/worker thread; all calls
        # are serialized by AbstractRecordTable.lock
        self._conn = sqlite3.connect(db, check_same_thread=False)
        self._conn.execute(
            f'CREATE TABLE IF NOT EXISTS {_q(table)} ({", ".join(cols)})')
        self._conn.commit()
        # a pre-existing table (CREATE IF NOT EXISTS no-op) may lack the
        # declared PK — ON CONFLICT(pk) would then raise OperationalError
        # at runtime, so verify the REAL schema before enabling the native
        # upsert path
        actual_pk = [r[1] for r in sorted(
            (r for r in self._conn.execute(
                f'PRAGMA table_info({_q(table)})') if r[5] > 0),
            key=lambda r: r[5])]
        self._pk_native = bool(self._pk) and actual_pk == list(self._pk)

    def validate_expr(self, e) -> None:
        """Refuse IR whose SQLite semantics diverge from the engine's
        (callers with a host path fall back; others surface the error)."""
        if e is None:
            return
        if isinstance(e, Arith) and e.op == "%" and e.type == "float":
            raise SiddhiAppCreationError(
                "sqlite store: '%' on REAL operands truncates to INTEGER "
                "in SQLite (engine fmod semantics diverge)")
        import math
        if isinstance(e, Const) and isinstance(e.value, float) and \
                not math.isfinite(e.value):
            # repr(inf)/repr(nan) render as bare `inf`/`nan` — invalid
            # SQLite syntax; refuse at compile time (clean host fallback)
            # instead of an OperationalError at probe time
            raise SiddhiAppCreationError(
                "sqlite store: non-finite float constants are not "
                "renderable as SQLite literals")
        for c in record_expr_children(e):
            self.validate_expr(c)

    def _exec(self, sql: str, params=None):
        self.sql_log.append(sql)
        return self._conn.execute(sql, _clean_params(params or {}))

    def _row_dict(self, names, row) -> Dict[str, Any]:
        d = dict(zip(names, row))
        for b in self._bools:
            if b in d and d[b] is not None:
                d[b] = bool(d[b])
        return d

    # ------------------------------------------------------------- SPI

    def add(self, records: List[Dict[str, Any]]) -> None:
        if not records:
            return
        cols = self.names
        sql = (f'INSERT INTO {_q(self._table)} '
               f'({", ".join(_q(c) for c in cols)}) '
               f'VALUES ({", ".join(":" + c for c in cols)})')
        self.sql_log.append(sql)
        self._conn.executemany(
            sql, [_clean_params({c: r.get(c) for c in cols})
                  for r in records])
        self._conn.commit()

    def find_records(self, condition, params) -> Iterable[Dict[str, Any]]:
        cur = self._exec(
            f'SELECT {", ".join(_q(c) for c in self.names)} '
            f'FROM {_q(self._table)} WHERE {_render(condition)}', params)
        for row in cur.fetchall():
            yield self._row_dict(self.names, row)

    def update_records(self, condition, param_rows, assignments) -> None:
        sets = ", ".join(f'{_q(col)} = {_render(e)}'
                         for col, e in assignments)
        sql = (f'UPDATE {_q(self._table)} SET {sets} '
               f'WHERE {_render(condition)}')
        for pr in param_rows:
            self._exec(sql, pr)
        self._conn.commit()

    def delete_records(self, condition, param_rows) -> None:
        sql = f'DELETE FROM {_q(self._table)} WHERE {_render(condition)}'
        for pr in (param_rows or [{}]):
            self._exec(sql, pr)
        self._conn.commit()

    def _pk_equality(self, e) -> Optional[Dict[str, Any]]:
        """When the condition is exactly an AND-chain of equality tests
        covering the declared primary key, return {pk col: operand node}
        (Param or Const); else None.  Shape alone is NOT sufficient for
        the native upsert — the caller must also check per row that each
        compared operand VALUE equals the value being inserted into that
        PK column, otherwise `on T.pk == <something else>` would match a
        different row than ON CONFLICT(pk) does."""
        ops: Dict[str, Any] = {}

        def walk(x) -> bool:
            if isinstance(x, BoolAnd):
                return walk(x.left) and walk(x.right)
            if isinstance(x, Cmp) and x.op == "==":
                side = (x.left if isinstance(x.left, Col) else
                        x.right if isinstance(x.right, Col) else None)
                other = x.right if side is x.left else x.left
                if side is not None and isinstance(other, (Param, Const)):
                    ops[side.name] = other
                    return True
            return False
        if e is not None and walk(e) and set(ops) == set(self._pk):
            return ops
        return None

    def upsert_records(self, condition, param_rows, assignments,
                       add_records) -> None:
        """Native atomic upsert via INSERT ... ON CONFLICT when a primary
        key is declared, the match condition is PK equality, AND (per row)
        the compared values equal the inserted PK values — only then do
        engine find-then-update semantics coincide with ON CONFLICT(pk).
        Closes the probe→write race of the SPI default against external
        writers on the same database; non-coinciding rows take the SPI
        default path."""
        ops = self._pk_equality(condition) if self._pk_native else None
        if ops is None:
            super().upsert_records(condition, param_rows, assignments,
                                   add_records)
            return
        cols = self.names
        sets = ", ".join(f'{_q(c)} = {_render(e)}' for c, e in assignments)
        sql = (f'INSERT INTO {_q(self._table)} '
               f'({", ".join(_q(c) for c in cols)}) '
               f'VALUES ({", ".join(":__ins_" + c for c in cols)}) '
               f'ON CONFLICT({", ".join(_q(k) for k in self._pk)}) '
               f'DO UPDATE SET {sets}')
        logged = False
        for pr, rec in zip(param_rows, add_records):
            cmp_vals = {k: (pr.get(op.name) if isinstance(op, Param)
                            else op.value) for k, op in ops.items()}
            if any(cmp_vals[k] != rec.get(k) for k in self._pk):
                # condition matches a row other than the one being
                # inserted — ON CONFLICT semantics diverge, use the
                # find-then-write default for this row
                super().upsert_records(condition, [pr], assignments, [rec])
                continue
            if not logged:
                self.sql_log.append(sql)
                logged = True
            self._conn.execute(sql, _clean_params(
                {**pr, **{"__ins_" + c: rec.get(c) for c in cols}}))
        self._conn.commit()

    def contains_records(self, condition, params) -> bool:
        cur = self._exec(
            f'SELECT EXISTS(SELECT 1 FROM {_q(self._table)} '
            f'WHERE {_render(condition)})', params)
        return bool(cur.fetchone()[0])

    # --------------------------------------------------- selection pushdown

    def query_records(self, condition, params,
                      selection: RecordSelection) -> Iterable[Dict[str, Any]]:
        names = [n for n, _ in selection.select]
        cols = ", ".join(f'{_render(e)} AS {_q(n)}'
                         for n, e in selection.select)
        sql = (f'SELECT {cols} FROM {_q(self._table)} '
               f'WHERE {_render(condition)}')
        if selection.group_by:
            sql += " GROUP BY " + ", ".join(
                _q(g) for g in selection.group_by)
        if selection.having is not None:
            sql += f" HAVING {_render(selection.having)}"
        if selection.order_by:
            sql += " ORDER BY " + ", ".join(
                f'{_q(a)} {"ASC" if asc else "DESC"}'
                for a, asc in selection.order_by)
        if selection.limit is not None or selection.offset is not None:
            sql += f" LIMIT {selection.limit if selection.limit is not None else -1}"
            if selection.offset is not None:
                sql += f" OFFSET {selection.offset}"
        cur = self._exec(sql, params)
        # outputs that are plain bool-column passthroughs keep host parity
        # (sqlite stores BOOL as 0/1)
        bool_outs = [n for n, e in selection.select
                     if isinstance(e, Col) and e.name in self._bools]
        for row in cur.fetchall():
            d = dict(zip(names, row))
            for b in bool_outs:
                if d[b] is not None:
                    d[b] = bool(d[b])
            yield d


# ===================================================================== errors

class SqliteErrorStore:
    """SQLite-backed ErrorStore (core/resilience.py): failed events
    survive a process restart — pair it with a FileSystemPersistenceStore
    for a fully durable recover-and-replay loop.  Events are pickled
    (timestamp, data-row) pairs; listing/purging filter server-side."""

    _SCHEMA = """CREATE TABLE IF NOT EXISTS siddhi_error_store (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        app_name TEXT NOT NULL,
        stream_id TEXT NOT NULL,
        origin TEXT NOT NULL,
        error TEXT NOT NULL,
        timestamp_ms INTEGER NOT NULL,
        attempts INTEGER NOT NULL,
        events BLOB NOT NULL)"""

    def __init__(self, database: str = ":memory:"):
        import threading
        self.database = database
        self._conn = sqlite3.connect(database, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(self._SCHEMA)
            self._conn.commit()

    def store(self, entry) -> int:
        from ..core.resilience import pickle_events
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO siddhi_error_store (app_name, stream_id, "
                "origin, error, timestamp_ms, attempts, events) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                (entry.app_name, entry.stream_id, entry.origin, entry.error,
                 entry.timestamp_ms, entry.attempts,
                 pickle_events(entry.events)))
            self._conn.commit()
            entry.id = cur.lastrowid
            return entry.id

    def list(self, app_name=None, stream_id=None):
        from ..core.resilience import ErrorEntry, unpickle_events
        sql = ("SELECT id, app_name, stream_id, origin, error, "
               "timestamp_ms, attempts, events FROM siddhi_error_store")
        conds, params = [], []
        if app_name is not None:
            conds.append("app_name = ?")
            params.append(app_name)
        if stream_id is not None:
            conds.append("stream_id = ?")
            params.append(stream_id)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        sql += " ORDER BY id"
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return [ErrorEntry(id=r[0], app_name=r[1], stream_id=r[2],
                           origin=r[3], error=r[4], timestamp_ms=r[5],
                           attempts=r[6], events=unpickle_events(r[7]))
                for r in rows]

    def purge(self, app_name=None, ids=None) -> int:
        sql = "DELETE FROM siddhi_error_store"
        conds, params = [], []
        if app_name is not None:
            conds.append("app_name = ?")
            params.append(app_name)
        if ids is not None:
            conds.append("id IN (%s)" % ",".join("?" * len(list(ids))))
            params.extend(ids)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur.rowcount

    def count(self, app_name=None) -> int:
        return len(self.list(app_name))

    def close(self):
        with self._lock:
            self._conn.close()
