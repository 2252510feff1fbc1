"""Expression type inference & checking (analyzer pass 1).

A pure re-statement of plan/expr_compiler's typing rules — promotion
``int ⊂ long ⊂ float ⊂ double``, string concat on ``+``, bool logic —
that *infers without compiling* and reports every violation as a typed
diagnostic instead of raising on the first.  Where the expr compiler
would crash at JIT time (arithmetic on a string column, and/or over
numerics), the analyzer flags SA004 at parse time; where the device
path would silently lose integer exactness in float32 lanes, it flags
SA006.

Unresolvable sub-expressions poison to ``None`` (diagnosed where they
failed) so one bad leaf doesn't cascade into a storm of follow-ups.
"""
from __future__ import annotations

from typing import List, Optional

from ..query_api.definition import AttrType
from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, Expression, In,
                                    IsNull, MathExpr, MathOp, Not, Or,
                                    TimeConstant, Variable)
from ..query_api.position import nearest_pos
from .diagnostics import DiagnosticSink
from .scope import QueryScope

_NUMERIC = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)
_ORDER = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE]

# aggregator result types (core/aggregator.AGGREGATORS)
_AGG_NUMERIC_IN = {"sum", "avg", "min", "max", "minforever", "maxforever",
                   "stddev"}


def promote(lt: AttrType, rt: AttrType) -> AttrType:
    if lt == rt:
        return lt
    if lt in _ORDER and rt in _ORDER:
        return _ORDER[max(_ORDER.index(lt), _ORDER.index(rt))]
    if AttrType.STRING in (lt, rt):
        return AttrType.STRING
    return AttrType.OBJECT


class TypeChecker:
    """Infers the AttrType of expressions against a QueryScope, emitting
    SA002/SA003 (via the scope), SA004/SA005/SA006/SA007 itself."""

    def __init__(self, scope: QueryScope, sink: DiagnosticSink,
                 script_functions=None, known_tables=None):
        self.scope = scope
        self.sink = sink
        self.script_functions = script_functions or {}
        self.known_tables = known_tables if known_tables is not None else {}

    # ------------------------------------------------------------ entry

    def check_condition(self, expr: Expression, what: str) -> None:
        """Type-check a filter/having/on expression and require bool."""
        t = self.infer(expr)
        if t is not None and t not in (AttrType.BOOL, AttrType.OBJECT):
            self.sink.emit(
                "SA005",
                f"{what} expression has type {t.value}, expected bool",
                pos=nearest_pos(expr), query=self.scope.query_name)

    # ------------------------------------------------------------ infer

    def infer(self, expr: Expression) -> Optional[AttrType]:
        if expr is None:
            return None
        if isinstance(expr, TimeConstant):
            return AttrType.LONG
        if isinstance(expr, Constant):
            return _constant_type(expr)
        if isinstance(expr, Variable):
            return self.scope.resolve(expr)
        if isinstance(expr, MathExpr):
            return self._infer_math(expr)
        if isinstance(expr, Compare):
            return self._infer_compare(expr)
        if isinstance(expr, (And, Or)):
            self._require_bool(expr.left, "and/or operand")
            self._require_bool(expr.right, "and/or operand")
            return AttrType.BOOL
        if isinstance(expr, Not):
            self._require_bool(expr.expr, "not operand")
            return AttrType.BOOL
        if isinstance(expr, IsNull):
            if expr.expr is not None:
                # resolution side effects only; a pattern-ref `e1 is null`
                # has no inner expression
                self.infer(expr.expr)
            return AttrType.BOOL
        if isinstance(expr, In):
            self.infer(expr.expr)
            if self.known_tables is not None and \
                    expr.source_id not in self.known_tables:
                self.sink.emit(
                    "SA001",
                    f"'in {expr.source_id}': no such table",
                    pos=nearest_pos(expr), query=self.scope.query_name)
            return AttrType.BOOL
        if isinstance(expr, AttributeFunction):
            return self._infer_function(expr)
        return AttrType.OBJECT

    # ------------------------------------------------------------ pieces

    def _require_bool(self, e: Expression, what: str):
        t = self.infer(e)
        if t is not None and t not in (AttrType.BOOL, AttrType.OBJECT):
            self.sink.emit(
                "SA004", f"{what} has type {t.value}, expected bool",
                pos=nearest_pos(e), query=self.scope.query_name)

    def _infer_math(self, m: MathExpr) -> Optional[AttrType]:
        lt, rt = self.infer(m.left), self.infer(m.right)
        if lt is None or rt is None:
            return None
        if m.op == MathOp.ADD and AttrType.STRING in (lt, rt):
            return AttrType.STRING          # concat
        for t, side in ((lt, m.left), (rt, m.right)):
            if t not in _NUMERIC and t != AttrType.OBJECT:
                self.sink.emit(
                    "SA004",
                    f"arithmetic '{m.op.value}' on {t.value} operand",
                    pos=nearest_pos(side) or nearest_pos(m),
                    query=self.scope.query_name)
                return None
        if AttrType.OBJECT in (lt, rt):
            return AttrType.OBJECT
        self._check_lossy(lt, rt, m)
        return promote(lt, rt)

    def _infer_compare(self, c: Compare) -> Optional[AttrType]:
        lt, rt = self.infer(c.left), self.infer(c.right)
        if lt is None or rt is None:
            return AttrType.BOOL
        ok = (AttrType.OBJECT in (lt, rt)
              or (lt in _NUMERIC and rt in _NUMERIC)
              or (lt == rt == AttrType.STRING)
              or (lt == rt == AttrType.BOOL
                  and c.op in (CompareOp.EQ, CompareOp.NEQ)))
        if not ok:
            self.sink.emit(
                "SA004",
                f"cannot compare {lt.value} {c.op.value} {rt.value}",
                pos=nearest_pos(c), query=self.scope.query_name)
        elif lt in _NUMERIC and rt in _NUMERIC:
            self._check_lossy(lt, rt, c)
        return AttrType.BOOL

    def _check_lossy(self, lt: AttrType, rt: AttrType, node: Expression):
        """int/long meeting float32: exactness dies above 2^24 (SA006)."""
        pair = {lt, rt}
        if AttrType.FLOAT in pair and \
                pair & {AttrType.INT, AttrType.LONG} and \
                _has_integer_variable(node, self.scope):
            intside = (lt if lt in (AttrType.INT, AttrType.LONG)
                       else rt).value
            self.sink.emit(
                "SA006",
                f"implicit {intside}→float promotion loses integer "
                f"exactness above 2^24",
                pos=nearest_pos(node), query=self.scope.query_name)

    # ------------------------------------------------------------ functions

    def _infer_function(self, f: AttributeFunction) -> Optional[AttrType]:
        ns = (f.namespace or "").lower()
        low = f.name.lower()
        arg_ts = [self.infer(a) for a in f.args]

        from ..core.aggregator import is_aggregator
        if is_aggregator(f.namespace, f.name, len(f.args)):
            return self._infer_aggregator(low, f, arg_ts)

        if ns == "":
            t = self._infer_builtin(low, f, arg_ts)
            if t is not None:
                return t
            if f.name in self.script_functions:
                fd = self.script_functions[f.name]
                return getattr(fd, "return_type", None) or AttrType.OBJECT
        if ns == "math":
            if low in ("abs", "round"):
                return arg_ts[0] if arg_ts else AttrType.DOUBLE
            if low in ("ceil", "floor", "sqrt", "log", "log10", "exp",
                       "sin", "cos", "tan", "power", "pow"):
                return AttrType.DOUBLE
        if ns == "str":
            if low in ("concat", "upper", "lower", "trim", "reverse"):
                return AttrType.STRING
            if low == "length":
                return AttrType.INT
            if low in ("contains", "startswith", "endswith",
                       "equalsignorecase"):
                return AttrType.BOOL
        # unknown: may be an extension registered only at runtime
        self.sink.emit(
            "SA007",
            f"unknown function '{(ns + ':') if ns else ''}{f.name}' — "
            f"not a builtin, aggregator or script function",
            pos=nearest_pos(f), query=self.scope.query_name)
        return AttrType.OBJECT

    def _infer_aggregator(self, low: str, f: AttributeFunction,
                          arg_ts: List[Optional[AttrType]]
                          ) -> Optional[AttrType]:
        at = arg_ts[0] if arg_ts else None
        if low in _AGG_NUMERIC_IN and at is not None and \
                at not in _NUMERIC and at != AttrType.OBJECT:
            self.sink.emit(
                "SA004", f"{low}() over non-numeric {at.value} argument",
                pos=nearest_pos(f), query=self.scope.query_name)
            return None
        if low == "sum":
            return (AttrType.LONG if at in (AttrType.INT, AttrType.LONG)
                    else AttrType.DOUBLE)
        if low in ("avg", "stddev"):
            return AttrType.DOUBLE
        if low in ("count", "distinctcount"):
            return AttrType.LONG
        if low in ("min", "max", "minforever", "maxforever"):
            return at
        if low in ("and", "or"):
            return AttrType.BOOL
        return AttrType.OBJECT           # unionset etc.

    def _infer_builtin(self, low: str, f: AttributeFunction,
                       arg_ts: List[Optional[AttrType]]
                       ) -> Optional[AttrType]:
        if low == "coalesce" and arg_ts:
            t = arg_ts[0]
            for a in arg_ts[1:]:
                if t is not None and a is not None:
                    t = promote(t, a)
            return t or AttrType.OBJECT
        if low == "ifthenelse" and len(arg_ts) == 3:
            self._require_bool(f.args[0], "ifThenElse condition")
            a, b = arg_ts[1], arg_ts[2]
            if a is None or b is None:
                return a or b
            return promote(a, b) if a in _NUMERIC else a
        if low in ("cast", "convert") and len(f.args) == 2:
            target = f.args[1]
            if isinstance(target, Constant):
                try:
                    return AttrType.of(str(target.value))
                except Exception:   # noqa: BLE001 — bad type name
                    self.sink.emit(
                        "SA004",
                        f"{low}(): unknown target type "
                        f"{target.value!r}",
                        pos=nearest_pos(f), query=self.scope.query_name)
                    return None
            return AttrType.OBJECT
        if low.startswith("instanceof"):
            return AttrType.BOOL
        if low == "uuid":
            return AttrType.STRING
        if low in ("currenttimemillis", "eventtimestamp"):
            return AttrType.LONG
        if low in ("maximum", "minimum", "max", "min") and len(arg_ts) > 1:
            t = arg_ts[0]
            for a in arg_ts[1:]:
                if t is not None and a is not None:
                    t = promote(t, a)
            return t
        if low == "default" and len(arg_ts) == 2:
            return arg_ts[1]
        if low == "createset":
            return AttrType.OBJECT
        if low == "sizeofset":
            return AttrType.INT
        return None


def _constant_type(c: Constant) -> AttrType:
    if c.type_hint:
        try:
            return AttrType.of(c.type_hint)
        except Exception:   # noqa: BLE001 — bad hint degrades to object
            return AttrType.OBJECT
    if isinstance(c.value, bool):
        return AttrType.BOOL
    if isinstance(c.value, int):
        return AttrType.INT
    if isinstance(c.value, float):
        return AttrType.DOUBLE
    if isinstance(c.value, str):
        return AttrType.STRING
    return AttrType.OBJECT


def _has_integer_variable(node: Expression, scope: QueryScope) -> bool:
    """True if the (sub)expression references an int/long-typed attribute
    — the SA006 trigger; pure int *literals* promote losslessly because
    the compiler folds them."""
    from ..query_api.expression import variables_of
    for v in variables_of(node):
        sid = v.stream_id
        d = None
        if sid is not None and sid in scope.bindings:
            d = scope.bindings[sid][1]
        elif sid is None:
            for name in scope.order:
                cand = scope.bindings[name][1]
                if any(a.name == v.attribute for a in cand.attributes):
                    d = cand
                    break
        if d is None:
            continue
        for a in d.attributes:
            if a.name == v.attribute and a.type in (AttrType.INT,
                                                    AttrType.LONG):
                return True
    return False
