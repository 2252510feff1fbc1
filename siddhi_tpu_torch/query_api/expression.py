"""Expression tree — the typed IR for all scalar computation in queries.

TPU-native counterpart of the reference's expression object model
(reference: modules/siddhi-query-api/src/main/java/io/siddhi/query/api/expression/**,
~20 files: math Add..Mod, conditions And/Or/Not/Compare/In/IsNull, constants,
Variable, AttributeFunction).  Unlike the reference — where each node is later
interpreted per event by an ExpressionExecutor object tree — these nodes are
*compiled once* into vectorised column programs (see siddhi_tpu_torch/plan/expr_compiler.py)
that evaluate a whole event micro-batch with one fused XLA computation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional, Tuple


class CompareOp(Enum):
    LT = "<"
    GT = ">"
    LTE = "<="
    GTE = ">="
    EQ = "=="
    NEQ = "!="


class MathOp(Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"


@dataclass(frozen=True)
class Expression:
    """Base class.  Fluent constructors mirror the reference's static factory
    API (Expression.value/variable/add/compare/... in
    reference expression/Expression.java) so the framework is usable without
    the SiddhiQL text front end."""

    # ---- fluent factories (query-api parity) ----
    @staticmethod
    def value(v: Any) -> "Constant":
        return Constant(v)

    @staticmethod
    def variable(name: str) -> "Variable":
        return Variable(name)

    @staticmethod
    def add(l: "Expression", r: "Expression") -> "MathExpr":
        return MathExpr(MathOp.ADD, l, r)

    @staticmethod
    def subtract(l: "Expression", r: "Expression") -> "MathExpr":
        return MathExpr(MathOp.SUB, l, r)

    @staticmethod
    def multiply(l: "Expression", r: "Expression") -> "MathExpr":
        return MathExpr(MathOp.MUL, l, r)

    @staticmethod
    def divide(l: "Expression", r: "Expression") -> "MathExpr":
        return MathExpr(MathOp.DIV, l, r)

    @staticmethod
    def mod(l: "Expression", r: "Expression") -> "MathExpr":
        return MathExpr(MathOp.MOD, l, r)

    @staticmethod
    def compare(l: "Expression", op: CompareOp, r: "Expression") -> "Compare":
        return Compare(l, op, r)

    @staticmethod
    def and_(l: "Expression", r: "Expression") -> "And":
        return And(l, r)

    @staticmethod
    def or_(l: "Expression", r: "Expression") -> "Or":
        return Or(l, r)

    @staticmethod
    def not_(e: "Expression") -> "Not":
        return Not(e)

    @staticmethod
    def is_null(e: "Expression") -> "IsNull":
        return IsNull(e)

    @staticmethod
    def in_(e: "Expression", source_id: str) -> "In":
        return In(e, source_id)

    @staticmethod
    def function(name: str, *args: "Expression", namespace: Optional[str] = None) -> "AttributeFunction":
        return AttributeFunction(namespace, name, tuple(args))

    @staticmethod
    def time_sec(v: float) -> "TimeConstant":
        return TimeConstant(int(v * 1000))

    @staticmethod
    def time_millisec(v: int) -> "TimeConstant":
        return TimeConstant(int(v))

    @staticmethod
    def time_minute(v: float) -> "TimeConstant":
        return TimeConstant(int(v * 60_000))

    @staticmethod
    def time_hour(v: float) -> "TimeConstant":
        return TimeConstant(int(v * 3_600_000))


@dataclass(frozen=True)
class Constant(Expression):
    value: Any
    # optional explicit siddhi type tag ('int','long','float','double','string','bool')
    type_hint: Optional[str] = None


@dataclass(frozen=True)
class TimeConstant(Constant):
    """A duration literal (`5 sec`, `1 min`...) normalised to milliseconds.
    (reference: expression/constant/TimeConstant.java)"""
    value: int = 0
    type_hint: Optional[str] = "long"

    @property
    def millis(self) -> int:
        return self.value


@dataclass(frozen=True)
class Variable(Expression):
    """Attribute reference, optionally qualified: ``[stream_id.]attribute`` with an
    optional pattern-event index: ``e1[2].price``, ``e1[last].price``.
    (reference: expression/Variable.java)"""
    attribute: str = ""
    stream_id: Optional[str] = None
    # index within a pattern's captured event chain; None = default,
    # -1 encodes LAST (reference StateEvent LAST addressing, state/StateEvent.java:138-182)
    stream_index: Optional[int] = None

    def of_stream(self, stream_id: str) -> "Variable":
        return dataclasses.replace(self, stream_id=stream_id)


LAST_INDEX = -1  # Variable.stream_index value meaning e[last]


@dataclass(frozen=True)
class MathExpr(Expression):
    op: MathOp = MathOp.ADD
    left: Expression = None
    right: Expression = None


@dataclass(frozen=True)
class Compare(Expression):
    left: Expression = None
    op: CompareOp = CompareOp.EQ
    right: Expression = None


@dataclass(frozen=True)
class And(Expression):
    left: Expression = None
    right: Expression = None


@dataclass(frozen=True)
class Or(Expression):
    left: Expression = None
    right: Expression = None


@dataclass(frozen=True)
class Not(Expression):
    expr: Expression = None


@dataclass(frozen=True)
class IsNull(Expression):
    expr: Optional[Expression] = None
    # `e1 is null` inside patterns refers to a stream state, not an attribute
    stream_id: Optional[str] = None
    stream_index: Optional[int] = None


@dataclass(frozen=True)
class In(Expression):
    """``expr in TableName`` membership test against a table.
    (reference: expression/condition/In.java)"""
    expr: Expression = None
    source_id: str = ""


@dataclass(frozen=True)
class AttributeFunction(Expression):
    """Function call ``ns:name(args...)`` — built-ins (coalesce, cast, convert,
    ifThenElse, ...) or extension functions resolved through the extension
    registry.  (reference: expression/AttributeFunction.java + executor/function/**)"""
    namespace: Optional[str] = None
    name: str = ""
    args: Tuple[Expression, ...] = ()


def walk(expr: Expression):
    """Yield every node of an expression tree (pre-order)."""
    if expr is None:
        return
    yield expr
    if isinstance(expr, MathExpr):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, Compare):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, (And, Or)):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, Not):
        yield from walk(expr.expr)
    elif isinstance(expr, IsNull):
        if expr.expr is not None:
            yield from walk(expr.expr)
    elif isinstance(expr, In):
        yield from walk(expr.expr)
    elif isinstance(expr, AttributeFunction):
        for a in expr.args:
            yield from walk(a)


def variables_of(expr: Expression) -> List[Variable]:
    return [n for n in walk(expr) if isinstance(n, Variable)]


def expr_children(e):
    """Dataclass-field children of an expression node — list AND tuple
    fields (AttributeFunction.args is a Tuple; a list-only walk silently
    skips nodes nested in function arguments)."""
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        vs = v if isinstance(v, (list, tuple)) else [v]
        for x in vs:
            if hasattr(x, "__dataclass_fields__"):
                yield x
