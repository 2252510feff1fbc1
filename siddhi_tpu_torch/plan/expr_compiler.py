"""Expression compiler: Expression tree → vectorised column program.

Counterpart of ``siddhi_tpu/plan/expr_compiler.py``: the same compiler,
plus :class:`TorchXP`, the array namespace the device programs use in
place of ``jax.numpy``.

Replacement for the reference's ExpressionExecutor interpreter
(siddhi-core executor/** — 163 files, ~10k LoC of per-type executor classes
instantiated by util/parser/ExpressionParser.java).  The reference walks an
executor object tree once per event; here the tree is compiled ONCE into a
closure over whole columns.  Evaluated with numpy on the host path and with
:class:`TorchXP` over torch tensors on the device path (numeric expressions
only — string columns are host-side or dictionary-encoded first).

Type promotion follows the reference's Java semantics: int ⊂ long ⊂ float ⊂
double; integer division truncates toward zero; `%` keeps the dividend's sign
(Java `%`, i.e. fmod).
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..query_api.definition import AttrType
from ..query_api.expression import (And, AttributeFunction, Compare, CompareOp,
                                    Constant, Expression, In, IsNull, MathExpr,
                                    MathOp, Not, Or, TimeConstant, Variable)
from ..utils.errors import (ExtensionNotFoundError,
                            SiddhiAppValidationException)

_NUMERIC_ORDER = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE]


def promote(lt: AttrType, rt: AttrType) -> AttrType:
    if lt == rt:
        return lt
    if lt in _NUMERIC_ORDER and rt in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(lt),
                                  _NUMERIC_ORDER.index(rt))]
    if AttrType.STRING in (lt, rt):
        return AttrType.STRING
    return AttrType.OBJECT


def np_dtype(t: AttrType):
    from ..core.event import dtype_for
    return dtype_for(t)


class EvalCtx:
    """Runtime bindings for a compiled expression: the current chunk's columns
    + timestamps, plus qualified bindings for join/pattern/table scopes.

    `qualified[(stream_id, index)][attr]` may be a column (len n) or a scalar
    (captured pattern event attribute broadcast over the batch)."""

    __slots__ = ("columns", "timestamps", "n", "qualified", "tables", "extra")

    def __init__(self, columns: Dict[str, np.ndarray], timestamps: np.ndarray,
                 n: Optional[int] = None,
                 qualified: Optional[Dict[Tuple[str, Optional[int]],
                                          Dict[str, Any]]] = None,
                 tables: Optional[Dict[str, Any]] = None):
        self.columns = columns
        self.timestamps = timestamps
        self.n = n if n is not None else len(timestamps)
        self.qualified = qualified or {}
        self.tables = tables or {}


Getter = Callable[[EvalCtx], Any]


@dataclass
class CompiledExpr:
    fn: Getter
    type: AttrType

    def __call__(self, ctx: EvalCtx):
        return self.fn(ctx)


class Scope:
    """Compile-time name resolution: which attributes exist, their types, and
    how to fetch their columns at runtime.  Mirrors the role of the reference's
    MetaStreamEvent/MetaStateEvent variable-position binding
    (util/parser/helper/QueryParserHelper.updateVariablePosition)."""

    def __init__(self):
        # (stream_id|None, index|None, attr) -> (getter, type)
        self._entries: Dict[Tuple[Optional[str], Optional[int], str],
                            Tuple[Getter, AttrType]] = {}
        self._default_ids: List[str] = []
        self.function_resolver: Optional[Callable[[AttributeFunction],
                                                  Optional[CompiledExpr]]] = None

    def add(self, stream_id: Optional[str], attr: str, typ: AttrType,
            getter: Getter, index: Optional[int] = None):
        self._entries[(stream_id, index, attr)] = (getter, typ)

    def add_primary(self, stream_id: Optional[str], alias: Optional[str],
                    definition) -> None:
        """Register a definition whose columns live in ctx.columns (the chunk
        being processed)."""
        for a in definition.attributes:
            def getter(ctx, name=a.name):
                return ctx.columns[name]
            self.add(None, a.name, a.type, getter)
            if stream_id:
                self.add(stream_id, a.name, a.type, getter)
            if alias and alias != stream_id:
                self.add(alias, a.name, a.type, getter)

    def add_qualified(self, stream_id: str, definition,
                      index: Optional[int] = None,
                      also_unqualified: bool = False):
        """Register a definition resolved through ctx.qualified[(stream_id, index)]."""
        for a in definition.attributes:
            def getter(ctx, name=a.name, sid=stream_id, idx=index):
                return ctx.qualified[(sid, idx)][name]
            self.add(stream_id, a.name, a.type, getter, index)
            if index is None or index == 0:
                # unindexed access e1.price defaults to first/captured event
                self.add(stream_id, a.name, a.type, getter, None)
            if also_unqualified and (None, None, a.name) not in self._entries:
                self.add(None, a.name, a.type, getter)

    def resolves(self, stream_id: Optional[str], attr: str) -> bool:
        """True when (stream_id, attr) binds to a column in this scope."""
        return (stream_id, None, attr) in self._entries or \
            (stream_id, 0, attr) in self._entries

    def resolve(self, var: Variable) -> Tuple[Getter, AttrType]:
        keys = []
        if var.stream_id is not None:
            keys.append((var.stream_id, var.stream_index, var.attribute))
            if var.stream_index is None:
                keys.append((var.stream_id, 0, var.attribute))
        else:
            keys.append((None, var.stream_index, var.attribute))
            keys.append((None, None, var.attribute))
        for k in keys:
            if k in self._entries:
                return self._entries[k]
        # unqualified fallback: unique match across qualified entries
        if var.stream_id is None:
            matches = [(k, v) for k, v in self._entries.items()
                       if k[2] == var.attribute]
            ids = {k[0] for k, _ in matches}
            if len(matches) >= 1 and len(ids) == 1:
                return matches[0][1]
            if len(ids) > 1:
                raise SiddhiAppValidationException(
                    f"Ambiguous attribute '{var.attribute}' "
                    f"(candidates: {sorted(i for i in ids if i)})")
        raise SiddhiAppValidationException(
            f"Cannot resolve attribute "
            f"'{(var.stream_id + '.') if var.stream_id else ''}{var.attribute}'")


# ------------------------------------------------------------------ compiler

class TorchXP:
    """The slice of the ``jax.numpy`` namespace the compiler calls, over
    torch tensors on one device.

    The JAX package runs its device programs with x64 off, so every
    ``float64`` there is ``float32`` and every ``int64`` is ``int32``;
    :meth:`dtype` maps numpy dtypes the same way, so a compiled
    expression yields the same dtypes (and values) in both packages.
    Scalars (Python or numpy) are kept as scalars where torch accepts
    them, so they promote as JAX's scalars do (never widening a tensor),
    and are made 0-d tensors on the device where torch needs a tensor.
    ``round`` is half-to-even in both."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        t = torch
        self._dtypes = {
            np.dtype(np.float64): t.float32, np.dtype(np.float32): t.float32,
            np.dtype(np.int64): t.int32, np.dtype(np.int32): t.int32,
            np.dtype(np.bool_): t.bool}
        for name in ("abs", "ceil", "floor", "sqrt", "log", "log10", "exp",
                     "sin", "cos", "tan", "round", "trunc"):
            fn = getattr(t, name)
            setattr(self, name, lambda v, _fn=fn: _fn(self.tensor(v)))

    def dtype(self, dt):
        """numpy dtype → torch dtype under the no-x64 mapping."""
        if isinstance(dt, self.torch.dtype):
            return dt
        return self._dtypes[np.dtype(dt)]

    def tensor(self, v, dtype=None):
        """``v`` as a tensor on the device (numpy/Python scalars and
        arrays are copied; float64/int64 narrow per :meth:`dtype`)."""
        t = self.torch
        if isinstance(v, t.Tensor):
            return v if dtype is None else v.to(dtype)
        if dtype is None:
            dtype = self.dtype(np.asarray(v).dtype)
        return t.as_tensor(np.asarray(v), device=self.device).to(dtype)

    def asarray(self, v, dt=None):
        return self.tensor(v, None if dt is None else self.dtype(dt))

    def logical_and(self, a, b):
        return self.torch.logical_and(self.tensor(a), self.tensor(b))

    def logical_or(self, a, b):
        return self.torch.logical_or(self.tensor(a), self.tensor(b))

    def logical_not(self, a):
        return self.torch.logical_not(self.tensor(a))

    def fmod(self, a, b):
        return self.torch.fmod(self.tensor(a), b)

    def full(self, n, v, dt):
        return self.torch.full((n,), v, dtype=self.dtype(dt),
                               device=self.device)

    def where(self, c, a, b):
        t = self.torch
        a = a if isinstance(a, t.Tensor) else self.tensor(a)
        b = b if isinstance(b, t.Tensor) else self.tensor(b)
        return t.where(self.tensor(c, t.bool), a, b)

    def maximum(self, a, b):
        return self.torch.maximum(self.tensor(a), self.tensor(b))

    def minimum(self, a, b):
        return self.torch.minimum(self.tensor(a), self.tensor(b))

    def power(self, a, b):
        return self.torch.pow(self.tensor(a), b)

    def divide(self, a, b):
        """``a / b`` as one IEEE division on every device, as JAX divides:
        torch computes a scalar over a tensor as ``reciprocal(b) * a``,
        and on CUDA a tensor over a scalar as ``a * (1 / b)``, each of
        which can round otherwise.  The scalar becomes a tensor of the
        result's dtype (rounded as torch rounds it)."""
        t = self.torch
        ta, tb = isinstance(a, t.Tensor), isinstance(b, t.Tensor)
        if ta == tb or (ta and a.device.type == "cpu"):
            return a / b
        ref = a if ta else b
        dt = t.result_type(a, b)
        if ta:
            return a / t.full_like(ref, b, dtype=dt)
        return t.full_like(ref, a, dtype=dt) / b


class ExprCompiler:
    """Compiles with a pluggable array namespace: numpy (host) or
    :class:`TorchXP` (device programs)."""

    def __init__(self, scope: Scope, xp=np,
                 script_functions: Optional[Dict[str, Any]] = None,
                 extension_registry=None, tables: Optional[Dict] = None):
        self.scope = scope
        self.xp = xp
        self.script_functions = script_functions or {}
        self.extension_registry = extension_registry
        self.tables = tables or {}

    def compile(self, expr: Expression) -> CompiledExpr:
        xp = self.xp
        if isinstance(expr, TimeConstant):
            v = np.int64(expr.value)
            return CompiledExpr(lambda ctx: v, AttrType.LONG)
        if isinstance(expr, Constant):
            return self._compile_constant(expr)
        if isinstance(expr, Variable):
            getter, typ = self.scope.resolve(expr)
            return CompiledExpr(getter, typ)
        if isinstance(expr, MathExpr):
            return self._compile_math(expr)
        if isinstance(expr, Compare):
            return self._compile_compare(expr)
        if isinstance(expr, And):
            l, r = self.compile(expr.left), self.compile(expr.right)
            return CompiledExpr(lambda ctx: xp.logical_and(l.fn(ctx), r.fn(ctx)),
                                AttrType.BOOL)
        if isinstance(expr, Or):
            l, r = self.compile(expr.left), self.compile(expr.right)
            return CompiledExpr(lambda ctx: xp.logical_or(l.fn(ctx), r.fn(ctx)),
                                AttrType.BOOL)
        if isinstance(expr, Not):
            e = self.compile(expr.expr)
            return CompiledExpr(lambda ctx: xp.logical_not(e.fn(ctx)),
                                AttrType.BOOL)
        if isinstance(expr, IsNull):
            return self._compile_is_null(expr)
        if isinstance(expr, In):
            return self._compile_in(expr)
        if isinstance(expr, AttributeFunction):
            return self._compile_function(expr)
        raise SiddhiAppValidationException(f"Cannot compile {expr!r}")

    # -------------------------------------------------------------- pieces

    def _compile_constant(self, c: Constant) -> CompiledExpr:
        hint = c.type_hint
        if hint is None:
            if isinstance(c.value, bool):
                hint = "bool"
            elif isinstance(c.value, int):
                hint = "int"
            elif isinstance(c.value, float):
                hint = "double"
            elif isinstance(c.value, str):
                hint = "string"
            else:
                hint = "object"
        typ = AttrType.of(hint)
        if typ in (AttrType.STRING, AttrType.OBJECT):
            v = c.value
        else:
            v = np_dtype(typ)(c.value)
        return CompiledExpr(lambda ctx: v, typ)

    def _compile_math(self, m: MathExpr) -> CompiledExpr:
        xp = self.xp
        l, r = self.compile(m.left), self.compile(m.right)
        if m.op == MathOp.ADD and (l.type == AttrType.STRING or
                                   r.type == AttrType.STRING):
            # string concatenation on host path
            def concat(ctx):
                a, b = l.fn(ctx), r.fn(ctx)
                return _str_binop(a, b, lambda x, y: str(x) + str(y))
            return CompiledExpr(concat, AttrType.STRING)
        out_t = promote(l.type, r.type)
        integer = out_t in (AttrType.INT, AttrType.LONG)
        dt = np_dtype(out_t)
        if m.op == MathOp.ADD:
            g = lambda a, b: xp.asarray(a + b, dt)
            py = lambda a, b: a + b
        elif m.op == MathOp.SUB:
            g = lambda a, b: xp.asarray(a - b, dt)
            py = lambda a, b: a - b
        elif m.op == MathOp.MUL:
            g = lambda a, b: xp.asarray(a * b, dt)
            py = lambda a, b: a * b
        elif m.op == MathOp.DIV:
            if integer:
                # Java integer division truncates toward zero
                g = lambda a, b: xp.asarray(xp.trunc(a / b), dt)
                py = lambda a, b: int(a / b)
            elif isinstance(xp, TorchXP):
                g = lambda a, b: xp.asarray(xp.divide(a, b), dt)
                py = lambda a, b: a / b
            else:
                g = lambda a, b: xp.asarray(a / b, dt)
                py = lambda a, b: a / b
        elif m.op == MathOp.MOD:
            # Java % = fmod (sign of dividend)
            g = lambda a, b: xp.asarray(xp.fmod(a, b), dt)
            py = lambda a, b: float(np.fmod(a, b))
        else:
            raise SiddhiAppValidationException(f"Unknown math op {m.op}")

        def fn(ctx):
            a, b = l.fn(ctx), r.fn(ctx)
            if _maybe_null(a) or _maybe_null(b):
                # null operand → null result (reference math executors
                # return null when either side is null)
                return _null_binop(a, b, py)
            return g(a, b)
        return CompiledExpr(fn, out_t)

    def _compile_compare(self, c: Compare) -> CompiledExpr:
        xp = self.xp
        l, r = self.compile(c.left), self.compile(c.right)
        op = c.op
        if AttrType.STRING in (l.type, r.type) or \
           AttrType.OBJECT in (l.type, r.type):
            py = {CompareOp.LT: lambda a, b: a < b,
                  CompareOp.GT: lambda a, b: a > b,
                  CompareOp.LTE: lambda a, b: a <= b,
                  CompareOp.GTE: lambda a, b: a >= b,
                  CompareOp.EQ: lambda a, b: a == b,
                  CompareOp.NEQ: lambda a, b: a != b}[op]
            if op in (CompareOp.LT, CompareOp.GT, CompareOp.LTE,
                      CompareOp.GTE):
                # Java String.compareTo orders by UTF-16 code unit, not
                # code point; the orders diverge only when a
                # supplementary-plane character is present — encode to
                # utf-16-be bytes only then (plain strings keep the
                # native compare)
                base = py

                def py(a, b, _base=base):
                    if isinstance(a, str) and isinstance(b, str) and \
                            ((a and max(a) > "\uffff") or
                             (b and max(b) > "\uffff")):
                        return _base(a.encode("utf-16-be"),
                                     b.encode("utf-16-be"))
                    return _base(a, b)

            def fn(ctx):
                a, b = l.fn(ctx), r.fn(ctx)
                return _obj_compare(a, b, py)
            return CompiledExpr(fn, AttrType.BOOL)
        opf = {CompareOp.LT: lambda a, b: a < b,
               CompareOp.GT: lambda a, b: a > b,
               CompareOp.LTE: lambda a, b: a <= b,
               CompareOp.GTE: lambda a, b: a >= b,
               CompareOp.EQ: lambda a, b: a == b,
               CompareOp.NEQ: lambda a, b: a != b}[op]

        def fn(ctx):
            a, b = l.fn(ctx), r.fn(ctx)
            if _maybe_null(a) or _maybe_null(b):
                # null operands compare false (reference per-type compare
                # executors skip null data)
                return _obj_compare(a, b, opf)
            return opf(a, b)
        return CompiledExpr(fn, AttrType.BOOL)

    def _compile_is_null(self, e: IsNull) -> CompiledExpr:
        xp = self.xp
        if e.expr is None:
            sid, idx = e.stream_id, e.stream_index
            # `a is null` on a bare identifier is ambiguous: a pattern
            # state-ref check or an attribute null-check.  The reference
            # resolves by name at parse time (ExpressionParser IsNull
            # branch); here, an identifier that resolves as a plain
            # attribute in scope compiles to the attribute check.
            if idx is None and self.scope.resolves(None, sid):
                return self._compile_is_null(IsNull(Variable(sid)))

            def fn(ctx):
                q = ctx.qualified.get((sid, idx if idx is not None else 0))
                absent = q is None or all(v is None for v in q.values())
                return xp.full(ctx.n, absent, bool)
            return CompiledExpr(fn, AttrType.BOOL)
        inner = self.compile(e.expr)

        def fn(ctx):
            # numeric columns normally carry no null lane, but absent
            # pattern/outer-join captures surface as None / object arrays
            v = inner.fn(ctx)
            if v is None:
                return np.ones(ctx.n, bool)
            if isinstance(v, np.ndarray) and v.dtype == object:
                return np.asarray([x is None for x in v], bool)
            if not isinstance(v, np.ndarray):
                return np.full(ctx.n, v is None, bool)
            return np.zeros(ctx.n, bool)
        return CompiledExpr(fn, AttrType.BOOL)

    def _compile_in(self, e: In) -> CompiledExpr:
        inner = self.compile(e.expr)
        source_id = e.source_id
        tables = self.tables

        def fn(ctx):
            table = ctx.tables.get(source_id) or tables.get(source_id)
            if table is None:
                raise SiddhiAppValidationException(
                    f"'in {source_id}': unknown table")
            return table.contains_column(inner.fn(ctx), ctx.n)
        return CompiledExpr(fn, AttrType.BOOL)

    # -------------------------------------------------------------- functions

    def _compile_function(self, f: AttributeFunction) -> CompiledExpr:
        # 1. scope hook (aggregators injected by the selector compiler)
        if self.scope.function_resolver is not None:
            res = self.scope.function_resolver(f)
            if res is not None:
                return res
        name = f.name
        ns = (f.namespace or "").lower()
        args = [self.compile(a) for a in f.args]
        xp = self.xp

        if ns in ("", "math", "str"):
            built = self._builtin(ns, name, f, args)
            if built is not None:
                return built
        # 2. script functions (define function)
        if name in self.script_functions:
            sf = self.script_functions[name]
            return sf.compile_call(args)
        # 3. extension registry
        if self.extension_registry is not None:
            ext = self.extension_registry.find_function(ns, name)
            if ext is not None:
                return ext.compile_call(args, self)
        raise ExtensionNotFoundError(
            f"No function extension '{(ns + ':') if ns else ''}{name}'")

    def _builtin(self, ns: str, name: str, f: AttributeFunction,
                 args: List[CompiledExpr]) -> Optional[CompiledExpr]:
        xp = self.xp
        low = name.lower()
        if ns == "" or ns is None:
            if low == "coalesce":
                def fn(ctx):
                    out = None
                    for a in args:
                        v = a.fn(ctx)
                        if out is None:
                            out = np.asarray(v, object) if not isinstance(
                                v, np.ndarray) else v.astype(object)
                            out = out.copy()
                        else:
                            m = np.asarray([x is None for x in out], bool)
                            if m.any():
                                vv = np.broadcast_to(
                                    np.asarray(v, object), out.shape)
                                out[m] = vv[m]
                    return out
                return CompiledExpr(fn, args[0].type)
            if low == "ifthenelse":
                c, a, b = args
                t = promote(a.type, b.type) if a.type in _NUMERIC_ORDER else a.type
                if t in (AttrType.STRING, AttrType.OBJECT):
                    def fn(ctx):
                        cond = np.asarray(c.fn(ctx), bool)
                        av = np.broadcast_to(np.asarray(a.fn(ctx), object),
                                             cond.shape)
                        bv = np.broadcast_to(np.asarray(b.fn(ctx), object),
                                             cond.shape)
                        return np.where(cond, av, bv)
                else:
                    fn = lambda ctx: xp.where(c.fn(ctx), a.fn(ctx), b.fn(ctx))
                return CompiledExpr(fn, t)
            if low in ("cast", "convert"):
                target = f.args[1]
                tname = target.value if isinstance(target, Constant) else "object"
                typ = AttrType.of(str(tname))
                src = args[0]
                if typ == AttrType.STRING:
                    def fn(ctx):
                        v = src.fn(ctx)
                        arr = np.asarray(v) if not np.isscalar(v) else np.asarray([v])
                        return np.asarray([None if x is None else str(x)
                                           for x in arr.tolist()], object)
                else:
                    dt = np_dtype(typ)
                    def fn(ctx):
                        v = src.fn(ctx)
                        if isinstance(v, np.ndarray) and v.dtype == object:
                            return np.asarray(
                                [dt(0) if x is None else dt(float(x))
                                 if typ in (AttrType.FLOAT, AttrType.DOUBLE)
                                 else dt(int(float(x))) for x in v])
                        return xp.asarray(v, dt)
                return CompiledExpr(fn, typ)
            if low.startswith("instanceof"):
                want = low[len("instanceof"):]
                tmap = {"integer": AttrType.INT, "long": AttrType.LONG,
                        "float": AttrType.FLOAT, "double": AttrType.DOUBLE,
                        "boolean": AttrType.BOOL, "string": AttrType.STRING}
                want_t = tmap.get(want)
                src = args[0]
                def fn(ctx):
                    if src.type == want_t:
                        return np.ones(ctx.n, bool)
                    if src.type in (AttrType.OBJECT,):
                        v = src.fn(ctx)
                        pyt = {AttrType.INT: int, AttrType.LONG: int,
                               AttrType.FLOAT: float, AttrType.DOUBLE: float,
                               AttrType.BOOL: bool, AttrType.STRING: str}[want_t]
                        return np.asarray(
                            [isinstance(x, pyt) for x in np.asarray(v, object)],
                            bool)
                    return np.zeros(ctx.n, bool)
                return CompiledExpr(fn, AttrType.BOOL)
            if low == "uuid":
                def fn(ctx):
                    return np.asarray([str(uuid.uuid4()) for _ in range(ctx.n)],
                                      object)
                return CompiledExpr(fn, AttrType.STRING)
            if low == "currenttimemillis":
                return CompiledExpr(
                    lambda ctx: np.full(ctx.n, int(time.time() * 1000),
                                        np.int64), AttrType.LONG)
            if low == "eventtimestamp":
                return CompiledExpr(lambda ctx: ctx.timestamps, AttrType.LONG)
            if low in ("maximum", "max") and len(args) > 1:
                t = args[0].type
                for a in args[1:]:
                    t = promote(t, a.type)
                def fn(ctx):
                    vals = [a.fn(ctx) for a in args]
                    out = vals[0]
                    for v in vals[1:]:
                        out = xp.maximum(out, v)
                    return out
                return CompiledExpr(fn, t)
            if low in ("minimum", "min") and len(args) > 1:
                t = args[0].type
                for a in args[1:]:
                    t = promote(t, a.type)
                def fn(ctx):
                    vals = [a.fn(ctx) for a in args]
                    out = vals[0]
                    for v in vals[1:]:
                        out = xp.minimum(out, v)
                    return out
                return CompiledExpr(fn, t)
            if low == "default":
                src, dflt = args
                def fn(ctx):
                    v = src.fn(ctx)
                    if isinstance(v, np.ndarray) and v.dtype == object:
                        d = dflt.fn(ctx)
                        out = v.copy()
                        m = np.asarray([x is None for x in out], bool)
                        dv = np.broadcast_to(np.asarray(d, object), out.shape)
                        out[m] = dv[m]
                        return out
                    return v
                return CompiledExpr(fn, dflt.type)
            if low == "createset":
                src = args[0]
                def fn(ctx):
                    v = src.fn(ctx)
                    arr = v if isinstance(v, np.ndarray) else np.asarray([v])
                    out = np.empty(len(arr), object)
                    for i, x in enumerate(arr.tolist()):
                        out[i] = {x}
                    return out
                return CompiledExpr(fn, AttrType.OBJECT)
            if low == "sizeofset":
                src = args[0]
                def fn(ctx):
                    v = src.fn(ctx)
                    arr = v if isinstance(v, np.ndarray) else np.asarray([v], object)
                    return np.asarray([len(x) if x is not None else 0
                                       for x in arr], np.int32)
                return CompiledExpr(fn, AttrType.INT)
        if ns == "math":
            unary = {"abs": xp.abs, "ceil": xp.ceil, "floor": xp.floor,
                     "sqrt": xp.sqrt, "log": xp.log, "log10": xp.log10,
                     "exp": xp.exp, "sin": xp.sin, "cos": xp.cos,
                     "tan": xp.tan, "round": xp.round}
            if low in unary:
                g = unary[low]
                a = args[0]
                out_t = a.type if low in ("abs", "round") else AttrType.DOUBLE
                return CompiledExpr(lambda ctx: g(a.fn(ctx)), out_t)
            if low in ("power", "pow"):
                a, b = args
                return CompiledExpr(lambda ctx: xp.power(a.fn(ctx), b.fn(ctx)),
                                    AttrType.DOUBLE)
        if ns == "str":
            if low == "concat":
                def fn(ctx):
                    parts = [a.fn(ctx) for a in args]
                    out = None
                    for p in parts:
                        p = np.asarray(p, object)
                        out = p.copy() if out is None else _str_binop(
                            out, p, lambda x, y: str(x) + str(y))
                    return out
                return CompiledExpr(fn, AttrType.STRING)
            str_map = {
                "length": (lambda s: len(s), AttrType.INT, np.int32),
                "upper": (lambda s: s.upper(), AttrType.STRING, object),
                "lower": (lambda s: s.lower(), AttrType.STRING, object),
                "trim": (lambda s: s.strip(), AttrType.STRING, object),
                "reverse": (lambda s: s[::-1], AttrType.STRING, object),
            }
            if low in str_map:
                g, t, dt = str_map[low]
                a = args[0]
                def fn(ctx):
                    v = np.asarray(a.fn(ctx), object)
                    flat = v if v.ndim else v.reshape(1)
                    return np.asarray([None if x is None else g(str(x))
                                       for x in flat], dt)
                return CompiledExpr(fn, t)
            str2_map = {
                "contains": lambda x, y: y in x,
                "startswith": lambda x, y: x.startswith(y),
                "endswith": lambda x, y: x.endswith(y),
                "equalsignorecase": lambda x, y: x.lower() == y.lower(),
            }
            if low in str2_map:
                g = str2_map[low]
                a, b = args

                def fn(ctx, _g=g):
                    va = np.asarray(a.fn(ctx), object)
                    vb = b.fn(ctx)
                    vb_arr = np.broadcast_to(np.asarray(vb, object),
                                             va.shape)
                    return np.asarray(
                        [False if x is None or y is None
                         else _g(str(x), str(y))
                         for x, y in zip(va, vb_arr)], bool)
                return CompiledExpr(fn, AttrType.BOOL)
        return None


def _str_binop(a, b, g):
    aa = np.asarray(a, object)
    bb = np.asarray(b, object)
    if aa.ndim == 0 and bb.ndim == 0:
        return g(aa.item(), bb.item())
    n = max(aa.size if aa.ndim else 1, bb.size if bb.ndim else 1)
    aa = np.broadcast_to(aa, (n,))
    bb = np.broadcast_to(bb, (n,))
    out = np.empty(n, object)
    for i in range(n):
        out[i] = g(aa[i], bb[i])
    return out


def _maybe_null(v):
    if v is None:
        return True
    return isinstance(v, np.ndarray) and v.dtype == object


def _null_binop(a, b, py):
    """Elementwise binary op over possibly-null object operands; null in →
    null out."""
    aa = np.asarray(a, object)
    bb = np.asarray(b, object)
    if aa.ndim == 0 and bb.ndim == 0:
        x, y = aa.item(), bb.item()
        return None if x is None or y is None else py(x, y)
    n = max(aa.size if aa.ndim else 1, bb.size if bb.ndim else 1)
    aa = np.broadcast_to(aa if aa.ndim else aa.reshape(1), (n,))
    bb = np.broadcast_to(bb if bb.ndim else bb.reshape(1), (n,))
    out = np.empty(n, object)
    for i in range(n):
        x, y = aa[i], bb[i]
        out[i] = None if x is None or y is None else py(x, y)
    return out


def _obj_compare(a, b, py):
    aa = np.asarray(a, object)
    bb = np.asarray(b, object)
    if aa.ndim == 0 and bb.ndim == 0:
        x, y = aa.item(), bb.item()
        if x is None or y is None:
            # reference law: ANY null operand compares false, every op
            # (CompareConditionExpressionExecutor.execute)
            return np.bool_(False)
        return np.bool_(py(x, y))
    n = max(aa.size if aa.ndim else 1, bb.size if bb.ndim else 1)
    aa = np.broadcast_to(aa, (n,))
    bb = np.broadcast_to(bb, (n,))
    out = np.empty(n, bool)
    for i in range(n):
        x, y = aa[i], bb[i]
        if x is None or y is None:
            out[i] = False
        else:
            out[i] = py(x, y)
    return out
