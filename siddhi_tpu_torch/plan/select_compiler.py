"""Selection compiler: group-by / having / order-by / limit → device plan.

Lowers a query's ``Selector`` tail (having predicate, order-by spec,
limit/offset) into a pure-data ``SelectProgram`` that the egress-side
device kernel (ops/select.py) interprets: having atoms become exact
two-float ("pair") comparisons over the grouped-agg output planes,
order-by keys become iterated stable sort passes replicating the host
``QuerySelector``'s numpy semantics literally, and limit/offset become
static slice parameters.  The grouped segment reductions themselves stay
on the ops/grouped_agg lane machinery — this module only decides HOW the
per-emission values it already produces are masked, ordered and sliced
without a host hop.

Exactness contract (device == host, value-identical):

  * float ``sum`` outputs ride the kernel's normalized two-float pairs
    (hi = f32 rounding of the represented value, |lo| <= ulp(hi)/2).
    The host compares the f64 value hi+lo — which is EXACT for a
    normalized f32 pair — so lexicographic (hi, lo) comparison equals
    the host's f64 comparison.
  * ``count`` and INT/LONG min/max/…Forever outputs are exact i32 values
    and convert losslessly to normalized pairs on device.
  * constants must be exactly representable as two float32s
    (c == f64(f32(c)) + f64(f32(c - f64(f32(c))))); anything else blocks.
  * avg/stdDev (f64 division), exact int64 sums (hi*65536 overflows a
    pair), group-key columns, string/extension aggregates and arithmetic
    over outputs are NOT device-expressible — the query keeps the host
    ``QuerySelector`` (the documented, value-identical fallback) and the
    blocking reason is surfaced (analyzer SP012, planner backend_reason).

Shape gates (host-path semantics that device selection must not break):

  * ``limit``/``offset`` over a sliding window are host-only: the host
    selector slices CURRENT and EXPIRED rows together, so expired rows
    share the limited slots (core/output.py filters types only after the
    selector).  Running aggregates (no window) have no expired rows.
  * ``order-by``/``limit`` inside a partition are host-only: the host
    applies them per key instance, not per chunk.  ``having`` is
    row-wise and stays expressible in keyed mode.

This module is jax-free (like plan/shapes.py) so analysis/ and tooling
can import the expressibility gate without pulling in a backend; the
kernel import happens lazily in plan/gagg_compiler._build_step.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..query_api import SingleInputStream
from ..query_api.definition import AttrType
from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, MathExpr, Not,
                                    Or, Variable)

_INT_TYPES = (AttrType.INT, AttrType.LONG)
_AGG_NAMES = {"sum", "count", "avg", "min", "max", "minforever",
              "maxforever", "stddev"}

#: kill switch — selection compiles to device unless =0/off/false
SELECT_ENV = "SIDDHI_TPU_SELECT"

_CMP = {CompareOp.LT: "lt", CompareOp.GT: "gt", CompareOp.LTE: "le",
        CompareOp.GTE: "ge", CompareOp.EQ: "eq", CompareOp.NEQ: "ne"}

# min/max/…Forever output → (windowed plane, forever plane) name stems;
# ops/select.py maps the stems onto the 13 grouped-agg output planes
_MINMAX_PLANES = {"min": "wmn", "max": "wmx",
                  "minforever": "amn", "maxforever": "amx"}


def select_enabled() -> bool:
    raw = os.environ.get(SELECT_ENV, "").strip().lower()
    return raw not in ("0", "false", "off", "no")


class SelectionBlocked(Exception):
    """A having/order/limit construct is not device-expressible; carries
    the human-readable blocking reason and (when known) the AST node for
    source-position reporting."""

    def __init__(self, reason: str, node: Any = None):
        super().__init__(reason)
        self.reason = reason
        self.node = node


@dataclass(frozen=True)
class SelectProgram:
    """Pure-data selection plan consumed by ops/select.build_select_step.

    ``having`` is a nested tuple tree — ("and"/"or", l, r), ("not", x),
    ("cmp", op, lhs, rhs) — whose leaves are operand tuples:
    ("fpair", vidx) float-sum pair, ("cnt",) count, ("f32"/"i32", plane,
    vidx) min/max planes, ("const", value).  ``order`` pairs operands
    with ascending flags in source order (already filtered to resolvable
    output names, matching the host's silent drop)."""

    having: Optional[tuple]
    order: Tuple[Tuple[tuple, bool], ...]
    limit: Optional[int]
    offset: int
    topk: bool
    uses_minmax: bool
    uses_forever: bool
    has_agg: bool
    key: str


@dataclass(frozen=True)
class SelectionDecision:
    """Static expressibility verdict (jax-free gate for analysis/tools)."""

    active: bool
    device: bool
    reason: Optional[str]
    node: Any = None


def selection_active(sel) -> bool:
    """True when the query's selector tail would engage the host
    QuerySelector's having/order/limit machinery (mirror of the old
    planner rejection predicate)."""
    return (sel.having is not None or bool(sel.order_by) or
            sel.limit is not None or sel.offset is not None)


# --------------------------------------------------------------- constants

def const_pair_ok(value) -> bool:
    """True iff ``value`` is EXACTLY representable as a normalized
    two-float32 pair (chi = f32(v), clo = f32(v - chi), chi + clo == v
    in f64) — the condition for device pair-comparisons to equal the
    host's f64 comparisons."""
    if isinstance(value, bool):
        return True
    if not isinstance(value, (int, float)):
        return False
    try:
        v = np.float64(value)
    except (OverflowError, ValueError):
        return False
    if not np.isfinite(v):
        return False
    if isinstance(value, int) and np.float64(int(v)) != np.float64(value):
        # int too large for f64 in the first place
        return False
    chi = np.float32(v)
    clo = np.float32(v - np.float64(chi))
    return bool(np.float64(chi) + np.float64(clo) == v)


# ----------------------------------------------------------- atom walking

class _Resolver:
    """Maps having/order leaf references onto operand tuples.  The real
    compiler (inside CompiledGroupedAgg) and the static analysis gate
    provide the two concrete lookups; the kind→operand rules live here
    once so they cannot drift."""

    def __init__(self):
        self.uses_minmax = False
        self.uses_forever = False
        self.has_agg = False

    # subclass hooks -------------------------------------------------
    def output_spec(self, name: str):
        """out name → (kind, int_mode, vidx) or None when unknown."""
        raise NotImplementedError

    def input_attr(self, name: str) -> bool:
        raise NotImplementedError

    # shared rules ---------------------------------------------------
    def _operand_for(self, kind: str, int_mode: bool, vidx: int,
                     label: str, where: str, node) -> tuple:
        if kind == "count":
            return ("cnt",)
        if kind == "key":
            raise SelectionBlocked(
                f"{where} references group-key output '{label}' "
                "(key columns live host-side)", node)
        if kind in ("avg", "stddev"):
            raise SelectionBlocked(
                f"{where} references {kind} output '{label}' "
                "(float64 division is host-only)", node)
        if kind == "sum":
            if int_mode:
                raise SelectionBlocked(
                    f"{where} references exact int64 sum '{label}' "
                    "(i32 hi/lo split sums exceed two-float compare "
                    "range)", node)
            return ("fpair", vidx)
        stem = _MINMAX_PLANES.get(kind)
        if stem is None:
            raise SelectionBlocked(
                f"{where} references non-device output '{label}'", node)
        if kind in ("min", "max"):
            self.uses_minmax = True
        else:
            self.uses_forever = True
        plane = stem + ("i" if int_mode else "f")
        return (("i32" if int_mode else "f32"), plane, vidx)

    def resolve_ref(self, name: str, where: str, node) -> tuple:
        spec = self.output_spec(name)
        if spec is not None:
            kind, int_mode, vidx = spec
            return self._operand_for(kind, int_mode, vidx, name, where,
                                     node)
        if self.input_attr(name):
            raise SelectionBlocked(
                f"{where} references input attribute '{name}' outside "
                "the select outputs (host evaluation only)", node)
        raise SelectionBlocked(
            f"{where} references unknown attribute '{name}'", node)

    def resolve_call(self, f: AttributeFunction, where: str) -> tuple:
        # the host QuerySelector materializes aggregator columns only
        # for the select clause; a call here has no host-side value to
        # be identical to, so it cannot compile
        label = f"{f.namespace + ':' if f.namespace else ''}{f.name}"
        raise SelectionBlocked(
            f"{where} calls '{label}' directly — only named select "
            "outputs are comparable (extension/function calls and "
            "inline aggregates are not device-expressible)", f)


def _operand(e, r: _Resolver, where: str) -> tuple:
    if isinstance(e, Constant):
        v = e.value
        if isinstance(v, str):
            raise SelectionBlocked(
                f"{where} compares a string constant (host-only)", e)
        if not const_pair_ok(v):
            raise SelectionBlocked(
                f"{where} constant {v!r} is not exactly two-float32 "
                "representable", e)
        return ("const", float(v))
    if isinstance(e, Variable):
        return r.resolve_ref(e.attribute, where, e)
    if isinstance(e, AttributeFunction):
        return r.resolve_call(e, where)
    if isinstance(e, MathExpr):
        raise SelectionBlocked(
            f"{where} computes arithmetic over outputs (host f64 math "
            "only)", e)
    raise SelectionBlocked(
        f"{where} construct {type(e).__name__} is not "
        "device-expressible", e)


def _walk_having(e, r: _Resolver) -> tuple:
    if isinstance(e, And):
        return ("and", _walk_having(e.left, r), _walk_having(e.right, r))
    if isinstance(e, Or):
        return ("or", _walk_having(e.left, r), _walk_having(e.right, r))
    if isinstance(e, Not):
        return ("not", _walk_having(e.expr, r))
    if isinstance(e, Compare):
        return ("cmp", _CMP[e.op], _operand(e.left, r, "having"),
                _operand(e.right, r, "having"))
    raise SelectionBlocked(
        f"having construct {type(e).__name__} is not device-expressible "
        "(And/Or/Not over comparisons only)", e)


def _shape_gates(sel, keyed: bool, windowed: bool) -> None:
    if not select_enabled():
        raise SelectionBlocked(
            f"selection disabled via {SELECT_ENV}=0")
    if windowed and (sel.limit is not None or sel.offset is not None):
        raise SelectionBlocked(
            "limit/offset over a sliding window shares slots with "
            "expired rows on the host path (host-only)")
    if keyed and (sel.order_by or sel.limit is not None or
                  sel.offset is not None):
        raise SelectionBlocked(
            "order-by/limit inside a partition applies per key "
            "instance on the host path (host-only)")


def _build_program(sel, r: _Resolver) -> SelectProgram:
    having = None
    if sel.having is not None:
        having = _walk_having(sel.having, r)
    order: List[Tuple[tuple, bool]] = []
    for ob in sel.order_by:
        name = ob.variable.attribute
        if r.output_spec(name) is None:
            continue        # host parity: silently dropped
        order.append((r.resolve_ref(name, "order-by", ob.variable),
                      bool(ob.ascending)))
    limit = None if sel.limit is None else int(sel.limit)
    offset = int(sel.offset or 0)
    # jax.lax.top_k fast path: single plain-f32 key, ascending, limit,
    # no offset — ties break on emission index exactly like the host's
    # stable ascending argsort
    topk = (len(order) == 1 and order[0][1] and order[0][0][0] == "f32"
            and limit is not None and limit > 0 and offset == 0)
    raw = repr((having, tuple(order), limit, offset, topk))
    digest = hashlib.blake2s(raw.encode(), digest_size=8).hexdigest()
    key = (f"h{int(having is not None)}o{len(order)}"
           f"l{'n' if limit is None else limit}f{offset}"
           f"t{int(topk)}-{digest}")
    return SelectProgram(
        having=having, order=tuple(order), limit=limit, offset=offset,
        topk=topk, uses_minmax=r.uses_minmax, uses_forever=r.uses_forever,
        has_agg=r.has_agg, key=key)


# ------------------------------------------------------------ real compile

class _CompiledResolver(_Resolver):
    """Resolver over a CompiledGroupedAgg's real outputs: atoms index
    the compiled value banks by each output's _Value lane."""

    def __init__(self, outputs, attr_types: Dict[str, Any]):
        super().__init__()
        self._out = {name: (kind, ref) for (name, kind, ref) in outputs}
        self._attr_types = attr_types

    def output_spec(self, name: str):
        got = self._out.get(name)
        if got is None:
            return None
        kind, ref = got
        if kind in ("key", "count", "stddev"):
            return (kind, False, 0)
        return (kind, bool(ref.int_mode), int(ref.vidx))

    def input_attr(self, name: str) -> bool:
        return name in self._attr_types


def compile_selection(selector, outputs, attr_types, *,
                      keyed: bool, windowed: bool) -> SelectProgram:
    """Compile a selection-active selector against a CompiledGroupedAgg's
    outputs.  Raises SelectionBlocked with the reason when any atom is
    not device-expressible — the planner turns that into the documented
    host-QuerySelector fallback."""
    _shape_gates(selector, keyed, windowed)
    r = _CompiledResolver(outputs, attr_types)
    return _build_program(selector, r)


# ------------------------------------------------------------- static gate

def _static_int(e, attr_types: Dict[str, Any]) -> bool:
    if isinstance(e, Variable):
        return attr_types.get(e.attribute) in _INT_TYPES
    if isinstance(e, Constant):
        return isinstance(e.value, int) and not isinstance(e.value, bool)
    if isinstance(e, MathExpr):
        return (_static_int(e.left, attr_types) and
                _static_int(e.right, attr_types))
    return False


class _StaticResolver(_Resolver):
    def __init__(self, outmap, attr_types):
        super().__init__()
        self._out = outmap
        self._attr_types = attr_types

    def output_spec(self, name: str):
        got = self._out.get(name)
        if got is None:
            return None
        kind, int_mode = got
        return (kind, int_mode, 0)

    def input_attr(self, name: str) -> bool:
        return name in self._attr_types


_DEVICE_WINDOWS = ("length", "time", "externaltime")


def classify_selection(query, attr_types: Dict[str, Any],
                       in_partition: bool = False) -> SelectionDecision:
    """Static (jax-free) expressibility verdict for a single-stream
    query's selection — the gate behind analyzer SP012, the static
    schema view and the t1_report coverage sweep.  Mirrors
    compile_selection's rules without compiling expressions; computed
    integer aggregate arguments may be classified optimistically (the
    runtime plan re-checks exactly)."""
    sel = query.selector
    if not selection_active(sel):
        return SelectionDecision(False, True, None)

    def blocked(reason, node=None):
        return SelectionDecision(True, False, reason, node)

    s = query.input_stream
    if not isinstance(s, SingleInputStream):
        return blocked("pattern/join selection is host-only")
    wh = getattr(s, "window_handler", None)
    if wh is None:
        windowed = False
    elif (wh.namespace or "") == "" and wh.name.lower() in _DEVICE_WINDOWS:
        windowed = True
    else:
        return blocked(f"#{wh.name} window is host-only (selection rides "
                       "the host selector)", wh)
    if getattr(sel, "select_all", False):
        return blocked("select * on the aggregate path is host-only")
    outmap: Dict[str, Tuple[str, bool]] = {}
    for oa in sel.attributes:
        e = oa.expr
        if isinstance(e, AttributeFunction) and \
                (e.namespace or "") == "" and e.name.lower() in _AGG_NAMES:
            kind = e.name.lower()
            int_mode = bool(kind not in ("count", "avg", "stddev") and
                            e.args and
                            _static_int(e.args[0], attr_types))
            outmap[oa.rename] = (kind, int_mode)
        elif isinstance(e, Variable):
            outmap[oa.rename] = ("key", False)
        else:
            return blocked(
                f"select output '{oa.rename}' is host-only (string or "
                "extension aggregate, or a computed expression)", e)
    try:
        _shape_gates(sel, keyed=in_partition, windowed=windowed)
        r = _StaticResolver(outmap, attr_types)
        _build_program(sel, r)
    except SelectionBlocked as e:
        return blocked(e.reason, e.node)
    return SelectionDecision(True, True, None)
