"""Numeric-safety verifier — static value-range & precision analysis.

The fourth pillar of the correctness tooling: SA proves semantics, PV/PC
the compiled plan, CE/LW concurrency and SC checkpoint schemas — this
module proves the engine's *arithmetic* is safe.  An interval lattice
(per-dtype, i64-backed for integer lanes, with widening so propagation
terminates) is seeded from declared attribute ranges
(``@attr:range(attr, lo, hi)`` on stream definitions; conservative dtype
bounds otherwise) and the declared event rate (``@app:rate(eps)``,
default :data:`DEFAULT_RATE_EPS`), then propagated through every query's
handler chain, selector expressions and aggregation carries.  Findings
carry stable NS0xx codes (diagnostics.py):

  NS001  int overflow reachable (arithmetic / sum escapes i32/i64)
  NS002  div-by-zero / NaN-propagation path (divisor interval has 0)
  NS003  f32 accumulation exceeds its precision budget
         (window span x rate x max|value| vs the 2^24 ulp cliff) —
         scoped to the UNCOMPENSATED accumulators: the incremental-
         aggregation slabs (ops/incremental_agg.py, whose docstring
         admits the gap).  gagg running sums are TwoSum-compensated and
         wagg rings Kahan-compensated, so they are exempt by
         construction; ``@numeric(sum='compensated')`` on a ``define
         aggregation`` switches the slab to compensated lanes and
         resolves the finding.
  NS004  ts32 horizon wrap: a window / `within` / gap-timer span past
         the usable int32-ms half-horizon (~12.4 days; ops/ts32.py)
  NS005  count-lane saturation: an int32 count plane (gagg gcnt, wagg
         cnt, slab cnt) whose static bound reaches 2^31
  NS006  lossy demotion at the fused-egress slab: int/long outputs
         with reachable |value| > 2^24 riding f32 egress lanes

Provenance triage keeps conservative-bound noise out of CI gates:
when a verdict rests ONLY on undeclared full-dtype bounds (no
``@attr:range`` / ``@app:rate``), the finding is downgraded to INFO —
declaring ranges is what arms the warning.  Verdicts grounded in
explicit declarations and window parameters fire at catalog severity.

Everything here is jax-free (``analyze --numeric`` runs without an
accelerator stack); :func:`attach_numeric_analysis` is the runtime half
that re-grounds NS004/NS005/NS006 on the COMPILED plan's dims via the
Plan-IR, and core/numguard.py holds the SIDDHI_TPU_NUMGUARD sentinels
that cross-validate these verdicts live (NS101).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ..query_api import SiddhiApp, find_annotation
from ..query_api.annotation import find_all
from ..query_api.definition import (DURATION_MS, AbstractDefinition,
                                    AttrType)
from ..query_api.expression import (AttributeFunction, Constant, MathExpr,
                                    MathOp, TimeConstant, Variable)
from ..query_api.position import pos_of
from ..query_api.query import (AbsentStreamStateElement, CountStateElement,
                               EveryStateElement, JoinInputStream,
                               LogicalStateElement, NextStateElement, Query,
                               SingleInputStream, StateElement,
                               StateInputStream, WindowHandler)
from .diagnostics import Diagnostic, DiagnosticSink, Severity

# ------------------------------------------------------------------ bounds

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
F32_MAX = 3.4028234663852886e38
F64_MAX = 1.7976931348623157e308
#: last float32 value below which EVERY integer is exactly representable
#: — the ulp cliff naive f32 accumulation falls off
F32_EXACT = float(1 << 24)
F64_EXACT = float(1 << 53)

#: jax-free mirror of ops/ts32.safe_max(slack): (1<<31) - (1<<21) -
#: (slack+1).  tests/test_numeric_ranges.py asserts the two stay equal.
TS32_GUARD = (1 << 21)


def ts32_safe_max(slack_ms: int) -> int:
    return (1 << 31) - TS32_GUARD - (slack_ms + 1)


#: a span is wrap-hazardous when the span itself no longer fits the
#: offset ceiling computed WITH that span as slack — i.e. past the
#: usable half-horizon (~12.4 days)
def ts32_span_hazard(span_ms: int) -> bool:
    return span_ms > ts32_safe_max(span_ms)


#: conservative default event rate (events/second) used to bound time
#: windows when the app declares no @app:rate — documented in
#: docs/numeric_safety.md; verdicts that rest on it are INFO-triaged
DEFAULT_RATE_EPS = 1000.0

_INT_KINDS = ("int", "long")
_RANK = {"int": 0, "long": 1, "float": 2, "double": 3}

_DTYPE_IV = {
    AttrType.INT: ("int", I32_MIN, I32_MAX),
    AttrType.LONG: ("long", I64_MIN, I64_MAX),
    AttrType.FLOAT: ("float", -F32_MAX, F32_MAX),
    AttrType.DOUBLE: ("double", -F64_MAX, F64_MAX),
}


# ----------------------------------------------------------------- lattice

@dataclass(frozen=True)
class Interval:
    """One closed interval [lo, hi] with provenance.

    Integer lanes stay exact Python ints (arbitrary precision, so an
    i64-escaping bound is *representable* and detectable before it is
    widened back to dtype bounds); float lanes ride Python floats with
    +/-inf as the top element.  ``declared`` is dataflow provenance:
    True iff every contributing leaf bound came from an explicit source
    (an @attr:range declaration, a literal constant or a window
    parameter) rather than conservative dtype defaults — the bit that
    decides warning-vs-info triage."""
    lo: Union[int, float]
    hi: Union[int, float]
    declared: bool = False

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"inverted interval [{self.lo}, {self.hi}]")

    # ---- constructors
    @staticmethod
    def point(v, declared: bool = True) -> "Interval":
        return Interval(v, v, declared)

    @staticmethod
    def top() -> "Interval":
        return Interval(-math.inf, math.inf, False)

    # ---- predicates
    @property
    def max_abs(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    @property
    def contains_zero(self) -> bool:
        return self.lo <= 0 <= self.hi

    def contains(self, v) -> bool:
        return self.lo <= v <= self.hi

    def within(self, lo, hi) -> bool:
        return self.lo >= lo and self.hi <= hi

    # ---- arithmetic (sound: result hull covers every concrete pair)
    def add(self, o: "Interval") -> "Interval":
        return Interval(self.lo + o.lo, self.hi + o.hi,
                        self.declared and o.declared)

    def sub(self, o: "Interval") -> "Interval":
        return Interval(self.lo - o.hi, self.hi - o.lo,
                        self.declared and o.declared)

    def neg(self) -> "Interval":
        return Interval(-self.hi, -self.lo, self.declared)

    def abs_(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return self.neg()
        return Interval(0, max(-self.lo, self.hi), self.declared)

    def mul(self, o: "Interval") -> "Interval":
        def p(a, b):
            if a == 0 or b == 0:       # 0 * inf must read as 0, not nan
                return 0
            return a * b
        cs = (p(self.lo, o.lo), p(self.lo, o.hi),
              p(self.hi, o.lo), p(self.hi, o.hi))
        return Interval(min(cs), max(cs), self.declared and o.declared)

    def scale(self, n: float) -> "Interval":
        """n * [lo, hi] for n >= 0 (window-length accumulation)."""
        def p(a):
            return 0 if (a == 0 or n == 0) else a * n
        return Interval(min(p(self.lo), 0), max(p(self.hi), 0),
                        self.declared)

    def div(self, o: "Interval") -> "Interval":
        """Quotient hull ASSUMING the divisor excludes 0 — callers check
        :attr:`contains_zero` first (that is the NS002 finding) and
        widen to dtype bounds on a zero-crossing divisor."""
        if o.contains_zero:
            return Interval.top()
        cs = (self.lo / o.lo, self.lo / o.hi,
              self.hi / o.lo, self.hi / o.hi)
        return Interval(min(cs), max(cs), self.declared and o.declared)

    def mod(self, o: "Interval") -> "Interval":
        m = o.abs_().hi
        if m == 0:
            return Interval.top()
        return Interval(-m, m, self.declared and o.declared)

    # ---- lattice ops
    def join(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi),
                        self.declared and o.declared)

    def widen(self, o: "Interval", bounds: "Interval") -> "Interval":
        """Classic jump-to-bounds widening: any bound still moving after
        a join snaps straight to the dtype bound, so iteration reaches a
        fixpoint in at most two steps (termination is property-tested)."""
        lo = self.lo if o.lo >= self.lo else bounds.lo
        hi = self.hi if o.hi <= self.hi else bounds.hi
        return Interval(lo, hi, self.declared and o.declared)

    def clamp(self, bounds: "Interval") -> "Interval":
        lo = max(self.lo, bounds.lo)
        hi = min(self.hi, bounds.hi)
        if lo > hi:                       # disjoint: keep a point at edge
            lo = hi = bounds.lo if self.hi < bounds.lo else bounds.hi
        return Interval(lo, hi, self.declared)

    def as_list(self) -> List[float]:
        def f(v):
            if isinstance(v, float) and math.isinf(v):
                return None               # JSON-safe
            return v
        return [f(self.lo), f(self.hi)]


def dtype_interval(t: AttrType) -> Tuple[Optional[str], Interval]:
    """(kind, conservative interval) for an attribute type; (None, top)
    for non-numeric types."""
    ent = _DTYPE_IV.get(t)
    if ent is None:
        if t == AttrType.BOOL:
            return "int", Interval(0, 1, True)
        return None, Interval.top()
    kind, lo, hi = ent
    return kind, Interval(lo, hi, False)


def kind_bounds(kind: Optional[str]) -> Interval:
    return {"int": Interval(I32_MIN, I32_MAX, False),
            "long": Interval(I64_MIN, I64_MAX, False),
            "float": Interval(-F32_MAX, F32_MAX, False),
            "double": Interval(-F64_MAX, F64_MAX, False)}.get(
                kind, Interval.top())


def _promote(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None or b is None:
        return a or b
    return a if _RANK.get(a, 3) >= _RANK.get(b, 3) else b


# ------------------------------------------------- declared range seeding

@dataclass
class AttrRanges:
    """Declared seeds: per-(stream, attribute) intervals + event rate."""
    ranges: Dict[Tuple[str, str], Interval] = field(default_factory=dict)
    rate_eps: float = DEFAULT_RATE_EPS
    rate_declared: bool = False

    def lookup(self, stream_id: Optional[str], attr: str,
               defs: Dict[str, AbstractDefinition]
               ) -> Tuple[Optional[str], Interval]:
        """Resolve a variable to (kind, interval): the declared range
        when one exists, the dtype's conservative bounds otherwise."""
        cands = ([defs[stream_id]] if stream_id in (defs or {})
                 else list((defs or {}).values()))
        for d in cands:
            for a in d.attributes:
                if a.name == attr:
                    kind, iv = dtype_interval(a.type)
                    declared = self.ranges.get((d.id, attr))
                    return kind, (declared if declared is not None else iv)
        return None, Interval.top()


def _parse_num(raw: str) -> Optional[float]:
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def collect_attr_ranges(app: SiddhiApp,
                        sink: Optional[DiagnosticSink] = None
                        ) -> AttrRanges:
    """Parse every ``@attr:range(attr, lo, hi)`` (stream definitions)
    and the app-level ``@app:rate(eps)``, emitting SA090/SA091/SA092 on
    malformed declarations when a sink is given."""
    out = AttrRanges()
    sink = sink or DiagnosticSink()

    defsets = list(app.stream_definitions.items()) + \
        list(getattr(app, "table_definitions", {}).items()) + \
        list(getattr(app, "window_definitions", {}).items())
    for sid, d in defsets:
        for ann in find_all(d.annotations, "attr:range"):
            posa = ann.positional()
            attr = ann.get("attr") or (posa[0] if len(posa) > 0 else None)
            lo_r = ann.get("lo") or (posa[1] if len(posa) > 1 else None)
            hi_r = ann.get("hi") or (posa[2] if len(posa) > 2 else None)
            if not attr or lo_r is None or hi_r is None:
                sink.emit("SA090",
                          f"stream '{sid}': @attr:range needs "
                          f"(attr, lo, hi); got {len(posa)} positional / "
                          f"{sorted(ann.as_dict())} keyed element(s)",
                          pos=pos_of(d))
                continue
            if attr not in d.attribute_names:
                sink.emit("SA090",
                          f"stream '{sid}': @attr:range names unknown "
                          f"attribute '{attr}'", pos=pos_of(d))
                continue
            kind, dt_iv = dtype_interval(d.attribute_type(attr))
            if kind is None:
                sink.emit("SA090",
                          f"stream '{sid}': @attr:range on non-numeric "
                          f"attribute '{attr}' "
                          f"({d.attribute_type(attr).value})",
                          pos=pos_of(d))
                continue
            lo, hi = _parse_num(lo_r), _parse_num(hi_r)
            if lo is None or hi is None:
                sink.emit("SA090",
                          f"stream '{sid}': @attr:range('{attr}') bounds "
                          f"must be finite numbers; got "
                          f"({lo_r!r}, {hi_r!r})", pos=pos_of(d))
                continue
            if lo > hi:
                sink.emit("SA091",
                          f"stream '{sid}': @attr:range('{attr}') "
                          f"declares lo={lo_r} > hi={hi_r}; the "
                          f"declaration is ignored", pos=pos_of(d))
                continue
            if kind in _INT_KINDS:
                lo, hi = int(lo), int(hi)
            if lo < dt_iv.lo or hi > dt_iv.hi:
                sink.emit("SA092",
                          f"stream '{sid}': @attr:range('{attr}') bounds "
                          f"[{lo}, {hi}] exceed the {kind} dtype "
                          f"[{dt_iv.lo}, {dt_iv.hi}]; clamping",
                          pos=pos_of(d))
            iv = Interval(lo, hi, True).clamp(dt_iv)
            out.ranges[(sid, attr)] = iv

    rate = find_annotation(app.annotations, "app:rate") or \
        find_annotation(app.annotations, "rate")
    if rate is not None:
        raw = rate.get("eps") or (rate.positional() or [None])[0]
        v = _parse_num(raw) if raw is not None else None
        if v is None or v <= 0:
            sink.emit("SA090",
                      f"@app:rate must declare a positive events/second "
                      f"number; got {raw!r} — falling back to the "
                      f"default {DEFAULT_RATE_EPS:g} eps")
        else:
            out.rate_eps, out.rate_declared = v, True
    return out


# --------------------------------------------------------- window bounds

@dataclass(frozen=True)
class EventsBound:
    """How many live events an accumulator can hold: ``n`` (may be inf
    for forever-accumulators), whether that bound is declared-grounded,
    and the time span backing it (for NS004)."""
    n: float
    declared: bool
    span_ms: Optional[int] = None


_LENGTH_WINDOWS = {"length", "lengthbatch"}
_TIME_WINDOWS = {"time", "timebatch", "delay", "session"}


def _const_val(e) -> Optional[float]:
    if isinstance(e, TimeConstant):
        return float(e.millis)
    if isinstance(e, Constant) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return float(e.value)
    return None


def window_events_bound(h: Optional[WindowHandler],
                        rate: AttrRanges) -> EventsBound:
    """Static bound on an accumulator's live-event count for one window
    handler (None = forever accumulation)."""
    if h is None:
        return EventsBound(math.inf, False, None)
    name = h.name.lower() if not h.namespace else ""
    params = [_const_val(p) for p in h.params]
    if name in _LENGTH_WINDOWS and params and params[0] is not None:
        return EventsBound(params[0], True, None)
    if name in _TIME_WINDOWS and params and params[0] is not None:
        span = int(params[0])
        return EventsBound(span / 1000.0 * rate.rate_eps,
                           rate.rate_declared, span)
    if name == "timelength" and len(params) >= 2 \
            and params[1] is not None:
        span = int(params[0]) if params[0] is not None else None
        return EventsBound(params[1], True, span)
    if name == "hopping" and params and params[0] is not None:
        span = int(params[0])
        return EventsBound(span / 1000.0 * rate.rate_eps,
                           rate.rate_declared, span)
    if name in ("externaltime", "externaltimebatch") and len(params) >= 2 \
            and params[1] is not None:
        span = int(params[1])
        return EventsBound(span / 1000.0 * rate.rate_eps,
                           rate.rate_declared, span)
    return EventsBound(math.inf, False, None)


# ------------------------------------------------------ expression walk

_AGG_FNS = {"sum", "avg", "count", "min", "max", "stddev",
            "distinctcount", "maxforever", "minforever"}


class _ExprEval:
    """Interval evaluation of one query's expressions; emits NS001 /
    NS002 as it walks."""

    def __init__(self, ranges: AttrRanges,
                 defs: Dict[str, AbstractDefinition],
                 bound: EventsBound, sink: DiagnosticSink,
                 qname: Optional[str], pos=None):
        self.ranges = ranges
        self.defs = defs
        self.bound = bound
        self.sink = sink
        self.qname = qname
        self.pos = pos

    def _emit(self, code: str, msg: str, declared: bool) -> None:
        sev = None if declared else Severity.INFO
        suffix = ("" if declared else
                  " [assuming conservative dtype bounds — declare "
                  "@attr:range / @app:rate to confirm or clear this]")
        self.sink.emit(code, msg + suffix, pos=self.pos, query=self.qname,
                       severity=sev)

    def eval(self, e) -> Tuple[Optional[str], Interval]:
        if e is None:
            return None, Interval.top()
        if isinstance(e, TimeConstant):
            return "long", Interval.point(int(e.millis))
        if isinstance(e, Constant):
            v = e.value
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None, Interval.top()
            kind = e.type_hint if e.type_hint in _RANK else (
                "long" if isinstance(v, int) else "double")
            return kind, Interval.point(v)
        if isinstance(e, Variable):
            return self.ranges.lookup(e.stream_id, e.attribute, self.defs)
        if isinstance(e, MathExpr):
            return self._math(e)
        if isinstance(e, AttributeFunction):
            return self._fn(e)
        # comparisons / logicals as operands: boolean lane
        return "int", Interval(0, 1, True)

    def _math(self, e: MathExpr) -> Tuple[Optional[str], Interval]:
        lk, li = self.eval(e.left)
        rk, ri = self.eval(e.right)
        kind = _promote(lk, rk)
        if e.op == MathOp.ADD:
            iv = li.add(ri)
        elif e.op == MathOp.SUB:
            iv = li.sub(ri)
        elif e.op == MathOp.MUL:
            iv = li.mul(ri)
        elif e.op == MathOp.MOD:
            if ri.contains_zero:
                self._emit("NS002",
                           "modulo divisor's value range includes 0 — "
                           f"[{ri.lo}, {ri.hi}]",
                           ri.declared)
            iv = li.mod(ri)
        else:                                             # DIV
            if ri.contains_zero:
                self._emit("NS002",
                           "divisor's value range includes 0 — "
                           f"[{ri.lo}, {ri.hi}]: a div-by-zero / "
                           "NaN-propagation path is reachable",
                           ri.declared)
            iv = li.div(ri)
        bounds = kind_bounds(kind)
        if kind in _INT_KINDS and not iv.within(bounds.lo, bounds.hi):
            self._emit("NS001",
                       f"{kind} arithmetic '{_render(e)}' can reach "
                       f"[{_fmt(iv.lo)}, {_fmt(iv.hi)}], outside "
                       f"{kind} bounds — device int ops wrap silently",
                       iv.declared)
            iv = iv.widen(bounds, bounds)
        return kind, iv.clamp(bounds) if kind else (kind, iv)[1]

    def _fn(self, e: AttributeFunction) -> Tuple[Optional[str], Interval]:
        name = e.name.lower() if not e.namespace else ""
        if name not in _AGG_FNS:
            # unknown scalar function: propagate the hull of its args
            ivs = [self.eval(a) for a in e.args]
            kind = None
            iv = Interval.top()
            for k, i in ivs:
                kind = _promote(kind, k)
            return kind, kind_bounds(kind) if kind else iv
        n = self.bound.n
        ndecl = self.bound.declared
        if name == "count":
            iv = Interval(0, n if math.isfinite(n) else math.inf, ndecl)
            if n >= I32_MAX:
                self._emit(
                    "NS005",
                    "count() lane is int32 on device; the window bound "
                    f"({_fmt(n)} live events) reaches 2^31 saturation",
                    ndecl and math.isfinite(n))
            return "long", iv
        if not e.args:
            return None, Interval.top()
        ak, ai = self.eval(e.args[0])
        if name in ("min", "max", "minforever", "maxforever"):
            return ak, ai
        if name == "avg":
            return "double", Interval(min(ai.lo, 0), max(ai.hi, 0),
                                      ai.declared)
        if name == "stddev":
            spread = (ai.hi - ai.lo) if math.isfinite(ai.hi - ai.lo) \
                else math.inf
            return "double", Interval(0, spread, ai.declared)
        if name == "distinctcount":
            return "long", Interval(0, n, ndecl)
        # ---- sum
        iv = ai.scale(n if math.isfinite(n) else math.inf)
        kind = "long" if ak in _INT_KINDS else "double"
        if ak in _INT_KINDS and not iv.within(I64_MIN, I64_MAX):
            self._emit(
                "NS001",
                f"sum({_render(e.args[0])}) over a bound of {_fmt(n)} "
                f"events with |value| <= {_fmt(ai.max_abs)} can reach "
                f"[{_fmt(iv.lo)}, {_fmt(iv.hi)}] — outside int64",
                iv.declared and ndecl and math.isfinite(n))
        return kind, iv.clamp(kind_bounds(kind))


def _fmt(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        if abs(v) >= 1e6:
            return f"{v:.3g}"
        return f"{v:g}"
    if isinstance(v, int) and abs(v) >= 1 << 40:
        return f"{float(v):.3g}"
    return str(v)


def _render(e) -> str:
    if isinstance(e, Variable):
        return (f"{e.stream_id}.{e.attribute}" if e.stream_id
                else e.attribute)
    if isinstance(e, TimeConstant):
        return f"{e.millis}ms"
    if isinstance(e, Constant):
        return repr(e.value)
    if isinstance(e, MathExpr):
        return f"({_render(e.left)} {e.op.value} {_render(e.right)})"
    if isinstance(e, AttributeFunction):
        inner = ", ".join(_render(a) for a in e.args)
        return f"{e.name}({inner})"
    return type(e).__name__.lower()


# ------------------------------------------------------------ the report

@dataclass
class NumericReport:
    """Everything the numeric verifier learned about one app."""
    app_name: Optional[str] = None
    findings: List[Diagnostic] = field(default_factory=list)
    per_query: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    rate_eps: float = DEFAULT_RATE_EPS
    rate_declared: bool = False
    declared_ranges: Dict[str, List[float]] = field(default_factory=dict)
    source: str = "static"       # "static" | "plan"

    @property
    def ok(self) -> bool:
        return not any(d.severity != Severity.INFO for d in self.findings)

    def counts(self, min_severity: Severity = Severity.WARNING
               ) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.findings:
            if d.severity.rank <= min_severity.rank:
                out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    def as_dict(self) -> Dict[str, Any]:
        return {"app": self.app_name,
                "source": self.source,
                "ok": self.ok,
                "rate_eps": self.rate_eps,
                "rate_declared": self.rate_declared,
                "declared_ranges": dict(sorted(
                    self.declared_ranges.items())),
                "per_query": {q: dict(v)
                              for q, v in sorted(self.per_query.items())},
                "findings": [d.as_dict() for d in self.findings]}

    def dump(self) -> str:
        lines = [f"numeric-safety report ({self.source}) — app "
                 f"{self.app_name or '?'}",
                 f"  rate: {self.rate_eps:g} eps "
                 f"({'declared' if self.rate_declared else 'default'})"]
        for key, b in sorted(self.declared_ranges.items()):
            lines.append(f"  range {key}: [{_fmt(b[0])}, {_fmt(b[1])}]")
        for q, info in sorted(self.per_query.items()):
            parts = " ".join(f"{k}={_fmt(v) if not isinstance(v, dict) else v}"
                             for k, v in sorted(info.items()))
            lines.append(f"  query {q}: {parts}")
        for d in self.findings:
            lines.append("  " + d.render())
        lines.append(f"  {len(self.findings)} finding(s), "
                     f"{sum(1 for d in self.findings if d.severity != Severity.INFO)} "
                     f"at warning+")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------ static pass

def numeric_pass(app: SiddhiApp, sink: DiagnosticSink,
                 engine: str = "auto") -> NumericReport:
    """The NS0xx pass over a parsed app: seeds the lattice, walks every
    query / partition / aggregation definition, emits into ``sink`` and
    returns the :class:`NumericReport`.  jax-free."""
    from ..query_api import Partition
    mark = len(sink.diagnostics)
    ranges = collect_attr_ranges(app, sink)
    report = NumericReport(
        app_name=app.name, rate_eps=ranges.rate_eps,
        rate_declared=ranges.rate_declared,
        declared_ranges={f"{sid}.{attr}": iv.as_list()
                         for (sid, attr), iv in ranges.ranges.items()})
    defs = _all_defs(app)

    qidx = 0
    for el in app.execution_elements:
        if isinstance(el, Query):
            _numeric_query(el, el.name or f"query_{qidx}", ranges, defs,
                           sink, engine, report)
        elif isinstance(el, Partition):
            for qi, q in enumerate(el.queries):
                qname = q.name or f"partition_{qidx}_query_{qi}"
                _numeric_query(q, qname, ranges, defs, sink, engine,
                               report)
        qidx += 1

    for aid, ad in getattr(app, "aggregation_definitions", {}).items():
        _numeric_aggregation(aid, ad, ranges, defs, sink, engine, report)

    report.findings = sink.diagnostics[mark:]
    return report


def _all_defs(app: SiddhiApp) -> Dict[str, AbstractDefinition]:
    defs: Dict[str, AbstractDefinition] = {}
    for group in ("stream_definitions", "table_definitions",
                  "window_definitions"):
        defs.update(getattr(app, group, {}) or {})
    return defs


def _query_streams(q: Query) -> List[SingleInputStream]:
    ins = q.input_stream
    if isinstance(ins, SingleInputStream):
        return [ins]
    if isinstance(ins, JoinInputStream):
        return [ins.left, ins.right]
    if isinstance(ins, StateInputStream):
        out: List[SingleInputStream] = []

        def rec(el: StateElement):
            if isinstance(el, NextStateElement):
                rec(el.state)
                rec(el.next)
            elif isinstance(el, EveryStateElement):
                rec(el.state)
            elif isinstance(el, LogicalStateElement):
                rec(el.state1)
                rec(el.state2)
            elif isinstance(el, CountStateElement):
                rec(el.state)
            elif el is not None and getattr(el, "stream", None) is not None:
                out.append(el.stream)
        rec(ins.state)
        return out
    return []


def _bound_defs(q: Query, defs: Dict[str, AbstractDefinition]
                ) -> Dict[str, AbstractDefinition]:
    """stream_id AND alias (``as e1``) both resolve to the definition."""
    bound: Dict[str, AbstractDefinition] = {}
    for s in _query_streams(q):
        d = defs.get(s.stream_id)
        if d is None:
            continue
        bound[s.stream_id] = d
        if s.stream_ref:
            bound[s.stream_ref] = d
    return bound


def _span_checks(q: Query, qname: str, sink: DiagnosticSink) -> List[int]:
    """NS004 over every time span the query declares: window spans are
    handled by the caller; here the pattern/sequence `within` bounds and
    absent-pattern gap timers (ops/ts32.py call sites: within expiry
    subtraction, `not ... for t` deadline addition)."""
    spans: List[int] = []
    ins = q.input_stream
    if not isinstance(ins, StateInputStream):
        return spans

    def check(ms: Optional[int], what: str):
        if ms is None:
            return
        spans.append(int(ms))
        if ts32_span_hazard(int(ms)):
            sink.emit("NS004",
                      f"{what} of {int(ms)} ms exceeds the usable int32 "
                      f"half-horizon (~{ts32_safe_max(0) // 2} ms): "
                      f"device ts32 offset arithmetic can wrap",
                      pos=pos_of(q), query=qname)

    check(ins.within_ms, "pattern `within` bound")

    def rec(el: StateElement):
        if el is None:
            return
        check(getattr(el, "within_ms", None), "pattern `within` bound")
        if isinstance(el, AbsentStreamStateElement):
            check(el.waiting_time_ms, "absent-pattern gap timer")
        for ch in ("state", "next", "state1", "state2"):
            sub = getattr(el, ch, None)
            if isinstance(sub, StateElement):
                rec(sub)
    rec(ins.state)
    return spans


def _numeric_query(q: Query, qname: str, ranges: AttrRanges,
                   defs: Dict[str, AbstractDefinition],
                   sink: DiagnosticSink, engine: str,
                   report: NumericReport) -> None:
    bound_defs = _bound_defs(q, defs)
    # worst-case events bound across the query's window handlers
    bound = EventsBound(math.inf, False, None)
    windows = []
    for s in _query_streams(q):
        h = s.window_handler
        if h is not None:
            windows.append(h)
    if windows:
        bs = [window_events_bound(h, ranges) for h in windows]
        bound = max(bs, key=lambda b: b.n)
    elif not q.selector.group_by and not _has_agg(q):
        bound = EventsBound(1, True, None)   # stateless pass-through

    for h in windows:
        b = window_events_bound(h, ranges)
        if b.span_ms is not None and ts32_span_hazard(b.span_ms):
            sink.emit("NS004",
                      f"#window.{h.name} span of {b.span_ms} ms exceeds "
                      f"the usable int32 half-horizon "
                      f"(~{ts32_safe_max(0) // 2} ms): device ts32 "
                      f"offset arithmetic can wrap",
                      pos=pos_of(h) or pos_of(q), query=qname)
        if math.isfinite(b.n) and b.n >= I32_MAX:
            sev = None if b.declared else Severity.INFO
            sink.emit("NS005",
                      f"#window.{h.name} bounds ~{_fmt(b.n)} live "
                      f"events — the int32 count lane reaches 2^31 "
                      f"saturation", pos=pos_of(h) or pos_of(q),
                      query=qname, severity=sev)

    spans = _span_checks(q, qname, sink)

    ev = _ExprEval(ranges, bound_defs, bound, sink, qname, pos=pos_of(q))
    out_ivs: Dict[str, List[float]] = {}
    sel = q.selector
    if not sel.select_all:
        for oa in sel.attributes:
            kind, iv = ev.eval(oa.expr)
            out_ivs[oa.rename] = iv.as_list()
            # NS006: int/long outputs past the f32 exact-integer cliff
            # ride f32 lanes through the fused-egress slab on device
            if engine != "host" and kind in _INT_KINDS \
                    and iv.max_abs > F32_EXACT:
                sev = None if iv.declared else Severity.INFO
                suffix = ("" if iv.declared else
                          " [assuming conservative dtype bounds — "
                          "declare @attr:range to confirm or clear "
                          "this]")
                sink.emit("NS006",
                          f"output '{oa.rename}' ({kind}) can reach "
                          f"|value| ~{_fmt(iv.max_abs)} > 2^24: the "
                          f"fused-egress f32 lane rounds exact "
                          f"integers above that{suffix}",
                          pos=pos_of(q), query=qname, severity=sev)
    if sel.having is not None:
        ev.eval(sel.having)
    for s in _query_streams(q):
        for h in s.handlers:
            from ..query_api.query import Filter as _Filter
            if isinstance(h, _Filter):
                ev.eval(h.expr)

    info: Dict[str, Any] = {}
    if math.isfinite(bound.n):
        info["events_bound"] = bound.n
    if spans or bound.span_ms:
        info["span_ms"] = max([bound.span_ms or 0] + spans)
    if out_ivs:
        info["outputs"] = out_ivs
    if info:
        report.per_query[qname] = info


def _has_agg(q: Query) -> bool:
    from ..query_api.expression import walk
    if q.selector.select_all:
        return False
    for oa in q.selector.attributes:
        for n in walk(oa.expr):
            if isinstance(n, AttributeFunction) and not n.namespace \
                    and n.name.lower() in _AGG_FNS:
                return True
    return False


def _numeric_aggregation(aid: str, ad, ranges: AttrRanges,
                         defs: Dict[str, AbstractDefinition],
                         sink: DiagnosticSink, engine: str,
                         report: NumericReport) -> None:
    """NS003/NS005/NS001 over a ``define aggregation``'s slab lanes.

    The device slab (ops/incremental_agg.py) accumulates every base in
    NAIVE float32 — its own docstring admits sums above 2^24 lose
    precision.  The per-bucket bound is the duration span x rate; the
    worst (longest) declared duration decides.  The per-query
    remediation is ``@numeric(sum='compensated')`` on the aggregation
    definition: plan/iagg_compiler then builds compensated (TwoSum)
    slab lanes, proven at parity in tests/test_numguard.py."""
    s = ad.basic_single_input_stream
    if s is None or engine == "host":
        return
    compensated = compensated_sum_declared(ad)
    periods = [p for p in (ad.time_periods or []) if p in DURATION_MS]
    if not periods:
        return
    worst = max(periods, key=lambda p: DURATION_MS[p])
    span = DURATION_MS[worst]
    n = span / 1000.0 * ranges.rate_eps
    bound_defs = {}
    d = defs.get(s.stream_id)
    if d is not None:
        bound_defs[s.stream_id] = d
        if s.stream_ref:
            bound_defs[s.stream_ref] = d
    sel = ad.selector
    if sel is None or sel.select_all:
        return
    ev = _ExprEval(ranges, bound_defs,
                   EventsBound(n, ranges.rate_declared, span), sink, aid,
                   pos=pos_of(ad))
    if n >= I32_MAX:
        sev = None if ranges.rate_declared else Severity.INFO
        sink.emit("NS005",
                  f"aggregation '{aid}': the '{worst}' bucket bounds "
                  f"~{_fmt(n)} events — the slab's int32 cnt lane "
                  f"reaches 2^31 saturation", pos=pos_of(ad), query=aid,
                  severity=sev)
    for oa in sel.attributes:
        for node in _agg_calls(oa.expr):
            if node.name.lower() != "sum" or not node.args:
                continue
            ak, ai = ev.eval(node.args[0])
            if ak is None:
                continue
            budget = n * ai.max_abs
            if not compensated and budget > F32_EXACT:
                declared = ai.declared and ranges.rate_declared
                sev = None if declared else Severity.INFO
                suffix = ("" if declared else
                          " [assuming conservative dtype bounds — "
                          "declare @attr:range / @app:rate to confirm "
                          "or clear this]")
                sink.emit(
                    "NS003",
                    f"aggregation '{aid}': sum({_render(node.args[0])}) "
                    f"over the '{worst}' bucket (~{_fmt(n)} events x "
                    f"max|value| {_fmt(ai.max_abs)} = {_fmt(budget)}) "
                    f"exceeds the f32 2^24 ulp budget on the naive "
                    f"slab lane; declare @numeric(sum='compensated') "
                    f"for exact compensated lanes{suffix}",
                    pos=pos_of(ad), query=aid, severity=sev)
    report.per_query[aid] = {"events_bound": n, "span_ms": span,
                             "compensated": compensated}


def compensated_sum_declared(ad) -> bool:
    """True when a ``define aggregation`` carries
    ``@numeric(sum='compensated')`` (aliases: kahan, exact) — the NS003
    remediation switch plan/iagg_compiler honours (compensated TwoSum
    slab lanes instead of the naive f32 fold)."""
    ann = find_annotation(getattr(ad, "annotations", []) or [], "numeric")
    if ann is None:
        return False
    mode = (ann.get("sum") or (ann.positional() or [""])[0] or "")
    return str(mode).strip().lower() in ("compensated", "kahan", "exact")


def _agg_calls(expr) -> List[AttributeFunction]:
    from ..query_api.expression import walk
    return [n for n in walk(expr)
            if isinstance(n, AttributeFunction) and not n.namespace
            and n.name.lower() in _AGG_FNS]


# -------------------------------------------------------------- entries

def analyze_numeric(app: Union[str, "SiddhiApp"],
                    engine: Optional[str] = None) -> NumericReport:
    """Standalone jax-free entry (the ``analyze --numeric`` path): parse
    if needed, run :func:`numeric_pass` on a fresh sink."""
    if isinstance(app, str):
        from ..compiler import SiddhiCompiler
        app = SiddhiCompiler.parse(app)
    if engine is None:
        from .analyzer import _engine_mode
        engine = _engine_mode(app)
    sink = DiagnosticSink()
    return numeric_pass(app, sink, engine)


def attach_numeric_analysis(rt, strict: bool = False) -> NumericReport:
    """Runtime half of the verifier: re-ground the static verdicts on
    the COMPILED plan's dims (Plan-IR) and merge the findings into
    ``rt.analysis`` with the attach_plan_analysis idempotency contract.
    The refined report rides ``rt.analysis.numeric`` (and GET /stats)."""
    from .analyzer import AnalysisResult
    from .plan_ir import extract_plan

    app = getattr(rt, "siddhi_app", None) or getattr(rt, "app", None)
    sink = DiagnosticSink()
    engine = "auto"
    report = NumericReport(app_name=getattr(rt, "name", None),
                           source="plan")
    if app is not None:
        try:
            from .analyzer import _engine_mode
            engine = _engine_mode(app)
        except Exception:   # noqa: BLE001 — engine mode is advisory
            pass
        report = numeric_pass(app, sink, engine)
        report.source = "plan"

    # plan-grounded refinement: the compiled within/window spans are
    # authoritative where the source pass had to guess
    plan_rep = getattr(getattr(rt, "analysis", None), "plan", None)
    plan = plan_rep.plan if plan_rep is not None else None
    if plan is None:
        try:
            plan = extract_plan(rt)
        except Exception:   # noqa: BLE001 — advisory refinement
            plan = None
    if plan is not None:
        mark = len(sink.diagnostics)
        for a in plan.automata:
            if a.within_ms is not None and ts32_span_hazard(
                    int(a.within_ms)):
                sink.emit("NS004",
                          f"compiled automaton `within` of "
                          f"{int(a.within_ms)} ms exceeds the usable "
                          f"int32 half-horizon — ts32 offsets can wrap",
                          query=a.query)
        for p in plan.programs:
            w = (p.dims or {}).get("window")
            if w and int(w) >= I32_MAX:
                sink.emit("NS005",
                          f"compiled {p.kind} window of {int(w)} "
                          f"entries saturates the int32 count lane",
                          query=p.query)
        report.findings = report.findings + sink.diagnostics[mark:]

    analysis = getattr(rt, "analysis", None)
    if analysis is None:
        analysis = AnalysisResult(app_name=getattr(rt, "name", None))
        rt.analysis = analysis
    prev = getattr(analysis, "numeric", None)
    if prev is not None:            # idempotent re-attach
        stale = set(map(id, prev.findings))
        analysis.diagnostics = [d for d in analysis.diagnostics
                                if id(d) not in stale]
    # the source-level analyzer already ran this pass at parse time —
    # drop its (now superseded) NS/SA09x findings before merging
    dup = {(d.code, d.message, d.query) for d in report.findings}
    analysis.diagnostics = [
        d for d in analysis.diagnostics
        if not ((d.code.startswith("NS") or d.code.startswith("SA09"))
                and (d.code, d.message, d.query) in dup)]
    order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
    analysis.diagnostics = sorted(
        analysis.diagnostics + report.findings,
        key=lambda d: (order[d.severity],
                       d.line if d.line >= 0 else 1 << 30, d.code))
    analysis.numeric = report
    rt.numeric_report = report
    if strict:
        bad = [d for d in report.findings
               if d.severity != Severity.INFO]
        if bad:
            from ..utils.errors import SiddhiAppValidationException
            raise SiddhiAppValidationException(
                f"numeric-safety verifier found {len(bad)} problem(s):\n"
                + "\n".join("  " + d.render() for d in bad))
    return report


# --------------------------------------------------------- sample sweep

def sample_numeric_counts(samples_dir: Optional[str] = None
                          ) -> Dict[str, Dict[str, int]]:
    """Warning-level NS finding counts over every SiddhiQL app embedded
    in samples/*.py — the t1_report artifact section and the golden
    gate (tests/test_numeric_samples.py) share this sweep.  Extraction
    mirrors tests/test_samples_analysis.py: plain string literals
    verbatim; f-string placeholders tried as '0' then ''."""
    import ast
    if samples_dir is None:
        samples_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "samples")
    out: Dict[str, Dict[str, int]] = {}
    for fname in sorted(os.listdir(samples_dir)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(samples_dir, fname)) as f:
            tree = ast.parse(f.read())
        apps: List[List[str]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                if "define stream" in node.value and ";" in node.value:
                    apps.append([node.value])
            elif isinstance(node, ast.JoinedStr):
                variants = []
                for filler in ("0", ""):
                    text = "".join(
                        str(v.value) if isinstance(v, ast.Constant)
                        else filler for v in node.values)
                    variants.append(text)
                if "define stream" in variants[0] and ";" in variants[0]:
                    apps.append(variants)
        apps = [v for v in apps
                if not any(v is not w and v[0] in w[0] for w in apps)]
        counts: Dict[str, int] = {}
        for variants in apps:
            rep = None
            for text in variants:
                try:
                    rep = analyze_numeric(text)
                    break
                except Exception:   # noqa: BLE001 — unparsable variant
                    continue
            if rep is None:
                continue
            for code, nn in rep.counts().items():
                counts[code] = counts.get(code, 0) + nn
        out[fname] = dict(sorted(counts.items()))
    return out
