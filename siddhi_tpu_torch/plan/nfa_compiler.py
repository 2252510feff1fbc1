"""Pattern query → batched NFA on the device (the north-star path).

Counterpart of ``siddhi_tpu/plan/nfa_compiler.py``: ``CompiledPatternNFA``,
the lowering and pruning above it, and ``CompiledPatternBank`` (N
patterns that differ only in their constants, stepped together over one
shared block).  Takes the same SiddhiQL the host oracle runs and lowers a
PATTERN or SEQUENCE state tree into an ops/nfa.py NfaSpec: a chain of
units (simple / count / logical / absent — reference
util/parser/StateInputStreamParser.java:76-404), per-side condition
programs compiled by plan/expr_compiler.ExprCompiler with the torch
namespace (TorchXP), capture-row allocation for cross-state references,
and a host runtime that packs event batches into [P, T] partition lanes
and decodes match buffers.

On a CUDA device the block step is the hand-written kernel
``csrc/nfa_step.cu``, for the specs of its class
(ops/nfa.kernel_class_reason): a spec outside it is rejected when the
engine is built, with ``SiddhiAppCreationError("device pattern path:
<what> not yet ported to the CUDA NFA kernel")``, so ``'auto'`` runs the
query on the host and ``'device'`` raises.  ``CompiledPatternBank``'s
kernels take the same class.  On the CPU the plain PyTorch step runs
every spec the JAX package compiles.

Supported algebra (the planner falls back to the host oracle
core/pattern.py with a recorded reason for anything else):
  - PATTERN and SEQUENCE chains `c0 -> c1 -> ...` / `c0, c1, ...`
  - leading `every` over the first element or a prefix group
  - kleene counts `<m:n>` / `*` / `+` / `?` at any chain position
    (not consecutive, not leading-`<0:n>`, not directly before `not`)
  - logical `and` / `or` pairs (non-absent sides)
  - absent `not X[filter] for t` at non-leading positions
  - per-state filters referencing earlier captures (numeric attributes)
  - top-level `within` (or an `every`-group within spanning the chain)
  - select of captured attributes (`e1.price as p1`, `e1[0].x`, `e1[last].x`)
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler import SiddhiCompiler
from ..ops.nfa import (CMP_OPS, COUNT_INF, NfaKernelProgram, NfaSpec,
                       UnitSpec, bank_class_reason, carry_dtype,
                       kernel_class_reason,
                       make_bank_carry, make_carry, make_timer_block,
                       nfa_bank_step, nfa_step_egress, resolve_batch_b,
                       resolve_stack)
from ..ops.pack import pack_blocks
from ..ops.windowed_agg import kernel_device
from ..query_api import (AbsentStreamStateElement, CountStateElement,
                         EveryStateElement, Filter, LogicalOp,
                         LogicalStateElement, NextStateElement, Query,
                         StateInputStream, StateType, StreamStateElement)
from ..query_api.definition import AttrType
from ..query_api.expression import (And, Compare, CompareOp, Constant, IsNull,
                                    Not, Or, TimeConstant, Variable,
                                    variables_of, walk)
from ..core.stateschema import (Carry, ListOf, Scalar, Struct,
                                persistent_schema)
from ..utils.errors import SiddhiAppCreationError, SiddhiAppRuntimeException
from .expr_compiler import (CompiledExpr, EvalCtx, ExprCompiler, Scope,
                            TorchXP)
from .nfa_program import (OP_AND, OP_CAP, OP_CMP, OP_EV, OP_K, Outside,
                          encode, lower_program)


_NUMERIC = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


class _Side:
    """One (stream, filter) condition — a side of a unit."""

    def __init__(self, ref: str, stream_id: str, definition, filters):
        self.ref = ref
        self.stream_id = stream_id
        self.definition = definition
        self.filters = filters
        self.row = -1            # capture row (assigned later)
        self.cond_id = -1


class _UnitDesc:
    def __init__(self, kind: str, sides: List[_Side], min_count: int = 1,
                 max_count: int = 1, waiting_ms: int = 0,
                 is_and: bool = False):
        self.kind = kind
        self.sides = sides
        self.min_count = min_count
        self.max_count = max_count
        self.waiting_ms = waiting_ms
        self.is_and = is_and


def _reject(msg: str):
    raise SiddhiAppCreationError("device NFA path: " + msg)


def _flatten_next(el) -> List:
    out = []

    def rec(e):
        if isinstance(e, NextStateElement):
            rec(e.state)
            rec(e.next)
        else:
            out.append(e)
    rec(el)
    return out


class _Lowering:
    """StateElement tree → unit-chain descriptors."""

    def __init__(self, sis: StateInputStream, app):
        self.app = app
        self.units: List[_UnitDesc] = []
        self.is_every = False
        self.every_group_end = 0
        self.tail_every_start = -1
        self.group_within: Optional[int] = None
        elements = _flatten_next(sis.state)
        first = elements[0]
        if isinstance(first, EveryStateElement):
            self.is_every = True
            inner = _flatten_next(first.state)
            for el in inner:
                self._lower_element(el)
            self.every_group_end = len(self.units) - 1
            if first.within_ms is not None:
                if len(elements) > 1:
                    _reject("`within` on a non-suffix `every` group is "
                            "host-only")
                self.group_within = first.within_ms
            elements = elements[1:]
        # trailing `every` (`A -> every B` — the continuous-monitoring
        # staple, StateInputStreamParser.java:272-273): the completing
        # partial re-arms at the group start instead of dying.  Mid-chain
        # `every` would fork partials (a clone waits at the group start
        # while the original advances) — host-only.
        tail = None
        if elements and isinstance(elements[-1], EveryStateElement):
            tail = elements[-1]
            elements = elements[:-1]
        self.mid_every: List[Tuple[int, int]] = []
        for el in elements:
            if isinstance(el, EveryStateElement):
                # mid-chain `every`: a partial leaving the group forks a
                # clone back to the group start (kernel alloc_clones)
                if el.within_ms is not None:
                    _reject("`within` on a mid-chain `every` group is "
                            "host-only")
                g0 = len(self.units)
                for sub in _flatten_next(el.state):
                    if isinstance(sub, EveryStateElement):
                        _reject("nested `every` is host-only")
                    self._lower_element(sub)
                g1 = len(self.units) - 1
                for u in self.units[g0:g1 + 1]:
                    if u.kind not in ("simple", "logical"):
                        _reject(f"a mid-chain `every` group supports "
                                f"simple/logical conditions only "
                                f"(got {u.kind})")
                self.mid_every.append((g0, g1))
            else:
                self._lower_element(el)
        if tail is not None:
            if not self.units:
                _reject("internal: trailing every with empty prefix")
            if tail.within_ms is not None:
                _reject("`within` on a trailing `every` group is host-only")
            self.tail_every_start = len(self.units)
            for el in _flatten_next(tail.state):
                if isinstance(el, EveryStateElement):
                    _reject("nested `every` is host-only")
                self._lower_element(el)
            for u in self.units[self.tail_every_start:]:
                if u.kind not in ("simple", "logical"):
                    _reject(f"a trailing `every` group supports simple/"
                            f"logical conditions only (got {u.kind})")
            if any(u.kind == "count" for u in self.units):
                # the oracle's re-arm clone shares/forks kleene chains in
                # ways the slot ring does not model — verified host-only
                _reject("kleene counts in a trailing-`every` chain are "
                        "host-only")
            if any(u.kind == "absent" for u in self.units):
                # prefix absent deadlines interacting with tail re-arms
                # have no conformance coverage yet — host-only until the
                # oracle parity is demonstrated
                _reject("absent states in a trailing-`every` chain are "
                        "host-only")
        self._validate()

    def _side_of(self, el: StreamStateElement, idx_hint: int) -> _Side:
        s = el.stream
        sid = s.stream_id
        if sid not in self.app.stream_definitions:
            raise SiddhiAppCreationError(f"No stream '{sid}'")
        d = self.app.stream_definitions[sid]
        filters = [h.expr for h in s.handlers if isinstance(h, Filter)]
        if any(not isinstance(h, Filter) for h in s.handlers):
            _reject("only [filter] handlers in conditions")
        self._n_sides = getattr(self, "_n_sides", 0) + 1
        return _Side(s.stream_ref or f"__s{self._n_sides}", sid, d, filters)

    def _lower_element(self, el):
        i = len(self.units)
        if isinstance(el, CountStateElement):
            inner = el.state
            if not isinstance(inner, StreamStateElement) or \
                    type(inner) is not StreamStateElement:
                _reject("kleene counts apply to plain conditions only")
            mn = el.min_count or 0
            mx = el.max_count if el.max_count not in (None,
                                                      CountStateElement.ANY) \
                else COUNT_INF
            if mn < 0 or (mx != COUNT_INF and mx < max(mn, 1)):
                _reject(f"bad kleene bounds <{mn}:{mx}>")
            self.units.append(_UnitDesc(
                "count", [self._side_of(inner, i)], min_count=mn,
                max_count=mx))
        elif isinstance(el, LogicalStateElement):
            for side_el in (el.state1, el.state2):
                if not isinstance(side_el, StreamStateElement) or \
                        type(side_el) is not StreamStateElement:
                    _reject("logical pairs with absent/count sides are "
                            "host-only")
            if el.op not in (LogicalOp.AND, LogicalOp.OR):
                _reject(f"logical op {el.op}")
            self.units.append(_UnitDesc(
                "logical",
                [self._side_of(el.state1, i), self._side_of(el.state2, i)],
                is_and=el.op == LogicalOp.AND))
        elif isinstance(el, AbsentStreamStateElement):
            if el.waiting_time_ms is None:
                _reject("`not X` without `for t` is host-only")
            self.units.append(_UnitDesc(
                "absent", [self._side_of(el, i)],
                waiting_ms=el.waiting_time_ms))
        elif isinstance(el, StreamStateElement):
            if type(el) is not StreamStateElement:
                _reject(f"state element {type(el).__name__}")
            self.units.append(_UnitDesc("simple", [self._side_of(el, i)]))
        else:
            _reject(f"state element {type(el).__name__}")

    def _validate(self):
        units = self.units
        if not units:
            _reject("empty pattern")
        # leading absent compiles for PATTERN mode (kernel ensure-arm /
        # kill-rearm); CompiledPatternNFA rejects the SEQUENCE case
        self.eps_start = False
        if units[0].kind == "count" and units[0].min_count == 0:
            # leading min-0 kleene: the start partial lives at unit 1 with
            # an empty live-appending chain (kernel eps_start machinery)
            if len(units) < 2 or units[1].kind != "simple":
                _reject("leading min-0 kleene must be followed by a "
                        "plain condition")
            if self.tail_every_start in (0, 1) or \
                    any(g0 <= 1 for g0, _g1 in self.mid_every) or \
                    (self.is_every and self.every_group_end >= 1):
                _reject("leading min-0 kleene inside an `every` re-arm "
                        "group is host-only")
            self.eps_start = True
        for j in range(len(units) - 1):
            if units[j].kind == "count" and units[j + 1].kind == "count":
                _reject("consecutive kleene counts are host-only")
            if units[j].kind == "count" and units[j + 1].kind == "absent":
                _reject("a kleene count directly before `not` is host-only")


def _scan_vars(e, fn):
    if isinstance(e, Variable):
        fn(e)
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if hasattr(x, "__dataclass_fields__"):
                    _scan_vars(x, fn)
        elif hasattr(v, "__dataclass_fields__"):
            _scan_vars(v, fn)


def _contains_guarded_null_ref(e, nullable_refs, count_refs=(),
                               inside=False) -> bool:
    """True if a Not/IsNull wraps a reference to a maybe-unmatched row
    (None-propagation differs from zero-filled lanes there).  [last] refs
    to kleene units are exempt: their null truth rides the __n
    chain-length lane exactly (_rewrite_last_refs, round 5)."""
    if isinstance(e, (Not, IsNull)):
        inside = True
    if inside and isinstance(e, Variable) and e.stream_id in nullable_refs:
        if not (e.stream_index == -1 and e.stream_id in count_refs):
            return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        vs = v if isinstance(v, list) else [v]
        for x in vs:
            if hasattr(x, "__dataclass_fields__") and \
                    _contains_guarded_null_ref(x, nullable_refs,
                                               count_refs, inside):
                return True
    return False


def _walk_filter_constants(units: List[_UnitDesc]) -> List:
    """Deterministic walk over all numeric Constant/TimeConstant nodes in
    the chain's filters (the per-pattern parameters of a pattern bank)."""
    found: List = []

    def rec(e):
        if isinstance(e, (Constant, TimeConstant)) and \
                isinstance(getattr(e, "value", None), (int, float)) and \
                not isinstance(e.value, bool):
            found.append(e)
            return
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, list):
                for x in v:
                    if hasattr(x, "__dataclass_fields__"):
                        rec(x)
            elif hasattr(v, "__dataclass_fields__"):
                rec(v)
    for u in units:
        for side in u.sides:
            for fe in side.filters:
                rec(fe)
    return found


def _fold_const(e):
    """Best-effort constant folding: (True, value) when the expression is
    a compile-time constant, else (False, None).  Mirrors the reference
    null law (any null operand makes a comparison false)."""
    from ..query_api.expression import (And, Compare, CompareOp, IsNull,
                                        MathExpr, MathOp, Not, Or)
    if isinstance(e, (Constant, TimeConstant)):
        return True, e.value
    if isinstance(e, Not):
        ok, v = _fold_const(e.expr)
        return (True, not v) if ok and isinstance(v, bool) else (False, None)
    if isinstance(e, And) or isinstance(e, Or):
        lok, lv = _fold_const(e.left)
        rok, rv = _fold_const(e.right)
        is_and = isinstance(e, And)
        for ok, v in ((lok, lv), (rok, rv)):
            if ok and isinstance(v, bool) and v != is_and:
                return True, v          # short-circuit dominator
        if lok and rok and isinstance(lv, bool) and isinstance(rv, bool):
            return True, (lv and rv) if is_and else (lv or rv)
        return False, None
    if isinstance(e, IsNull):
        if e.expr is not None:
            ok, v = _fold_const(e.expr)
            if ok:
                return True, v is None
        return False, None
    if isinstance(e, Compare):
        lok, lv = _fold_const(e.left)
        rok, rv = _fold_const(e.right)
        if not (lok and rok):
            return False, None
        if lv is None or rv is None:
            return True, False          # reference: null compares false
        try:
            return True, {
                CompareOp.LT: lambda a, b: a < b,
                CompareOp.GT: lambda a, b: a > b,
                CompareOp.LTE: lambda a, b: a <= b,
                CompareOp.GTE: lambda a, b: a >= b,
                CompareOp.EQ: lambda a, b: a == b,
                CompareOp.NEQ: lambda a, b: a != b,
            }[e.op](lv, rv)
        except TypeError:
            return False, None
    if isinstance(e, MathExpr):
        lok, lv = _fold_const(e.left)
        rok, rv = _fold_const(e.right)
        if not (lok and rok) or isinstance(lv, (str, bool)) or \
                isinstance(rv, (str, bool)):
            return False, None
        try:
            return True, {
                MathOp.ADD: lambda a, b: a + b,
                MathOp.SUB: lambda a, b: a - b,
                MathOp.MUL: lambda a, b: a * b,
                MathOp.DIV: lambda a, b: a / b,
                MathOp.MOD: lambda a, b: a % b,
            }[e.op](lv, rv)
        except (TypeError, ZeroDivisionError):
            return False, None
    return False, None


def _fold_bool(e) -> Optional[bool]:
    """Fold a filter expression to a constant boolean, or None."""
    ok, v = _fold_const(e)
    return v if ok and isinstance(v, bool) else None


def _simplify_expr(e, changed: List[int]):
    """Boolean simplification: fold constant subtrees out of And/Or/Not
    (`x and 2 > 1` -> `x`).  Purely semantics-preserving — the compiled
    condition is the same function with less trace work.  Increments
    changed[0] per rewrite."""
    from ..query_api.expression import And, Not, Or
    if isinstance(e, (And, Or)):
        left = _simplify_expr(e.left, changed)
        right = _simplify_expr(e.right, changed)
        is_and = isinstance(e, And)
        lv, rv = _fold_bool(left), _fold_bool(right)
        for v, other in ((lv, right), (rv, left)):
            if v is not None:
                changed[0] += 1
                if v == is_and:          # neutral operand drops out
                    return other
                return Constant(v, "bool")      # dominator
        if left is e.left and right is e.right:
            return e
        return And(left, right) if is_and else Or(left, right)
    if isinstance(e, Not):
        inner = _simplify_expr(e.expr, changed)
        v = _fold_bool(inner)
        if v is not None:
            changed[0] += 1
            return Constant(not v, "bool")
        return e if inner is e.expr else Not(inner)
    return e


def _referenced_names(units: List[_UnitDesc], query,
                      skip_side: _Side) -> set:
    """Every stream_id a Variable mentions in the chain's filters (other
    than skip_side's own) or the select clause — the conservative "is
    this capture addressed anywhere" test the pruner uses."""
    names: set = set()

    def note(v: Variable):
        if v.stream_id:
            names.add(v.stream_id)
    for u in units:
        for side in u.sides:
            if side is skip_side:
                continue
            for fe in side.filters:
                _scan_vars(fe, note)
    for oa in query.selector.attributes:
        _scan_vars(oa.expr, note)
    return names


def _prune_chain(low: _Lowering, query) -> Dict[str, Any]:
    """Liveness pruning over the lowered unit chain, BEFORE capture-row
    allocation and condition compilation (so everything downstream —
    lane layout, cond programs, NfaSpec — is built from the pruned
    chain and stays internally consistent).

    Match-output equivalence (asserted on randomized feeds in
    tests/test_plan_verify.py):

      * a filter folding to constant TRUE is dropped (the condition
        without it is identical);
      * an `or` side folding to constant FALSE can never match its
        side, so the unit degrades to a simple unit of the live side —
        guarded on the dead side's captures being referenced nowhere;
      * a min-0 kleene whose condition folds FALSE can never append:
        its only viable path is the epsilon skip `_land_static` already
        takes, so the unit is deleted outright (same guard, plus chain-
        adjacency rules so no host-only shape is created);
      * any NON-skippable unit whose condition folds FALSE makes accept
        unreachable — the chain is a straight line, partials only move
        forward — so the whole automaton is dead: the engine skips the
        device step (zero matches either way).

    Returns the prune report {pruned_states, simplified, dead, notes}.
    """
    report: Dict[str, Any] = {"pruned_states": 0, "simplified": 0,
                              "dead": False, "notes": []}
    units = low.units

    # ---- pass 1: simplify + fold filters per side
    false_sides: Dict[int, List[_Side]] = {}
    for ui, u in enumerate(units):
        for side in u.sides:
            kept = []
            side_false = False
            changed = [0]
            for fe in side.filters:
                fe = _simplify_expr(fe, changed)
                v = _fold_bool(fe)
                if v is True:
                    changed[0] += 1
                    report["notes"].append(
                        f"s{ui}/{side.ref}: dropped constant-true filter")
                    continue
                if v is False:
                    side_false = True
                kept.append(fe)
            report["simplified"] += changed[0]
            if changed[0]:
                report["notes"].append(
                    f"s{ui}/{side.ref}: folded {changed[0]} constant "
                    f"boolean subtree(s)")
            if not side_false:
                # only mutate when provably harmless: constant subtrees
                # folded out, everything else identical
                side.filters = kept
            else:
                false_sides.setdefault(ui, []).append(side)

    # ---- pass 2: unit satisfiability (can a partial ever pass it?)
    for ui, u in enumerate(units):
        dead_here = False
        fs = false_sides.get(ui, [])
        if u.kind == "simple" and fs:
            dead_here = True
        elif u.kind == "count" and fs and u.min_count >= 1:
            dead_here = True
        elif u.kind == "logical" and fs:
            dead_here = u.is_and or len(fs) == len(u.sides)
        # absent: a false condition only means no arrival can ever kill
        # the wait — the absence always confirms; the unit stays live
        if dead_here:
            report["dead"] = True
            report["notes"].append(
                f"s{ui} ({u.kind}) condition folds to constant false: "
                f"accept unreachable, automaton dead")
    if report["dead"]:
        return report

    # ---- pass 3: structural prunes (skippable dead pieces)

    def is_referenced(side: _Side) -> bool:
        names = _referenced_names(units, query, side)
        return side.ref in names or side.stream_id in names

    # or-units with exactly one dead side degrade to simple
    for ui, u in enumerate(units):
        fs = false_sides.get(ui, [])
        if u.kind == "logical" and not u.is_and and len(fs) == 1:
            dead = fs[0]
            live = next(s for s in u.sides if s is not dead)
            if is_referenced(dead):
                report["notes"].append(
                    f"s{ui}: dead `or` side {dead.ref} kept "
                    f"(referenced in select/conditions)")
                continue
            u.kind = "simple"
            u.sides = [live]
            u.is_and = False
            report["pruned_states"] += 1
            report["notes"].append(
                f"s{ui}: `or` side {dead.ref} can never match — "
                f"degraded to simple({live.ref})")

    # dead min-0 kleene units delete outright (epsilon path only)
    structural_ok = (not low.mid_every and low.tail_every_start < 0)
    j = len(units) - 1
    while j >= 1:
        u = units[j]
        fs = false_sides.get(j, [])
        if u.kind == "count" and u.min_count == 0 and fs and \
                structural_ok and \
                not (low.is_every and j <= low.every_group_end):
            side = u.sides[0]
            prev_k = units[j - 1].kind
            next_k = units[j + 1].kind if j + 1 < len(units) else None
            adjacency_safe = not (
                prev_k == "count" and next_k in ("count", "absent"))
            if adjacency_safe and not is_referenced(side):
                units.pop(j)
                report["pruned_states"] += 1
                report["notes"].append(
                    f"s{j}: min-0 kleene {side.ref} can never append — "
                    f"state deleted, transition matrices shrink")
            elif not adjacency_safe:
                report["notes"].append(
                    f"s{j}: dead min-0 kleene kept (deletion would "
                    f"create a host-only adjacency)")
            else:
                report["notes"].append(
                    f"s{j}: dead min-0 kleene {side.ref} kept "
                    f"(referenced in select/conditions)")
        j -= 1
    return report


PRUNE_ENV = "SIDDHI_TPU_NFA_PRUNE"


def _widen_slots(c: Dict[str, torch.Tensor], axis: int, pad: int, R: int,
                 C: int) -> Dict[str, torch.Tensor]:
    """``pad`` empty slots appended on the slot axis of every per-slot
    carry leaf (the fills of a fresh carry)."""
    c = dict(c)
    lead = tuple(c["slot_state"].shape[:axis])

    def cat(key, fill, extra=()):
        v = c[key]
        c[key] = torch.cat([v, torch.full(lead + (pad,) + extra, fill,
                                          dtype=v.dtype, device=v.device)],
                           dim=axis)
    cat("slot_state", -1)
    cat("slot_start", 0)
    cat("slot_enter", 0)
    cat("slot_seq", 0)
    cat("captures", 0, (R, C))
    if "cnt_cur" in c:
        cat("cnt_cur", 0)
        cat("cnt_prev", -1)
    if "lmask" in c:
        cat("lmask", 0)
    if "deadline" in c:
        cat("deadline", 0)
    return c


@persistent_schema(
    "nfa-engine", version=1,
    schema=Struct(carry=Carry(), base_ts=Scalar("opt_int"),
                  n_partitions=Scalar("int"), str_decoder=ListOf("str")),
    dims={"S": "exact", "K": "ladder", "P": "free",
          "R": "exact", "C": "exact"},
    doc="S automaton units and R/C capture geometry are plan-fixed; "
        "slot capacity K grows by doubling; lane count P is adopted "
        "wholesale by restore")
class CompiledPatternNFA:
    """One pattern query compiled for batched multi-partition execution."""

    def __init__(self, app_string, n_partitions: int,
                 n_slots: int = 8, query_name: Optional[str] = None,
                 query: Optional[Query] = None, mesh: Any = "auto",
                 prune: Optional[bool] = None,
                 batch_b: Optional[int] = None, telemetry: bool = False,
                 device=None, parameterize: bool = False):
        """mesh: None or "auto", both one device (a multi-device mesh is
        not yet ported).

        prune: liveness pruning over the unit chain (on by default; env
        SIDDHI_TPU_NFA_PRUNE=0 disables globally — the unpruned baseline
        the equivalence tests diff against).  Pattern-bank mode
        (parameterize=True) always compiles unpruned: folding constants
        out of filters would desync the per-pattern parameter lanes.

        parameterize: pattern-bank mode — every numeric filter constant
        becomes a per-pattern float32 lane ``__param_<j>`` read from the
        event dict (CompiledPatternBank feeds them).

        batch_b: events per tick of the plain step (default resolves
        SIDDHI_TPU_NFA_BATCH; B > 1 hoists capture-free conditions).

        telemetry: @app:statistics(telemetry='true') — carry an int32
        per-state telemetry leaf (occupancy, gate pass/fail, within
        drops) read out through the fused egress slab (plain step only).

        device: the torch device of the carry and step (default "cuda",
        see ops/windowed_agg.kernel_device).  On CUDA a spec outside the
        kernel's class raises SiddhiAppCreationError here, before any
        device memory is touched."""
        if not (mesh is None or (isinstance(mesh, str) and mesh == "auto")):
            raise SiddhiAppCreationError(
                "device NFA path: an explicit device mesh is not yet ported "
                "to the torch backend")
        app = (SiddhiCompiler.parse(app_string)
               if isinstance(app_string, str) else app_string)
        self.app = app
        if query is None:
            query = self._pick_query(app, query_name)
        sis = query.input_stream
        if not isinstance(sis, StateInputStream):
            raise SiddhiAppCreationError(
                "device NFA path needs a PATTERN/SEQUENCE query")
        low = _Lowering(sis, app)
        if prune is None:
            prune = os.environ.get(PRUNE_ENV, "1") != "0"
        self.prune_enabled = bool(prune) and not parameterize
        self._parameterize = bool(parameterize)
        if self.prune_enabled:
            self.prune_report = _prune_chain(low, query)
        else:
            self.prune_report = {"pruned_states": 0, "simplified": 0,
                                 "dead": False, "notes": []}
        self.units = low.units
        self.is_sequence = sis.state_type == StateType.SEQUENCE
        if self.units[0].kind == "absent" and self.is_sequence:
            _reject("leading absent states in a sequence are host-only")
        self.seq_dead_start = False
        if self.is_sequence and self.units[0].kind == "count":
            # Round 5: the leading-kleene family compiles (retiring the r4
            # pin).  Oracle semantics (StreamPreStateProcessor.resetState
            # :263-279, CountPreStateProcessor:53-105, verified
            # empirically against core/pattern.py):
            #   - the per-event barrier clears every pending list, so an
            #     accumulator below `min` survives ONLY via the CountPost
            #     re-add — which fires at cnt >= min.  min >= 2 therefore
            #     NEVER forwards: the shape is dead (zero matches ever)
            #     for every and non-every alike.
            #   - min == 1: one live chain at a time (the shared StateEvent
            #     occupies the start's new-list while appending; re-init
            #     only after it freezes at max, closes, or dies).
            #   - min == 0: the eps_start virgin; every-mode recreates it
            #     whenever no LIVE (cnt >= 0) chain holds unit 1.
            if len(self.units) < 2:
                _reject("a single-unit SEQUENCE kleene is host-only")
            if self.units[1].kind in ("absent", "logical"):
                _reject("a SEQUENCE leading kleene directly before an "
                        "absent/logical unit is host-only")
            if self.units[0].min_count >= 2:
                self.seq_dead_start = True
            elif sis.within_ms is not None or low.group_within is not None:
                _reject("`within` on a SEQUENCE leading kleene is "
                        "host-only")
        is_every = low.is_every
        within_ms = sis.within_ms
        if low.group_within is not None:
            within_ms = (low.group_within if within_ms is None
                         else min(within_ms, low.group_within))

        # statically-dead plans (pruner-proven constant-false condition,
        # or the SEQUENCE dead-start family — both reach accept never):
        # the engine path skips the device step entirely; match output is
        # identically empty either way (equivalence test-asserted)
        if self.seq_dead_start and self.prune_enabled and \
                not self.prune_report["dead"]:
            self.prune_report["dead"] = True
            self.prune_report["notes"].append(
                "SEQUENCE leading kleene min>=2: per-event barrier kills "
                "every sub-min accumulator — automaton dead")
        self.statically_dead = bool(self.prune_enabled and
                                    self.prune_report["dead"])

        # stream codes: order of first appearance
        self.stream_codes: Dict[str, int] = {}
        for u in self.units:
            for side in u.sides:
                if side.stream_id not in self.stream_codes:
                    self.stream_codes[side.stream_id] = \
                        len(self.stream_codes)

        # attribute schema: union over referenced streams.  Numeric attrs
        # ride lanes directly; STRING attrs referenced in equality
        # conditions or captures are dictionary-encoded onto integer lanes
        # (codes exact in float32 up to 2^24 values; the host owns the
        # dictionary) — the columnar replacement for the reference's
        # Object[]-typed StreamEvent payloads carrying strings
        # (event/stream/StreamEvent.java:40-57).
        self.attr_names: List[str] = []
        self.attr_types: Dict[str, AttrType] = {}
        self.real_types: Dict[str, AttrType] = {}
        # INT/LONG capture exactness (round 5): selected integer attrs
        # get three companion event lanes (hi 22 / mid 21 / lo 21 bits of
        # the sign-biased value — each exact in f32) that ride the same
        # capture banks; decode reassembles the exact int64.  Maps
        # companion lane name → source attr.
        self.int_exact_src: Dict[str, str] = {}
        str_attrs: set = set()
        for u in self.units:
            for side in u.sides:
                for a in side.definition.attributes:
                    if a.name not in self.real_types:
                        self.real_types[a.name] = a.type
                        if a.type in _NUMERIC:
                            self.attr_names.append(a.name)
                            self.attr_types[a.name] = a.type
                        elif a.type == AttrType.STRING:
                            str_attrs.add(a.name)
        self._setup_string_encoding(str_attrs, query)

        # ---- capture rows: one per capturing side
        rows: List[_Side] = []
        self.ref_to_unit: Dict[str, int] = {}
        self.ref_to_side: Dict[str, _Side] = {}
        for ui, u in enumerate(self.units):
            for side in u.sides:
                if u.kind != "absent":
                    side.row = len(rows)
                    rows.append(side)
                if side.ref in self.ref_to_unit:
                    _reject(f"duplicate state ref '{side.ref}'")
                self.ref_to_unit[side.ref] = ui
                self.ref_to_side[side.ref] = side
        self.rows = rows
        self.row_unit = [self.ref_to_unit[s.ref] for s in rows]
        # rows whose captures may legitimately be absent in a match
        self.nullable_rows: set = set()
        for u in self.units:
            if u.kind == "count" and u.min_count == 0:
                self.nullable_rows.add(u.sides[0].row)
            if u.kind == "logical" and not u.is_and:
                for side in u.sides:
                    self.nullable_rows.add(side.row)
        self.nullable_refs = {s.ref for s in rows
                              if s.row in self.nullable_rows}

        # ---- scan filters + select for cross-state references
        self._cond_capture_attrs: set = set()
        needed_f: List[set] = [set() for _ in rows]
        needed_l: List[set] = [set() for _ in rows]
        needed_idx: List[dict] = [{} for _ in rows]     # k -> attrs
        needed_lastk: List[dict] = [{} for _ in rows]   # j -> attrs

        def which_of(var: Variable, row: int,
                     select_ctx: bool = False) -> str:
            si = var.stream_index
            unit = self.units[self.row_unit[row]]
            if si is None or si == 0:
                return "f"
            if si == -1:
                return "l" if unit.kind == "count" else "f"
            if unit.kind != "count":
                _reject(f"indexing into a non-kleene capture "
                        f"(got index {si})")
            if not select_ctx:
                # conditions read per-slot capture lanes at trace time —
                # only first/last banks exist there
                _reject("indexed kleene captures in CONDITIONS are "
                        "host-only (select-side e[k]/e[last-k] compile)")
            # select-side arbitrary indexing: each referenced index gets
            # its own capture bank (written when the chain reaches it /
            # shifted behind the last bank — ops/nfa.write_count)
            if si >= 1:
                if si > 30:
                    _reject(f"capture index {si} exceeds the bank budget")
                return f"i{si}"
            j = -si - 1                  # last-j  (si = -(j+1))
            if j > 30:
                _reject(f"capture index last-{j} exceeds the bank budget")
            return f"m{j}"

        def note(var: Variable, current_side: Optional[_Side]):
            if var.stream_id is None:
                return
            side = self.ref_to_side.get(var.stream_id)
            if side is None:
                # a bare stream-id qualifier is allowed when unambiguous
                cands = [s for s in self.rows
                         if s.stream_id == var.stream_id]
                if len(cands) == 1 and (current_side is None or
                                        cands[0] is not current_side):
                    side = cands[0]
                else:
                    return
            if current_side is not None and side is current_side:
                is_count = self.units[self.row_unit[side.row]].kind == \
                    "count"
                if is_count and var.stream_index == -1:
                    # e[last] inside the kleene's OWN condition: the
                    # oracle shifts self negative indexes past the just-
                    # appended candidate (core/pattern._register_qualified
                    # self_unit; ExpressionParser.java:1366), i.e. the
                    # last PREVIOUSLY accepted element — exactly the
                    # kernel's pre-write last bank.  Null law rides the
                    # __n chain-length lane (_rewrite_last_refs).
                    needed_l[side.row].add(var.attribute)
                    return
                if var.stream_index not in (None, 0) or \
                        (is_count and var.stream_index is not None):
                    _reject("self-indexed references (other than [last]) "
                            "inside a kleene condition are host-only")
                return              # binds to the current event
            if side.row < 0:
                _reject(f"'{var.stream_id}' is an absent state; it "
                        f"captures nothing")
            if var.attribute not in self.attr_types:
                _reject(f"captured attribute "
                        f"'{var.stream_id}.{var.attribute}' is not numeric")
            (needed_f if which_of(var, side.row) == "f" else
             needed_l)[side.row].add(var.attribute)
            self._cond_capture_attrs.add(var.attribute)

        for ui, u in enumerate(self.units):
            for side in u.sides:
                count_refs = {s.ref for s in self.rows
                              if self.units[self.row_unit[s.row]].kind ==
                              "count"}
                for fe in side.filters:
                    _scan_vars(fe, lambda v, _s=side: note(v, _s))
                    if _contains_guarded_null_ref(fe, self.nullable_refs,
                                                  count_refs):
                        _reject("not()/isNull() over a maybe-unmatched "
                                "state is host-only")
                    # unit-0 conditions must be capture-free (arming reads
                    # lane 0); in particular a logical side referencing its
                    # partner is host-only
                    if ui == 0:
                        def chk(v, _s=side):
                            s2 = self.ref_to_side.get(v.stream_id or "")
                            if s2 is not None and s2 is not _s:
                                _reject("the first condition cannot "
                                        "reference other captures")
                        _scan_vars(fe, chk)

        self.select_outputs: List[Tuple[str, int, str, str]] = []
        for oa in query.selector.attributes:
            e = oa.expr
            if not isinstance(e, Variable) or e.stream_id is None:
                _reject("select must be captured attributes "
                        "(e1.attr as name)")
            side = self.ref_to_side.get(e.stream_id)
            if side is None or side.row < 0:
                _reject(f"select references unknown or absent state "
                        f"'{e.stream_id}'")
            if e.attribute not in self.attr_types:
                _reject(f"selected attribute "
                        f"'{e.stream_id}.{e.attribute}' is not numeric")
            w = which_of(e, side.row, select_ctx=True)
            sel_attrs = [e.attribute]
            if self.attr_types.get(e.attribute) in (AttrType.INT,
                                                    AttrType.LONG) and \
                    e.attribute not in self.encoded_attrs:
                # exact integer payload: three companion lanes ride the
                # same bank as the base attr (see int_exact_src)
                for part in ("hi", "md", "lo"):
                    comp = f"__ex{part}_{e.attribute}"
                    if comp not in self.attr_types:
                        self.attr_names.append(comp)
                        self.attr_types[comp] = AttrType.INT
                        self.int_exact_src[comp] = e.attribute
                    sel_attrs.append(comp)
            for a in sel_attrs:
                if w == "f":
                    needed_f[side.row].add(a)
                elif w == "l":
                    needed_l[side.row].add(a)
                elif w.startswith("i"):
                    needed_idx[side.row].setdefault(int(w[1:]),
                                                    set()).add(a)
                else:
                    needed_lastk[side.row].setdefault(int(w[1:]),
                                                      set()).add(a)
                    # last-j shifts source from the LAST bank: its attrs
                    # must ride there too
                    needed_l[side.row].add(a)
            if any(o[0] == oa.rename for o in self.select_outputs):
                # reference DuplicateAttributeException (SelectorParser)
                _reject(f"duplicate output attribute '{oa.rename}' in "
                        "select (use 'as' to alias)")
            self.select_outputs.append((oa.rename, side.row, e.attribute, w))

        # ---- lane layout per row: first bank ++ last bank ++ meta lanes
        cap_cols: List[Tuple[str, ...]] = []
        n_first: List[int] = []
        n_lane: List[int] = []
        matched_lane: List[int] = []
        self.cap_lane: Dict[Tuple[int, str, str], int] = {}
        idx_banks: List[Tuple] = []      # per row: ((k, start, len), ...)
        lastk_banks: List[Tuple] = []    # per row: ((j, start), ...)
        m_src: List[Tuple[int, ...]] = []  # per row: l-bank source lanes
        n_last: List[int] = []
        for r in range(len(rows)):
            unit = self.units[self.row_unit[r]]
            fcols = sorted(needed_f[r])
            lcols = sorted(needed_l[r]) if unit.kind == "count" else []
            cols = list(fcols) + list(lcols)
            for lane, a in enumerate(fcols):
                self.cap_lane[(r, a, "f")] = lane
                if a not in lcols:
                    self.cap_lane[(r, a, "l")] = lane
            for lane, a in enumerate(lcols):
                self.cap_lane[(r, a, "l")] = len(fcols) + lane
                if a not in fcols:
                    self.cap_lane[(r, a, "f")] = len(fcols) + lane
            n_last.append(len(lcols))
            # absolute-index banks e[k]: written when the chain reaches
            # k+1 elements
            row_ib = []
            for k in sorted(needed_idx[r]):
                attrs = sorted(needed_idx[r][k])
                start = len(cols)
                for lane, a in enumerate(attrs):
                    self.cap_lane[(r, a, f"i{k}")] = start + lane
                cols += attrs
                row_ib.append((k, start, len(attrs)))
            idx_banks.append(tuple(row_ib))
            # last-k banks: all share the union attr set (lane-aligned
            # shift chain m_j <- m_{j-1} <- last bank)
            um = sorted(set().union(*needed_lastk[r].values())) \
                if needed_lastk[r] else []
            row_mb = []
            max_j = max(needed_lastk[r], default=0)
            for j in range(1, max_j + 1):
                start = len(cols)
                for lane, a in enumerate(um):
                    self.cap_lane[(r, a, f"m{j}")] = start + lane
                cols += [f"__m{j}_{a}" for a in um]
                row_mb.append((j, start))
            lastk_banks.append(tuple(row_mb))
            m_src.append(tuple(len(fcols) + lcols.index(a) for a in um))
            if unit.kind == "count":
                n_lane.append(len(cols))
                cols.append("__n")
                matched_lane.append(-1)
            elif unit.kind == "logical":
                n_lane.append(-1)
                matched_lane.append(len(cols))
                cols.append("__matched")
            else:
                n_lane.append(-1)
                matched_lane.append(-1)
            n_first.append(len(fcols))
            cap_cols.append(tuple(cols))
        C = max((len(c) for c in cap_cols), default=0)

        # optional pattern-bank parameterization: numeric filter constants
        # become per-pattern lanes fed through the event dict
        self._param_map: Dict[int, str] = {}
        self.param_names: List[str] = []
        if parameterize and any(w[0] in "im"
                                for (_n, _r, _a, w) in self.select_outputs):
            _reject("indexed kleene selects ride extra capture banks the "
                    "bank ring decode does not gate — not parameterizable")
        if parameterize:
            for j, c in enumerate(_walk_filter_constants(self.units)):
                name = f"__param_{j}"
                self._param_map[id(c)] = name
                self.param_names.append(name)

        # ---- compile per-side condition programs against the torch
        # namespace, and their split into the kernel's inputs
        self.device = kernel_device(device)
        self._xp = TorchXP(self.device)
        cond_fns: List[Callable] = []
        cond_free: List[bool] = []
        unit_specs: List[UnitSpec] = []
        self._n_lane = n_lane
        self._matched_lane = matched_lane
        kern_conds: List[Any] = []      # per cond: _kernel_split or reason
        for u in self.units:
            for side in u.sides:
                side.cond_id = len(cond_fns)
                fn, free, kc = self._compile_condition(side)
                cond_fns.append(fn)
                cond_free.append(free)
                kern_conds.append(kc)
            a = u.sides[0]
            b = u.sides[1] if len(u.sides) > 1 else None
            unit_specs.append(UnitSpec(
                kind=u.kind,
                stream_a=self.stream_codes[a.stream_id],
                cond_a=a.cond_id, row_a=a.row,
                stream_b=self.stream_codes[b.stream_id] if b else -1,
                cond_b=b.cond_id if b else -1,
                row_b=b.row if b else -1,
                is_and=u.is_and, min_count=u.min_count,
                max_count=u.max_count, waiting_ms=u.waiting_ms))

        # single-shot arming: non-every queries (both modes), and
        # every-leading-count patterns (the accumulator chain is shared
        # with the re-arm clones)
        arm_once = (not is_every) or \
            (not self.is_sequence and self.units[0].kind == "count")
        self.batch_b = resolve_batch_b(batch_b)
        self.spec = NfaSpec(
            units=tuple(unit_specs), n_rows=len(rows), n_caps=C,
            n_slots=n_slots, within_ms=within_ms,
            cond_fns=tuple(cond_fns), cap_cols=tuple(cap_cols),
            n_first=tuple(n_first), n_lane=tuple(n_lane),
            matched_lane=tuple(matched_lane),
            attr_names=tuple(self.attr_names), is_every=is_every,
            is_sequence=self.is_sequence, arm_once=arm_once,
            every_group_end=low.every_group_end,
            tail_every_start=low.tail_every_start,
            mid_every=tuple(low.mid_every),
            eps_start=low.eps_start,
            lead_absent=self.units[0].kind == "absent",
            dead_start=self.seq_dead_start,
            n_last=tuple(n_last), idx_banks=tuple(idx_banks),
            lastk_banks=tuple(lastk_banks), m_src=tuple(m_src),
            cond_free=tuple(cond_free), batch_b=self.batch_b,
            telemetry=bool(telemetry))
        self.kprog = self._kernel_program(kern_conds)
        # a bank's template is held to the bank kernels' class, which is
        # the step's (ops/nfa.bank_class_reason)
        reason = bank_class_reason(self.spec, self.kprog) if parameterize \
            else self.kprog.reason
        if self.device.type == "cuda" and reason is not None:
            raise SiddhiAppCreationError(
                f"device pattern path: {reason} not yet ported "
                f"to the CUDA NFA kernel")
        self.has_absent = any(u.kind == "absent" for u in self.units)
        self.last_min_deadline: Optional[int] = None
        self.last_telemetry = None   # [P, 3S+1] host int32 after retire
        # egress sizes that have worked: slab rows, and scratch rows per
        # CTA of the CUDA step (None: the kernel's default)
        self._egress_cap = 1024
        self._egress_seg: Optional[int] = None
        self.n_partitions = n_partitions
        # a parameterized compile is a bank's template: the bank holds the
        # [N, P, ...] carries and builds its own step; the template keeps
        # a [P, ...] carry of its spec, as the reference's does
        self.carry = self._place_carry(
            make_carry(self.spec, n_partitions, self.device))
        self._step = None if parameterize else self._build_step()
        self.base_ts: Optional[int] = None

        # Select-side INT/LONG payloads are exact (companion lanes).
        # CONDITIONS still compare f32 event/capture scalars, so an
        # integer attr referenced cross-state in a condition keeps a
        # narrowed warning.
        import warnings
        for a in sorted(self._cond_capture_attrs):
            if a in self.encoded_attrs:
                continue       # dictionary codes are capped at 2^24
            if self.attr_types.get(a) in (AttrType.INT, AttrType.LONG):
                warnings.warn(
                    f"device NFA path: {self.attr_types[a].name} attribute "
                    f"'{a}' is compared in a CONDITION on float32 lanes; "
                    f"condition compares round above 2**24 (match "
                    f"payloads stay exact)", stacklevel=2)

    # -------------------------------------------- string dictionary coding

    def _setup_string_encoding(self, str_attrs: set, query) -> None:
        """Find STRING attrs used by this query, validate their usage
        (equality compares and captures only — codes carry no order),
        rewrite plan-time string constants to their codes, and register
        the attrs as LONG code lanes."""
        self.str_encoder: Dict[Any, int] = {}
        self.str_decoder: List[Any] = []
        self.encoded_attrs: set = set()
        self.derived: Dict[str, Tuple[str, Any, str]] = {}
        if not str_attrs:
            return

        def is_str_var(e) -> bool:
            return isinstance(e, Variable) and e.attribute in str_attrs

        def with_null_guards(cmp: Compare, str_vars) -> Any:
            # host compare executors treat ANY null operand as false
            # (expr_compiler compare lowering); nulls encode as code 0, so
            # every string compare gets `var != 0` guards
            out = cmp
            for v in str_vars:
                out = And(out, Compare(v, CompareOp.NEQ,
                                       Constant(0, "long")))
            return out

        def rewrite(e, side=None):
            if isinstance(e, Compare):
                ls, rs = is_str_var(e.left), is_str_var(e.right)
                if ls or rs:
                    if e.op not in (CompareOp.EQ, CompareOp.NEQ):
                        # ORDER comparison: dictionary codes carry no
                        # order, but CURRENT-EVENT-vs-CONSTANT order
                        # predicates are per-event pure — they lower onto
                        # a host-computed 0/1 lane the condition reads
                        # (round 4; null → 0 ⇒ false, the reference law)
                        from .str_lanes import _REFLECT
                        var, const = (e.left, e.right) if ls else \
                            (e.right, e.left)
                        if (ls and rs) or not (
                                isinstance(const, Constant) and
                                isinstance(const.value, str)):
                            _reject("string ORDER comparisons support "
                                    "only attribute-vs-constant on the "
                                    "device")
                        if getattr(var, "stream_index", None) is not None:
                            _reject("indexed string references have no "
                                    "order lanes")
                        own = (None,) if side is None else \
                            (None, side.ref, side.stream_id)
                        if var.stream_id not in own:
                            # the lane is computed from the CURRENT
                            # event's column — a captured state's string
                            # (e1.s > 'mm' inside e2) has no lane
                            _reject("cross-state string ORDER "
                                    "comparisons are host-only")
                        op = e.op if ls else _REFLECT[e.op]
                        name = f"__sord{len(self.derived)}"
                        self.derived[name] = (var.attribute, op,
                                              const.value)
                        return Compare(Variable(attribute=name),
                                       CompareOp.GT, Constant(0, "long"))
                    if ls and rs:
                        self.encoded_attrs.add(e.left.attribute)
                        self.encoded_attrs.add(e.right.attribute)
                        return with_null_guards(e, (e.left, e.right))
                    var, const = (e.left, e.right) if ls else \
                        (e.right, e.left)
                    if not (isinstance(const, Constant) and
                            isinstance(const.value, str)):
                        _reject("string attributes compare only against "
                                "string constants or string attributes on "
                                "the device")
                    self.encoded_attrs.add(var.attribute)
                    code = self._encode_str(const.value)
                    cc = Constant(code, "long")
                    return with_null_guards(
                        Compare(var if ls else cc, e.op,
                                cc if ls else var), (var,))
                # no direct string side: any nested string var (functions,
                # arithmetic) is untranslatable
                for v in variables_of(e):
                    if is_str_var(v):
                        _reject(f"string attribute '{v.attribute}' is "
                                f"only supported in ==/!= compares and "
                                f"captures on the device")
                return e
            if isinstance(e, And):
                return And(rewrite(e.left, side),
                           rewrite(e.right, side))
            if isinstance(e, Or):
                return Or(rewrite(e.left, side),
                          rewrite(e.right, side))
            if isinstance(e, Not):
                return Not(rewrite(e.expr, side))
            for v in variables_of(e):
                if is_str_var(v):
                    _reject(f"string attribute '{v.attribute}' is only "
                            f"supported in ==/!= compares and captures "
                            f"on the device")
            return e

        for u in self.units:
            for side in u.sides:
                side.filters = [rewrite(f, side)
                                for f in side.filters]
        for oa in query.selector.attributes:
            for v in variables_of(oa.expr):
                if is_str_var(v):
                    self.encoded_attrs.add(v.attribute)

        if (self.encoded_attrs or self.derived) and self._parameterize:
            _reject("string conditions are not parameterizable "
                    "(pattern-bank mode lowers constants to float lanes)")

        for a in sorted(self.encoded_attrs):
            self.attr_names.append(a)
            self.attr_types[a] = AttrType.LONG
        for name in self.derived:
            self.attr_names.append(name)
            self.attr_types[name] = AttrType.FLOAT

    def _encode_str(self, v) -> int:
        code = self.str_encoder.get(v)
        if code is None:
            code = len(self.str_encoder) + 1    # 0 = null/padding/missing
            if code > (1 << 24):
                # raised at ingest: the junction's @OnError boundary
                # LOG-drops or fault-routes the chunk (a runtime data
                # error, not an app-definition one)
                from ..utils.errors import SiddhiAppRuntimeException
                raise SiddhiAppRuntimeException(
                    "string dictionary exceeded 2^24 distinct values "
                    "(codes must stay exact in float32 lanes); "
                    "re-plan with @app:engine('host')")
            self.str_encoder[v] = code
            self.str_decoder.append(v)
        return code

    def derived_lane(self, name: str, col) -> np.ndarray:
        """Host-computed 0/1 lane for a string ORDER predicate
        (`s > 'A'`): vectorized unicode comparison; null → 0 (the
        reference null law: comparisons with null are false)."""
        from ..query_api.expression import CompareOp
        _src, op, cval = self.derived[name]
        obj = np.asarray(col, object)
        none = np.asarray([x is None for x in obj], bool)
        strs = np.asarray(["" if x is None else str(x) for x in obj])
        from .str_lanes import has_supplementary, utf16_keys
        if has_supplementary(strs) or any(ord(c) > 0xFFFF for c in cval):
            # match Java's UTF-16 code-unit order (see str_lanes)
            strs = utf16_keys(strs)
            cval = cval.encode("utf-16-be")
        res = {CompareOp.GT: strs > cval, CompareOp.GTE: strs >= cval,
               CompareOp.LT: strs < cval, CompareOp.LTE: strs <= cval
               }[op]
        res = res & ~none
        return res.astype(np.float32)

    def encode_column(self, col) -> np.ndarray:
        """String column → float32 code lane (dictionary grows on first
        sight of a value; ingest-side, host).  Nulls map to the reserved
        code 0, which every rewritten compare guards against — host
        parity: null operands compare false."""
        out = np.empty(len(col), np.float32)
        for i, v in enumerate(col):
            v = v.item() if hasattr(v, "item") else v
            out[i] = 0 if v is None else self._encode_str(v)
        return out

    def int_exact_lane(self, comp: str, col) -> np.ndarray:
        """Companion lane for exact INT/LONG capture payloads: the sign-
        biased uint64 value split into hi (22) / mid (21) / lo (21) bit
        fields — each exact in a float32 lane."""
        obj = np.asarray(col)
        if obj.dtype == object:
            v = np.asarray([0 if x is None else int(x) for x in obj],
                           np.int64)
        else:
            v = np.asarray(obj, np.int64)
        u = v.astype(np.uint64) ^ np.uint64(1 << 63)
        part = comp[4:6]                      # "hi" | "md" | "lo"
        if part == "hi":
            out = u >> np.uint64(42)
        elif part == "md":
            out = (u >> np.uint64(21)) & np.uint64(0x1FFFFF)
        else:
            out = u & np.uint64(0x1FFFFF)
        return out.astype(np.float32)

    @staticmethod
    def _int_exact_join(hi, md, lo):
        """Reassemble the exact int64 from the three companion lanes."""
        u = (np.asarray(hi, np.uint64) << np.uint64(42)) | \
            (np.asarray(md, np.uint64) << np.uint64(21)) | \
            np.asarray(lo, np.uint64)
        return (u ^ np.uint64(1 << 63)).astype(np.int64)

    def output_type(self, attr: str) -> AttrType:
        """The user-facing type of a selected attribute (encoded lanes
        decode back to STRING)."""
        if attr in self.encoded_attrs:
            return AttrType.STRING
        return self.attr_types[attr]

    @staticmethod
    def _pick_query(app, query_name) -> Query:
        for el in app.execution_elements:
            if not isinstance(el, Query):
                continue
            if query_name is None or el.name == query_name:
                return el
        raise SiddhiAppCreationError(f"No query '{query_name}' in app")

    def _last_ref_row(self, v) -> Optional[int]:
        """Capture row of a `[last]`-indexed ref to a kleene unit (self or
        cross), else None."""
        if not isinstance(v, Variable) or v.stream_index != -1:
            return None
        s2 = self.ref_to_side.get(v.stream_id or "")
        if s2 is None or s2.row < 0:
            return None
        if self.units[self.row_unit[s2.row]].kind != "count":
            return None
        return s2.row

    def _rewrite_last_refs(self, expr):
        """Null law for `[last]` kleene refs in CONDITIONS: an empty chain
        makes `x is null` true and every comparison false (reference
        compare executors).  Lanes are zero-filled, so the truth rides the
        __n chain-length lane instead: IsNull → __cnt == 0, and each
        Compare touching a [last] ref gains an `__cnt >= 1` guard.
        Returns (expr', rows_used)."""
        from ..query_api.expression import (And, Compare, CompareOp,
                                            Constant, IsNull, MathExpr,
                                            Not, Or)
        used: set = set()

        def scan_rows(e, acc):
            r = self._last_ref_row(e)
            if r is not None:
                acc.add(r)
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                vs = v if isinstance(v, list) else [v]
                for x in vs:
                    if hasattr(x, "__dataclass_fields__"):
                        scan_rows(x, acc)

        def cnt_var(r):
            used.add(r)
            return Variable(attribute=f"__cnt_{r}")

        def rw(e):
            if isinstance(e, IsNull) and e.expr is not None:
                r = self._last_ref_row(e.expr)
                if r is not None:
                    return Compare(cnt_var(r), CompareOp.EQ,
                                   Constant(0, "long"))
            if isinstance(e, Compare):
                rows: set = set()
                scan_rows(e, rows)
                out = Compare(rw(e.left), e.op, rw(e.right))
                for r in sorted(rows):
                    used.add(r)
                    out = And(out, Compare(cnt_var(r), CompareOp.GTE,
                                           Constant(1, "long")))
                return out
            if isinstance(e, And):
                return And(rw(e.left), rw(e.right))
            if isinstance(e, Or):
                return Or(rw(e.left), rw(e.right))
            if isinstance(e, Not):
                return Not(rw(e.expr))
            if isinstance(e, MathExpr):
                return MathExpr(e.op, rw(e.left), rw(e.right))
            return e
        return rw(expr), used

    def _condition_expr(self, side: _Side):
        """The side's filters as one expression (AND, in filter order),
        with the [last]-ref null law applied → (expr, cnt_rows)."""
        expr = side.filters[0]
        for fe in side.filters[1:]:
            expr = And(expr, fe)
        return self._rewrite_last_refs(expr)

    def _var_source(self, side: _Side, v: Variable):
        """Where a condition variable reads: ("event", None) for the
        current event, ("cap", other_side) for another state's captures
        (the scope's resolution rules, see _condition_scope)."""
        sid = v.stream_id
        if sid is None:
            return "event", None
        s2 = self.ref_to_side.get(sid)
        if s2 is None:
            cands = [s for s in self.rows if s.stream_id == sid]
            if len(cands) == 1 and cands[0] is not side:
                s2 = cands[0]
        if s2 is None or (s2 is side and v.stream_index in (None, 0)):
            return "event", None
        return "cap", s2

    def _condition_scope(self, side: _Side, cnt_rows) -> Scope:
        scope = Scope()
        # current event attributes (one value per evaluated slot); encoded
        # string attrs resolve as their LONG code lanes
        for a in side.definition.attributes:
            if a.name not in self.attr_types:
                continue

            def g(ctx, _a=a.name):
                return ctx.columns[_a]
            lane_t = self.attr_types[a.name]
            scope.add(None, a.name, lane_t, g)
            scope.add(side.stream_id, a.name, lane_t, g)
            scope.add(side.ref, a.name, lane_t, g)
        # synthetic string-ORDER lanes (host-computed 0/1, see derived_lane)
        for name in self.derived:
            def gd(ctx, _a=name):
                return ctx.columns[_a]
            scope.add(None, name, AttrType.FLOAT, gd)
        # own-row [last] bank (self e[last] refs) + chain-length lanes
        # (__cnt_r guards from _rewrite_last_refs)
        if side.row >= 0 and \
                self.units[self.row_unit[side.row]].kind == "count":
            for a in side.definition.attributes:
                if a.name not in self.attr_types:
                    continue

                def gsl(ctx, _r=side.ref, _a=a.name):
                    return ctx.qualified[(_r, -1)][_a]
                scope.add(side.ref, a.name, self.attr_types[a.name], gsl,
                          index=-1)
        for r in cnt_rows:
            def gc(ctx, _a=f"__cnt_{r}"):
                return ctx.columns[_a]
            scope.add(None, f"__cnt_{r}", AttrType.LONG, gc)
        # other states' captures: first bank at index 0/None, last bank at
        # index -1 for count rows
        for other in self.rows:
            if other is side:
                continue
            qualifiers = [other.ref]
            if len([s for s in self.rows
                    if s.stream_id == other.stream_id]) == 1 and \
                    other.stream_id != other.ref:
                qualifiers.append(other.stream_id)
            for a in other.definition.attributes:
                if a.name not in self.attr_types:
                    continue    # unresolvable attrs reject at compile

                def gq(ctx, _r=other.ref, _a=a.name):
                    return ctx.qualified[(_r, 0)][_a]

                def gql(ctx, _r=other.ref, _a=a.name):
                    q = ctx.qualified.get((_r, -1))
                    return (q or ctx.qualified[(_r, 0)])[_a]
                lane_t = self.attr_types[a.name]
                for qn in qualifiers:
                    scope.add(qn, a.name, lane_t, gq, index=0)
                    scope.add(qn, a.name, lane_t, gq, index=None)
                    scope.add(qn, a.name, lane_t, gql, index=-1)
        return scope

    def _cond_fn(self, compiled, side: _Side, gate_rows, cnt_rows):
        """The cond-fn protocol of ops/nfa: ``fn(event, captures)`` with
        event columns of shape [N] and captures [N or 1, R, C] → [N]
        bool."""
        cap_lane = self.cap_lane
        rows = self.rows
        gates = tuple(sorted(gate_rows))
        cnts = tuple(sorted(cnt_rows))
        dev = self.device

        def fn(event, captures):
            n = event["__ts"].shape[0]

            def lane(r, ln):
                v = captures[:, r, ln]
                return v if v.shape[0] == n else v.expand(n)
            qualified = {}
            for other in rows:
                cols_f, cols_l = {}, {}
                for (r, a, w), ln in cap_lane.items():
                    if r != other.row:
                        continue
                    if w == "f":
                        cols_f[a] = lane(r, ln)
                    elif w == "l":
                        cols_l[a] = lane(r, ln)
                    # i{k}/m{j} banks are select-side only
                if other is side:
                    # self refs: only the [last] bank is addressable (the
                    # un-indexed name binds to the current event)
                    if cols_l:
                        qualified[(other.ref, -1)] = cols_l
                    continue
                qualified[(other.ref, 0)] = cols_f
                if cols_l:
                    qualified[(other.ref, -1)] = cols_l
            cols_now = {a: event[a] for a in self.attr_names}
            for pn in self.param_names:
                if pn in event:
                    cols_now[pn] = event[pn]
            for r in cnts:
                cols_now[f"__cnt_{r}"] = lane(r, self._n_lane[r])
            ctx = EvalCtx(cols_now, event["__ts"], n, qualified=qualified)
            out = compiled.fn(ctx)
            if not isinstance(out, torch.Tensor):
                out = torch.as_tensor(np.asarray(out), device=dev)
            out = out.to(torch.bool)
            if out.shape != (n,):
                out = out.expand(n)
            for r in gates:
                vlane = self._n_lane[r] if self._n_lane[r] >= 0 \
                    else self._matched_lane[r]
                out = out & (lane(r, vlane) > 0)
            return out
        return fn

    def _compile_condition(self, side: _Side):
        """Compile one side's condition → (fn, capture_free, kernel).

        ``capture_free`` is True when the program provably reads ONLY the
        current event (no cross-state captures, no self-[last] bank, no
        __cnt chain-length lanes, no nullable-row validity gates) — the
        license ops/nfa needs to hoist it block-wide (spec.cond_free).
        ``kernel`` is the condition as the CUDA kernel takes it (gate fn,
        compare tables and program, _kernel_split), or the reason it
        cannot."""
        if not side.filters:
            def true_fn(event, captures, _dev=self.device):
                return torch.ones((event["__ts"].shape[0],),
                                  dtype=torch.bool, device=_dev)
            return true_fn, True, (true_fn, (), (), (), ())
        expr, cnt_rows = self._condition_expr(side)

        # rows this condition references → validity gates for nullable rows
        gate_rows: set = set()

        def note_gate(v: Variable):
            s2 = self.ref_to_side.get(v.stream_id or "")
            if s2 is not None and s2 is not side and \
                    s2.row in self.nullable_rows:
                gate_rows.add(s2.row)
        _scan_vars(expr, note_gate)

        # capture-freeness: any reference resolving to another state's
        # captures, or a self-[last] bank read, pins the condition to the
        # per-slot evaluation (conservative: marking not-free is always
        # semantics-safe)
        free_flag = [not gate_rows and not cnt_rows]

        def note_free(v: Variable):
            if self._var_source(side, v)[0] == "cap":
                free_flag[0] = False
        _scan_vars(expr, note_free)

        scope = self._condition_scope(side, cnt_rows)
        if self._param_map:
            compiler = _ParamExprCompiler(scope, self._xp, self._param_map)
        else:
            compiler = ExprCompiler(scope, self._xp)
        fn = self._cond_fn(compiler.compile(expr), side, gate_rows,
                           cnt_rows)
        if free_flag[0] and not self._reads_params(expr):
            return fn, True, (fn, (), (), (), ())
        raw = side.filters[0]
        for fe in side.filters[1:]:
            raw = And(raw, fe)
        if not gate_rows and all(self._guard_holds(side, r)
                                 for r in cnt_rows) and \
                not any(isinstance(n, IsNull) for n in walk(raw)):
            # every [last] guard holds wherever the condition is read:
            # the kernel takes the condition without them
            return fn, free_flag[0], self._kernel_split(side, raw, compiler)
        # the guards the plain condition adds ride its program: the
        # rewrite's __cnt terms, and each nullable row's validity lane > 0
        valid = tuple((r, self._n_lane[r] if self._n_lane[r] >= 0
                       else self._matched_lane[r]) for r in sorted(gate_rows))
        return fn, free_flag[0], self._kernel_split(side, expr, compiler,
                                                     valid)

    def _guard_holds(self, side: _Side, row: int) -> bool:
        """True when the ``__cnt >= 1`` guard of a ``[last]`` reference
        to capture row ``row`` holds wherever ``side``'s condition is
        read: the row is a kleene count's with min >= 1 before the side's
        unit, so every slot that reads the condition has passed that
        count with at least min elements (its __n lane >= 1)."""
        unit = self.row_unit[row]
        u = self.units[unit]
        return side is not self.rows[row] and u.kind == "count" and \
            u.min_count >= 1 and unit < self.ref_to_unit[side.ref]

    def _param_of(self, e) -> Optional[str]:
        """The parameter lane a filter node compiles to (a numeric,
        non-duration constant of a bank compile), or None."""
        if isinstance(e, Constant) and not isinstance(e, TimeConstant):
            return self._param_map.get(id(e))
        return None

    def _reads_params(self, e) -> bool:
        """True when expression ``e`` reads a parameter lane."""
        return any(self._param_of(n) is not None for n in walk(e))

    def _kernel_split(self, side: _Side, expr, compiler, valid=()):
        """A condition reading captures or pattern constants as the kernel
        takes it, conjunct by conjunct (its AND): those that read only the
        event fold into one gate program (shared by every pattern of a
        bank); ``<event attr> <cmp> <pattern constant>`` goes to the param
        table, ``<event attr> <cmp> <capture attr>`` and ``<capture attr>
        <cmp> <numeric constant>`` (either side first; a capture of
        another unit's first bank, or of an earlier kleene count's
        ``[last]`` bank) to the capture tables; every other conjunct, the
        ``[last]`` rewrite's ``__cnt`` terms and, per ``valid`` (row,
        lane), a nullable row's validity lane ``> 0``, to the condition's
        program (plan/nfa_program.py) → (gate fn, ((attr, row, lane, op),
        ...), ((attr, param, op), ...), ((row, lane, op, constant), ...),
        program) with attr an attribute name, param a parameter lane name,
        constant the float32 value the condition compares in and program
        its lowered instructions (empty: none); or the reason it is
        outside the kernel's class."""
        conj: List[Any] = []

        def flat(e):
            if isinstance(e, And):
                flat(e.left)
                flat(e.right)
            else:
                conj.append(e)
        flat(expr)
        ops = {CompareOp.LT: "<", CompareOp.LTE: "<=", CompareOp.GT: ">",
               CompareOp.GTE: ">=", CompareOp.EQ: "==", CompareOp.NEQ: "!="}
        mirror = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==",
                  "!=": "!="}
        free, cmps, pcmps, ccmps, rest = [], [], [], [], []

        def numeric(e):
            return isinstance(e, Constant) and \
                isinstance(e.value, (int, float)) and \
                not isinstance(e.value, bool) and self._param_of(e) is None

        def source(v: Variable) -> str:
            if v.stream_id is None and v.attribute.startswith("__cnt_"):
                return "cnt"
            return self._var_source(side, v)[0]

        def cap_lane(other, cap):
            """(row, lane) of capture ``cap`` read through ``other``'s
            row, or None outside the kernel's banks."""
            which = "l" if cap.stream_index == -1 else "f"
            lane = self.cap_lane.get((other.row, cap.attribute, which))
            if cap.stream_index not in (None, 0, -1) or lane is None or \
                    other.row < 0 or \
                    (which == "l" and self.units[self.row_unit[other.row]]
                     .kind != "count"):
                return None
            return other.row, lane

        def table(c):
            """The conjunct as a table entry: ("pcmp" | "cmp" | "ccmp",
            entry), or None."""
            if not (isinstance(c, Compare) and c.op in ops):
                return None
            op = ops[c.op]
            if self._param_of(c.left) is not None or \
                    self._param_of(c.right) is not None:
                ev, prm = c.left, self._param_of(c.right)
                if prm is None:
                    ev, prm, op = c.right, self._param_of(c.left), mirror[op]
                if isinstance(ev, Variable) and source(ev) == "event" and \
                        ev.attribute in self.attr_names:
                    return "pcmp", (ev.attribute, prm, CMP_OPS.index(op))
                return None
            if numeric(c.left) or numeric(c.right):
                cap, const = c.left, c.right
                if numeric(c.left):
                    cap, const, op = c.right, c.left, mirror[op]
                if not isinstance(cap, Variable) or source(cap) != "cap":
                    return None
                rl = cap_lane(self._var_source(side, cap)[1], cap)
                if rl is None:
                    return None
                return "ccmp", rl + (CMP_OPS.index(op),
                                     float(np.float32(const.value)))
            if not (isinstance(c.left, Variable) and
                    isinstance(c.right, Variable)):
                return None
            if {source(c.left), source(c.right)} != {"event", "cap"}:
                return None
            ev, cap = c.left, c.right
            if source(c.left) == "cap":
                ev, cap, op = c.right, c.left, mirror[op]
            rl = cap_lane(self._var_source(side, cap)[1], cap)
            if rl is None or ev.attribute not in self.attr_names:
                return None
            return "cmp", (ev.attribute,) + rl + (CMP_OPS.index(op),)
        for c in conj:
            if not self._reads_params(c) and \
                    all(source(v) == "event" for v in variables_of(c)):
                free.append(c)
                continue
            t = table(c)
            if t is None:
                rest.append(c)
            else:
                {"pcmp": pcmps, "cmp": cmps, "ccmp": ccmps}[t[0]].append(
                    t[1])

        def resolve(v: Variable):
            kind = source(v)
            if kind == "cnt":
                r = int(v.attribute[len("__cnt_"):])
                return OP_CAP, (r, self._n_lane[r])
            if kind == "event":
                if v.attribute not in self.attr_names:
                    raise Outside(f"the event lane '{v.attribute}' outside "
                                  f"the kernel's attributes")
                return OP_EV, v.attribute
            rl = cap_lane(self._var_source(side, v)[1], v)
            if rl is None:
                raise Outside("a capture outside the first bank and a "
                              "kleene count's [last] bank")
            return OP_CAP, rl
        try:
            prog = list(lower_program(
                rest, resolve, self._param_of,
                lambda e: compiler.compile(e).fn(None),
                lambda e: compiler.compile(e).type)) if rest else []
        except Outside as e:
            return e.reason
        for r, lane in valid:
            prog += [(OP_CAP, (r, lane)), (OP_K, 0.0),
                     (OP_CMP, CMP_OPS.index(">"))] + \
                ([(OP_AND, 0)] if prog else [])
        if free:
            g = free[0]
            for c in free[1:]:
                g = And(g, c)
            gate = self._cond_fn(compiler.compile(g), side, (), ())
        else:
            def gate(event, captures, _dev=self.device):
                return torch.ones((event["__ts"].shape[0],),
                                  dtype=torch.bool, device=_dev)
        return gate, tuple(cmps), tuple(pcmps), tuple(ccmps), tuple(prog)

    def _kernel_program(self, kern_conds) -> NfaKernelProgram:
        """The spec as the CUDA kernel takes it (ops/nfa
        NfaKernelProgram), with the first feature outside its class as
        ``reason``."""
        spec = self.spec
        reason = kernel_class_reason(spec)
        for kc in kern_conds:
            if reason is None and isinstance(kc, str):
                reason = kc
        kern_attrs: List[str] = []

        def attr_ix(a):
            if a not in kern_attrs:
                kern_attrs.append(a)
            return kern_attrs.index(a)
        R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
        row_src: List[int] = []
        for r in range(R):
            cols = spec.cap_cols[r] if r < len(spec.cap_cols) else ()
            for c in range(C):
                if c >= len(cols):
                    row_src.append(-1)
                elif cols[c] in spec.attr_names:
                    row_src.append(attr_ix(cols[c]))
                else:
                    row_src.append(-2)       # __matched / __n default 1.0
        gate_fns, cmp, pcmp, ccmp, prog, pconst = [], [], [], [], [], []
        for kc in kern_conds:
            if isinstance(kc, str):
                gate_fns.append(None)
                for t in (cmp, pcmp, ccmp, prog, pconst):
                    t.append(())
                continue
            gate_fns.append(kc[0])
            cmp.append(tuple((attr_ix(a), r, ln, op)
                             for (a, r, ln, op) in kc[1]))
            pcmp.append(tuple((attr_ix(a), self.param_names.index(pn), op)
                              for (a, pn, op) in kc[2]))
            ccmp.append(tuple(kc[3]))
            words, consts = encode(kc[4], attr_ix, C,
                                   self.param_names.index)
            prog.append(words)
            pconst.append(consts)
        return NfaKernelProgram(
            gate_fns=tuple(gate_fns), cmp=tuple(cmp),
            kern_attrs=tuple(kern_attrs), row_src=tuple(row_src),
            reason=reason, pcmp=tuple(pcmp),
            param_names=tuple(self.param_names), ccmp=tuple(ccmp),
            prog=tuple(prog), pconst=tuple(pconst))

    def extract_params(self, app_string: str,
                       query_name: Optional[str] = None) -> Dict[str, float]:
        """Constant values of a structurally-identical app, keyed by the
        param lanes of this (parameterized) compile."""
        app = SiddhiCompiler.parse(app_string)
        query = self._pick_query(app, query_name)
        low = _Lowering(query.input_stream, app)
        if len(low.units) != len(self.units):
            raise SiddhiAppCreationError(
                "pattern bank: app has a different chain length")
        consts = _walk_filter_constants(low.units)
        if len(consts) != len(self.param_names):
            raise SiddhiAppCreationError(
                "pattern bank: app has a different constant count")
        return {name: float(c.value)
                for name, c in zip(self.param_names, consts)}

    # ------------------------------------------------------------ execution

    def _place_carry(self, carry: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Carry leaves (numpy arrays, e.g. a JAX package snapshot, or
        tensors) → tensors on the engine's device with the carry dtypes.
        When profiling is on, the placed carry's total bytes feed the
        KernelProfiler ``live_bytes`` gauge."""
        placed = {}
        for k, v in carry.items():
            if not isinstance(v, torch.Tensor):
                v = np.ascontiguousarray(v)
                v = torch.from_numpy(v if v.flags.writeable else v.copy())
            placed[k] = v.to(self.device, carry_dtype(k)).contiguous()
        from ..core.profiling import profiler
        prof = profiler()
        if prof.enabled:
            prof.set_live_bytes(
                "nfa.step", sum(int(v.numel() * v.element_size())
                                for v in placed.values()))
        return placed

    # ------------------------------------------------ partition shard-out

    def pin_to_device(self, device) -> None:
        """Pin this engine to one shard's device (parallel/shards.py): the
        carry moves there, and steps, growth and replay follow it."""
        self.device = torch.device(device)
        self.carry = self._place_carry(self.carry)

    def clone_for_shard(self, device) -> "CompiledPatternNFA":
        """A fresh-state shard clone on ``device``.  Shares the compiled
        artifacts (spec, step, condition programs) and — by design — the
        string dictionary (str_encoder/str_decoder mutate in place, so
        encoded values stay comparable across shards and one decode table
        serves the whole set).  Owns its carry, base_ts and growth axes:
        a clone growing slots rebuilds only its own step."""
        import copy
        cl = copy.copy(self)
        cl.device = torch.device(device)
        cl.carry = cl._place_carry(make_carry(cl.spec, cl.n_partitions,
                                              cl.device))
        cl.base_ts = None
        # never packed (plan/xtenant.py) and never fused into the app
        # slab: each shard reads its own egress
        cl.egress_fuser = None
        cl._tenant_bucket = None
        return cl

    @property
    def replayable(self) -> bool:
        """True: the step never modifies its input carry, so an
        overflowing chunk can replay from the pre-chunk carry (and a
        packed tenant can rewind alone, plan/xtenant.py)."""
        return True

    # ------------------------------------------------ cross-tenant packing

    def _xt_sync(self) -> None:
        """A packed tenant's pending block (plan/xtenant.py) steps before
        any out-of-band access to its carry."""
        bucket = getattr(self, "_tenant_bucket", None)
        if bucket is not None:
            bucket.sync(self)

    def _xt_rebucket(self) -> None:
        """Shape change (K/P growth, snapshot restore): a packed tenant
        re-keys into the bucket matching its new shape class — its old
        gang signatures are stale (plan/xtenant.py)."""
        bucket = getattr(self, "_tenant_bucket", None)
        if bucket is not None:
            bucket.packer.rebucket(self)

    def _build_step(self, trigger: str = "build"):
        from ..core.profiling import wrap_kernel
        from .shapes import nfa_shape_dims, shape_registry
        spec, kprog, B = self.spec, self.kprog, self.batch_b

        def step(carry, block, cap, seg):
            return nfa_step_egress(spec, carry, block, kprog, cap, seg, B)
        batch_of = (lambda carry, block, *_:
                    int(block["__ts"].numel()) if "__ts" in block else 0)
        ticks_of = (lambda carry, block, *_:
                    (-(-int(block["__ts"].shape[-1]) // max(B, 1)), B)
                    if "__ts" in block else (0, B))
        rj = shape_registry().jit(
            "nfa.step",
            nfa_shape_dims(spec, self.n_partitions, B,
                           device=self.device.type),
            step, trigger=trigger)
        return wrap_kernel("nfa.step", rj, batch_of=batch_of,
                           ticks_of=ticks_of)

    def grow(self, n_partitions: int) -> None:
        """Widen the partition axis (slab growth for keyed partitioning);
        existing lane state is preserved, new lanes start empty."""
        if n_partitions <= self.n_partitions:
            return
        if self._parameterize:
            raise SiddhiAppCreationError(
                "a parameterized compile holds no carry to grow: a "
                "CompiledPatternBank's partition count is fixed")
        self._xt_sync()
        fresh = make_carry(self.spec, n_partitions - self.n_partitions,
                           self.device)
        self.carry = self._place_carry(
            {k: torch.cat([self.carry[k], fresh[k]], dim=0)
             for k in self.carry})
        self.n_partitions = n_partitions
        self._step = self._build_step(trigger="grow")
        self._xt_rebucket()

    def grow_slots(self, n_slots: int) -> None:
        """Widen the K (concurrent-partials) axis: the host oracle's pending
        lists are unbounded, so the slot ring must grow rather than drop
        when a pattern has no `within` bound."""
        if n_slots <= self.spec.n_slots:
            return
        self._xt_sync()
        R, C = max(self.spec.n_rows, 1), max(self.spec.n_caps, 1)
        self.carry = self._place_carry(_widen_slots(
            self.carry, 1, n_slots - self.spec.n_slots, R, C))
        self.spec = self.spec._replace(n_slots=n_slots)
        if not self._parameterize:
            self._step = self._build_step(trigger="grow")
            self._xt_rebucket()

    def max_active_slots(self) -> int:
        """Device reduction: the fullest partition's live-partial count."""
        return int((self.carry["slot_state"] >= 0).sum(dim=1).max())

    def min_pending_deadline(self) -> Optional[int]:
        """Earliest absent-state deadline over all live slots (absolute
        ms), or None — drives host TIMER scheduling."""
        if not self.has_absent:
            return None
        S = len(self.spec.units)
        absent = torch.tensor([u.kind == "absent" for u in self.spec.units] +
                              [False], dtype=torch.bool, device=self.device)
        st = self.carry["slot_state"]
        waiting = absent[st.clamp(0, S).long()] & (st >= 0)
        if not bool(waiting.any()):
            return None
        dl = torch.where(waiting, self.carry["deadline"], 2 ** 31 - 1)
        return int(dl.min()) + (self.base_ts or 0)

    def schema_dims(self) -> Dict[str, Any]:
        return {"S": len(self.spec.units), "K": int(self.spec.n_slots),
                "P": int(self.n_partitions),
                "R": int(self.spec.n_rows), "C": int(self.spec.n_caps)}

    def current_state(self) -> Dict[str, Any]:
        """The JAX package's state dict: numpy carry leaves, the time
        base, the lane count and the string dictionary."""
        self._xt_sync()         # a snapshot must see the pending block
        return {"carry": {k: v.detach().cpu().numpy().copy()
                          for k, v in self.carry.items()},
                "base_ts": self.base_ts,
                "n_partitions": self.n_partitions,
                # captured codes are only meaningful with their dictionary
                "str_decoder": list(self.str_decoder)}

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Accepts this engine's own ``current_state()`` or the JAX
        package's ``CompiledPatternNFA.current_state()`` unchanged."""
        self._xt_sync()
        self.n_partitions = int(state["n_partitions"])
        self.carry = self._place_carry(state["carry"])
        self.base_ts = state["base_ts"]
        dec = state.get("str_decoder")
        if dec is not None and self.encoded_attrs:
            # the carry is replaced wholesale by the snapshot's, so its
            # codes are only meaningful with the snapshot's dictionary —
            # adopt it unconditionally (same app ⇒ plan-time constants
            # occupy the same prefix)
            self.str_decoder = list(dec)
            self.str_encoder = {v: i + 1 for i, v in enumerate(dec)}
        k = int(self.carry["slot_state"].shape[1])
        if k != self.spec.n_slots:    # snapshot taken after slot growth
            self.spec = self.spec._replace(n_slots=k)
        self._step = self._build_step(trigger="restart")
        self._xt_rebucket()

    def to_device(self, block) -> Dict[str, torch.Tensor]:
        """Host [P, T] numpy lanes → tensors on the engine's device (attr
        lanes float32, __ts/__stream int32, __valid bool).  On CUDA each
        lane is a ``non_blocking`` copy from pageable memory: CUDA stages
        it at once and does not wait for earlier kernels."""
        out = {}
        for k, v in block.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            dt = torch.bool if k == "__valid" else (
                torch.int32 if k in ("__ts", "__stream") else torch.float32)
            out[k] = v.to(self.device, dt, non_blocking=True)
        return out

    def process_block(self, block, carry=None, seg=None):
        """Run one [P, T] packed block (numpy or tensors) from ``carry``
        (default: the engine's, which the new carry replaces) through the
        step and the match compaction — fused on CUDA, the plain
        composition on the CPU.  Returns the block's NfaEgress on the
        engine's device; nothing is read back."""
        own = carry is None
        if own:
            # a packed tenant stepped out-of-band (timer rows, replay):
            # its deferred block lands first
            self._xt_sync()
        new, eg = self._step(self.carry if own else carry,
                             self.to_device(block), self._egress_cap,
                             self._egress_seg if seg is None else seg)
        if own:
            self.carry = new
        return eg

    def _dispatch(self, block) -> dict:
        """process_block + egress_dispatch: one block's step, compaction
        and the start of its read, with what a re-run needs."""
        pre = self.carry
        return self.egress_dispatch(self.process_block(block), pre, block)

    def egress_dispatch(self, eg, pre_carry, block) -> dict:
        """Phase 1 of the compacted egress: start the device→host copy of
        one block's egress buffer WITHOUT blocking.  Returns an opaque
        handle for egress_retire, holding the compaction's re-run
        (``repack``) and the step's inputs (``step_carry``, ``block``)
        for the overflow paths; no dense outputs.  Splitting dispatch from
        retire lets the engine pipeline chunks (≙ the reference's @Async
        disruptor junction, stream/StreamJunction.java:280-316)."""
        from .pipeline import HostCopy
        telem = self.carry.get("telem") if self.spec.telemetry else None
        bufs = [eg.buf] if telem is None else [eg.buf, telem]
        fuser = getattr(self, "egress_fuser", None)
        token, copy = None, None
        if fuser is not None:
            # per-app fused egress (plan/pipeline.EgressFuser): the buffer
            # rides the app's per-ingest-block slab — ONE D2H per block
            token = fuser.register(self, bufs)
        else:
            copy = HostCopy(bufs)
        return {"fuse": token, "copy": copy, "cap": self._egress_cap,
                "seg": eg.seg, "repack": eg.repack, "step_carry": pre_carry,
                "block": block, "dl_base": self.base_ts,
                "tk": (int(block["__ts"].shape[1]), self.spec.n_slots)}

    def egress_retire(self, handle):
        """Phase 2: wait for the transfer and resolve, before any row is
        decoded, what the device reported in the buffer: a full scratch
        segment (status row: rows were lost) re-runs the step from the
        handle's carry and block with segments that fit, its new carry
        discarded; a count above cap re-runs the compaction alone at a
        doubled cap.  Results exact.  Side effect: sets
        self.last_dropped_total (drives grow-and-replay without an extra
        sync)."""
        from .pipeline import HostCopy
        token = handle.get("fuse")
        if token is not None:
            # the slab read is accounted by the fuser under "egress.fuse"
            fetched = token.fetch()
        else:
            from ..core.ledger import ledger
            from ..core.profiling import profiler
            with ledger().span("egress_d2h"):
                fetched = handle["copy"].wait()
            profiler().record_d2h("nfa.egress_pack", fetched[0].nbytes)
        buf = fetched[0]
        if len(fetched) > 1:
            self.last_telemetry = fetched[1]
        if int(buf[-1, 0]) > handle["seg"]:
            seg = 1 << (int(buf[-1, 0]) - 1).bit_length()
            self._egress_seg = max(self._egress_seg or 0, seg)
            eg = self.process_block(handle["block"],
                                    carry=handle["step_carry"], seg=seg)
            handle.update(repack=eg.repack, seg=eg.seg,
                          cap=self._egress_cap)
            buf = HostCopy([eg.buf]).wait()[0]
        count = int(buf[-2, 0])
        while count > handle["cap"]:
            cap = handle["cap"]
            while cap < count:
                cap *= 2
            handle["cap"] = cap
            self._egress_cap = max(self._egress_cap, cap)
            buf = HostCopy([handle["repack"](cap)]).wait()[0]
        self.last_dropped_total = int(buf[-2, 1])
        if self.has_absent:
            dmin = int(buf[-2, 2])
            self.last_min_deadline = (
                None if dmin == 2 ** 31 - 1
                else dmin + (handle["dl_base"] or 0))
        return buf[:count], handle["tk"]

    def _decode_compact(self, rows: np.ndarray, tk) -> list:
        """Compacted egress rows → match list [(partition, ts, {name:
        value})] in emission order — scalar view over the columnar decode
        (decode_compact_columns) so the two cannot diverge."""
        pids, ts, cols = self.decode_compact_columns(rows, tk)
        names = list(cols)
        col_lists = [cols[n].tolist() for n in names]
        return [(int(p), int(t), dict(zip(names, vals)))
                for p, t, *vals in zip(pids.tolist(), ts.tolist(),
                                       *col_lists)]

    def _decode_caps_row(self, caps_row: np.ndarray) -> dict:
        """One [R, C] capture row → select-output values (shared by the
        dense and compacted decoders)."""
        vals = {}
        for name, row, attr, which in self.select_outputs:
            if row in self.nullable_rows:
                vlane = self._n_lane[row] if self._n_lane[row] >= 0 \
                    else self._matched_lane[row]
                if caps_row[row, vlane] <= 0:
                    vals[name] = None
                    continue
            if which[0] in "im" and self._n_lane[row] >= 0 and \
                    caps_row[row, self._n_lane[row]] < int(which[1:]) + 1:
                vals[name] = None
                continue
            lane = self.cap_lane[(row, attr, which)]
            v = float(caps_row[row, lane])
            at = self.attr_types.get(attr)
            if at in (AttrType.INT, AttrType.LONG):
                hik = (row, f"__exhi_{attr}", which)
                if hik in self.cap_lane:
                    v = int(self._int_exact_join(
                        *[round(float(caps_row[row, self.cap_lane[
                            (row, f"__ex{p}_{attr}", which)]]))
                          for p in ("hi", "md", "lo")]))
                else:
                    v = int(round(v))
            if attr in self.encoded_attrs:
                v = self.str_decoder[v - 1] if v >= 1 else None
            vals[name] = v
        return vals

    def decode_compact_columns(self, rows: np.ndarray, tk,
                               base_ts: Optional[int] = None):
        """Vectorized compacted-egress decode → (pids, ts, {name: column})
        in the oracle emission order (completion ts, then final-unit entry
        order, then arm sequence) — same contract as _decode_compact but
        columnar: no per-match Python loop, so the engine's egress decode
        scales with numpy throughput instead of interpreter speed.
        base_ts pins the timestamp origin the block was packed against
        (pipelined retires can happen after a later chunk rebased)."""
        from ..core.event import dtype_for
        T, K = tk
        R, C = max(self.spec.n_rows, 1), max(self.spec.n_caps, 1)
        n = len(rows)
        if base_ts is None:
            base_ts = self.base_ts
        pids = rows[:, 0].astype(np.int64) // (T * K)
        ts = rows[:, 1].astype(np.int64) + (base_ts or 0)
        if n:
            order = np.lexsort((rows[:, 3], rows[:, 2], ts))
            pids, ts = pids[order], ts[order]
            caps_f = rows[:, 4:].view(np.float32).reshape(-1, R, C)[order]
        else:
            caps_f = np.zeros((0, R, C), np.float32)
        cols: Dict[str, np.ndarray] = {}
        for name, row, attr, which in self.select_outputs:
            lane = self.cap_lane[(row, attr, which)]
            v = caps_f[:, row, lane]
            at = self.attr_types.get(attr)
            null_mask = None
            if row in self.nullable_rows:
                vlane = self._n_lane[row] if self._n_lane[row] >= 0 \
                    else self._matched_lane[row]
                null_mask = caps_f[:, row, vlane] <= 0
            if which[0] in "im" and self._n_lane[row] >= 0:
                # e[k] valid iff the chain reached k+1 elements;
                # e[last-j] valid iff it reached j+1
                need = int(which[1:]) + 1
                short = caps_f[:, row, self._n_lane[row]] < need
                null_mask = short if null_mask is None \
                    else (null_mask | short)
            if attr in self.encoded_attrs:
                codes = np.rint(v).astype(np.int64)
                out = np.full(n, None, object)
                valid = codes >= 1
                if null_mask is not None:
                    valid &= ~null_mask
                if valid.any():
                    dec = np.asarray(self.str_decoder, object)
                    out[valid] = dec[codes[valid] - 1]
                cols[name] = out
                continue
            if at in (AttrType.INT, AttrType.LONG):
                hik = (row, f"__exhi_{attr}", which)
                if hik in self.cap_lane:
                    # exact payload: reassemble from companion lanes
                    # (loop state frozen via defaults — B023)
                    g = lambda p, _r=row, _a=attr, _w=which: np.rint(
                        caps_f[:, _r,
                               self.cap_lane[(_r, f"__ex{p}_{_a}", _w)]])
                    v = self._int_exact_join(g("hi"), g("md"), g("lo"))
                else:
                    v = np.rint(v).astype(np.int64)
            col = v.astype(dtype_for(self.output_type(attr)))
            if null_mask is not None:
                out = col.astype(object)
                out[null_mask] = None
                col = out
            cols[name] = col
        return pids, ts, cols

    def arm_leading(self, now_ms: int) -> None:
        """Arm the initial leading-absent partial at engine start
        (reference AbsentStreamPreStateProcessor.start + init): one slot
        per lane at unit 0 with deadline = start + waiting.  Host-side
        carry mutation (startup only)."""
        if not self.spec.lead_absent:
            return
        if self.base_ts is None:
            self.base_ts = now_ms
        c = {k: v.detach().cpu().numpy().copy()
             for k, v in self.carry.items()}
        off = now_ms - self.base_ts
        empty = c["slot_state"][:, 0] < 0
        c["slot_state"][:, 0] = np.where(empty, 0, c["slot_state"][:, 0])
        c["deadline"][:, 0] = np.where(
            empty, off + self.spec.units[0].waiting_ms,
            c["deadline"][:, 0])
        c["slot_start"][:, 0] = np.where(empty, off, c["slot_start"][:, 0])
        c["slot_enter"][:, 0] = np.where(empty, off, c["slot_enter"][:, 0])
        c["slot_seq"][:, 0] = np.where(empty, c["arm_seq"],
                                       c["slot_seq"][:, 0])
        c["arm_seq"] = c["arm_seq"] + empty.astype(np.int32)
        self.carry = self._place_carry(c)

    def process_timer(self, now_ms: int):
        """Inject one virtual TIMER row at absolute time now_ms (absent
        deadlines + within expiry between real events)."""
        if self.statically_dead:
            self.last_dropped_total = 0
            if self.has_absent:
                self.last_min_deadline = None
            return []
        self._xt_sync()
        if self.base_ts is None:
            self.base_ts = now_ms
        self._maybe_rebase(now_ms, now_ms)
        block = make_timer_block(self.n_partitions, now_ms - self.base_ts,
                                 self.attr_names)
        return self._decode_compact(*self.egress_retire(
            self._dispatch(block)))

    def dispatch_events(self, partition_ids: np.ndarray,
                        columns: Dict[str, np.ndarray],
                        timestamps: np.ndarray,
                        stream_names: Optional[np.ndarray] = None,
                        stream_codes: Optional[np.ndarray] = None) -> dict:
        """Pack + dispatch one flat event batch and start its egress D2H
        transfer without blocking; returns a handle for retire_events.
        The pipelined engine path (plan/planner.py) keeps a few handles in
        flight so the device read of chunk N overlaps chunk
        N+1's dispatch; the handle carries everything needed to replay the
        block after a slot-ring growth (grow-and-replay)."""
        if self.statically_dead:
            # liveness pruning proved accept unreachable: zero matches on
            # any input, so the kernel dispatch is skipped outright (the
            # chunk is neither packed nor shipped)
            if self.base_ts is None:
                self.base_ts = int(timestamps[0]) if len(timestamps) else 0
            return {"dead": True, "pre_carry": self.carry,
                    "pre_base": self.base_ts, "base_ts": self.base_ts,
                    "ts_range": None, "block": None}
        bucket = getattr(self, "_tenant_bucket", None)
        if bucket is not None:
            # a still-pending earlier block of THIS tenant must step
            # before the rebase below mutates the carry it will read
            # (and before two blocks of one tenant could coexist)
            bucket.sync(self)
        if self.base_ts is None:
            self.base_ts = int(timestamps[0]) if len(timestamps) else 0
        ts_range = None
        if len(timestamps):
            ts_range = (int(np.min(timestamps)), int(np.max(timestamps)))
            self._maybe_rebase(*ts_range)
        if stream_codes is not None:
            codes = np.asarray(stream_codes, np.int32)
        elif stream_names is None:
            codes = np.zeros(len(partition_ids), np.int32)
        else:
            codes = np.asarray([self.stream_codes[s] for s in stream_names],
                               np.int32)
        cols = {}
        for a in self.attr_names:
            if a in self.derived and a not in columns:
                c = self.derived_lane(a, columns[self.derived[a][0]])
            elif a in self.int_exact_src and a not in columns:
                c = self.int_exact_lane(a, columns[self.int_exact_src[a]])
            else:
                c = columns[a]
                if a in self.encoded_attrs:
                    c = self.encode_column(c)
            cols[a] = np.asarray(c)
        block = pack_blocks(np.asarray(partition_ids), cols,
                            np.asarray(timestamps), codes,
                            self.n_partitions, base_ts=self.base_ts)
        if bucket is not None:
            # cross-tenant gang (plan/xtenant.py): the block waits in the
            # tenant's bucket and steps with every co-tenant's pending
            # block in one launch; any read of the handle flushes it
            return bucket.submit(self, block, ts_range)
        pre_carry, pre_base = self.carry, self.base_ts
        h = self._dispatch(block)
        h.update(ts_range=ts_range, pre_carry=pre_carry,
                 pre_base=pre_base, base_ts=self.base_ts)
        return h

    def replay_block(self, h: dict) -> dict:
        """Re-dispatch a handle's block against the current carry (after a
        grow_slots); re-applies the rebase its original dispatch did."""
        if h.get("dead"):
            return h
        if h["ts_range"] is not None:
            self._maybe_rebase(*h["ts_range"])
        nh = self._dispatch(h["block"])
        nh.update(ts_range=h["ts_range"],
                  pre_carry=None, pre_base=None, base_ts=self.base_ts)
        return nh

    def retire_events(self, h: dict):
        """Block on a dispatched handle → (pids, ts, columns) in emission
        order (columnar decode).  Sets self.last_dropped_total."""
        if "xpend" in h:
            h["xpend"].resolve(h)
        if h.get("dead"):
            self.last_dropped_total = 0
            if self.has_absent:
                self.last_min_deadline = None
            R = max(self.spec.n_rows, 1)
            C = max(self.spec.n_caps, 1)
            return self.decode_compact_columns(
                np.zeros((0, 4 + R * C), np.int32),
                (1, self.spec.n_slots), base_ts=h["base_ts"])
        rows, tk = self.egress_retire(h)
        return self.decode_compact_columns(rows, tk,
                                           base_ts=h["base_ts"])

    def process_events(self, partition_ids: np.ndarray,
                       columns: Dict[str, np.ndarray],
                       timestamps: np.ndarray,
                       stream_names: Optional[np.ndarray] = None,
                       stream_codes: Optional[np.ndarray] = None):
        """Flat event batch → packed lanes → device step → decoded matches.

        Returns a list of (partition, match_ts, {out_name: value})."""
        h = self.dispatch_events(partition_ids, columns, timestamps,
                                 stream_names=stream_names,
                                 stream_codes=stream_codes)
        if "xpend" in h:
            h["xpend"].resolve(h)
        if h.get("dead"):
            self.last_dropped_total = 0
            return []
        return self._decode_compact(*self.egress_retire(h))

    def _ts_safe_max(self) -> int:
        # keep ts - slot_start inside int32 even for a slot clamped to
        # -(within+1) (shared headroom policy: ops/ts32.py)
        from ..ops.ts32 import safe_max
        return safe_max(self.spec.within_ms or 0)

    def _maybe_rebase(self, ts_min: int, ts_max: int) -> None:
        """Timestamps ride int32 ms offsets from base_ts, which overflows
        after ~24.8 days of stream time.  Rebase the origin onto this batch
        and shift the carried start/deadline timestamps to match."""
        safe = self._ts_safe_max()
        if ts_max - self.base_ts <= safe:
            return
        if ts_max - ts_min > safe:
            raise ValueError(
                "device NFA path: one batch spans more than ~24 days of "
                "stream time; int32 timestamp offsets cannot represent it")
        delta = ts_min - self.base_ts
        carry = dict(self.carry)
        # inactive slots hold stale values but are gated on slot_state>=0,
        # so a uniform shift is safe; clamp in int64 so an arbitrarily
        # large delta can't wrap int32 — anything older than `within` is
        # expired regardless of how old, and -(within+1) reads as expired
        # at every ts >= 0 without the expiry subtraction ever leaving
        # int32 range (see _ts_safe_max)
        from ..ops.ts32 import shift_clamped
        lo = -(self.spec.within_ms + 1) \
            if self.spec.within_ms is not None else 0
        carry["slot_start"] = shift_clamped(carry["slot_start"], delta, lo)
        carry["slot_enter"] = shift_clamped(carry["slot_enter"], delta, lo)
        if "deadline" in carry:
            # a deadline already due stays due at any clamp ≥ lo
            carry["deadline"] = shift_clamped(carry["deadline"], delta, lo)
        self.carry = carry
        self.base_ts += delta

    def decode_matches(self, mask, caps, ts, enter=None, seq=None):
        """Dense-buffer decode (host-side arrays) — the engine path uses
        the compacted form (egress_retire/_decode_compact); this remains
        for direct users stepping nfa_block_step_plain's outputs."""
        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
        mask = host(mask)                # [P, T, K]
        caps = host(caps)                # [P, T, K, R, C]
        ts = host(ts)
        enter = host(enter) if enter is not None else np.zeros_like(ts)
        seq = host(seq) if seq is not None else np.zeros_like(ts)
        out = []
        order = []
        ps, tts, ks = np.nonzero(mask)
        for p, t, k in zip(ps, tts, ks):
            vals = self._decode_caps_row(caps[p, t, k])
            out.append((int(p), int(ts[p, t, k]) + (self.base_ts or 0),
                        vals))
            order.append((int(enter[p, t, k]), int(seq[p, t, k])))
        # oracle order: completion time, then the last unit's pending-list
        # insertion order (when each partial entered the final unit, ties
        # broken by arm sequence)
        out = [m for _o, m in sorted(
            zip(order, out), key=lambda x: (x[1][1], x[0][0], x[0][1]))]
        return out


class _ParamExprCompiler(ExprCompiler):
    """Expression compiler that lowers marked Constant nodes to per-pattern
    parameter lanes read from the event dict (pattern-bank mode)."""

    def __init__(self, scope: Scope, xp, param_map: Dict[int, str]):
        super().__init__(scope, xp)
        self._param_map = param_map

    def _compile_constant(self, c):
        name = self._param_map.get(id(c))
        if name is None:
            return super()._compile_constant(c)

        def fn(ctx, _n=name):
            return ctx.columns[_n]
        return CompiledExpr(fn, AttrType.DOUBLE)


class CompiledPatternBank:
    """N structurally-identical pattern queries (constants differ) stepped
    together: carry [N, P, ...], one shared event block per step, match
    counts per pattern (BASELINE config: 1k NFAs × 10k partitions).

    On CUDA a block is two kernels per dispatch (the bank step, then the
    match ring of csrc/nfa_step.cu; ops/nfa.nfa_bank_step), for every
    spec of the single-pattern step's class (ops/nfa.bank_class_reason).
    The bank step runs its widened instance (csrc/nfa_wide.cu, a group of
    threads per (pattern, lane) on the widened unit loop) for the
    programs of ops/nfa.kernel_wide: logical units, SEQUENCE, the `every`
    forms beyond a leading one, leading min-0 counts and absent units,
    telemetry, a capture compare or program in the first condition.  Any
    other spec runs its thread instance (one thread per (pattern, lane))
    with K <= 16 and at most 8 constant compares whose layout fits
    shared memory, its simple, kleene count and absent units and its
    condition programs alike (ops/nfa.bank_geometry), else its group
    instance (a group of threads per lane).  A spec outside the class
    (transcendentals, INT/LONG arithmetic, the program limits, more than
    31 conditions or 4 mid-chain `every` groups) raises
    ``SiddhiAppCreationError`` when the bank is built, before any device
    memory is touched (the bank has no host engine to fall back to).  On
    the CPU the plain bank step runs every spec the JAX package's bank
    compiles."""

    def __init__(self, apps: Sequence[str], n_partitions: int,
                 n_slots: int = 8, pattern_chunk: Optional[int] = None,
                 ring: int = 0, batch_b: Optional[int] = None,
                 stack: Optional[bool] = None, replayable: bool = False,
                 telemetry: bool = False, device=None):
        """stack: run all homogeneous pattern chunks as ONE dispatch over
        a stacked [C, N, ...] carry instead of C sequential dispatches.
        Default resolves SIDDHI_TPU_NFA_STACK (on; =0 restores the
        chunk loop).  Chunks are homogeneous by construction (same
        NfaSpec geometry, constants live in parameter lanes).

        replayable: keep the pre-block carry (the step writes a new
        carry) so process_block_replayed can rewind, grow the slot ring
        and replay a whole block after an overflow, at dispatch
        granularity.  Default False: the CUDA step updates the carry in
        place and overflowing partials count into ``dropped``.

        device: the torch device of the carries and the step (default
        "cuda", see ops/windowed_agg.kernel_device)."""
        self.nfa = CompiledPatternNFA(apps[0], n_partitions=n_partitions,
                                      n_slots=n_slots, parameterize=True,
                                      mesh=None, batch_b=batch_b,
                                      telemetry=telemetry, device=device)
        self.device = self.nfa.device
        self.n_patterns = len(apps)
        self.n_partitions = n_partitions
        # top-k over the per-partition counts caps the ring at P
        self.ring = min(ring, n_partitions)
        lanes: Dict[str, List[float]] = {n: [] for n in
                                         self.nfa.param_names}
        for a in apps:
            for k, v in self.nfa.extract_params(a).items():
                lanes[k].append(v)
        if pattern_chunk is None:
            pattern_chunk = self._default_chunk(n_partitions, n_slots)
        self.chunk = min(pattern_chunk, self.n_patterns)
        if self.n_patterns % self.chunk:
            raise SiddhiAppCreationError(
                f"n_patterns ({self.n_patterns}) must be a multiple of "
                f"pattern_chunk ({self.chunk})")
        self.n_chunks = self.n_patterns // self.chunk
        self.params = []
        for ci in range(self.n_chunks):
            sl = slice(ci * self.chunk, (ci + 1) * self.chunk)
            self.params.append({k: torch.tensor(v[sl], dtype=torch.float32,
                                                device=self.device)
                                for k, v in lanes.items()})
        # stacking only changes shapes with more than one chunk
        self.stacked = resolve_stack(stack) and self.n_chunks > 1
        self.replayable = bool(replayable)
        spec = self.nfa.spec
        if self.stacked:
            # ONE [C, N, ...] tensor per leaf, element-identical to the C
            # separate chunk carries
            flat = make_bank_carry(spec, self.n_patterns, n_partitions,
                                   self.device)
            self._stack_carry = {
                k: v.reshape((self.n_chunks, self.chunk) + tuple(v.shape[1:]))
                for k, v in flat.items()}
            self._stack_params = {
                k: torch.stack([p[k] for p in self.params])
                for k in self.params[0]}
            self._carries = None
        else:
            self._stack_carry = self._stack_params = None
            self._carries = [make_bank_carry(spec, self.chunk, n_partitions,
                                             self.device)
                             for _ in range(self.n_chunks)]
        self.nfa._stacked = self.stacked
        self.nfa._dispatches_per_block = 1 if self.stacked else self.n_chunks
        self._set_live_bytes()
        self._build_step()
        self.base_ts: Optional[int] = None

    @property
    def carries(self):
        """Per-chunk carry dicts ([N, P, ...] leaves).  Stacked banks
        serve views into the [C, N, ...] carry; mutate through
        process_block / grow_slots, not through these."""
        if self.stacked:
            return [{k: v[ci] for k, v in self._stack_carry.items()}
                    for ci in range(self.n_chunks)]
        return self._carries

    def _set_live_bytes(self):
        from ..core.profiling import profiler
        if not profiler().enabled:
            return
        leaves = (self._stack_carry.values() if self.stacked else
                  [v for c in self._carries for v in c.values()])
        profiler().set_live_bytes(
            "nfa.bank_step", sum(int(v.numel() * v.element_size())
                                 for v in leaves))

    def _build_step(self):
        from ..core.profiling import wrap_kernel
        from .shapes import nfa_shape_dims, shape_registry
        spec, kprog, ring = self.nfa.spec, self.nfa.kprog, self.ring
        B = max(self.nfa.batch_b, 1)
        # a replayable bank rewinds to the pre-block carry after a slot
        # overflow, so its step must leave the input carry alone
        inplace = not self.replayable

        def step(carry, block, params):
            return nfa_bank_step(spec, carry, block, params, ring, kprog,
                                 self.nfa.batch_b, inplace)
        dims = nfa_shape_dims(spec, self.nfa.n_partitions,
                              self.nfa.batch_b, ring=self.ring,
                              chunks=self.n_chunks, stacked=self.stacked)
        self._step = wrap_kernel(
            "nfa.bank_step",
            shape_registry().jit("nfa.bank_step", dims, step),
            batch_of=lambda carry, block, params:
                int(block["__ts"].numel()) if "__ts" in block else 0,
            ticks_of=lambda carry, block, params:
                (-(-int(block["__ts"].shape[-1]) // B), B)
                if "__ts" in block else (0, B))

    def _default_chunk(self, n_partitions: int, n_slots: int) -> int:
        from ..analysis.cost_model import default_pattern_chunk
        spec = self.nfa.spec
        return default_pattern_chunk(
            self.n_patterns, n_partitions, n_slots, spec.n_rows,
            spec.n_caps, batch_b=max(self.nfa.batch_b, 1),
            ring=bool(self.ring))

    def process_block(self, block):
        """ring == 0 → per-pattern match counts for this block ([N] int32).

        ring > 0 → (counts [N], ring_cnt [N, ring], ring_pid [N, ring],
        ring_caps [N, ring, R, C], ring_ts [N, ring], ring_ok [N, ring]) —
        the bounded match payload buffer (see ops/nfa.bank_ring_plain),
        as tensors on the bank's device; nothing is read back.

        Stacked banks pay ONE dispatch here; the sequential path one per
        chunk."""
        block = self.nfa.to_device(block)
        if self.stacked:
            self._stack_carry, res = self._step(self._stack_carry, block,
                                                self._stack_params)
            return res
        outs = []
        for ci in range(self.n_chunks):
            self._carries[ci], res = self._step(self._carries[ci], block,
                                                self.params[ci])
            outs.append(res)
        if not self.ring:
            return torch.cat(outs)
        return tuple(torch.cat([o[i] for o in outs]) for i in range(6))

    def total_dropped(self) -> int:
        """Cumulative slot-ring evictions over all patterns (syncs)."""
        if self.stacked:
            return int(self._stack_carry["dropped"].sum())
        return sum(int(c["dropped"].sum()) for c in self._carries)

    def grow_slots(self, n_slots: int) -> None:
        """Widen the K (concurrent-partials) axis of every chunk carry
        and rebuild the step — the bank analogue of
        CompiledPatternNFA.grow_slots."""
        if n_slots <= self.nfa.spec.n_slots:
            return
        pad = n_slots - self.nfa.spec.n_slots
        R = max(self.nfa.spec.n_rows, 1)
        C = max(self.nfa.spec.n_caps, 1)
        if self.stacked:
            # slot axis of the [C, N, P, K, ...] carry
            self._stack_carry = _widen_slots(self._stack_carry, 3, pad, R, C)
        else:
            self._carries = [_widen_slots(c, 2, pad, R, C)
                             for c in self._carries]
        # the inner (parameterized) NFA owns the spec the bank steps
        self.nfa.grow_slots(n_slots)
        self._set_live_bytes()
        self._build_step()

    def process_block_replayed(self, block):
        """process_block with grow-and-replay at dispatch granularity:
        keep the pre-block carry, step the whole bank as one unit, and if
        the slot ring evicted partials, rewind the ENTIRE bank to it,
        double K, and replay the same block.  Requires replayable=True
        (the step leaves its input carry alone)."""
        if not self.replayable:
            raise SiddhiAppCreationError(
                "process_block_replayed needs a CompiledPatternBank "
                "built with replayable=True")
        block = self.nfa.to_device(block)
        for _ in range(16):         # 2^16 x slots: far past any real feed
            if self.stacked:
                pre = dict(self._stack_carry)
            else:
                pre = [dict(c) for c in self._carries]
            before = self.total_dropped()
            res = self.process_block(block)
            if self.total_dropped() == before:
                return res
            if self.stacked:
                self._stack_carry = pre
            else:
                self._carries = pre
            self.grow_slots(self.nfa.spec.n_slots * 2)
        raise SiddhiAppRuntimeException(
            "pattern bank slot ring failed to stabilise after 16 growths")

    def decode_ring(self, ring_cnt, ring_pid, ring_caps, ring_ts, ring_ok):
        """Vectorised host decode of a block's match-ring payloads.

        → dict of columnar arrays over the M decoded matches:
        {"pattern": [M], "partition": [M], "ts": [M], <out_name>: [M], ...}
        (the columnar analogue of the reference's per-match QueryCallback
        payload).  Entries whose slot was re-armed after the match
        (ring_ok False) are excluded — overwritten payloads, still counted
        in `ring_cnt`."""
        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
        cnt = host(ring_cnt)
        pid = host(ring_pid)
        caps = host(ring_caps)               # [N, ring, R, C]
        ts = host(ring_ts)
        ok = host(ring_ok)
        pat, slot = np.nonzero((cnt > 0) & ok)
        out = {"pattern": pat, "partition": pid[pat, slot],
               "ts": ts[pat, slot].astype(np.int64) + (self.base_ts or 0)}
        nfa = self.nfa
        for name, row, attr, which in nfa.select_outputs:
            lane = nfa.cap_lane[(row, attr, which)]
            v = caps[pat, slot, row, lane]
            at = nfa.attr_types.get(attr)
            if at in (AttrType.INT, AttrType.LONG):
                v = np.round(v).astype(np.int64)
            out[name] = v
        return out
