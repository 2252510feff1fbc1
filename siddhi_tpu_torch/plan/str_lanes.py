"""Per-chunk order-preserving string code lanes for the device filter
path.

A stateless filter's string predicates need no persistent dictionary:
each chunk's string values are ranked by np.unique (sorted), so the code
order IS the string order within the chunk, and every comparison —
``==``/``!=``, ``<``/``>``/``<=``/``>=``, ``is null``, and
variable-vs-variable compares — rewrites exactly onto integer code lanes
the jitted column program evaluates on device.  Constants lower to
per-chunk threshold lanes (searchsorted left/right ranks), so the traced
program never bakes a chunk-dependent value.

Null law (reference ExpressionParser compare executors): any comparison
involving null is false; ``is null`` is the only null-true predicate.
Null codes are -1; thresholds are >= 0, so ``>=``-style compares are
null-safe for free and the rest carry an explicit ``code >= 0`` guard.

(The pattern NFA path keeps its PERSISTENT dictionary-code story —
captures survive across chunks there; see plan/nfa_compiler.py.)
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, Expression, In,
                                    IsNull, MathExpr, Not, Or, Variable,
                                    expr_children)


class StringRewriteError(ValueError):
    """A string-typed construct with no code-lane rewrite (→ host)."""


def has_supplementary(strs: np.ndarray) -> bool:
    """True if any string contains a code point above U+FFFF.

    numpy unicode arrays are UCS4, so viewing as uint32 exposes the raw
    code points (padding is 0).  Java's String.compareTo orders by UTF-16
    code unit, numpy/Python by code point; the two orders agree exactly
    unless a supplementary-plane character is present (its surrogates
    0xD800-0xDFFF sort below U+E000..U+FFFF in UTF-16)."""
    if strs.size == 0:
        return False
    if strs.dtype.kind != "U":
        return any(ord(c) > 0xFFFF for s in strs for c in str(s))
    return bool((strs.view(np.uint32) > 0xFFFF).any())


def utf16_keys(strs) -> np.ndarray:
    """Per-string utf-16-be byte keys; bytewise order == Java compareTo."""
    return np.asarray([str(s).encode("utf-16-be") for s in strs], object)


def rank_encode(uniq: np.ndarray, consts):
    """Shared union-rank machinery for per-chunk/per-probe string code
    lanes (used by the filter path here and the join probe,
    plan/join_lanes.py — ONE source of truth for the UTF-16 ordering
    rules).  Returns (codes_of, bounds_of): codes_of maps an array of
    strings (each present in `uniq`) to int ranks in Java compareTo
    order; bounds_of maps a constant to its [lo, hi) rank bounds."""
    resort = len(uniq) > 0 and (
        has_supplementary(uniq) or
        any(any(ord(c) > 0xFFFF for c in v) for v in consts))
    if resort:
        keys16 = utf16_keys(uniq)
        order = np.argsort(keys16)
        rank16 = np.empty(len(uniq), np.int64)
        rank16[order] = np.arange(len(uniq), dtype=np.int64)
        uniq16 = list(keys16[order])

    def codes_of(strs: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(uniq, strs)
        return rank16[idx] if resort else idx

    def bounds_of(v: str):
        if resort:
            import bisect
            v16 = v.encode("utf-16-be")
            return (bisect.bisect_left(uniq16, v16),
                    bisect.bisect_right(uniq16, v16))
        return (int(np.searchsorted(uniq, v, side="left")),
                int(np.searchsorted(uniq, v, side="right")))
    return codes_of, bounds_of


_REFLECT = {CompareOp.LT: CompareOp.GT, CompareOp.GT: CompareOp.LT,
            CompareOp.LTE: CompareOp.GTE, CompareOp.GTE: CompareOp.LTE,
            CompareOp.EQ: CompareOp.EQ, CompareOp.NEQ: CompareOp.NEQ}


def _num(v: float) -> Constant:
    return Constant(value=float(v))


class StringLanes:
    """Collects string attrs/constants used in rewritten predicates and
    encodes the per-chunk code + threshold lanes."""

    def __init__(self, str_attrs: Set[str]):
        self.str_attrs = str_attrs
        self.used: List[str] = []            # attrs needing code lanes
        self.consts: List[str] = []          # constant values, lane order
        # compare-class string FUNCTIONS lower onto per-chunk numeric
        # lanes (round 5): (kind, attr, const-arg) in lane order.
        # length → f32 value lane (null = -1 sentinel, guarded per
        # enclosing Compare); contains/startsWith/endsWith/
        # equalsIgnoreCase → 0/1 lane (null = 0)
        self.fn_lanes: List[tuple] = []
        self._guard_lanes: Set[str] = set()  # length lanes needing >= 0
        self.any = False

    # ------------------------------------------------------------ naming

    def code_lane(self, attr: str) -> str:
        if attr not in self.used:
            self.used.append(attr)
        self.any = True
        return f"__strcode_{attr}"

    def _const_lane(self, value: str, side: str) -> str:
        if value not in self.consts:
            self.consts.append(value)
        self.any = True
        return f"__strc{self.consts.index(value)}_{side}"

    def lane_names(self) -> List[str]:
        names = [f"__strcode_{a}" for a in self.used]
        for i in range(len(self.consts)):
            names += [f"__strc{i}_lo", f"__strc{i}_hi"]
        names += [f"__strfn{i}" for i in range(len(self.fn_lanes))]
        return names

    def _fn_lane(self, kind: str, attr: str, arg) -> str:
        key = (kind, attr, arg)
        if key not in self.fn_lanes:
            self.fn_lanes.append(key)
        self.any = True
        return f"__strfn{self.fn_lanes.index(key)}"

    def _try_fn(self, e: AttributeFunction):
        """Compare-class string function → per-chunk lane rewrite, or
        None when the shape has no lane form."""
        if (e.namespace or "").lower() != "str":
            return None
        nm = e.name.lower()
        args = e.args
        if nm == "length" and len(args) == 1 and \
                self._is_str_var(args[0]) and args[0].stream_index is None:
            lane = self._fn_lane("length", args[0].attribute, None)
            self._guard_lanes.add(lane)
            return Variable(attribute=lane)
        if nm in ("contains", "startswith", "endswith",
                  "equalsignorecase") and len(args) == 2 and \
                self._is_str_var(args[0]) and \
                args[0].stream_index is None and \
                isinstance(args[1], Constant) and \
                isinstance(args[1].value, str):
            lane = self._fn_lane(nm, args[0].attribute, args[1].value)
            return Compare(Variable(attribute=lane), CompareOp.GTE,
                           _num(1.0))
        return None

    def _scan_guards(self, e, acc: Set[str]):
        if isinstance(e, Variable) and e.attribute in self._guard_lanes:
            acc.add(e.attribute)
        for c in expr_children(e):
            self._scan_guards(c, acc)

    # ------------------------------------------------------------ rewrite

    def _is_str_var(self, e) -> bool:
        return isinstance(e, Variable) and e.attribute in self.str_attrs

    def _var(self, e: Variable) -> Variable:
        if e.stream_index is not None:
            raise StringRewriteError(
                "indexed string reference has no code lane")
        return Variable(attribute=self.code_lane(e.attribute))

    def _cmp_var_const(self, var: Variable, op: CompareOp,
                       value) -> Expression:
        if not isinstance(value, str):
            raise StringRewriteError("string/non-string comparison")
        code = self._var(var)
        lo = Variable(attribute=self._const_lane(value, "lo"))
        hi = Variable(attribute=self._const_lane(value, "hi"))
        nn = Compare(code, CompareOp.GTE, _num(0.0))     # null guard
        if op == CompareOp.EQ:
            # s == c ⟺ lo <= code < hi  (hi = lo + 1 iff c present)
            return And(Compare(code, CompareOp.GTE, lo),
                       Compare(code, CompareOp.LT, hi))
        if op == CompareOp.NEQ:
            return And(nn, Or(Compare(code, CompareOp.LT, lo),
                              Compare(code, CompareOp.GTE, hi)))
        if op == CompareOp.GT:      # s > c ⟺ code >= hi (hi >= 0: null-safe)
            return Compare(code, CompareOp.GTE, hi)
        if op == CompareOp.GTE:
            return Compare(code, CompareOp.GTE, lo)
        if op == CompareOp.LT:
            return And(nn, Compare(code, CompareOp.LT, lo))
        if op == CompareOp.LTE:
            return And(nn, Compare(code, CompareOp.LT, hi))
        raise StringRewriteError(f"op {op}")

    def _cmp_var_var(self, a: Variable, op: CompareOp,
                     b: Variable) -> Expression:
        ca, cb = self._var(a), self._var(b)
        guards = And(Compare(ca, CompareOp.GTE, _num(0.0)),
                     Compare(cb, CompareOp.GTE, _num(0.0)))
        return And(guards, Compare(ca, op, cb))

    def rewrite(self, e):
        """Expression → same tree with string predicates lowered onto
        code/threshold lanes; raises StringRewriteError when a string
        construct has no lane form (→ the caller falls back to host)."""
        if isinstance(e, Compare):
            ls, rs = self._is_str_var(e.left), self._is_str_var(e.right)
            lc = isinstance(e.left, Constant) and isinstance(e.left.value,
                                                             str)
            rc = isinstance(e.right, Constant) and \
                isinstance(e.right.value, str)
            if ls and rs:
                return self._cmp_var_var(e.left, e.op, e.right)
            if ls and rc:
                return self._cmp_var_const(e.left, e.op, e.right.value)
            if lc and rs:
                return self._cmp_var_const(e.right, _REFLECT[e.op],
                                           e.left.value)
            if ls or rs or lc or rc:
                raise StringRewriteError(
                    "string comparison against a non-string/computed side")
            out = Compare(self.rewrite(e.left), e.op,
                          self.rewrite(e.right))
            # length lanes encode null as -1: any comparison touching one
            # is null-guarded (the reference null law — every op false)
            guards: Set[str] = set()
            self._scan_guards(out, guards)
            for g in sorted(guards):
                out = And(out, Compare(Variable(attribute=g),
                                       CompareOp.GTE, _num(0.0)))
            return out
        if isinstance(e, IsNull):
            # `symbol is null` parses as IsNull(stream_id='symbol') — a
            # bare identifier is stream-or-attribute; in a single-stream
            # filter a string-attribute name resolves to the attribute
            target = None
            if e.expr is not None and self._is_str_var(e.expr):
                target = e.expr
            elif e.expr is None and e.stream_id in self.str_attrs and \
                    e.stream_index is None:
                target = Variable(attribute=e.stream_id)
            if target is not None:
                return Compare(self._var(target), CompareOp.LT,
                               _num(0.0))
        if isinstance(e, And):
            return And(self.rewrite(e.left), self.rewrite(e.right))
        if isinstance(e, Or):
            return Or(self.rewrite(e.left), self.rewrite(e.right))
        if isinstance(e, Not):
            # boolean function lanes are two-valued with null → 0, which
            # matches the HOST executors exactly (str:contains(null) is
            # false, so `not …` is true on both engines).  The string-
            # function extension is outside the reference core, so the
            # two-valued null behavior is this engine's defined contract
            # (host and device agree by construction).
            return Not(self.rewrite(e.expr))
        if isinstance(e, MathExpr):
            return MathExpr(e.op, self.rewrite(e.left),
                            self.rewrite(e.right))
        if isinstance(e, In):
            if self._contains_str(e):
                raise StringRewriteError(
                    "string table membership has no code lanes")
            return e
        if self._is_str_var(e):
            raise StringRewriteError(
                f"string attribute '{e.attribute}' outside a comparison")
        if isinstance(e, AttributeFunction):
            lowered = self._try_fn(e)
            if lowered is not None:
                return lowered
            if self._contains_str(e):
                raise StringRewriteError(
                    "string arguments to functions have no code lanes")
            # numeric functions may nest lane-rewritable args
            return AttributeFunction(
                namespace=e.namespace, name=e.name,
                args=tuple(self.rewrite(a) for a in e.args))
        return e

    def _contains_str(self, e) -> bool:
        if self._is_str_var(e) or (isinstance(e, Constant) and
                                   isinstance(e.value, str)):
            return True
        return any(self._contains_str(x) for x in expr_children(e))

    # ------------------------------------------------------------ encode

    def encode(self, columns: Dict[str, np.ndarray], n: int,
               n_pad: int) -> Dict[str, np.ndarray]:
        """Per-chunk lanes: order-preserving codes for each used attr +
        lo/hi rank thresholds for each constant (all float32 [n_pad])."""
        cols = {}
        pools = []
        per_attr: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for a in self.used:
            col = columns.get(a)
            obj = (np.asarray(col, object) if col is not None
                   else np.full(n, None, object))
            none = np.asarray([x is None for x in obj], bool)
            strs = np.asarray(["" if x is None else x for x in obj])
            per_attr[a] = (strs, none)
            if (~none).any():
                pools.append(strs[~none])
        uniq = np.unique(np.concatenate(pools)) if pools else \
            np.zeros(0, "U1")
        codes_of, bounds_of = rank_encode(uniq, self.consts)
        for a, (strs, none) in per_attr.items():
            codes = codes_of(strs).astype(np.float32)
            codes[none] = -1.0
            lane = np.full(n_pad, -1.0, np.float32)
            lane[:n] = codes
            cols[f"__strcode_{a}"] = lane
        for i, v in enumerate(self.consts):
            lo, hi = bounds_of(v)
            cols[f"__strc{i}_lo"] = np.full(n_pad, float(lo), np.float32)
            cols[f"__strc{i}_hi"] = np.full(n_pad, float(hi), np.float32)
        for i, (kind, attr, arg) in enumerate(self.fn_lanes):
            col = columns.get(attr)
            obj = (np.asarray(col, object) if col is not None
                   else np.full(n, None, object))
            vals = np.zeros(n, np.float32)
            for j, x in enumerate(obj):
                if x is None:
                    vals[j] = -1.0 if kind == "length" else 0.0
                    continue
                s = str(x)
                if kind == "length":
                    vals[j] = float(len(s))
                elif kind == "contains":
                    vals[j] = 1.0 if arg in s else 0.0
                elif kind == "startswith":
                    vals[j] = 1.0 if s.startswith(arg) else 0.0
                elif kind == "endswith":
                    vals[j] = 1.0 if s.endswith(arg) else 0.0
                else:               # equalsignorecase
                    vals[j] = 1.0 if s.lower() == arg.lower() else 0.0
            lane = np.full(n_pad, -1.0 if kind == "length" else 0.0,
                           np.float32)
            lane[:n] = vals
            cols[f"__strfn{i}"] = lane
        return cols
