"""Per-probe STRING and DOUBLE lanes for the device join probe.

Round 4 limited the join on-condition to numeric f32 lanes: strings
joined only via ``==``/``!=`` over a persistent dictionary, and any
DOUBLE attribute (or double literal not exactly representable in f32)
forced the host mask.  Round 5 carries the sibling paths' lane tricks
into the probe (VERDICT r4 #6):

- STRING compares (equality AND order, var-vs-var and var-vs-const)
  rewrite onto order-preserving rank lanes computed per probe over the
  union of both chunks' values (+ condition constants) — rank order IS
  string order within the probe, exactly like plan/str_lanes.py's
  per-chunk code lanes (Java UTF-16 code-unit order, resort only when a
  supplementary-plane character is present).
- DOUBLE compares rewrite onto a monotone 64-bit key split into two
  exact i32 lanes: key = bits ^ (sign ? 0x7fff.. : 0) maps float64
  total order to integer order (−0.0 normalized to +0.0 so equality
  matches Java's ``==``; NaN columns route to the host mask), and the
  two-lane lexicographic compare reproduces every f64 comparison
  exactly — no f32 rounding anywhere.  FLOAT attrs and numeric literals
  compared against DOUBLEs ride the same keying (f32→f64 is exact).

Reference: query/input/stream/join/JoinProcessor.java:36-122 +
the per-type CompareConditionExpressionExecutors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..query_api.definition import AttrType
from ..query_api.expression import (And, Compare, CompareOp, Constant,
                                    Expression, Not, Or, Variable,
                                    expr_children)
from .str_lanes import _REFLECT, rank_encode


class JoinRewriteError(ValueError):
    """A string/double construct with no probe-lane form (→ host mask)."""


def _dbl_key_i64(vals: np.ndarray) -> np.ndarray:
    """float64 → monotone int64 key (total order == float order for
    non-NaN; −0.0 normalized to +0.0)."""
    v = np.where(vals == 0.0, 0.0, vals)         # −0.0 → +0.0
    bits = np.asarray(v, np.float64).view(np.int64)
    return np.where(bits < 0, bits ^ np.int64(0x7FFFFFFFFFFFFFFF), bits)


def _split_i64(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 key → (hi, lo) i32 pair; lo is offset to signed so the
    lexicographic (hi, lo) compare preserves the i64 order exactly."""
    hi = (key >> 32).astype(np.int32)
    lo = ((key & np.int64(0xFFFFFFFF)) - np.int64(1 << 31)).astype(np.int32)
    return hi, lo


class JoinLanes:
    """Collects string/double attrs + constants used in rewritten
    compares and encodes the per-probe lanes."""

    def __init__(self, types: Dict[Tuple[Optional[str], str], AttrType]):
        self.types = types
        self.str_attrs: Set[str] = set()     # attrs with code lanes
        self.dbl_attrs: Set[str] = set()     # attrs with key-pair lanes
        self.str_consts: List[str] = []      # constants, lane order
        # equality-only string joins keep the cheap INCREMENTAL
        # dictionary (O(chunk) per probe); order compares and constant
        # thresholds need per-probe union ranks instead (review r5)
        self.needs_ranks = False
        self._dict: Dict[str, int] = {}
        self.any = False

    # ------------------------------------------------------------ typing

    def _type_of(self, e) -> Optional[AttrType]:
        if isinstance(e, Variable):
            return self.types.get((e.stream_id, e.attribute)) or \
                self.types.get((None, e.attribute))
        return None

    def _is_str(self, e) -> bool:
        return self._type_of(e) == AttrType.STRING

    def _is_dbl(self, e) -> bool:
        return self._type_of(e) == AttrType.DOUBLE

    # ------------------------------------------------------------ rewrite

    def _svar(self, e: Variable) -> Variable:
        if e.stream_index not in (None, 0):
            raise JoinRewriteError("indexed string reference")
        self.str_attrs.add(e.attribute)
        self.any = True
        return Variable(stream_id=e.stream_id,
                        attribute=f"__scode_{e.attribute}")

    def _sconst(self, value: str, side: str, anchor: Variable) -> Variable:
        """Threshold lane rides the SAME side as the anchored variable so
        both broadcast together in the [n, m] probe."""
        if value not in self.str_consts:
            self.str_consts.append(value)
        self.any = True
        i = self.str_consts.index(value)
        return Variable(stream_id=anchor.stream_id,
                        attribute=f"__sc{i}_{side}")

    def _str_cmp_const(self, var: Variable, op: CompareOp,
                       value: str) -> Expression:
        code = self._svar(var)
        lo = self._sconst(value, "lo", var)
        hi = self._sconst(value, "hi", var)
        if op == CompareOp.EQ:
            return And(Compare(code, CompareOp.GTE, lo),
                       Compare(code, CompareOp.LT, hi))
        if op == CompareOp.NEQ:
            return Or(Compare(code, CompareOp.LT, lo),
                      Compare(code, CompareOp.GTE, hi))
        if op == CompareOp.GT:
            return Compare(code, CompareOp.GTE, hi)
        if op == CompareOp.GTE:
            return Compare(code, CompareOp.GTE, lo)
        if op == CompareOp.LT:
            return Compare(code, CompareOp.LT, lo)
        if op == CompareOp.LTE:
            return Compare(code, CompareOp.LT, hi)
        raise JoinRewriteError(f"string op {op}")

    def _dvar_pair(self, e) -> Tuple[Expression, Expression]:
        """A double-compare side → (hi, lo) lane expressions.  Vars get
        per-probe key lanes; numeric constants get compile-time keys."""
        if isinstance(e, Variable):
            t = self._type_of(e)
            if t in (AttrType.DOUBLE, AttrType.FLOAT, AttrType.INT,
                     AttrType.LONG):
                if e.stream_index not in (None, 0):
                    raise JoinRewriteError("indexed double reference")
                self.dbl_attrs.add(e.attribute)
                self.any = True
                return (Variable(stream_id=e.stream_id,
                                 attribute=f"__dkhi_{e.attribute}"),
                        Variable(stream_id=e.stream_id,
                                 attribute=f"__dklo_{e.attribute}"))
            raise JoinRewriteError(
                f"'{e.attribute}' ({t}) in a DOUBLE compare")
        if isinstance(e, Constant) and isinstance(e.value, (int, float)) \
                and not isinstance(e.value, bool):
            hi, lo = _split_i64(_dbl_key_i64(
                np.asarray([float(e.value)], np.float64)))
            return (Constant(int(hi[0]), "int"), Constant(int(lo[0]), "int"))
        raise JoinRewriteError("computed expression in a DOUBLE compare")

    def _dbl_cmp(self, left, op: CompareOp, right) -> Expression:
        lh, ll = self._dvar_pair(left)
        rh, rl = self._dvar_pair(right)
        eq_hi = Compare(lh, CompareOp.EQ, rh)
        if op == CompareOp.EQ:
            return And(eq_hi, Compare(ll, CompareOp.EQ, rl))
        if op == CompareOp.NEQ:
            return Or(Compare(lh, CompareOp.NEQ, rh),
                      Compare(ll, CompareOp.NEQ, rl))
        strict = {CompareOp.GT: CompareOp.GT, CompareOp.GTE: CompareOp.GT,
                  CompareOp.LT: CompareOp.LT, CompareOp.LTE: CompareOp.LT}
        tie = {CompareOp.GT: CompareOp.GT, CompareOp.GTE: CompareOp.GTE,
               CompareOp.LT: CompareOp.LT, CompareOp.LTE: CompareOp.LTE}
        if op in strict:
            return Or(Compare(lh, strict[op], rh),
                      And(eq_hi, Compare(ll, tie[op], rl)))
        raise JoinRewriteError(f"double op {op}")

    def rewrite(self, e):
        """Join on-condition → same tree with string/double compares
        lowered onto probe lanes; raises JoinRewriteError for constructs
        with no lane form (→ the caller records the host-mask reason)."""
        if isinstance(e, Compare):
            ls, rs = self._is_str(e.left), self._is_str(e.right)
            lc = isinstance(e.left, Constant) and \
                isinstance(e.left.value, str)
            rc = isinstance(e.right, Constant) and \
                isinstance(e.right.value, str)
            if ls and rs:
                if e.op not in (CompareOp.EQ, CompareOp.NEQ):
                    self.needs_ranks = True
                return Compare(self._svar(e.left), e.op,
                               self._svar(e.right))
            if ls and rc:
                self.needs_ranks = True
                return self._str_cmp_const(e.left, e.op, e.right.value)
            if lc and rs:
                self.needs_ranks = True
                return self._str_cmp_const(e.right, _REFLECT[e.op],
                                           e.left.value)
            if ls or rs or lc or rc:
                raise JoinRewriteError(
                    "string compared against a non-string/computed side")
            if self._is_dbl(e.left) or self._is_dbl(e.right) or \
                    self._f32_unsafe(e.left) or self._f32_unsafe(e.right):
                # DOUBLE sides, or a float literal that would round on
                # f32 lanes (e.g. price > 50.1): exact 64-bit keying
                return self._dbl_cmp(e.left, e.op, e.right)
            return Compare(self.rewrite(e.left), e.op,
                           self.rewrite(e.right))
        if isinstance(e, Variable):
            t = self._type_of(e)
            if t in (AttrType.STRING, AttrType.DOUBLE):
                raise JoinRewriteError(
                    f"'{e.attribute}' ({t.name}) outside a plain compare")
            return e
        if isinstance(e, Constant):
            return e
        kids = list(expr_children(e))
        if any(self._contains_sd(k) for k in kids):
            if isinstance(e, And):
                return And(self.rewrite(e.left), self.rewrite(e.right))
            if isinstance(e, Or):
                return Or(self.rewrite(e.left), self.rewrite(e.right))
            if isinstance(e, Not):
                # negating exact rank/key compares is exact (null rows
                # route the whole probe to the host mask already)
                return Not(self.rewrite(e.expr))
            raise JoinRewriteError(
                f"string/double inside {type(e).__name__}")
        return e

    @staticmethod
    def _f32_unsafe(e) -> bool:
        return (isinstance(e, Constant) and isinstance(e.value, float) and
                float(np.float32(e.value)) != e.value)

    def _contains_sd(self, e) -> bool:
        if self._is_str(e) or self._is_dbl(e) or self._f32_unsafe(e) or (
                isinstance(e, Constant) and isinstance(e.value, str)):
            return True
        return any(self._contains_sd(x) for x in expr_children(e))

    # ------------------------------------------------------------ encode

    def lane_map(self) -> List[Tuple[str, Optional[str]]]:
        """(lane name, source attr | None) — all lanes ride exact i32
        device columns; attr-derived lanes bind to sides carrying the
        attr, threshold lanes (source None) to both sides."""
        out: List[Tuple[str, Optional[str]]] = []
        for a in sorted(self.str_attrs):
            out.append((f"__scode_{a}", a))
        for i in range(len(self.str_consts)):
            out.append((f"__sc{i}_lo", None))
            out.append((f"__sc{i}_hi", None))
        for a in sorted(self.dbl_attrs):
            out.append((f"__dkhi_{a}", a))
            out.append((f"__dklo_{a}", a))
        return out

    def encode(self, left_cols: Dict[str, np.ndarray], nl: int,
               right_cols: Dict[str, np.ndarray], nr: int
               ) -> Optional[Tuple[Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]]:
        """Per-probe lanes for both sides, or None when a value needs the
        host mask (null strings, NaN doubles — the reference null/NaN
        compare laws are three-valued)."""
        lanes_l: Dict[str, np.ndarray] = {}
        lanes_r: Dict[str, np.ndarray] = {}
        if self.str_attrs and not self.needs_ranks:
            # equality-only: persistent dictionary codes, O(values)
            d = self._dict
            for cols, lanes, n in ((left_cols, lanes_l, nl),
                                   (right_cols, lanes_r, nr)):
                for a in sorted(self.str_attrs):
                    col = cols.get(a)
                    if col is None:
                        continue
                    out = np.empty(n, np.int32)
                    for i, x in enumerate(np.asarray(col, object)):
                        if x is None:
                            return None    # null law → host mask
                        c = d.get(x)
                        if c is None:
                            c = len(d)
                            d[x] = c
                        out[i] = c
                    lanes[f"__scode_{a}"] = out
        elif self.str_attrs:
            per: List[Tuple[Dict, str, np.ndarray]] = []
            pool: List[np.ndarray] = []
            for cols, lanes, _n in ((left_cols, lanes_l, nl),
                                    (right_cols, lanes_r, nr)):
                for a in sorted(self.str_attrs):
                    col = cols.get(a)
                    if col is None:
                        continue
                    obj = np.asarray(col, object)
                    if any(x is None for x in obj):
                        return None        # null law → host mask
                    strs = np.asarray([str(x) for x in obj])
                    per.append((lanes, a, strs))
                    pool.append(strs)
            uniq = np.unique(np.concatenate(pool)) if pool else \
                np.zeros(0, "U1")
            codes_of, bounds_of = rank_encode(uniq, self.str_consts)
            for lanes, a, strs in per:
                lanes[f"__scode_{a}"] = codes_of(strs).astype(np.int32)
            for i, v in enumerate(self.str_consts):
                lo, hi = bounds_of(v)
                # threshold lanes broadcast on BOTH sides (the rewrite
                # anchors them to the compared variable's side)
                for lanes, n in ((lanes_l, nl), (lanes_r, nr)):
                    lanes[f"__sc{i}_lo"] = np.full(n, lo, np.int32)
                    lanes[f"__sc{i}_hi"] = np.full(n, hi, np.int32)
        for cols, lanes, _n in ((left_cols, lanes_l, nl),
                                (right_cols, lanes_r, nr)):
            for a in sorted(self.dbl_attrs):
                col = cols.get(a)
                if col is None:
                    continue
                if col.dtype == object:
                    if any(x is None for x in col):
                        return None
                    col = np.asarray([float(x) for x in col], np.float64)
                vals = np.asarray(col, np.float64)
                if np.isnan(vals).any():
                    return None           # NaN law → host mask
                hi, lo = _split_i64(_dbl_key_i64(vals))
                lanes[f"__dkhi_{a}"] = hi
                lanes[f"__dklo_{a}"] = lo
        return lanes_l, lanes_r
