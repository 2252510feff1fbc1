"""Attribute aggregators: sum, avg, count, distinctCount, min, max,
minForever, maxForever, stdDev, and, or, unionSet.

(reference: query/selector/attribute/aggregator/*.java — 13 incremental
aggregators with add-on-CURRENT / subtract-on-EXPIRED / reset-on-RESET
semantics.)

Each aggregator processes a (values, types) column pair for one group-by key
and returns the *running* output per row — the batched equivalent of the
reference's per-event processAdd/processRemove calls.  Sum/count/avg/stdDev/
and/or are fully vectorised (cumulative sums); order-statistics (min/max) use
a lazy-deletion heap; set aggregators use counters.
"""
from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, List, Optional, Type

import numpy as np

from ..query_api.definition import AttrType
from .event import CURRENT, EXPIRED, RESET


class AttributeAggregator:
    name = ""

    def __init__(self, input_type: Optional[AttrType]):
        self.input_type = input_type

    @property
    def output_type(self) -> AttrType:
        raise NotImplementedError

    def process(self, values: Optional[np.ndarray],
                types: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> dict:
        raise NotImplementedError

    def restore(self, state: dict):
        raise NotImplementedError


def _signs(types: np.ndarray) -> np.ndarray:
    return np.where(types == CURRENT, 1,
                    np.where(types == EXPIRED, -1, 0)).astype(np.int64)


def _has_reset(types: np.ndarray) -> bool:
    return bool((types == RESET).any())


class _CumulativeAggregator(AttributeAggregator):
    """Base for aggregators expressible as running sums of signed deltas."""

    def _segments(self, values, types):
        """Split on RESET rows; yields (slice, is_reset_row_mask)."""
        resets = np.flatnonzero(types == RESET)
        start = 0
        for r in resets:
            yield start, int(r)
            self._reset()
            start = int(r) + 1
        yield start, len(types)

    def _reset(self):
        raise NotImplementedError


class SumAggregator(_CumulativeAggregator):
    name = "sum"

    def __init__(self, input_type):
        super().__init__(input_type)
        self._float = input_type in (AttrType.FLOAT, AttrType.DOUBLE)
        self.total = 0.0 if self._float else 0

    @property
    def output_type(self):
        return AttrType.DOUBLE if self._float else AttrType.LONG

    def _reset(self):
        self.total = 0.0 if self._float else 0

    def process(self, values, types):
        dt = np.float64 if self._float else np.int64
        out = np.empty(len(types), dt)
        for a, b in self._segments(values, types):
            if b > a:
                delta = np.asarray(values[a:b], dt) * _signs(types[a:b])
                run = self.total + np.cumsum(delta)
                out[a:b] = run
                self.total = dt(run[-1]).item()
        # rows at RESET positions output the reset value
        out[types == RESET] = self.total
        return out

    def state(self):
        return {"total": self.total}

    def restore(self, s):
        self.total = s["total"]


class CountAggregator(_CumulativeAggregator):
    name = "count"

    def __init__(self, input_type=None):
        super().__init__(input_type)
        self.count = 0

    @property
    def output_type(self):
        return AttrType.LONG

    def _reset(self):
        self.count = 0

    def process(self, values, types):
        out = np.empty(len(types), np.int64)
        for a, b in self._segments(values, types):
            if b > a:
                run = self.count + np.cumsum(_signs(types[a:b]))
                out[a:b] = run
                self.count = int(run[-1])
        out[types == RESET] = self.count
        return out

    def state(self):
        return {"count": self.count}

    def restore(self, s):
        self.count = s["count"]


class AvgAggregator(_CumulativeAggregator):
    name = "avg"

    def __init__(self, input_type):
        super().__init__(input_type)
        self.total = 0.0
        self.count = 0

    @property
    def output_type(self):
        return AttrType.DOUBLE

    def _reset(self):
        self.total, self.count = 0.0, 0

    def process(self, values, types):
        out = np.empty(len(types), np.float64)
        for a, b in self._segments(values, types):
            if b > a:
                s = _signs(types[a:b])
                run_t = self.total + np.cumsum(
                    np.asarray(values[a:b], np.float64) * s)
                run_c = self.count + np.cumsum(s)
                with np.errstate(divide="ignore", invalid="ignore"):
                    out[a:b] = np.where(run_c > 0, run_t / np.maximum(run_c, 1),
                                        0.0)
                self.total = float(run_t[-1])
                self.count = int(run_c[-1])
        out[types == RESET] = 0.0
        return out

    def state(self):
        return {"total": self.total, "count": self.count}

    def restore(self, s):
        self.total, self.count = s["total"], s["count"]


class StdDevAggregator(_CumulativeAggregator):
    name = "stddev"

    def __init__(self, input_type):
        super().__init__(input_type)
        self.n = 0
        self.s1 = 0.0
        self.s2 = 0.0

    @property
    def output_type(self):
        return AttrType.DOUBLE

    def _reset(self):
        self.n, self.s1, self.s2 = 0, 0.0, 0.0

    def process(self, values, types):
        out = np.empty(len(types), np.float64)
        for a, b in self._segments(values, types):
            if b > a:
                sg = _signs(types[a:b])
                v = np.asarray(values[a:b], np.float64)
                n = self.n + np.cumsum(sg)
                s1 = self.s1 + np.cumsum(v * sg)
                s2 = self.s2 + np.cumsum(v * v * sg)
                with np.errstate(divide="ignore", invalid="ignore"):
                    mean = np.where(n > 0, s1 / np.maximum(n, 1), 0.0)
                    var = np.where(n > 0, s2 / np.maximum(n, 1) - mean * mean,
                                   0.0)
                out[a:b] = np.sqrt(np.maximum(var, 0.0))
                self.n, self.s1, self.s2 = int(n[-1]), float(s1[-1]), float(s2[-1])
        out[types == RESET] = 0.0
        return out

    def state(self):
        return {"n": self.n, "s1": self.s1, "s2": self.s2}

    def restore(self, s):
        self.n, self.s1, self.s2 = s["n"], s["s1"], s["s2"]


class _HeapExtremum(AttributeAggregator):
    """min/max with expiry: lazy-deletion heap + live counter."""
    sign = 1  # 1 = min, -1 = max

    def __init__(self, input_type):
        super().__init__(input_type)
        self.heap: List[float] = []
        self.live: Counter = Counter()

    @property
    def output_type(self):
        return self.input_type

    def _push(self, v):
        heapq.heappush(self.heap, self.sign * v)
        self.live[v] += 1

    def _remove(self, v):
        self.live[v] -= 1
        if self.live[v] <= 0:
            del self.live[v]

    def _top(self):
        while self.heap:
            v = self.sign * self.heap[0]
            if self.live.get(v, 0) > 0:
                return v
            heapq.heappop(self.heap)
        return None

    def process(self, values, types):
        from .event import dtype_for
        dt = dtype_for(self.input_type)
        out = np.zeros(len(types), dt)
        vals = values
        for i in range(len(types)):
            t = types[i]
            if t == CURRENT:
                self._push(vals[i].item() if hasattr(vals[i], "item")
                           else vals[i])
            elif t == EXPIRED:
                self._remove(vals[i].item() if hasattr(vals[i], "item")
                             else vals[i])
            elif t == RESET:
                self.heap.clear()
                self.live.clear()
            top = self._top()
            out[i] = top if top is not None else 0
        return out

    def state(self):
        return {"live": dict(self.live)}

    def restore(self, s):
        self.live = Counter(s["live"])
        self.heap = [self.sign * v for v in self.live]
        heapq.heapify(self.heap)


class MinAggregator(_HeapExtremum):
    name = "min"
    sign = 1


class MaxAggregator(_HeapExtremum):
    name = "max"
    sign = -1


class MinForeverAggregator(AttributeAggregator):
    name = "minforever"
    _cmp = np.minimum

    def __init__(self, input_type):
        super().__init__(input_type)
        self.best = None

    @property
    def output_type(self):
        return self.input_type

    def process(self, values, types):
        from .event import dtype_for
        dt = dtype_for(self.input_type)
        v = np.asarray(values, dt).copy()
        # forever-variants consider every data event, even EXPIRED
        # (reference Min/MaxForeverAttributeAggregator processRemove also
        # updates toward the extremum)
        data = (types == CURRENT) | (types == EXPIRED)
        neutral = np.iinfo(dt).max if np.issubdtype(dt, np.integer) \
            else np.inf
        if type(self)._cmp is np.maximum:
            neutral = np.iinfo(dt).min if np.issubdtype(dt, np.integer) \
                else -np.inf
        v[~data] = neutral
        if self.best is not None:
            v = np.concatenate([[dt(self.best)], v])
            out = type(self)._cmp.accumulate(v)[1:]
        else:
            out = type(self)._cmp.accumulate(v)
        self.best = out[-1].item() if len(out) else self.best
        return out

    def state(self):
        return {"best": self.best}

    def restore(self, s):
        self.best = s["best"]


class MaxForeverAggregator(MinForeverAggregator):
    name = "maxforever"
    _cmp = np.maximum


class DistinctCountAggregator(AttributeAggregator):
    name = "distinctcount"

    def __init__(self, input_type):
        super().__init__(input_type)
        self.counter: Counter = Counter()

    @property
    def output_type(self):
        return AttrType.LONG

    def process(self, values, types):
        out = np.empty(len(types), np.int64)
        vals = values
        for i in range(len(types)):
            t = types[i]
            v = vals[i].item() if hasattr(vals[i], "item") else vals[i]
            if t == CURRENT:
                self.counter[v] += 1
            elif t == EXPIRED:
                self.counter[v] -= 1
                if self.counter[v] <= 0:
                    del self.counter[v]
            elif t == RESET:
                self.counter.clear()
            out[i] = len(self.counter)
        return out

    def state(self):
        return {"counter": dict(self.counter)}

    def restore(self, s):
        self.counter = Counter(s["counter"])


class BoolAndAggregator(AttributeAggregator):
    """and(bool) — true while every live event is true
    (reference AndAttributeAggregator: counts of false)."""
    name = "and"

    def __init__(self, input_type):
        super().__init__(input_type)
        self.false_count = 0
        self.true_count = 0

    @property
    def output_type(self):
        return AttrType.BOOL

    def process(self, values, types):
        out = np.empty(len(types), np.bool_)
        v = np.asarray(values, bool)
        for i in range(len(types)):
            t = types[i]
            if t == CURRENT:
                if v[i]:
                    self.true_count += 1
                else:
                    self.false_count += 1
            elif t == EXPIRED:
                if v[i]:
                    self.true_count -= 1
                else:
                    self.false_count -= 1
            elif t == RESET:
                self.false_count = self.true_count = 0
            out[i] = self._value()
        return out

    def _value(self):
        return self.false_count == 0 and self.true_count > 0

    def state(self):
        return {"f": self.false_count, "t": self.true_count}

    def restore(self, s):
        self.false_count, self.true_count = s["f"], s["t"]


class BoolOrAggregator(BoolAndAggregator):
    name = "or"

    def _value(self):
        return self.true_count > 0


class UnionSetAggregator(AttributeAggregator):
    name = "unionset"

    def __init__(self, input_type):
        super().__init__(input_type)
        self.counter: Counter = Counter()

    @property
    def output_type(self):
        return AttrType.OBJECT

    def process(self, values, types):
        out = np.empty(len(types), object)
        for i in range(len(types)):
            t = types[i]
            v = values[i]
            items = v if isinstance(v, (set, frozenset, list, tuple)) else [v]
            if t == CURRENT:
                for x in items:
                    self.counter[x] += 1
            elif t == EXPIRED:
                for x in items:
                    self.counter[x] -= 1
                    if self.counter[x] <= 0:
                        del self.counter[x]
            elif t == RESET:
                self.counter.clear()
            out[i] = set(self.counter.keys())
        return out

    def state(self):
        return {"counter": {repr(k): v for k, v in self.counter.items()}}

    def restore(self, s):
        # keys were repr()'d for serialisation; best-effort literal restore
        import ast
        c = Counter()
        for k, v in s["counter"].items():
            try:
                c[ast.literal_eval(k)] = v
            except (ValueError, SyntaxError):
                c[k] = v
        self.counter = c


AGGREGATORS: Dict[str, Type[AttributeAggregator]] = {
    "sum": SumAggregator,
    "avg": AvgAggregator,
    "count": CountAggregator,
    "distinctcount": DistinctCountAggregator,
    "min": MinAggregator,
    "max": MaxAggregator,
    "minforever": MinForeverAggregator,
    "maxforever": MaxForeverAggregator,
    "stddev": StdDevAggregator,
    "and": BoolAndAggregator,
    "or": BoolOrAggregator,
    "unionset": UnionSetAggregator,
}


def is_aggregator(namespace: Optional[str], name: str, nargs: int) -> bool:
    if namespace:
        return False
    low = name.lower()
    if low not in AGGREGATORS:
        return False
    # min/max with >1 args are the scalar minimum/maximum functions
    if low in ("min", "max") and nargs > 1:
        return False
    return True
