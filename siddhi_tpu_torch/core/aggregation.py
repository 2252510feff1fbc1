"""Incremental aggregation: `define aggregation ... aggregate by ts every
sec ... year`.

Reference model (siddhi-core aggregation/): AggregationRuntime.java:67-199
builds a per-duration IncrementalExecutor chain (SECONDS→…→YEARS) of
in-memory buckets keyed by (bucket_start, group key); composite functions are
decomposed into incremental bases (avg → sum+count, stdDev → sum+sumSq+count,
IncrementalAttributeAggregator SPI) recombined at query time; `find()` merges
buckets for `within <range> per <duration>` queries
(IncrementalAggregateCompileCondition).

Columnar design here: every duration keeps a dict bucket store updated from
event micro-batches; a query-side `find_chunk` materialises the requested
duration's buckets in-range as one EventChunk (AGG_TIMESTAMP + group-by +
recombined outputs), which joins/store-queries then treat like any other
buffer.  On the TPU path bucket stores become fixed slab tensors updated with
segment-sums (ops/).
"""
from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx, ExprCompiler, Scope
from ..query_api import Filter
from ..query_api.definition import (DURATION_MS, AggregationDefinition,
                                    Attribute, AttrType, StreamDefinition)
from ..query_api.expression import AttributeFunction, Constant, TimeConstant
from ..utils.errors import SiddhiAppCreationError, StoreQueryCreationError
from .event import CURRENT, EventChunk
from .stateschema import MapOf, Struct, persistent_schema

AGG_TS = "AGG_TIMESTAMP"

# composite → incremental bases (reference IncrementalAttributeAggregator
# implementations: Avg/Sum/Count/Min/Max/StdDev IncrementalAttributeAggregator)
_DECOMPOSE = {
    "sum": ("sum",),
    "count": ("count",),
    "avg": ("sum", "count"),
    "min": ("min",),
    "max": ("max",),
    "stddev": ("sum", "sumsq", "count"),
    # distinct value-set per bucket, |set| on read (reference
    # DistinctCountIncrementalAttributeAggregator); host-only lane
    "distinctcount": ("distinct",),
}


class _OutputSpec:
    """One select attribute of the aggregation definition."""

    __slots__ = ("name", "kind", "bases", "arg", "out_type", "group_idx")

    def __init__(self, name, kind, bases, arg, out_type, group_idx=None):
        self.name = name
        self.kind = kind          # 'agg' | 'last' | 'group'
        self.bases = bases        # base slot indices ('agg'/'last')
        self.arg = arg            # CompiledExpr (agg argument / last expr)
        self.out_type = out_type
        self.group_idx = group_idx  # index into group key tuple ('group')


@persistent_schema("aggregation",
                   schema=Struct(buckets=MapOf("bucket-store")))
class AggregationRuntime:
    def __init__(self, ad: AggregationDefinition, app_runtime):
        self.ad = ad
        self.app = app_runtime
        stream = ad.basic_single_input_stream
        self.stream_id = stream.stream_id
        self.input_definition = app_runtime.definition_of(self.stream_id)

        scope = Scope()
        scope.add_primary(self.stream_id, stream.stream_ref,
                          self.input_definition)
        compiler = ExprCompiler(scope, np,
                                app_runtime.app_ctx.script_functions,
                                app_runtime.extension_registry)
        self.filters: List[CompiledExpr] = [
            compiler.compile(h.expr) for h in stream.handlers
            if isinstance(h, Filter)]

        # group-by executors
        self.group_exprs: List[CompiledExpr] = [
            compiler.compile(v) for v in ad.selector.group_by]
        self.group_names: List[str] = [v.attribute
                                       for v in ad.selector.group_by]

        # decompose select attributes
        self.base_fns: List[str] = []      # base op per slot: sum/count/...
        self.base_args: List[Optional[CompiledExpr]] = []
        self.outputs: List[_OutputSpec] = []
        out_attrs: List[Attribute] = [Attribute(AGG_TS, AttrType.LONG)]
        for oa in ad.selector.attributes:
            e = oa.expr
            if isinstance(e, AttributeFunction) and \
                    e.name.lower() in _DECOMPOSE:
                fname = e.name.lower()
                arg = compiler.compile(e.args[0]) if e.args else None
                slots = []
                for b in _DECOMPOSE[fname]:
                    slots.append(len(self.base_fns))
                    self.base_fns.append(b)
                    self.base_args.append(arg)
                t = (AttrType.DOUBLE if fname in ("avg", "stddev")
                     else (arg.type if arg is not None else AttrType.LONG))
                if fname in ("count", "distinctcount"):
                    t = AttrType.LONG
                if fname == "sum" and arg is not None and arg.type in (
                        AttrType.INT, AttrType.LONG):
                    t = AttrType.LONG
                elif fname == "sum":
                    t = AttrType.DOUBLE
                self.outputs.append(_OutputSpec(oa.rename, "agg", slots,
                                                arg, t))
                out_attrs.append(Attribute(oa.rename, t))
            else:
                ce = compiler.compile(e)
                gname = getattr(e, "attribute", None)
                if gname in self.group_names:
                    gi = self.group_names.index(gname)
                    self.outputs.append(_OutputSpec(oa.rename, "group", None,
                                                    None, ce.type,
                                                    group_idx=gi))
                else:
                    # non-grouped passthrough: per-bucket last value
                    # (reference incremental 'last' semantics)
                    slot = len(self.base_fns)
                    self.base_fns.append("last")
                    self.base_args.append(ce)
                    self.outputs.append(_OutputSpec(oa.rename, "last",
                                                    [slot], ce, ce.type))
                out_attrs.append(Attribute(oa.rename, ce.type))
        self.output_definition = StreamDefinition(ad.id, out_attrs)

        # external-time attribute
        self.by_attr = ad.aggregate_attribute
        self.durations = list(ad.time_periods)
        for d in self.durations:
            if d not in DURATION_MS:
                raise SiddhiAppCreationError(f"Bad duration '{d}'")
        # bucket stores: duration → {(bucket_ts, key): [base values]}
        self.buckets: Dict[str, Dict[Tuple[int, Tuple], List[Any]]] = {
            d: {} for d in self.durations}

        junction = app_runtime.junction_of(self.stream_id)
        junction.subscribe(self)
        self._setup_purging()

    # ------------------------------------------------------------ purging

    _DEFAULT_RETENTION = {"sec": 120_000, "min": 86_400_000,
                          "hour": 30 * 86_400_000, "day": 365 * 86_400_000,
                          "month": None, "year": None}   # None = keep all

    def _setup_purging(self):
        """@purge(enable, interval, @retentionPeriod(sec=..., min=...))
        (reference aggregation/IncrementalDataPurging.java)."""
        from ..query_api import find_annotation
        ann = find_annotation(self.ad.annotations, "purge")
        if ann is None or str(ann.get("enable", "true")).lower() != "true":
            self.retention = None
            return
        from .runtime import _parse_time_str
        interval = _parse_time_str(ann.get("interval", "15 min"))
        self.retention = dict(self._DEFAULT_RETENTION)
        rp = find_annotation(ann.annotations, "retentionperiod") or \
            find_annotation(ann.annotations, "retentionPeriod")
        if rp is not None:
            for k, v in rp.as_dict().items():
                kk = k.lower().rstrip("s")
                if kk in self.retention:
                    self.retention[kk] = (None if str(v).lower() == "all"
                                          else _parse_time_str(v))
        ctx = self.app.app_ctx

        def fire(now):
            self.purge(now)
            ctx.scheduler.notify_at(now + interval, fire)
        ctx.scheduler.notify_at(
            ctx.timestamp_generator.current_time() + interval, fire)

    def purge(self, now: int):
        if self.retention is None:
            return
        for dur in self.durations:
            keep_ms = self.retention.get(dur)
            if keep_ms is None:
                continue
            store = self.buckets[dur]
            cutoff = now - keep_ms
            for b in [b for b in store if b[0] < cutoff]:
                del store[b]

    # ------------------------------------------------------------ ingestion

    def _prepare_chunk(self, chunk: EventChunk):
        """Shared ingest head: filters → (ts_col, key_cols, base_vals, n)
        or None when the chunk is fully filtered."""
        chunk = chunk.only(CURRENT)
        n = len(chunk)
        if n == 0:
            return None
        ctx = EvalCtx(chunk.columns, chunk.timestamps, n)
        for f in self.filters:
            m = np.asarray(f.fn(ctx), bool)
            if m.ndim == 0:
                m = np.full(n, bool(m))
            if not m.all():
                chunk = chunk.mask(m)
                n = len(chunk)
                if n == 0:
                    return None
                ctx = EvalCtx(chunk.columns, chunk.timestamps, n)
        # event time column
        if self.by_attr is not None:
            ts_col = np.asarray(chunk.columns[self.by_attr], np.int64)
        else:
            ts_col = chunk.timestamps
        key_cols = [np.asarray(g.fn(ctx)) for g in self.group_exprs]
        base_vals = []
        for _fn, arg in zip(self.base_fns, self.base_args):
            if arg is None:
                base_vals.append(None)
            else:
                v = arg.fn(ctx)
                v = np.broadcast_to(np.asarray(v), (n,)) \
                    if np.asarray(v).ndim == 0 else np.asarray(v)
                base_vals.append(v)
        return ts_col, key_cols, base_vals, n

    def receive_chunk(self, chunk: EventChunk):
        prep = self._prepare_chunk(chunk)
        if prep is None:
            return
        ts_col, key_cols, base_vals, n = prep
        for i in range(n):
            key = tuple(_py(kc[i]) for kc in key_cols)
            ts = int(ts_col[i])
            for dur in self.durations:
                step = DURATION_MS[dur]
                b = (ts - ts % step, key)
                store = self.buckets[dur]
                slots = store.get(b)
                if slots is None:
                    slots = [_init_of(fn) for fn in self.base_fns]
                    store[b] = slots
                for si, fn in enumerate(self.base_fns):
                    v = base_vals[si]
                    slots[si] = _update(fn, slots[si],
                                        None if v is None else _py(v[i]))

    # ------------------------------------------------------------ query side

    def find_chunk(self, within, per, probe_chunk=None) -> EventChunk:
        """Materialise buckets of duration `per` within the time range as an
        EventChunk (reference IncrementalAggregateCompileCondition.find).
        `within`/`per` may be Variables referencing the probing stream's
        attributes (`within i.startTime, i.endTime per i.perValue` —
        Aggregation1TestCase test6); they resolve against probe_chunk's
        first row."""
        from ..query_api.expression import Variable
        probe_row = None
        within_items = list(within) if isinstance(within, (tuple, list)) \
            else [within]
        if probe_chunk is not None and len(probe_chunk) and any(
                isinstance(p, Variable)
                for p in within_items + [per] if p is not None):
            probe_row = {nm: _py(probe_chunk.columns[nm][0])
                         for nm in probe_chunk.names}
        dur = _eval_per(per, probe_row)
        if dur not in self.buckets:
            raise StoreQueryCreationError(
                f"Aggregation '{self.ad.id}' has no '{dur}' duration "
                f"(has {self.durations})")
        lo, hi = _eval_within(within, probe_row)
        rows = [(b_ts, key, slots)
                for (b_ts, key), slots in self.buckets[dur].items()
                if lo <= b_ts < hi]
        rows.sort(key=lambda r: r[0])
        k = len(rows)
        names = self.output_definition.attribute_names
        cols: Dict[str, np.ndarray] = {}
        cols[AGG_TS] = np.asarray([r[0] for r in rows], np.int64)
        for gi, gname in enumerate(self.group_names):
            arr = np.empty(k, object)
            for i, r in enumerate(rows):
                arr[i] = r[1][gi]
            cols[gname] = arr
        for o in self.outputs:
            if o.name in cols:
                continue
            arr = np.empty(k, object)
            for i, (_b_ts, key, slots) in enumerate(rows):
                if o.kind == "group":
                    arr[i] = key[o.group_idx]
                elif o.kind == "last":
                    arr[i] = slots[o.bases[0]]
                else:
                    arr[i] = _recombine(o, self.base_fns, slots)
            cols[o.name] = arr
        ts = cols[AGG_TS]
        return EventChunk(names, ts, np.zeros(k, np.int8), cols)

    # ------------------------------------------------------------ snapshot

    def current_state(self):
        return {
            "buckets": {d: [[list(b), list(map(_jsonable, slots))]
                            for b, slots in store.items()]
                        for d, store in self.buckets.items()},
        }

    def restore_state(self, s):
        self.buckets = {
            d: {(int(b[0]), tuple(b[1])): list(slots)
                for b, slots in recs}
            for d, recs in s["buckets"].items()}


# ---------------------------------------------------------------- helpers

def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _jsonable(v):
    return _py(v)


def _init_of(fn: str):
    if fn == "distinct":
        return set()
    return None if fn in ("min", "max") else 0


def _update(fn: str, acc, v):
    if fn == "count":
        return (acc or 0) + 1
    if v is None:
        return acc
    if fn == "last":
        return v
    if fn == "sum":
        return (acc or 0) + v
    if fn == "sumsq":
        return (acc or 0) + v * v
    if fn == "min":
        return v if acc is None else min(acc, v)
    if fn == "max":
        return v if acc is None else max(acc, v)
    if fn == "distinct":
        acc = set() if acc is None else acc
        acc.add(v)
        return acc
    raise SiddhiAppCreationError(f"Unknown base fn {fn}")


def _recombine(o: _OutputSpec, base_fns, slots):
    vals = [slots[i] for i in o.bases]
    kinds = [base_fns[i] for i in o.bases]
    if kinds == ["distinct"]:
        return len(vals[0] or ())
    if len(vals) == 1:
        return vals[0]
    d = dict(zip(kinds, vals))
    if set(kinds) == {"sum", "count"}:
        return (d["sum"] / d["count"]) if d["count"] else None
    if set(kinds) == {"sum", "sumsq", "count"}:
        n = d["count"]
        if not n:
            return None
        mean = d["sum"] / n
        return max(d["sumsq"] / n - mean * mean, 0.0) ** 0.5
    return vals[0]


def _probe_value(v, probe_row):
    """Resolve a Variable against the probing stream's row."""
    from ..query_api.expression import Variable
    if isinstance(v, Variable) and probe_row is not None and \
            v.attribute in probe_row:
        return probe_row[v.attribute]
    return v


def _eval_per(per, probe_row=None) -> str:
    if per is None:
        raise StoreQueryCreationError("aggregation query needs `per`")
    per = _probe_value(per, probe_row)
    if isinstance(per, Constant):
        word = str(per.value)
    elif isinstance(per, str):
        word = per
    else:
        raise StoreQueryCreationError(f"Unsupported per expression {per!r}")
    from ..compiler.parser import Parser
    try:
        return Parser._norm_duration(word)
    except Exception:
        # `per` may now flow from event data (per i.perValue): a bad value
        # is a store-query error, not a parse-time one
        raise StoreQueryCreationError(
            f"Bad per duration {word!r}") from None


_DATE_FORMATS = ["%Y-%m-%d %H:%M:%S %z", "%Y-%m-%d %H:%M:%S",
                 "%Y-%m-%d"]


def _parse_time_point(v) -> int:
    if isinstance(v, TimeConstant):
        return int(v.value)
    if isinstance(v, Constant):
        v = v.value
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        for fmt in _DATE_FORMATS:
            try:
                dt = datetime.strptime(s, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=timezone.utc)
                return int(dt.timestamp() * 1000)
            except ValueError:
                continue
    raise StoreQueryCreationError(f"Cannot parse time point {v!r}")


def _eval_within(within, probe_row=None) -> Tuple[int, int]:
    if within is None:
        return (-2**62, 2**62)
    if isinstance(within, (tuple, list)):
        items = [w for w in within if w is not None]
    else:
        items = [within]
    items = [_probe_value(w, probe_row) for w in items]
    if len(items) == 2:
        return (_parse_time_point(items[0]), _parse_time_point(items[1]))
    w = items[0]
    # single value: a wildcard date pattern "2014-**-** ..." covering a range
    wv = w.value if isinstance(w, Constant) else w
    if isinstance(wv, str) and "**" in wv:
        s = wv.strip()
        # the range comes from the date prefix before the first wildcard
        prefix = s.split("**")[0].rstrip("-: ")
        try:
            if len(prefix) == 4:            # "2014"
                lo = datetime(int(prefix), 1, 1, tzinfo=timezone.utc)
                hi = datetime(int(prefix) + 1, 1, 1, tzinfo=timezone.utc)
            elif len(prefix) == 7:          # "2014-02"
                y, mth = int(prefix[:4]), int(prefix[5:7])
                lo = datetime(y, mth, 1, tzinfo=timezone.utc)
                hi = datetime(y + (mth == 12), mth % 12 + 1, 1,
                              tzinfo=timezone.utc)
            elif len(prefix) == 10:         # "2014-02-15"
                y, mth, dd = (int(prefix[:4]), int(prefix[5:7]),
                              int(prefix[8:10]))
                lo = datetime(y, mth, dd, tzinfo=timezone.utc)
                hi = datetime.fromtimestamp(lo.timestamp() + 86400,
                                            tz=timezone.utc)
            else:
                raise ValueError(s)
            return (int(lo.timestamp() * 1000), int(hi.timestamp() * 1000))
        except ValueError:
            raise StoreQueryCreationError(
                f"Bad within pattern {s!r}") from None
    t = _parse_time_point(w)
    return (t, 2**62)
