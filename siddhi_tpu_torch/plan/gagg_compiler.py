"""Grouped / running aggregation query → ops/grouped_agg step (K7).

Counterpart of ``siddhi_tpu/plan/gagg_compiler.py``.  Lowers

    from S[filter](#window.length(W) | #window.time(t) |
                   #window.externalTime(ts, t))?
    select <keys/passthroughs>, sum|count|avg|min|max|minForever|maxForever|
           stdDev(x)
    (group by k1, k2, ...)?
    (having ... order by ... limit ... offset ...)?
    insert into Out;

onto ``ops.grouped_agg.grouped_step`` / ``grouped_time_step``: the CUDA
kernels (K7a, K7b) for CUDA tensors, the plain PyTorch steps for CPU
ones.  It covers what the sibling CompiledWindowedAgg refuses: group-by
keys finer than or different from the partition key, several distinct
aggregate arguments (each its own V lane; float- and int-typed ones in
separate exact banks), no-window running aggregates, minForever/
maxForever, exact INT/LONG sums (the kernel's i32 hi/lo split) and time
windows (a ring that doubles by rewind-and-replay).  An expressible
selection tail (having / order-by / limit / offset) compiles into the
selection step (ops/select.py, K8) over the 13 output planes.

Filters, value projections and group-key encoding run host-side with the
same expression IR (numpy backend), as in the JAX package; every plane
the step sees is int32 or float32 (bool for the accepted flags).

State: ``current_state``/``restore_state`` keep the JAX package's
persistent schema (numpy carry leaves), so a JAX snapshot restores here
(``ops.grouped_agg.carry_from_reference``).  Shard-out is not ported.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..query_api import Filter, Query, SingleInputStream, WindowHandler
from ..core.stateschema import (CarryTuple, MapOf, Scalar, Struct,
                                persistent_schema)
from ..query_api.definition import AttrType
from ..query_api.expression import AttributeFunction, Constant, Variable
from ..utils.errors import (SiddhiAppCreationError,
                            SiddhiAppRuntimeException)
from ..ops.grouped_agg import (INT_EXACT_MAX, INT_GROUP_MAX, TS_EMPTY,
                               GroupedTimeCarry, carry_from_reference,
                               grouped_step, grouped_time_step,
                               make_grouped_carry, make_grouped_time_carry,
                               reassemble_int_sums)
from ..ops.windowed_agg import kernel_device
from .expr_compiler import EvalCtx, ExprCompiler, Scope
from .pipeline import HostCopy

_AGGS = {"sum", "count", "avg", "min", "max", "minforever", "maxforever",
         "stddev"}
_INT_TYPES = (AttrType.INT, AttrType.LONG)
_NUM_TYPES = _INT_TYPES + (AttrType.FLOAT, AttrType.DOUBLE)

G_START = 8          # initial per-lane group capacity (doubles on demand)
MAX_WINDOW = (1 << 15) - 1   # hi/lo int sums stay exact below this
TIME_CAPACITY_START = 64     # time-window ring start (grow-and-replay)


def _reject(msg: str):
    raise SiddhiAppCreationError("device grouped-agg path: " + msg)


class GaggOverflow(Exception):
    """A still-in-window time-ring entry was evicted during a step —
    decode() signals the caller to rewind, grow, and replay."""


class _Value:
    """One distinct aggregate argument expression → one V lane."""

    def __init__(self, ast_, compiled, int_mode: bool, vidx: int,
                 attr: Optional[str]):
        self.ast = ast_
        self.compiled = compiled
        self.int_mode = int_mode
        self.vidx = vidx                 # index within its bank
        self.attr = attr                 # plain-Variable name (int check)
        self.type = compiled.type


class _SplitSquare:
    """x² split across two exactly-representable f32 parts (stdDev lanes):
    hi = f32(x²), lo = x² − hi (the rounding remainder, ≤ ulp(hi)/2 —
    f32-representable).  x² itself is exact in float64 for f32 inputs."""

    def __init__(self, base, part: str):
        self._base = base
        self._part = part
        self.type = AttrType.DOUBLE

    def fn(self, ctx):
        x = np.asarray(self._base.fn(ctx), np.float64)
        sq = x * x
        if np.any(sq > 3.0e38):
            # x² must fit the f32 hi lane; |x| > ~1.8e19 would ride as
            # inf and poison the running sums — loud data error instead
            raise SiddhiAppRuntimeException(
                "device grouped-agg path: stdDev argument magnitude "
                "exceeds the f32 square range (|x| > 1.8e19); re-plan "
                "with @app:engine('host')")
        hi = sq.astype(np.float32).astype(np.float64)
        return hi if self._part == "hi" else sq - hi


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host plane as a tensor on ``dev`` (a ``non_blocking`` copy on
    CUDA: staged at once, so the host may drop the array after)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev,
                                                        non_blocking=True)


@persistent_schema(
    "gagg-engine", version=1,
    schema=Struct(carry=CarryTuple(), n_lanes=Scalar("int"),
                  n_groups=Scalar("int"), window=Scalar("opt_num"),
                  ts_base=Scalar("opt_int"), gid_map=MapOf("int"),
                  lane_gids=MapOf("int")),
    dims={"L": "free", "G": "free", "wkind": "exact"},
    doc="lane/group capacities are adopted wholesale by restore; the "
        "window kind (length vs time carry layout) is plan-fixed")
class CompiledGroupedAgg:
    """One aggregation query over [lane, group, value] device state."""

    def __init__(self, app, query: Query, n_lanes: int = 1,
                 keyed: bool = False, device="cuda"):
        s = query.input_stream
        assert isinstance(s, SingleInputStream)
        self.device = kernel_device(device)
        wh = s.window_handler
        self.window_kind = "length"      # length | time (no-window: W=0)
        self.ts_attr: Optional[str] = None
        kind = wh.name.lower() if wh is not None and \
            not (wh.namespace or "") else ("" if wh is None else "?")
        if wh is None:
            self.window = 0
        elif kind == "length":
            if not wh.params or not isinstance(wh.params[0], Constant):
                _reject("window.length needs a constant length")
            self.window = int(wh.params[0].value)
            if not 0 < self.window <= MAX_WINDOW:
                _reject(f"window length {self.window} out of device range")
        elif kind in ("time", "externaltime"):
            self.window_kind = "time"
            if kind == "externaltime":
                if len(wh.params) != 2 or \
                        not isinstance(wh.params[0], Variable):
                    _reject("externalTime needs (tsAttr, window)")
                self.ts_attr = wh.params[0].attribute
                span = wh.params[1]
            else:
                span = wh.params[0] if wh.params else None
            if not isinstance(span, Constant):
                _reject(f"{wh.name} needs a constant window length")
            self.window_ms = int(span.value)
            self.window = TIME_CAPACITY_START
            self._ts_base: Optional[int] = None
        else:
            _reject(f"only #window.length / #window.time / "
                    f"#window.externalTime / no window compile "
                    f"(got #{wh.name})")
        # set by the pipelined runtime: retires in-flight work before a
        # timestamp rebase mutates the ring (plan/pipeline.py)
        self.flush_hook = None
        self.egress_fuser = None
        definition = app.stream_definitions.get(s.stream_id)
        if definition is None:
            _reject(f"no stream '{s.stream_id}'")
        self.stream_id = s.stream_id
        self.input_definition = definition
        attr_types = {a.name: a.type for a in definition.attributes}
        if self.ts_attr is not None:
            at = attr_types.get(self.ts_attr)
            if at not in (AttrType.INT, AttrType.LONG):
                _reject(f"externalTime: '{self.ts_attr}' must be an "
                        f"INT/LONG attribute")

        scope = Scope()
        scope.add_primary(s.stream_id, s.stream_ref, definition)
        host = ExprCompiler(scope, np)
        self.filters = [host.compile(h.expr) for h in s.handlers
                        if isinstance(h, Filter)]
        if any(not isinstance(h, (Filter, WindowHandler))
               for h in s.handlers):
            _reject("stream functions are host-only")

        # group-by: plain attributes (dictionary-encoded host-side)
        self.group_attrs: List[str] = []
        for g in query.selector.group_by:
            if not isinstance(g, Variable) or g.attribute not in attr_types:
                _reject("group-by must be plain stream attributes")
            self.group_attrs.append(g.attribute)

        # outputs: (name, kind, value|attr) — every distinct aggregate
        # argument gets its own V lane in the float or int bank
        self.values: List[_Value] = []
        by_ast: Dict[Any, _Value] = {}
        self._n_float = 0
        self._n_int = 0

        def value_of(e) -> _Value:
            v = by_ast.get(e)        # frozen dataclasses: hash == eq
            if v is not None:
                return v
            ce = host.compile(e)
            if ce.type not in _NUM_TYPES:
                _reject(f"aggregate argument type {ce.type} not numeric")
            int_mode = ce.type in _INT_TYPES
            attr = e.attribute if isinstance(e, Variable) else None
            if int_mode and attr is None:
                _reject("INT/LONG aggregate arguments must be plain "
                        "attributes (computed integer expressions cannot "
                        "be exactness-checked)")
            if int_mode:
                v = _Value(e, ce, True, self._n_int, attr)
                self._n_int += 1
            else:
                v = _Value(e, ce, False, self._n_float, attr)
                self._n_float += 1
            by_ast[e] = v
            self.values.append(v)
            return v

        self.outputs: List[Tuple[str, str, Any]] = []
        want_minmax = False
        want_forever = False
        have_agg = False
        for oa in query.selector.attributes:
            e = oa.expr
            if isinstance(e, AttributeFunction) and \
                    (e.namespace or "") == "" and e.name.lower() in _AGGS:
                kind = e.name.lower()
                have_agg = True
                if kind == "count" and not e.args:
                    self.outputs.append((oa.rename, "count", None))
                    continue
                if not e.args:
                    _reject(f"{kind}() needs an argument")
                if kind == "stddev":
                    # stdDev(x) = sqrt(E[x²] − E[x]²), the reference's own
                    # mean/meanSq formula; each square rides TWO exact f32
                    # lanes (hi = f32(x²), lo = x² − hi)
                    arg = e.args[0]
                    vx = value_of(arg)
                    if vx.int_mode:
                        _reject("stdDev over INT/LONG arguments would "
                                "square outside the exact i32 range")
                    parts = []
                    for part in ("hi", "lo"):
                        key = ("__stddev_sq", part, arg)
                        v = by_ast.get(key)
                        if v is None:
                            v = _Value(key, _SplitSquare(vx.compiled, part),
                                       False, self._n_float, None)
                            self._n_float += 1
                            by_ast[key] = v
                            self.values.append(v)
                        parts.append(v)
                    self.outputs.append(
                        (oa.rename, "stddev", (vx, parts[0], parts[1])))
                    continue
                val = value_of(e.args[0])
                if kind in ("min", "max"):
                    want_minmax = True
                if kind in ("minforever", "maxforever"):
                    want_forever = True
                self.outputs.append((oa.rename, kind, val))
            elif isinstance(e, Variable) and e.attribute in attr_types:
                self.outputs.append((oa.rename, "key", e.attribute))
            else:
                _reject("select supports aggregates plus plain attributes")
        # selection tail (having / order-by / limit / offset): compiled
        # into the selection step when expressible; atoms may pull in
        # min/max planes the select clause alone didn't want, so this
        # runs BEFORE _build_step fixes the kernel program
        from .select_compiler import (SelectionBlocked, compile_selection,
                                      selection_active)
        self.selection = None
        if selection_active(query.selector):
            try:
                self.selection = compile_selection(
                    query.selector, self.outputs, attr_types,
                    keyed=keyed,
                    windowed=(self.window != 0))
            except SelectionBlocked as e:
                _reject(f"selection tail stays on the host "
                        f"QuerySelector: {e.reason}")
            have_agg = have_agg or self.selection.has_agg
            want_minmax = want_minmax or self.selection.uses_minmax
            want_forever = want_forever or self.selection.uses_forever
        if not have_agg:
            _reject("no aggregates to run (plain projection is the filter "
                    "path)")
        self.want_minmax = want_minmax
        self.want_forever = want_forever
        # the INT_GROUP_MAX egress guard protects EXACT int sums; queries
        # whose int lanes feed only min/max/count need no such bound
        self._int_sum_needed = any(
            kind in ("sum", "avg") and isinstance(ref, _Value) and
            ref.int_mode for (_n, kind, ref) in self.outputs)

        self.n_lanes = n_lanes
        self.n_groups = G_START
        self.gid_map: Dict[Tuple, int] = {}      # (lane, key tuple) → gid
        self._lane_gids: Dict[int, int] = {}     # lane → next local gid
        # numeric sentinels (core/numguard.py, SIDDHI_TPU_NUMGUARD):
        # armed at compile time — the device sentinel output is part of
        # the compiled program, not a runtime toggle
        from ..core.numguard import numeric_sentinels, numguard_enabled
        self._numguard = numguard_enabled()
        self.sentinels = numeric_sentinels(app.name or "?") \
            if self._numguard else None
        self._build_step()
        self.carry = self._make_carry(n_lanes)

    # ------------------------------------------------------------ shapes

    @property
    def donated(self) -> bool:
        """Length/running carries are updated in place (the JAX package
        donates them) unless exact int sums are wanted: their bound trips
        in decode and rewinds to the pre-step carry, as does every time
        window's ring overflow."""
        return self.window_kind != "time" and not self._int_sum_needed

    def _build_step(self):
        from ..core.profiling import wrap_kernel
        from .shapes import shape_registry
        dev = self.device.type
        if self.window_kind == "time":
            self._step = wrap_kernel("gagg.time.step", shape_registry().jit(
                "gagg.time.step",
                {"win_ms": self.window_ms, "win": self.window,
                 "vf": self._n_float, "vi": self._n_int,
                 "forever": self.want_forever, "device": dev},
                grouped_time_step(
                    self.window_ms, self.window, self.want_forever)))
        else:
            self._step = wrap_kernel("gagg.step", shape_registry().jit(
                "gagg.step",
                {"kind": self.window_kind, "win": self.window,
                 "vf": self._n_float, "vi": self._n_int,
                 "minmax": self.want_minmax, "forever": self.want_forever,
                 "donate": self.donated, "numguard": self._numguard,
                 "device": dev},
                grouped_step(
                    self.window, self.want_minmax, self.want_forever,
                    numguard=self._numguard, inplace=self.donated)))
        if getattr(self, "selection", None) is not None:
            from ..ops.select import build_select_step
            p = self.selection
            self._select = wrap_kernel("select.step", shape_registry().jit(
                "select.step",
                {"sig": p.key, "vf": self._n_float, "vi": self._n_int,
                 "device": dev},
                build_select_step(p)))

    def _make_carry(self, n_lanes: int, n_groups: Optional[int] = None):
        g = self.n_groups if n_groups is None else n_groups
        if self.window_kind == "time":
            return make_grouped_time_carry(n_lanes, self.window, g,
                                           self._n_float, self._n_int,
                                           self.device)
        return make_grouped_carry(n_lanes, self.window, g,
                                  self._n_float, self._n_int, self.device)

    def grow_lanes(self, n_lanes: int) -> None:
        if n_lanes <= self.n_lanes:
            return
        fresh = self._make_carry(n_lanes - self.n_lanes)
        self.carry = type(self.carry)(
            *[torch.cat([a, b], dim=0) for a, b in zip(self.carry, fresh)])
        self.n_lanes = n_lanes

    def _grow_groups(self, n_groups: int) -> None:
        if n_groups <= self.n_groups:
            return
        pad = self._make_carry(self.n_lanes,
                               n_groups=n_groups - self.n_groups)
        c, p = self.carry, pad
        gfields = ("fmin_f", "fmax_f", "fmin_i", "fmax_i")
        if self.window_kind != "time":
            gfields += ("fsum_hi", "fsum_lo", "isum_hi", "isum_lo", "gcnt")
        self.carry = c._replace(**{
            f: torch.cat([getattr(c, f), getattr(p, f)], dim=1)
            for f in gfields})
        self.n_groups = n_groups

    def _grow_time_capacity(self, new_capacity: int) -> None:
        """Double the time ring (chronological compaction so the
        slot-fill invariant `valid slots = [0, cnt)` holds), keeping the
        value/gid planes aligned with their timestamps."""
        assert self.window_kind == "time"
        if new_capacity <= self.window:
            return
        old = self.carry
        P = self.n_lanes
        rts = old.ring_ts.cpu().numpy()
        rf = old.ring_f.cpu().numpy()
        ri = old.ring_i.cpu().numpy()
        rg = old.ring_gid.cpu().numpy()
        W2 = new_capacity
        nf = np.zeros((P, W2) + rf.shape[2:], np.float32)
        ni = np.zeros((P, W2) + ri.shape[2:], np.int32)
        ng = np.full((P, W2), -1, np.int32)
        nts = np.full((P, W2), TS_EMPTY, np.int32)
        cnt = np.zeros(P, np.int32)
        order = np.argsort(rts, axis=1, kind="stable")
        keep = np.take_along_axis(rts, order, 1) != TS_EMPTY
        for p in range(P):                  # host-side, grow-time only
            sel = order[p][keep[p]]
            k = len(sel)
            nf[p, :k] = rf[p, sel]
            ni[p, :k] = ri[p, sel]
            ng[p, :k] = rg[p, sel]
            nts[p, :k] = rts[p, sel]
            cnt[p] = k
        self.window = W2
        dev = self.device
        self.carry = GroupedTimeCarry(
            ring_f=_to_device(nf, dev), ring_i=_to_device(ni, dev),
            ring_gid=_to_device(ng, dev), ring_ts=_to_device(nts, dev),
            pos=_to_device((cnt % W2).astype(np.int32), dev),
            cnt=_to_device(cnt, dev),
            overflow=torch.zeros((P,), dtype=torch.bool, device=dev),
            fmin_f=old.fmin_f, fmax_f=old.fmax_f,
            fmin_i=old.fmin_i, fmax_i=old.fmax_i)
        self._build_step()

    def _gids_for(self, lanes: np.ndarray, key_cols: List[np.ndarray]
                  ) -> np.ndarray:
        """(lane, group-key tuple) → stable per-lane group ids, growing the
        slab when a lane's group population exceeds capacity."""
        n = len(lanes)
        out = np.empty(n, np.int32)
        for i in range(n):
            lane = int(lanes[i])
            key = (lane,) + tuple(c[i].item() if hasattr(c[i], "item")
                                  else c[i] for c in key_cols)
            gid = self.gid_map.get(key)
            if gid is None:
                gid = self._lane_gids.get(lane, 0)
                self._lane_gids[lane] = gid + 1
                self.gid_map[key] = gid
            out[i] = gid
        need = max(self._lane_gids.values(), default=0)
        if need > self.n_groups:
            cap = self.n_groups
            while cap < need:
                cap *= 2
            self._grow_groups(cap)
        return out

    def _ts_offsets(self, data, lanes32, row, ok, shape) -> np.ndarray:
        """[P, T] i32 ts offsets for the time kernel (shared rebase
        protocol: ops/ts32.rebase_offsets — only ACCEPTED rows decide the
        base; filter-rejected rows may carry junk timestamps).
        externalTime reads the event's own ts attribute."""
        from ..ops.ts32 import rebase_offsets
        src = (np.asarray(data.columns[self.ts_attr], np.int64)
               if self.ts_attr else
               np.asarray(data.timestamps, np.int64))
        offs, base, new_ring = rebase_offsets(
            src, ok, self._ts_base, self.window_ms,
            self.carry.ring_ts, TS_EMPTY,
            sentinels=self.sentinels, site="gagg.ts32")
        if new_ring is not self.carry.ring_ts:
            # rebase shifts the carried ring: retire in-flight work first
            # so every queued step (and any overflow replay) shares one
            # timestamp base, then recompute against the settled carry
            if self.flush_hook is not None:
                self.flush_hook()
            offs, base, new_ring = rebase_offsets(
                src, ok, self._ts_base, self.window_ms,
                self.carry.ring_ts, TS_EMPTY,
                sentinels=self.sentinels, site="gagg.ts32")
            self.carry = self.carry._replace(ring_ts=new_ring.contiguous())
        self._ts_base = base
        plane = np.zeros(shape, np.int32)
        plane[lanes32, row] = offs
        return plane

    # ------------------------------------------------------------ execute

    def dispatch(self, lanes: np.ndarray, data) -> Optional[Dict[str, Any]]:
        """data: EventChunk of CURRENT events, lanes: per-event lane
        index.  Host-side encode + ONE step dispatch; returns a work dict
        whose un-read device outputs `decode` consumes later (pipelined
        ingest), or None when no event passes the filters.  Data errors
        that are host-detectable (2^31 integer lanes) raise HERE, before
        any carry mutation."""
        from ..native_ext import assign_rows
        n = len(data)
        ctx = EvalCtx(data.columns, data.timestamps, n)
        ok = np.ones(n, bool)
        for f in self.filters:
            m = np.asarray(f.fn(ctx), bool)
            ok &= np.broadcast_to(m, ok.shape)

        vals_f = np.zeros((n, self._n_float), np.float32)
        vals_i = np.zeros((n, self._n_int), np.int32)
        for v in self.values:
            col = np.broadcast_to(np.asarray(v.compiled.fn(ctx)), (n,))
            if v.int_mode:
                iv = np.asarray(col, np.int64)
                bad = ok & (np.abs(iv) >= INT_EXACT_MAX)
                if bad.any():
                    raise SiddhiAppRuntimeException(
                        "device grouped-agg path: integer aggregate value "
                        f"|{int(iv[bad][0])}| >= 2^31 does not fit the "
                        "i32 device lanes; re-plan with "
                        "@app:engine('host')")
                vals_i[:, v.vidx] = iv.astype(np.int32)
            else:
                vals_f[:, v.vidx] = np.asarray(col, np.float32)
        if not ok.any():
            return None
        # group ids only for ACCEPTED rows — filter-rejected keys must not
        # allocate slab entries (high-cardinality streams would grow the
        # [P, G, V] state for groups that never hold data)
        key_cols = [np.asarray(data.columns[a])[ok]
                    for a in self.group_attrs]
        gids_ok = self._gids_for(np.asarray(lanes)[ok], key_cols)
        gids = np.zeros(n, np.int32)
        gids[ok] = gids_ok

        lanes32 = np.ascontiguousarray(lanes, np.int32)
        row, _counts, T = assign_rows(lanes32, self.n_lanes)
        P = self.n_lanes
        T = 1 << (T - 1).bit_length()
        f_plane = np.zeros((P, T, self._n_float), np.float32)
        i_plane = np.zeros((P, T, self._n_int), np.int32)
        g_plane = np.zeros((P, T), np.int32)
        ok_plane = np.zeros((P, T), bool)
        f_plane[lanes32, row] = vals_f
        i_plane[lanes32, row] = vals_i
        g_plane[lanes32, row] = gids
        ok_plane[lanes32, row] = ok
        work: Dict[str, Any] = {"data": data, "ok": ok,
                                "lanes32": lanes32, "row": row}
        dev = self.device
        if self.selection is not None:
            # padded per-emission gather vectors for the select step —
            # pow2-bucketed like T; padding rows carry ok=False and sort
            # behind out_count
            n_pad = 1 << max(0, (n - 1).bit_length())
            lp = np.zeros(n_pad, np.int32)
            rp = np.zeros(n_pad, np.int32)
            op = np.zeros(n_pad, bool)
            lp[:n] = lanes32
            rp[:n] = row
            op[:n] = ok
            work["sel_pad"] = tuple(_to_device(a, dev) for a in (lp, rp, op))
        planes = [f_plane, i_plane, g_plane, ok_plane]
        if self.window_kind == "time":
            planes.insert(3, self._ts_offsets(data, lanes32, row, ok,
                                              (P, T)))
        work["planes"] = tuple(_to_device(a, dev) for a in planes)
        self.redispatch(work)
        return work

    def redispatch(self, work: Dict[str, Any]) -> None:
        """(Re)run a work item's step on the CURRENT carry — used at
        dispatch and when replaying in-flight chunks after a rewind.
        Donated configs never rewind, so pre_carry is None there:
        touching it is a bug, not a stale read."""
        # a leaf set from the host (a numpy array) is taken as a tensor
        self.carry = type(self.carry)(*[torch.as_tensor(a, device=self.device)
                                        for a in self.carry])
        work["pre_carry"] = None if self.donated else self.carry
        self.carry, outs = self._step(self.carry, *work["planes"])
        if self.selection is not None:
            # chain the selection step: having mask, ordering permutation
            # and limit bound over the 13 grouped planes; the numguard
            # sentinel (14th output) stays behind the select outputs
            base, tail = outs[:13], outs[13:]
            outs = tuple(self._select(*base, *work["sel_pad"])) + \
                tuple(tail)
        extra = ([self.carry.overflow]
                 if self.window_kind == "time" else [])
        if self.egress_fuser is not None:
            # outputs (and the time ring's overflow flags, read first in
            # decode) ride the app's per-ingest-block slab
            work["fuse"] = self.egress_fuser.register(
                self, list(outs) + extra)
            work["copy"] = None
        else:
            work["fuse"] = None
            work["copy"] = HostCopy(list(outs) + extra)

    def grow_time_window(self) -> None:
        """Double the time-window ring (the caller has already rewound
        self.carry to the failing chunk's pre-carry)."""
        if self.window * 2 > MAX_WINDOW + 1:
            raise SiddhiAppRuntimeException(
                "device grouped-agg path: time window needs more "
                "than 2^15 live entries (exact int-sum bound) — "
                "re-plan with @app:engine('host')")
        self._grow_time_capacity(self.window * 2)

    def decode(self, work: Dict[str, Any]) -> Dict[str, Any]:
        """Wait for a work item's outputs and decode them per event.
        Raises GaggOverflow when a still-in-window time-ring entry was
        evicted — the caller rewinds to work["pre_carry"], grows, and
        replays this and every later in-flight chunk.  Raises
        SiddhiAppRuntimeException on the exact integer-sum bound — the
        caller rewinds likewise."""
        from ..core.ledger import ledger
        data, ok = work["data"], work["ok"]
        lanes32, row = work["lanes32"], work["row"]
        if work.get("fuse") is not None:
            fetched = work["fuse"].fetch()
        else:
            with ledger().span("egress_d2h"):
                fetched = work["copy"].wait()
        if self.window_kind == "time":
            if bool(np.asarray(fetched[-1]).any()):
                raise GaggOverflow()
            fetched = fetched[:-1]
        outs_host = fetched
        if self._numguard and self.window_kind != "time":
            # device sentinel plane (14th output — see _build_step)
            sent, outs_host = outs_host[-1], outs_host[:-1]
            if self.sentinels is not None:
                self.sentinels.observe_sentinel_plane("gagg.step", sent)
        sel_idx = None
        if self.selection is not None:
            # the selection step: sel_rows is the ordering permutation
            # over chunk rows, meta = [out_count, max_cnt]; the 13 planes
            # arrive gathered and compacted, so the selected rows are the
            # first out_count entries
            sel_rows = np.asarray(outs_host[0])
            meta = np.asarray(outs_host[1])
            sel_k = int(meta[0])
            sel_cmax = int(meta[1])
            sel_idx = sel_rows[:sel_k]
            outs_host = outs_host[2:]
        (fhi, flo, ihi, ilo, cnt, w_mnf, w_mxf, w_mni, w_mxi,
         a_mnf, a_mxf, a_mni, a_mxi) = outs_host
        if self.sentinels is not None:
            # host-rim witness over planes this decode already fetched
            self.sentinels.observe_floats("gagg.decode", fhi)
            self.sentinels.observe_counts("gagg.decode", cnt)
        if sel_idx is not None:
            def pick(a):
                return a[:sel_k]
            cnt_max = sel_cmax
        else:
            sel_l, sel_r = lanes32[ok], row[ok]

            def pick(a):
                return a[sel_l, sel_r]
        counts = pick(cnt).astype(np.int64)
        if sel_idx is None:
            cnt_max = int(counts.max(initial=0))
        if self._int_sum_needed and self.window == 0 and \
                cnt_max >= INT_GROUP_MAX:
            raise SiddhiAppRuntimeException(
                "device grouped-agg path: a group accumulated >= 2^15 "
                "events; exact running integer sums exceed the i32 "
                "partial-sum bound — re-plan with @app:engine('host')")
        out: Dict[str, Any] = {"mask": ok} if sel_idx is None else \
            {"sel_rows": sel_idx}
        for (name, kind, ref) in self.outputs:
            if kind == "key":
                rows_sel = ok if sel_idx is None else sel_idx
                out[name] = np.asarray(data.columns[ref])[rows_sel]
                continue
            if kind == "count":
                out[name] = counts
                continue
            if kind == "stddev":
                vx, vh, vl = ref
                sx = pick(fhi)[:, vx.vidx].astype(np.float64) + \
                    pick(flo)[:, vx.vidx].astype(np.float64)
                sxx = (pick(fhi)[:, vh.vidx].astype(np.float64) +
                       pick(flo)[:, vh.vidx].astype(np.float64)) + \
                      (pick(fhi)[:, vl.vidx].astype(np.float64) +
                       pick(flo)[:, vl.vidx].astype(np.float64))
                with np.errstate(invalid="ignore", divide="ignore"):
                    c = np.maximum(counts, 1)
                    var = sxx / c - (sx / c) ** 2
                    out[name] = np.where(counts > 0,
                                         np.sqrt(np.maximum(var, 0.0)),
                                         np.nan)
                continue
            v: _Value = ref
            j = v.vidx
            if v.int_mode:
                sums = reassemble_int_sums(pick(ihi)[:, j],
                                           pick(ilo)[:, j])
                mn, mx = pick(w_mni)[:, j], pick(w_mxi)[:, j]
                fm, fx = pick(a_mni)[:, j], pick(a_mxi)[:, j]
            else:
                # two-float pair → f64 (tracks the host's float64
                # accumulation to ~2^-48 relative)
                sums = pick(fhi)[:, j].astype(np.float64) + \
                    pick(flo)[:, j].astype(np.float64)
                mn, mx = pick(w_mnf)[:, j], pick(w_mxf)[:, j]
                fm, fx = pick(a_mnf)[:, j], pick(a_mxf)[:, j]
            if kind == "sum":
                out[name] = sums
            elif kind == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[name] = np.where(
                        counts > 0,
                        sums.astype(np.float64) / np.maximum(counts, 1),
                        np.nan)
            elif kind == "min":
                out[name] = mn
            elif kind == "max":
                out[name] = mx
            elif kind == "minforever":
                out[name] = fm
            elif kind == "maxforever":
                out[name] = fx
        return out

    # ------------------------------------------------------------ types

    def output_attr_type(self, kind: str, ref) -> AttrType:
        """Host-parity output types (reference typed aggregator returns)."""
        if kind == "key":
            return {a.name: a.type for a in
                    self.input_definition.attributes}[ref]
        if kind == "count":
            return AttrType.LONG
        if kind == "stddev":
            return AttrType.DOUBLE
        if kind == "sum":
            return AttrType.LONG if ref.int_mode else AttrType.DOUBLE
        if kind == "avg":
            return AttrType.DOUBLE
        # min/max/minForever/maxForever return the input type
        return ref.type

    # ------------------------------------------------------------ snapshot

    def schema_dims(self) -> dict:
        return {"L": int(self.n_lanes), "G": int(self.n_groups),
                "wkind": self.window_kind}

    def current_state(self) -> dict:
        return {"carry": [np.asarray(a.detach().cpu().numpy()).copy()
                          for a in self.carry],
                "n_lanes": self.n_lanes, "n_groups": self.n_groups,
                "window": self.window,
                "ts_base": getattr(self, "_ts_base", None),
                "gid_map": {repr(k): v for k, v in self.gid_map.items()},
                "lane_gids": dict(self._lane_gids)}

    def restore_state(self, state: dict) -> None:
        """Accepts this engine's own ``current_state()`` or the JAX
        package's ``CompiledGroupedAgg.current_state()`` unchanged."""
        self.n_lanes = state["n_lanes"]
        self.n_groups = state["n_groups"]
        if self.window_kind == "time":
            self._ts_base = state.get("ts_base")
            if state.get("window", self.window) != self.window:
                self.window = state["window"]
                self._build_step()
        self.carry = carry_from_reference(state, self.device)
        self.gid_map = {ast.literal_eval(k): v
                        for k, v in state["gid_map"].items()}
        self._lane_gids = {int(k): v
                           for k, v in state["lane_gids"].items()}
