"""Windowed-aggregation query → device step (BASELINE config 2 path).

Counterpart of ``siddhi_tpu/plan/wagg_compiler.py``.  Lowers `from
S[filter]#window.length(W) | #window.time(t) | #window.externalTime(ts,
t) select sum(x)/count()/avg(x)/min(x)/max(x) group by <partition key>`
into ops/windowed_agg: the filter and the aggregated value expression
compile once through the shared expression compiler under the torch
namespace (plan/expr_compiler.TorchXP) and run over the block's [P, T]
tensors on the engine's device; the stateful window update is
``ops.windowed_agg.wagg_step`` (length, K1) or ``time_wagg_step`` (time
and externalTime, K6) — the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU ones.

The group-by key is the partition axis — the same key→lane mapping the
JAX package uses (SURVEY.md §2.8).

State: the length kernel updates its carry in place, where the JAX
package donates it to the jitted step (``donate_argnums``).  The time
step writes a fresh carry: on a ring overflow the block is replayed from
the carry before it, after the ring doubles (as in the JAX package).
The time ring keeps int32 ts offsets from a host-held base
(``ops/ts32``).  ``current_state``/``restore_state`` use the JAX
package's numpy state dict, so state crosses between the two packages
(:func:`carry_from_reference`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler import SiddhiCompiler
from ..query_api import Filter, Query, SingleInputStream
from ..core.stateschema import (CarryTuple, Scalar, Struct,
                                persistent_schema)
from ..query_api.definition import AttrType
from ..query_api.expression import AttributeFunction, Constant, Variable
from ..utils.errors import SiddhiAppCreationError
from .expr_compiler import EvalCtx, ExprCompiler, Scope, TorchXP
from ..ops.windowed_agg import (CARRY_DTYPES, TIME_CARRY_DTYPES, TS_EMPTY,
                                TimeWaggCarry, WaggCarry, kernel_device,
                                make_time_wagg_carry, make_wagg_carry,
                                time_wagg_step, wagg_step)

_AGGS = {"sum", "count", "avg", "min", "max"}

TIME_CAPACITY_START = 64      # initial time-window ring capacity (doubles
                              # on overflow; the block is replayed)

# what evaluating a compiled expression under TorchXP raises when the
# expression itself is unsupported: a column with no device lane
# (KeyError), an object/string operand or dtype torch refuses (TypeError),
# a namespace function TorchXP lacks (AttributeError)
_EXPR_REJECTIONS = (KeyError, TypeError, AttributeError, NotImplementedError)


def carry_from_reference(state: dict, device=None):
    """The port's carry from the dict the JAX package's
    ``CompiledWindowedAgg.current_state()`` returns (numpy leaves in
    WaggCarry or TimeWaggCarry order, by ``window_kind``), placed on
    ``device`` (default: the card).  Every length carry a step produces
    has ``pos == cnt`` in a lane whose ring is not yet full (the ring
    fills from slot 0), and the kernel's min/max path takes it so: a
    state that breaks it raises ``ValueError``."""
    leaves = state["carry"]
    if state.get("window_kind", "length") == "time":
        if len(leaves) != len(TimeWaggCarry._fields):
            raise ValueError(f"time-window carry has "
                             f"{len(TimeWaggCarry._fields)} leaves, got "
                             f"{len(leaves)}")
        dev = kernel_device(device)
        return TimeWaggCarry(*[
            torch.tensor(np.asarray(a), dtype=dt, device=dev)
            for a, dt in zip(leaves, TIME_CARRY_DTYPES)])
    if len(leaves) != len(WaggCarry._fields):
        raise ValueError(f"length-window carry has {len(WaggCarry._fields)}"
                         f" leaves, got {len(leaves)}")
    window = np.asarray(leaves[0]).shape[1]
    pos, cnt = np.asarray(leaves[1]), np.asarray(leaves[2])
    bad = np.flatnonzero((cnt < window) & (pos != cnt))
    if bad.size:
        p = int(bad[0])
        raise ValueError(
            f"length-window carry: lane {p} has cnt {int(cnt[p])} < W "
            f"{window} but pos {int(pos[p])} != cnt ({bad.size} such "
            f"lanes); a length window fills its ring from slot 0")
    dev = kernel_device(device)
    return WaggCarry(*[torch.tensor(np.asarray(a), dtype=dt, device=dev)
                       for a, dt in zip(leaves, CARRY_DTYPES)])


@persistent_schema(
    "wagg-engine", version=1,
    schema=Struct(carry=CarryTuple(), n_partitions=Scalar("int"),
                  window_kind=Scalar("str"), window=Scalar("num"),
                  ts_base=Scalar("opt_int")),
    dims={"P": "free", "wkind": "exact"},
    doc="partition-lane count is adopted by restore; the window kind "
        "decides the carry tuple class and is plan-fixed")
class CompiledWindowedAgg:
    """One length- or time-window aggregation query over P
    group/partition lanes.  ``t_per_block`` and ``use_pallas`` are the
    JAX package's signature: the port's steps take any T and there is
    no Pallas path (``use_pallas=True`` raises)."""

    def __init__(self, app_string, n_partitions: int,
                 t_per_block: int = 16, query_name: Optional[str] = None,
                 use_pallas: Optional[bool] = None,
                 query: Optional[Query] = None, device="cuda"):
        if use_pallas:
            raise SiddhiAppCreationError(
                "windowed-agg path: the torch backend has no Pallas step")
        app = (SiddhiCompiler.parse(app_string)
               if isinstance(app_string, str) else app_string)
        if query is None:
            for el in app.execution_elements:
                if isinstance(el, Query) and (query_name is None or
                                              el.name == query_name):
                    query = el
                    break
        if query is None:
            raise SiddhiAppCreationError(f"No query '{query_name}'")
        s = query.input_stream
        if not isinstance(s, SingleInputStream):
            raise SiddhiAppCreationError(
                "windowed-agg path needs a single input stream")
        wh = s.window_handler
        kind = (wh.name.lower() if wh is not None else "")
        self.window_ms = 0
        self.ts_attr = None
        self._ts_base = None          # i64→i32 offset base (time kinds)
        if kind == "length":
            self.window_kind = "length"
            self.window = int(wh.params[0].value)
        elif kind in ("time", "externaltime"):
            # time(t): arrival-ts driven; externalTime(tsAttr, t): the same
            # masked-expiry ring driven by the event's own timestamp
            # attribute (reference ExternalTimeWindowProcessor)
            self.window_kind = "time"
            if kind == "externaltime":
                if len(wh.params) != 2 or \
                        not isinstance(wh.params[0], Variable):
                    raise SiddhiAppCreationError(
                        "externalTime needs (tsAttr, window)")
                self.ts_attr = wh.params[0].attribute
                span = wh.params[1]
            else:
                span = wh.params[0] if wh.params else None
            if not isinstance(span, Constant):
                raise SiddhiAppCreationError(
                    f"{wh.name} needs a constant window length")
            self.window_ms = int(span.value)
            self.window = TIME_CAPACITY_START
        else:
            raise SiddhiAppCreationError(
                "windowed-agg path needs #window.length(n), "
                "#window.time(t) or #window.externalTime(tsAttr, t)")
        definition = app.stream_definitions[s.stream_id]
        if self.ts_attr is not None:
            at = {a.name: a.type for a in definition.attributes}.get(
                self.ts_attr)
            if at is None:
                raise SiddhiAppCreationError(
                    f"externalTime: '{self.ts_attr}' is not an attribute "
                    f"of '{s.stream_id}'")
            if at not in (AttrType.LONG, AttrType.INT):
                raise SiddhiAppCreationError(
                    f"externalTime: '{self.ts_attr}' must be INT/LONG, "
                    f"got {at}")

        # outputs: aggregates of ONE value expression + key passthroughs
        # (name, sum|count|avg|min|max|key, key_attr_or_None)
        self.outputs: List[Tuple[str, str, Optional[str]]] = []
        value_ast = None
        for oa in query.selector.attributes:
            e = oa.expr
            if isinstance(e, AttributeFunction) and e.name.lower() in _AGGS:
                if e.args:
                    # the kernel carries one value lane: every aggregate must
                    # ride the same argument expression (count() is arg-free)
                    if value_ast is not None and e.args[0] != value_ast:
                        raise SiddhiAppCreationError(
                            "windowed-agg path supports aggregates of a "
                            f"single shared argument expression; got both "
                            f"{value_ast} and {e.args[0]}")
                    value_ast = e.args[0]
                self.outputs.append((oa.rename, e.name.lower(), None))
            elif isinstance(e, Variable):
                self.outputs.append((oa.rename, "key", e.attribute))
            else:
                raise SiddhiAppCreationError(
                    "windowed-agg select supports sum/count/avg/min/max of "
                    "one expression plus key attributes")
        self.device = kernel_device(device)
        xp = TorchXP(self.device)
        self._xp = xp
        scope = Scope()
        scope.add_primary(s.stream_id, s.stream_ref, definition)
        compiler = ExprCompiler(scope, xp)
        self.filter_exprs = [h.expr for h in s.handlers
                             if isinstance(h, Filter)]
        self.filters = [compiler.compile(e) for e in self.filter_exprs]
        self.value = (compiler.compile(value_ast)
                      if value_ast is not None else None)
        self.want_minmax = any(k in ("min", "max")
                               for _, k, _ in self.outputs)
        self.input_definition = definition
        self.stream_id = s.stream_id
        self.n_partitions = n_partitions
        self.t_per_block = t_per_block
        # numeric sentinels (core/numguard.py, SIDDHI_TPU_NUMGUARD):
        # host-rim witnesses over arrays the retire path already fetches
        from ..core.numguard import numeric_sentinels, numguard_enabled
        self.sentinels = numeric_sentinels(app.name or "?") \
            if numguard_enabled() else None
        self._build_step()
        self.carry = self._make_carry(n_partitions)

    def _build_step(self):
        xp = self._xp
        dev = self.device
        want_minmax = self.want_minmax

        def evaluate(ctx, ok):
            for f in self.filters:
                m = xp.asarray(f.fn(ctx), bool)
                ok = ok & m.expand(ok.shape)
            if self.value is not None:
                vals = xp.asarray(self.value.fn(ctx), np.float32) \
                    .expand(ok.shape)
            else:
                vals = torch.zeros(ok.shape, dtype=torch.float32,
                                   device=dev)
            return vals, ok

        def program(block: Dict[str, torch.Tensor]):
            """filter + projection over the [P, T] block → (values f32,
            accepted bool), both [P, T].  Only the expression's own
            rejections (a column with no device lane, a type or operation
            the torch namespace cannot evaluate) become
            SiddhiAppCreationError; a failed launch or allocation
            (RuntimeError) raises as it is."""
            shape = tuple(block["__ts"].shape)
            n = block["__ts"].numel()
            cols = {k: v.reshape(-1) for k, v in block.items()
                    if not k.startswith("__")}
            ctx = EvalCtx(cols, block["__ts"].reshape(-1), n)
            try:
                vals, ok = evaluate(ctx, block["__valid"].reshape(-1))
            except _EXPR_REJECTIONS as e:
                raise SiddhiAppCreationError(
                    f"device wagg path: filter/value expression rejected "
                    f"by the torch program ({type(e).__name__}: {e})") from e
            return (vals.reshape(shape).contiguous(),
                    ok.reshape(shape).contiguous())

        window_ms = self.window_ms

        def full_step(carry, block):
            vals, ok = program(block)
            if self.window_kind == "time":
                # i32 ts offsets (rebased in process_block) for
                # cross-block window expiry
                return time_wagg_step(window_ms, carry, vals,
                                      block["__ts32"], ok, want_minmax)
            return wagg_step(carry, vals, ok, want_minmax)

        self._program = program
        from ..core.profiling import wrap_kernel
        from .shapes import shape_registry
        kind = f"wagg.{self.window_kind}.step"
        self._step = wrap_kernel(
            kind,
            shape_registry().jit(
                kind,
                {"win": self.window, "win_ms": window_ms,
                 "filters": len(self.filters), "minmax": want_minmax,
                 "device": dev.type,
                 "donate": self.window_kind == "length"},
                full_step),
            batch_of=lambda carry, block: int(block["__ts"].numel()))

    def _make_carry(self, n: int):
        if self.window_kind == "length":
            return make_wagg_carry(n, self.window, self.device)
        return make_time_wagg_carry(n, self.window, self.device)

    def to_device(self, block) -> Dict[str, torch.Tensor]:
        """Host [P, T] numpy lanes → tensors on the engine's device.  On
        CUDA each lane is a ``non_blocking`` copy from pageable memory:
        CUDA stages it at once and does not wait for earlier kernels, so
        the host may free the numpy buffer after the call."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, non_blocking=True)
                for k, v in block.items()
                if k not in ("__ts64", "__stream")}

    def grow(self, n_partitions: int) -> None:
        """Widen the group-lane axis (keyed partitioning slab growth)."""
        if n_partitions <= self.n_partitions:
            return
        fresh = self._make_carry(n_partitions - self.n_partitions)
        self.carry = type(self.carry)(*[torch.cat([a, b], dim=0)
                                        for a, b in zip(self.carry, fresh)])
        self.n_partitions = n_partitions

    # ------------------------------------------------ partition shard-out

    def pin_to_device(self, device) -> None:
        """Pin the engine to one shard's device (parallel/shards.py): the
        carry moves there, and steps and growth follow it."""
        dev = torch.device(device)
        self.device = dev
        self.carry = type(self.carry)(*[a.to(dev) for a in self.carry])

    def clone_for_shard(self, device) -> "CompiledWindowedAgg":
        """Fresh-state shard clone on ``device``: shares the compiled step
        and programs; owns its carry (and time-ring rebasing base), so
        capacity growth is shard-local."""
        import copy
        cl = copy.copy(self)
        cl.device = torch.device(device)
        if cl.window_kind == "time":
            cl._ts_base = None
        cl.carry = cl._make_carry(cl.n_partitions)
        return cl

    # ------------------------------------------------- time-window capacity

    def overflowed(self) -> bool:
        """True if any lane evicted a still-in-window entry (time mode) —
        the just-processed block's results undercount; grow and replay."""
        return self.window_kind == "time" and \
            bool(self.carry.overflow.any())

    def grow_capacity(self, new_capacity: int) -> None:
        """Double the time-window ring, keeping its entries in
        chronological order (ts order, stable; empty slots dropped) so
        the slot-fill invariant ``valid slots = [0, cnt)`` holds in the
        new ring.  Host-side, at grow time only (the JAX package's
        arithmetic)."""
        assert self.window_kind == "time"
        if new_capacity <= self.window:
            return
        old = self.carry
        ring = old.ring.cpu().numpy()
        rts = old.ring_ts.cpu().numpy()
        P = ring.shape[0]
        cnt = np.zeros(P, np.int32)
        new_ring = np.zeros((P, new_capacity), np.float32)
        new_rts = np.full((P, new_capacity), TS_EMPTY, np.int32)
        order = np.argsort(rts, axis=1, kind="stable")
        keep = np.take_along_axis(rts, order, 1) != TS_EMPTY
        for p in range(P):
            sel = order[p][keep[p]]
            k = len(sel)
            new_ring[p, :k] = ring[p, sel]
            new_rts[p, :k] = rts[p, sel]
            cnt[p] = k
        self.window = new_capacity
        dev = self.device
        self.carry = TimeWaggCarry(
            ring=torch.from_numpy(new_ring).to(dev),
            ring_ts=torch.from_numpy(new_rts).to(dev),
            pos=torch.from_numpy(cnt % new_capacity).to(dev),
            cnt=torch.from_numpy(cnt).to(dev),
            last_ts=old.last_ts,
            overflow=torch.zeros((P,), dtype=torch.bool, device=dev))
        self._build_step()

    def schema_dims(self) -> dict:
        return {"P": int(self.n_partitions), "wkind": self.window_kind}

    def current_state(self) -> dict:
        return {"carry": [a.detach().cpu().numpy().copy()
                          for a in self.carry],
                "n_partitions": self.n_partitions,
                "window_kind": self.window_kind, "window": self.window,
                "ts_base": self._ts_base}

    def restore_state(self, state: dict) -> None:
        if state.get("window_kind", "length") != self.window_kind:
            raise SiddhiAppCreationError(
                f"windowed-agg state of a {state.get('window_kind')} "
                f"window restored into a {self.window_kind} window")
        self.n_partitions = state["n_partitions"]
        if self.window_kind == "time":
            self._ts_base = state.get("ts_base")
            if state["window"] != self.window:
                self.window = state["window"]
                self._build_step()
        self.carry = carry_from_reference(state, self.device)

    def process_block(self, block):
        """block: [P, T] packed lanes (ops.pack.pack_blocks, numpy; time
        mode also needs ``block['__ts64']``, absolute i64 lanes) → (sums
        [P, T], counts [P, T][, mins, maxs]) running aggregates, as
        tensors on the engine's device.  Time mode: on a ring overflow
        the ring grows and the block replays from the carry before it,
        so results are always exact."""
        if self.window_kind == "length":
            self.carry, outs = self._step(self.carry, self.to_device(block))
            return outs
        dev_block = self.to_device(self._with_ts_offsets(block))
        while True:
            prev = self.carry
            self.carry, outs = self._step(prev, dev_block)
            if not self.overflowed():
                return outs
            self.carry = prev
            self.grow_capacity(self.window * 2)

    def _with_ts_offsets(self, block) -> Dict[str, np.ndarray]:
        """The step's i32 ``__ts32`` lanes from the block's absolute i64
        ``__ts64`` lanes by the shared rebase protocol (ops/ts32; ~24.8
        days of stream time per base).  A rebase shifts the carried ring
        timestamps and ``last_ts`` with the base."""
        from ..ops.ts32 import rebase_offsets, shift_clamped
        ts_abs = np.asarray(block["__ts64"], np.int64)
        valid = np.asarray(block["__valid"])
        base_before = self._ts_base
        offs, self._ts_base, new_ring = rebase_offsets(
            ts_abs.reshape(-1), valid.reshape(-1), self._ts_base,
            self.window_ms, self.carry.ring_ts, TS_EMPTY,
            sentinels=self.sentinels, site="wagg.ts32")
        if new_ring is not self.carry.ring_ts:
            # the ring only shifts when a prior base moved by delta
            delta = self._ts_base - (base_before or 0)
            last = shift_clamped(self.carry.last_ts, delta, TS_EMPTY + 1)
            self.carry = self.carry._replace(ring_ts=new_ring, last_ts=last)
        out = {k: v for k, v in block.items() if k != "__ts64"}
        out["__ts32"] = offs.reshape(ts_abs.shape)
        return out

    def current_aggregates(self) -> Dict[str, np.ndarray]:
        """Per-lane aggregate values right now."""
        if self.window_kind == "time":
            ring = self.carry.ring.cpu().numpy()
            rts = self.carry.ring_ts.cpu().numpy()
            cnt = self.carry.cnt.cpu().numpy()
            now = self.carry.last_ts.cpu().numpy().astype(np.int64)
            valid = (np.arange(self.window)[None, :] < cnt[:, None]) & \
                (rts > (now - self.window_ms)[:, None])
            s = np.where(valid, ring, 0.0).sum(axis=1)
            c = valid.sum(axis=1)
        else:
            s = self.carry.runsum.cpu().numpy()
            c = self.carry.cnt.cpu().numpy()
            ring = None           # D2H of the [P, W] ring only if a
            valid = None          # min/max output actually needs it
        if self.sentinels is not None:
            # NUMGUARD witness over the arrays fetched above — reads only
            self.sentinels.observe_floats("wagg.retire", s)
            self.sentinels.observe_counts("wagg.retire", c)
        out = {}
        for name, kind, _attr in self.outputs:
            if kind == "sum":
                out[name] = s
            elif kind == "count":
                out[name] = c.astype(np.int64)
            elif kind == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[name] = np.where(c > 0, s / np.maximum(c, 1),
                                         np.nan)
            elif kind in ("min", "max"):
                if ring is None:
                    ring = self.carry.ring.cpu().numpy()
                    valid = np.arange(self.window)[None, :] < c[:, None]
                fill = np.inf if kind == "min" else -np.inf
                red = np.min if kind == "min" else np.max
                out[name] = red(np.where(valid, ring, fill), axis=1)
        return out
