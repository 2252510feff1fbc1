"""Windowed-aggregation query → device step (BASELINE config 2 path).

Counterpart of ``siddhi_tpu/plan/wagg_compiler.py``, length windows only.
Lowers `from S[filter]#window.length(W) select sum(x)/count()/avg(x)/
min(x)/max(x) group by <partition key>` into ops/windowed_agg: the filter
and the aggregated value expression compile once through the shared
expression compiler under the torch namespace (plan/expr_compiler
.TorchXP) and run over the block's [P, T] tensors on the engine's device;
the stateful sliding-window update is ``ops.windowed_agg.wagg_step`` —
the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU ones.

The group-by key is the partition axis — the same key→lane mapping the
JAX package uses (SURVEY.md §2.8).  ``#window.time`` and
``#window.externalTime`` are not yet ported.

State: the kernel updates the carry in place, where the JAX package
donates it to the jitted step (``donate_argnums``); either way the
previous carry is gone after a step.  ``current_state``/``restore_state``
use the JAX package's numpy state dict, so state crosses between the two
packages (:func:`carry_from_reference`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler import SiddhiCompiler
from ..query_api import Filter, Query, SingleInputStream
from ..core.stateschema import (CarryTuple, Scalar, Struct,
                                persistent_schema)
from ..query_api.expression import AttributeFunction, Variable
from ..utils.errors import SiddhiAppCreationError
from .expr_compiler import EvalCtx, ExprCompiler, Scope, TorchXP
from ..ops.windowed_agg import (CARRY_DTYPES, WaggCarry, kernel_device,
                                make_wagg_carry, wagg_step)

_AGGS = {"sum", "count", "avg", "min", "max"}

# what evaluating a compiled expression under TorchXP raises when the
# expression itself is unsupported: a column with no device lane
# (KeyError), an object/string operand or dtype torch refuses (TypeError),
# a namespace function TorchXP lacks (AttributeError)
_EXPR_REJECTIONS = (KeyError, TypeError, AttributeError, NotImplementedError)


def carry_from_reference(state: dict, device=None) -> WaggCarry:
    """The port's carry from the dict the JAX package's
    ``CompiledWindowedAgg.current_state()`` returns (numpy leaves in
    WaggCarry order), placed on ``device`` (default: the card).  Every
    carry a step produces has ``pos == cnt`` in a lane whose ring is not
    yet full (the ring fills from slot 0), and the kernel's min/max path
    takes it so: a state that breaks it raises ``ValueError``."""
    if state.get("window_kind", "length") != "length":
        raise SiddhiAppCreationError(
            "time-window aggregation state not yet ported to the torch "
            "backend")
    leaves = state["carry"]
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
    """One length-window aggregation query over P group/partition lanes."""

    def __init__(self, app_string, n_partitions: int,
                 query_name: Optional[str] = None,
                 query: Optional[Query] = None, device="cuda"):
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
        if kind in ("time", "externaltime"):
            raise SiddhiAppCreationError(
                f"#window.{wh.name} aggregation not yet ported to the "
                f"torch backend")
        if kind != "length":
            raise SiddhiAppCreationError(
                "windowed-agg path needs #window.length(n)")
        self.window_kind = "length"
        self.window = int(wh.params[0].value)
        definition = app.stream_definitions[s.stream_id]

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
        # numeric sentinels (core/numguard.py, SIDDHI_TPU_NUMGUARD):
        # host-rim witnesses over arrays the retire path already fetches
        from ..core.numguard import numeric_sentinels, numguard_enabled
        self.sentinels = numeric_sentinels(app.name or "?") \
            if numguard_enabled() else None
        self._build_step()
        self.carry = make_wagg_carry(n_partitions, self.window, self.device)

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

        def full_step(carry, block):
            vals, ok = program(block)
            return wagg_step(carry, vals, ok, want_minmax)

        self._program = program
        from ..core.profiling import wrap_kernel
        from .shapes import shape_registry
        self._step = wrap_kernel(
            "wagg.length.step",
            shape_registry().jit(
                "wagg.length.step",
                {"win": self.window, "win_ms": 0,
                 "filters": len(self.filters), "minmax": want_minmax,
                 "device": dev.type, "donate": True},
                full_step),
            batch_of=lambda carry, block: int(block["__ts"].numel()))

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
        fresh = make_wagg_carry(n_partitions - self.n_partitions,
                                self.window, self.device)
        self.carry = WaggCarry(*[torch.cat([a, b], dim=0)
                                 for a, b in zip(self.carry, fresh)])
        self.n_partitions = n_partitions

    def schema_dims(self) -> dict:
        return {"P": int(self.n_partitions), "wkind": self.window_kind}

    def current_state(self) -> dict:
        return {"carry": [a.detach().cpu().numpy().copy()
                          for a in self.carry],
                "n_partitions": self.n_partitions,
                "window_kind": self.window_kind, "window": self.window,
                "ts_base": None}

    def restore_state(self, state: dict) -> None:
        self.n_partitions = state["n_partitions"]
        self.carry = carry_from_reference(state, self.device)

    def process_block(self, block):
        """block: [P, T] packed lanes (ops.pack.pack_blocks, numpy) →
        (sums [P, T], counts [P, T][, mins, maxs]) running aggregates, as
        tensors on the engine's device."""
        self.carry, outs = self._step(self.carry, self.to_device(block))
        return outs

    def current_aggregates(self) -> Dict[str, np.ndarray]:
        """Per-lane aggregate values right now."""
        s = self.carry.runsum.cpu().numpy()
        c = self.carry.cnt.cpu().numpy()
        ring = None               # D2H of the [P, W] ring only if a
        valid = None              # min/max output actually needs it
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
