"""Join runtime: windowed stream-stream, stream-table, stream-window and
stream-aggregation joins.

TPU-shaped design: instead of the reference's per-event `find()` probe with a
compiled condition walked over a linked buffer (query/input/stream/join/
JoinProcessor.java:36-122, JoinInputStreamParser.java), an arriving micro-batch
is joined against the opposite buffer as one vectorised cross-product mask —
n×m condition evaluation in a single fused column program.

Semantics mirrored from the reference:
  - arriving CURRENT events probe the opposite window and emit joined CURRENT
    rows; events expiring from a window probe and emit joined EXPIRED rows
    (docs/siddhi-architecture.md:286-289)
  - `unidirectional` restricts which side triggers output (EventTrigger)
  - left/right/full outer joins emit null-padded rows for non-matching
    arrivals (JoinProcessor + OuterJoinMatcher)
  - a side without a #window holds no buffer: its events join only at their
    own arrival instant (reference empty-window behaviour)
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx, Scope
from ..query_api import (EventTrigger, Filter, JoinInputStream, JoinType,
                         StreamFunctionHandler, WindowHandler)
from ..query_api.definition import Attribute, StreamDefinition
from ..query_api.expression import expr_children
from ..utils.errors import SiddhiAppCreationError
from .event import CURRENT, EXPIRED, TIMER, EventChunk
from .processor import Processor
from .window import WindowProcessor, create_window_processor


class _Collector(Processor):
    """Captures a window processor's output chunk (current + expired)."""

    def __init__(self):
        super().__init__()
        self.collected: List[EventChunk] = []

    def process(self, chunk: EventChunk):
        self.collected.append(chunk)

    def drain(self) -> List[EventChunk]:
        out, self.collected = self.collected, []
        return out


class JoinSide:
    """One side of the join: its definition, filter, buffer and aliases."""

    def __init__(self, runtime: "JoinRuntime", stream, factory, side: str):
        self.runtime = runtime
        self.side = side
        self.stream_id = stream.stream_id
        self.ref = stream.stream_ref or stream.stream_id
        app = runtime.qr.app_runtime
        self.is_table = app.has_table(stream.stream_id)
        self.is_named_window = app.has_named_window(stream.stream_id)
        self.is_aggregation = stream.stream_id in app.aggregations
        self.definition = app.definition_of(stream.stream_id)
        if self.is_aggregation:
            self.definition = app.aggregations[
                stream.stream_id].output_definition

        scope = Scope()
        scope.add_primary(self.stream_id, self.ref, self.definition)
        compiler = factory(scope)
        self.filters: List[CompiledExpr] = []
        self.window: Optional[WindowProcessor] = None
        self.collector = _Collector()
        for h in stream.handlers:
            if isinstance(h, Filter):
                self.filters.append(compiler.compile(h.expr))
            elif isinstance(h, WindowHandler):
                if self.is_table or self.is_named_window or \
                        self.is_aggregation:
                    raise SiddhiAppCreationError(
                        f"'{self.stream_id}' is not a stream: windows are "
                        f"not allowed on table/window/aggregation join sides")
                self.window = create_window_processor(
                    h.name, h.params, app.app_ctx,
                    self.definition.attribute_names,
                    lambda e: compiler.compile(e),
                    namespace=h.namespace or "",
                    extension_registry=app.extension_registry)
                self.window.lock = runtime.qr.lock
                self.window.next = self.collector
            elif isinstance(h, StreamFunctionHandler):
                raise SiddhiAppCreationError(
                    "stream functions on join sides are not supported yet")

    def apply_filters(self, chunk: EventChunk) -> EventChunk:
        for f in self.filters:
            n = len(chunk)
            if n == 0:
                break
            ctx = EvalCtx(chunk.columns, chunk.timestamps, n)
            m = np.asarray(f.fn(ctx), bool)
            if m.ndim == 0:
                m = np.full(n, bool(m))
            chunk = chunk.mask(m | (chunk.types == TIMER))
        return chunk

    def buffer_chunk(self) -> Optional[EventChunk]:
        """Opposite-side probe target (reference FindableProcessor.find)."""
        app = self.runtime.qr.app_runtime
        if self.is_table:
            return app.table_of(self.stream_id).all_rows_chunk()
        if self.is_named_window:
            return app.named_window_of(self.stream_id).find_chunk()
        if self.window is not None:
            return self.window.find_chunk()
        return None  # windowless stream side: nothing buffered


class _JoinReceiver:
    def __init__(self, runtime: "JoinRuntime", side: JoinSide):
        self.runtime = runtime
        self.side = side

    def receive_chunk(self, chunk: EventChunk):
        self.runtime.on_arrival(self.side, chunk)



class JoinRuntime:
    def __init__(self, qr, jis: JoinInputStream, factory):
        self.qr = qr
        self.jis = jis
        app = qr.app_runtime
        self.left = JoinSide(self, jis.left, factory, "left")
        self.right = JoinSide(self, jis.right, factory, "right")
        if self.left.is_aggregation or self.right.is_aggregation:
            agg_side = self.left if self.left.is_aggregation else self.right
            self.agg_runtime = app.aggregations[agg_side.stream_id]
        else:
            self.agg_runtime = None
        from ..query_api.expression import Variable
        probes = list(jis.within) if isinstance(jis.within, (tuple, list)) \
            else [jis.within]
        self._agg_per_row = any(isinstance(p, Variable)
                                for p in probes + [jis.per] if p is not None)
        self.join_type = jis.join_type
        self.trigger = jis.trigger

        # joined scope: both sides qualified + unique attrs unqualified
        scope = Scope()
        union_attrs: List[Attribute] = []
        seen: Dict[str, str] = {}
        for side in (self.left, self.right):
            for a in side.definition.attributes:
                def g(ctx, _r=side.ref, _a=a.name):
                    return ctx.qualified[(_r, 0)][_a]
                scope.add(side.ref, a.name, a.type, g)
                if side.stream_id != side.ref:
                    scope.add(side.stream_id, a.name, a.type, g)
                if a.name not in seen:
                    seen[a.name] = side.ref
                    union_attrs.append(a)
                    scope.add(None, a.name, a.type, g)
        self.union_def = StreamDefinition("__join", union_attrs)

        self.on: Optional[CompiledExpr] = None
        if jis.on is not None:
            self.on = factory(scope).compile(jis.on)

        # table sides: precompile the `on` condition as a table probe so
        # PK / @Index hash lookups replace the O(n*m) cross product
        # (reference JoinInputStreamParser compiles the condition against
        # the opposite FindableProcessor for exactly this reason)
        self._table_conds: Dict[str, object] = {}
        for tside, pside in ((self.left, self.right),
                             (self.right, self.left)):
            if not tside.is_table or jis.on is None:
                continue
            if pside.is_table or pside.is_named_window or \
                    pside.is_aggregation:
                continue
            # unqualified attrs present on BOTH sides bind to the left in
            # the joined scope but to the table in probe scope — ambiguous,
            # keep the cross product
            from ..query_api.expression import variables_of
            both = {a.name for a in tside.definition.attributes} & \
                   {a.name for a in pside.definition.attributes}
            if any(v.stream_id is None and v.attribute in both
                   for v in variables_of(jis.on)):
                continue
            try:
                from copy import copy as _copy
                sd = _copy(pside.definition)
                if pside.ref != sd.id:
                    sd.source_alias = pside.ref
                table = app.table_of(tside.stream_id)
                cc = table.compile_condition(jis.on, sd, factory)
                if cc.pk_probe is not None or cc.index_probe is not None:
                    self._table_conds[tside.side] = cc
                elif getattr(cc, "root", None) is not None:
                    # record table (core/record_table.py): the condition
                    # translated to the store-neutral IR — probe natively
                    self._table_conds[tside.side] = cc
            except Exception:  # noqa: BLE001 — any shape issue → cross path
                pass

        # device probe (VERDICT r2 next #7): the `on` condition over the
        # arriving-chunk × buffer cross product — the reference's per-event
        # JoinProcessor.find() hot loop (JoinProcessor.java:36-122) — as
        # one [n, m] broadcast program on the device.  Built when the
        # condition compiles under jnp over numeric attributes; DOUBLE
        # attributes are excluded (f32 lanes would flip borderline
        # compares vs the host's float64) and INT/LONG columns are
        # range-guarded per probe (2^24 f32 exactness).  Falls back to the
        # host numpy mask with self.device_probe_reason recorded.  When a
        # PK/@Index hash probe exists, the host O(1) lookup wins — the
        # device brute-force cross is for non-indexable conditions.
        self.device_probe = None
        self.device_probe_reason: Optional[str] = None
        # the device probe's route, fixed at build: "fused" (the condition
        # lowered to plan/join_program, one kernel, no mask) or "mask"
        # (the torch program's mask, then probe_compact), with the reason
        self.probe_route: Optional[str] = None
        self.probe_route_reason: Optional[str] = None
        self.probe_program = None
        self.mask_probe = None
        from ..plan.planner import engine_mode
        app_obj = getattr(app, "app", None)
        mode = engine_mode(app_obj) if app_obj is not None else "host"
        if mode == "host":
            self.device_probe_reason = (
                "device join probe: engine mode 'host'"
                if app_obj is not None
                else "device join probe: inside host partition clone")
        elif jis.on is None:
            self.device_probe_reason = \
                "device join probe: no on-condition (pure cross product)"
        elif self._table_conds:
            self.device_probe_reason = \
                "device join probe: PK/@Index hash probe is faster on host"
        elif self.agg_runtime is not None:
            self.device_probe_reason = \
                "device join probe: aggregation sides are host-only"
        else:
            self._try_build_device_probe(jis, scope)

        qr._finish_chain([], scope, self.union_def, factory)
        self.head = qr._chain_head([])

        # subscribe both sides (self-join: two receivers on one junction);
        # a named-window side subscribes to the shared window itself — its
        # published CURRENT/EXPIRED events trigger the join exactly like
        # the reference's Window.java feeding downstream JoinProcessors
        for side, s in ((self.left, jis.left), (self.right, jis.right)):
            if side.is_table or side.is_aggregation:
                continue
            recv = _JoinReceiver(self, side)
            if side.is_named_window:
                app.named_window_of(s.stream_id).subscribe(recv)
            else:
                junction = app.junction_of(s.stream_id, s.is_inner,
                                           s.is_fault)
                junction.subscribe(recv)
            qr.receivers[f"{side.side}:{s.stream_id}"] = recv

    @property
    def windows(self) -> List[WindowProcessor]:
        return [w for w in (self.left.window, self.right.window)
                if w is not None]

    # ------------------------------------------------------- device probe

    def _try_build_device_probe(self, jis, scope) -> None:
        """Build the device probe (the JAX package's, on the app's device).
        A condition that cannot compile or run as a torch program records
        ``device_probe_reason`` and keeps the host mask.  Otherwise the
        route is fixed here (``probe_route``, ``probe_route_reason``): a
        condition inside ``plan/join_program``'s class runs fused
        (``ops/join_probe.probe_fused``), any other as the torch program's
        mask compacted by ``probe_compact``.  A missing CUDA device, a
        failed build or a failed launch raises ``RuntimeError``."""
        from ..query_api.definition import AttrType
        from ..query_api.expression import variables_of
        from ..plan.expr_compiler import ExprCompiler as _EC

        from ..query_api.expression import MathExpr

        def _fail(reason):
            self.device_probe_reason = "device join probe: " + reason

        # timestamp functions would read a zeros placeholder in the probe
        # ctx — the sibling device paths reject them the same way
        from ..plan.planner import _is_time_fn, _scan_fns
        if _scan_fns(jis.on, _is_time_fn):
            return _fail("timestamp functions need int64 host evaluation")

        types = {}
        for s in (self.left, self.right):
            for a in s.definition.attributes:
                types.setdefault((s.ref, a.name), a.type)
                types.setdefault((s.stream_id, a.name), a.type)
                types.setdefault((None, a.name), a.type)

        # STRING compares (equality AND order, var-vs-var/var-vs-const)
        # and exact DOUBLE compares rewrite onto per-probe lanes —
        # order-preserving rank codes / monotone 64-bit keys split into
        # i32 pairs (plan/join_lanes.py)
        from ..plan.join_lanes import JoinLanes, JoinRewriteError
        jl = JoinLanes(types)
        try:
            dev_cond = jl.rewrite(jis.on)
        except JoinRewriteError as ve:
            return _fail(str(ve))
        self._jlanes = jl

        # INT/LONG variables are range-guarded per column (2^24), but
        # arithmetic ON them (L.id * R.id) can leave the exact range even
        # when the columns are inside it — reject at build
        def int_in_math(e, inside=False) -> bool:
            from ..query_api.expression import Variable as _V
            if isinstance(e, _V) and inside and \
                    types.get((e.stream_id, e.attribute)) in \
                    (AttrType.INT, AttrType.LONG):
                return True
            inside = inside or isinstance(e, MathExpr)
            return any(int_in_math(x, inside) for x in expr_children(e))
        if int_in_math(jis.on):
            return _fail("arithmetic on INT/LONG attributes can leave the "
                         "f32 exact-integer range")

        for v in variables_of(jis.on):
            t = types.get((v.stream_id, v.attribute))
            if t is None:
                continue            # resolution errors surface on host
            if t == AttrType.OBJECT:
                return _fail(f"non-numeric attribute '{v.attribute}'")

        import torch

        from ..ops.join_probe import probe_compact, probe_fused
        from ..ops.windowed_agg import kernel_device
        from ..plan.expr_compiler import TorchXP
        from ..plan.wagg_compiler import _EXPR_REJECTIONS
        dev = kernel_device(self.qr.app_runtime.app_ctx.siddhi_context
                            .device)
        xp = TorchXP(dev)
        # device scope: numeric attrs mirror the joined scope's wiring;
        # string/double attrs never reach the program raw — the rewritten
        # condition reads their per-probe lanes (exact i32 columns)
        lane_map = jl.lane_map()
        dev_scope = Scope()
        seen_u: set = set()
        refs = []
        for s in (self.left, self.right):
            side_attrs = {a.name for a in s.definition.attributes}
            entries = [(a.name, a.type)
                       for a in s.definition.attributes
                       if a.type not in (AttrType.STRING,
                                         AttrType.DOUBLE,
                                         AttrType.OBJECT)]
            entries += [(lane, AttrType.INT)
                        for (lane, src) in lane_map
                        if src is None or src in side_attrs]
            for name, t in entries:
                def g(ctx, _r=s.ref, _a=name):
                    return ctx.qualified[(_r, 0)][_a]
                g.lane = (len(refs), name, t)
                dev_scope.add(s.ref, name, t, g)
                if s.stream_id != s.ref:
                    dev_scope.add(s.stream_id, name, t, g)
                if name not in seen_u:
                    seen_u.add(name)
                    dev_scope.add(None, name, t, g)
            keys = [s.ref] + ([s.stream_id] if s.stream_id != s.ref else [])
            refs.append((keys, [name for name, _t in entries]))
        try:
            dev_on = _EC(dev_scope, xp).compile(dev_cond)
        except Exception as e:  # noqa: BLE001 — any compile failure → host
            return _fail(f"condition not device-compilable ({e})")

        def condition(lcols, rcols, nl2, nr2):
            """The on-condition over the [nl2, nr2] cross product, as a
            contiguous bool mask (a torch program)."""
            q = {}
            for (keys, names), cols, expand in (
                    (refs[0], lcols, 0), (refs[1], rcols, 1)):
                cc = {a: (cols[a][:, None] if expand == 0
                          else cols[a][None, :]) for a in names
                      if a in cols}
                for k in keys:
                    q[(k, 0)] = cc
            ctx = EvalCtx({}, torch.zeros((1,), dtype=torch.int32,
                                          device=dev), nl2 * nr2,
                          qualified=q)
            m = torch.broadcast_to(xp.tensor(dev_on.fn(ctx), torch.bool),
                                   (nl2, nr2))
            return m if m.is_contiguous() else m.contiguous()

        def probe_mask(lcols, rcols, nl, nr, nl2, nr2, cap):
            # device-side compaction: the first-cap matching pair indices
            # (row-major == host emission order) + the true count
            return probe_compact(condition(lcols, rcols, nl2, nr2),
                                 nl, nr, cap)

        # run the condition at [1, 1] now, so one the torch program
        # cannot take (functions, scripts, table membership) rejects at
        # build time; a failed copy, allocation or launch raises as it is
        warm = {}
        for (_keys, names), s in ((refs[0], self.left),
                                  (refs[1], self.right)):
            warm[s.side] = {
                nm: torch.zeros((1,), dtype=torch.int32
                                if nm.startswith("__") else torch.float32,
                                device=dev)
                for nm in names}
        try:
            condition(warm["left"], warm["right"], 1, 1)
        except _EXPR_REJECTIONS as e:
            return _fail(f"condition not device-traceable ({e})")
        prog = self._lower_probe(dev_cond, dev_scope, xp)
        if prog is None:
            probe = probe_mask
        else:
            lnames, rnames = prog.lanes

            def probe(lcols, rcols, nl, nr, nl2, nr2, cap):
                return probe_fused(prog, [lcols[a] for a in lnames],
                                   [rcols[a] for a in rnames], nl, nr,
                                   nl2, nr2, cap, dev)
        self.probe_program = prog
        # the mask route for this condition whatever the route: the
        # yardstick a fused probe is timed against
        self.mask_probe = probe_mask
        from ..plan.shapes import shape_registry
        self._probe_jit = shape_registry().jit(
            "join.probe",
            {"lcols": len(refs[0][1]), "rcols": len(refs[1][1])},
            probe)
        self._probe_cap = 4096
        self._probe_device = dev
        self._probe_jit(warm["left"], warm["right"], 0, 0, 1, 1, 4)
        self.device_probe = probe
        # build-time constants of the probe hot path: raw columns the
        # lane encode replaces (strings/doubles) or that never feed
        # the program (objects)
        self._probe_skip = {
            s.side: {a.name for a in s.definition.attributes
                     if a.type in (AttrType.STRING, AttrType.DOUBLE,
                                   AttrType.OBJECT)}
            for s in (self.left, self.right)}
        # condition-referenced attrs per definition: a referenced
        # column that arrives object-typed (outer-join nulls upstream)
        # must force the host mask, not vanish from the feed
        self._cond_attrs = {v.attribute for v in variables_of(jis.on)}
        self._int24 = [
            (s.side, a.name)
            for s in (self.left, self.right)
            for a in s.definition.attributes
            if a.type in (AttrType.INT, AttrType.LONG)]

    def _lower_probe(self, dev_cond, dev_scope, xp):
        """The condition as a fused probe program (``probe_route`` =
        "fused"), or None (``probe_route`` = "mask") with the reason."""
        from ..query_api.definition import AttrType
        from ..plan.expr_compiler import EvalCtx as _Ctx
        from ..plan.expr_compiler import ExprCompiler as _EC
        from ..plan.join_program import Unfused, lower_condition

        def resolve(v):
            side, name, t = dev_scope.resolve(v)[0].lane
            if t not in (AttrType.INT, AttrType.LONG, AttrType.FLOAT):
                raise Unfused(f"'{v.attribute}' is {t.name}")
            return side, name

        ctx0 = _Ctx({}, xp.tensor(np.zeros(1, np.int32)), 1, qualified={})

        def fold(e):
            return _EC(dev_scope, xp).compile(e).fn(ctx0)
        try:
            prog = lower_condition(dev_cond, resolve, fold)
        except Unfused as u:
            self.probe_route = "mask"
            self.probe_route_reason = f"outside the fused class: {u}"
            return None
        self.probe_route = "fused"
        self.probe_route_reason = (
            f"{prog.n_atoms} cross-side atoms, "
            f"{prog.n_slots[0]}+{prog.n_slots[1]} one-sided slots")
        return prog

    def _device_pairs(self, side: JoinSide, data: EventChunk,
                      buf: EventChunk):
        """(sel_data, sel_buf) matching-pair indices in host emission
        order via the device probe, or None when a runtime guard (int
        2^24 exactness) demands the host path."""
        import torch

        from ..ops import join_probe as _join_probe
        dev = self._probe_device
        left_first = side.side == "left"
        chunks = {"left": data if left_first else buf,
                  "right": buf if left_first else data}
        nl, nr = len(chunks["left"]), len(chunks["right"])
        # pow2 padding keeps the JAX package's flat indices (and its
        # retrace bound, log(max shape) per axis)
        nl2 = 1 << max(nl - 1, 0).bit_length()
        nr2 = 1 << max(nr - 1, 0).bit_length()
        # flat indices are int32, as in the JAX package: a larger probe
        # runs in blocks of rb rows, each block's indices offset on the
        # host in int64 (the blocks, in row order, keep row-major order)
        rb = nl2
        while rb > 0 and rb * nr2 > _join_probe.MAX_CELLS:
            rb //= 2
        if rb == 0:
            raise ValueError(
                f"device join probe: {nr} opposite events exceed one "
                f"probe row of int32 indices")
        skip = self._probe_skip
        host = {}
        for sd, c in chunks.items():
            cc = {}
            for a in c.names:
                if a in skip[sd]:
                    continue           # lanes carry strings/doubles
                col = c.columns[a]
                if col.dtype == object:
                    if a in self._cond_attrs:
                        # a numeric column promoted to object (nulls
                        # from an upstream outer join): host mask owns
                        # null-compare semantics
                        return None
                    continue
                if (sd, a) in self._int24 and len(col) \
                        and np.abs(np.asarray(col, np.int64)).max() >= \
                        (1 << 24):
                    return None     # would round on f32 lanes
                cc[a] = np.asarray(col, np.float32)
            host[sd] = cc
        if self._jlanes.any:
            enc = self._jlanes.encode(
                chunks["left"].columns, nl, chunks["right"].columns, nr)
            if enc is None:
                return None     # null strings / NaN doubles → host mask
            for sd, lanes in (("left", enc[0]), ("right", enc[1])):
                for name, arr in lanes.items():
                    host[sd][name] = np.asarray(arr, np.int32)
        cols = {}
        for sd, want in (("left", nl2), ("right", nr2)):
            cc = {}
            for a, v in host[sd].items():
                if len(v) != want:
                    v = np.concatenate([v, np.zeros(want - len(v), v.dtype)])
                cc[a] = torch.from_numpy(v).to(dev)
            cols[sd] = cc
        parts = []
        for i0 in range(0, max(nl, 1), rb):
            lcols = cols["left"] if rb == nl2 else \
                {a: v[i0:i0 + rb] for a, v in cols["left"].items()}
            nlb = min(rb, nl - i0)
            while True:
                idx, count = self._probe_jit(lcols, cols["right"], nlb, nr,
                                             rb, nr2, self._probe_cap)
                count = int(count)
                if count <= self._probe_cap:
                    break
                # overflow: grow the compaction buffer and re-run —
                # results stay exact
                cap = self._probe_cap
                while cap < count:
                    cap *= 2
                self._probe_cap = cap
            parts.append(idx[:count].cpu().numpy().astype(np.int64)
                         + i0 * nr2)
        idx = parts[0] if len(parts) == 1 else np.concatenate(parts)
        li, rj = idx // nr2, idx % nr2
        if not left_first:
            li, rj = rj, li
            order = np.lexsort((rj, li))    # host order: data-major
            li, rj = li[order], rj[order]
        return li, rj

    # ------------------------------------------------------------ event flow

    def on_arrival(self, side: JoinSide, chunk: EventChunk):
        with self.qr.lock:
            opposite = self.right if side.side == "left" else self.left
            chunk = side.apply_filters(chunk)
            if chunk.is_empty:
                return
            data = chunk.only(CURRENT)
            triggers = (self.trigger == EventTrigger.ALL or
                        (self.trigger == EventTrigger.LEFT and
                         side.side == "left") or
                        (self.trigger == EventTrigger.RIGHT and
                         side.side == "right"))
            # 1. arriving CURRENT events probe the opposite buffer
            if triggers and not data.is_empty:
                self._probe_and_emit(side, opposite, data, CURRENT)
            # 1b. a named-window side's publication carries its own
            # EXPIRED rows (shared buffer already applied) — probe them
            # as EXPIRED joins (reference Window.java → JoinProcessor)
            if side.is_named_window and triggers:
                expired = chunk.only(EXPIRED)
                if not expired.is_empty:
                    self._probe_and_emit(side, opposite,
                                         expired.with_types(CURRENT),
                                         EXPIRED)
            # 2. events enter this side's window; expirees probe as EXPIRED
            if side.window is not None:
                side.window.process(chunk)
                for out in side.collector.drain():
                    if not triggers:
                        continue
                    expired = out.only(EXPIRED)
                    if not expired.is_empty:
                        self._probe_and_emit(side, opposite,
                                             expired.with_types(CURRENT),
                                             EXPIRED)

    def _probe_and_emit(self, side: JoinSide, opposite: JoinSide,
                        data: EventChunk, emit_type: int):
        n = len(data)
        cc = self._table_conds.get(opposite.side)
        if self.agg_runtime is not None and opposite.is_aggregation:
            if self._agg_per_row and n > 1:
                # within/per read the probing rows' attributes → each row
                # may target a different range/duration
                for i in range(n):
                    self._probe_and_emit(side, opposite,
                                         data.slice(i, i + 1), emit_type)
                return
            buf = self.agg_runtime.find_chunk(self.jis.within, self.jis.per,
                                              data)
        elif cc is not None:
            from .record_table import AbstractRecordTable
            table = self.qr.app_runtime.table_of(opposite.stream_id)
            if not isinstance(table, AbstractRecordTable):
                # indexed table probe per arriving row (hash lookup +
                # residual); snapshot and probe under ONE lock acquisition
                # so the probed row indices are valid for the snapshot
                with table.lock:
                    buf = table.all_rows_chunk()
                    rows = [table._match_rows(cc, data, i)
                            for i in range(n)] if len(buf) else []
            else:
                # record table: condition pushdown, one native store probe
                # per arriving row (≙ AbstractRecordTable.find with the
                # compiled condition's per-probe parameters).  One lock
                # acquisition for the whole chunk so a concurrent
                # insert/delete cannot yield an inconsistent join view
                # across rows (RLock: find()'s nested acquire is safe)
                with table.lock:
                    chunks = [table.find(cc, data, i) for i in range(n)]
                buf = EventChunk.concat(chunks)
                rows, off = [], 0
                for c in chunks:
                    rows.append(np.arange(off, off + len(c)))
                    off += len(c)
        else:
            buf = opposite.buffer_chunk()
        m = 0 if buf is None or buf.is_empty else len(buf)
        outer_this = (
            self.join_type == JoinType.FULL_OUTER or
            (self.join_type == JoinType.LEFT_OUTER and side.side == "left") or
            (self.join_type == JoinType.RIGHT_OUTER and side.side == "right"))

        if cc is not None and m > 0:
            sel_l = np.concatenate(
                [np.full(len(r), i, np.int64) for i, r in enumerate(rows)]
                or [np.empty(0, np.int64)])
            sel_r = np.concatenate(rows) if rows \
                else np.empty(0, np.int64)
            if outer_this:
                miss = np.asarray([i for i, r in enumerate(rows)
                                   if len(r) == 0], np.int64)
                sel_l = np.concatenate([sel_l, miss])
                sel_r = np.concatenate([sel_r, np.full(len(miss), -1)])
                order = np.argsort(sel_l, kind="stable")
                sel_l, sel_r = sel_l[order], sel_r[order]
            if len(sel_l):
                self._emit(side, data, opposite, buf, sel_l, sel_r,
                           emit_type)
            return

        if m == 0:
            if outer_this:
                self._emit(side, data, opposite, None,
                           np.arange(n), np.full(n, -1), emit_type)
            return

        # cross product: row i of data × row j of buffer
        sel = None
        if self.device_probe is not None:
            sel = self._device_pairs(side, data, buf)
        if sel is not None:
            sel_l, sel_r = sel
        else:
            li = np.repeat(np.arange(n), m)
            rj = np.tile(np.arange(m), n)
            if self.on is not None:
                qualified = {}
                for s, c, idx in ((side, data, li), (opposite, buf, rj)):
                    cols = {a: c.columns[a][idx] for a in c.names}
                    qualified[(s.ref, 0)] = cols
                    if s.stream_id != s.ref:
                        qualified[(s.stream_id, 0)] = cols
                ctx = EvalCtx({}, data.timestamps[li], n * m,
                              qualified=qualified)
                mask = np.asarray(self.on.fn(ctx), bool)
                if mask.ndim == 0:
                    mask = np.full(n * m, bool(mask))
            else:
                mask = np.ones(n * m, bool)
            sel_l, sel_r = li[mask], rj[mask]
        if outer_this:
            matched = np.zeros(n, bool)
            matched[sel_l] = True
            miss = np.flatnonzero(~matched)
            sel_l = np.concatenate([sel_l, miss])
            sel_r = np.concatenate([sel_r, np.full(len(miss), -1)])
            order = np.argsort(sel_l, kind="stable")
            sel_l, sel_r = sel_l[order], sel_r[order]
        if len(sel_l) == 0:
            return
        self._emit(side, data, opposite, buf, sel_l, sel_r, emit_type)

    def _emit(self, side: JoinSide, data: EventChunk, opposite: JoinSide,
              buf: Optional[EventChunk], sel_l: np.ndarray,
              sel_r: np.ndarray, emit_type: int):
        k = len(sel_l)
        qualified = {}
        flat: Dict[str, np.ndarray] = {}

        def null_col(length):
            return np.full(length, None, object)

        for s, c, idx in ((side, data, sel_l), (opposite, buf, sel_r)):
            cols = {}
            for a in s.definition.attribute_names:
                if c is None:
                    cols[a] = null_col(k)
                else:
                    vals = c.columns[a][np.maximum(idx, 0)]
                    if (idx < 0).any():
                        vals = vals.astype(object)
                        vals[idx < 0] = None
                    cols[a] = vals
            qualified[(s.ref, 0)] = cols
            if s.stream_id != s.ref:
                qualified[(s.stream_id, 0)] = cols
        # flattened union columns (left side wins collisions iff it defined
        # the union attr first)
        for a in self.union_def.attribute_names:
            for s in (self.left, self.right):
                if a in s.definition.attribute_names:
                    flat[a] = qualified[(s.ref, 0)][a]
                    break
        ts = data.timestamps[sel_l]
        out = EventChunk(self.union_def.attribute_names, ts,
                         np.full(k, emit_type, np.int8), flat, qualified)
        self.head.process(out)
