"""QueryRuntime: wires input → handler chain → selector → rate limiter → output.

(reference: query/QueryRuntime.java + util/parser/QueryParser.java:83-249 —
input-stream runtime construction, selector, lock strategy, rate limiter and
output callback; query/input/ProcessStreamReceiver.java junction entry.)
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..plan.expr_compiler import ExprCompiler, Scope
from ..query_api import (Filter, InsertIntoStream, JoinInputStream, Query,
                         SingleInputStream, StateInputStream,
                         StreamFunctionHandler, WindowHandler)
from ..query_api.definition import StreamDefinition
from ..query_api.query import DeleteStream, UpdateOrInsertStream, UpdateStream
from ..utils.errors import SiddhiAppCreationError
from .event import EventChunk
from .output import (DeleteTableCallback, InsertIntoStreamCallback,
                     InsertIntoTableCallback, InsertIntoWindowCallback,
                     OutputCallbackProcessor, ReturnCallback,
                     UpdateOrInsertTableCallback, UpdateTableCallback)
from .processor import FilterProcessor, LogStreamProcessor, Processor
from .ratelimit import build_rate_limiter
from .selector import QuerySelector
from .window import WindowProcessor, create_window_processor


def _expr_has_aggregate(e) -> bool:
    """Walk an expression IR tree for aggregator AttributeFunctions."""
    from dataclasses import fields, is_dataclass

    from ..query_api.expression import AttributeFunction, Expression
    from .aggregator import is_aggregator
    if e is None:
        return False
    if isinstance(e, AttributeFunction) and \
            is_aggregator(e.namespace, e.name, len(e.args)):
        return True
    if isinstance(e, (list, tuple)):
        return any(_expr_has_aggregate(x) for x in e)
    if is_dataclass(e) and isinstance(e, Expression):
        return any(_expr_has_aggregate(getattr(e, f.name))
                   for f in fields(e))
    return False


def _selector_has_aggregates(selector) -> bool:
    """IR-level aggregate detection (works on both the host path, where a
    QuerySelector exists, and the device path, where the select clause is
    folded into the kernel) — drives snapshot-limiter dispatch (reference
    WrappedSnapshotOutputRateLimiter.init's aggregateAttributePositionList)."""
    return any(_expr_has_aggregate(oa.expr) for oa in selector.attributes)


class ProcessStreamReceiver:
    """Junction entry point for a query; holds the query lock
    (reference query/input/ProcessStreamReceiver.java; debugger check at the
    IN terminal :103-106)."""

    def __init__(self, first: Processor, lock: threading.RLock,
                 latency_tracker=None, query_name: str = "",
                 app_ctx=None):
        self.first = first
        self.lock = lock
        self.latency_tracker = latency_tracker
        self.query_name = query_name
        self.app_ctx = app_ctx

    def flush(self):
        """Retire pipelined device work held anywhere in the processor
        chain (device ingress heads, mid-chain device windows) under the
        query lock — junction idle/drain hook."""
        p = self.first
        while p is not None:
            f = getattr(p, "flush", None)
            if f is not None:
                with self.lock:
                    f()
            p = getattr(p, "next", None)

    def receive_chunk(self, chunk: EventChunk):
        dbg = getattr(self.app_ctx, "debugger", None) if self.app_ctx else None
        if dbg is not None:
            dbg.check(self.query_name, dbg.IN, chunk)
        with self.lock:
            if self.latency_tracker is not None:
                self.latency_tracker.mark_in()
            try:
                self.first.process(chunk)
            finally:
                if self.latency_tracker is not None:
                    self.latency_tracker.mark_out()


class QueryRuntime:
    def __init__(self, query: Query, app_runtime, query_name: str,
                 partition_key: Optional[str] = None,
                 device_key_executors: Optional[Dict] = None):
        self.query = query
        self.app_runtime = app_runtime
        self.name = query_name
        self.partition_key = partition_key
        self.lock = threading.RLock()
        self.output_processor: Optional[OutputCallbackProcessor] = None
        self.selector: Optional[QuerySelector] = None
        self.windows: List[WindowProcessor] = []
        self.receivers: Dict[str, ProcessStreamReceiver] = {}
        self.state_runtime = None          # set for pattern/sequence queries
        self.join_runtime = None
        self.device_runtime = None         # set when the planner picked TPU
        self.backend = "host"
        self.backend_reason: Optional[str] = None
        self._device_key_executors = device_key_executors
        self.output_definition: Optional[StreamDefinition] = None
        self._build()

    # ------------------------------------------------------------ build

    @property
    def selection_route(self) -> Optional[Dict]:
        """Where the query's selection tail (having / order-by / limit /
        offset) executes.  None when the query has no selection tail;
        ``{"backend": "device", "sig": ...}`` when plan/select_compiler
        lowered it into the egress kernel (ops/select.py);
        ``{"backend": "host", "reason": ...}`` for the documented
        host-QuerySelector fallback (value-identical, per-emission
        Python).  Surfaced by service/rest.py stats and
        tools/t1_report.py coverage artifacts."""
        from ..plan.select_compiler import (classify_selection,
                                            selection_active)
        if not selection_active(self.query.selector):
            return None
        route = getattr(self.device_runtime, "selection_route", None)
        if route is not None:
            return dict(route)
        # host route: the static classifier gives the atom-level blocking
        # reason even when another plan stage (e.g. the dwin hybrid)
        # overwrote backend_reason
        reason = None
        app = getattr(self.app_runtime, "app", None)
        ins = self.query.input_stream
        if app is not None and isinstance(ins, SingleInputStream):
            d = app.stream_definitions.get(ins.stream_id)
            attr_types = {a.name: a.type for a in d.attributes} \
                if d is not None else {}
            dec = classify_selection(
                self.query, attr_types,
                in_partition=(self.partition_key is not None or
                              self._device_key_executors is not None))
            if dec.active and not dec.device:
                reason = dec.reason
        return {"backend": "host",
                "reason": reason or self.backend_reason or
                "host query path"}

    def _expr_compiler_factory(self) -> Callable[[Scope], ExprCompiler]:
        app = self.app_runtime
        return lambda scope: ExprCompiler(
            scope, np, app.app_ctx.script_functions, app.extension_registry,
            tables=app.tables)

    def _build(self):
        q = self.query
        app = self.app_runtime
        factory = self._expr_compiler_factory()

        if isinstance(q.input_stream, SingleInputStream):
            if self._device_key_executors is not None:
                # keyed (partition) mode: device or raise, as below.
                # The specialized window-ring path (K1 for a length
                # window, K6 for time/externalTime; group == partition
                # key, float values) is tried first, as in the JAX
                # package; the grouped-agg step (K7) takes the rest:
                # finer group-bys, running aggregates, INT/LONG values
                # and selection tails
                from ..plan.planner import (DeviceGroupedAggRuntime,
                                            DeviceWindowedAggRuntime)
                try:
                    self.device_runtime = DeviceWindowedAggRuntime(
                        self, q.input_stream, factory,
                        self._device_key_executors)
                except SiddhiAppCreationError:
                    self.device_runtime = DeviceGroupedAggRuntime(
                        self, q.input_stream, factory,
                        key_executors=self._device_key_executors)
                self.backend = "device"
                return
            dev, reason = None, "inside host partition clone"
            if self.partition_key is None and \
                    getattr(app, "app", None) is not None:
                from ..plan.planner import plan_single_runtime
                dev, reason = plan_single_runtime(self, q.input_stream,
                                                  factory)
            if dev is not None:
                self.device_runtime = dev
                self.backend = "device"
                return
            self.backend_reason = reason
            self._build_single(q.input_stream, factory)
        elif isinstance(q.input_stream, JoinInputStream):
            from .join import JoinRuntime
            self.join_runtime = JoinRuntime(self, q.input_stream, factory)
            # the on-condition probe — the join's per-event hot loop — may
            # have compiled to the device; buffers/windows stay host
            if self.join_runtime.device_probe is not None:
                self.backend = "device"
            else:
                self.backend_reason = \
                    self.join_runtime.device_probe_reason
        elif isinstance(q.input_stream, StateInputStream):
            if self._device_key_executors is not None:
                # keyed (partition) mode: device or raise — the caller
                # (PartitionRuntime) owns the host fallback, because a host
                # fallback HERE would wire an unpartitioned state runtime
                from ..plan.planner import DevicePatternRuntime
                self.device_runtime = DevicePatternRuntime(
                    self, q.input_stream, factory,
                    key_executors=self._device_key_executors)
                self.backend = "device"
                return
            dev, reason = None, "inside host partition clone"
            if self.partition_key is None and \
                    getattr(app, "app", None) is not None:
                from ..plan.planner import plan_state_runtime
                dev, reason = plan_state_runtime(self, q.input_stream,
                                                 factory)
            if dev is not None:
                self.device_runtime = dev
                self.backend = "device"
            else:
                self.backend_reason = reason
                from .pattern import StateStreamRuntime
                self.state_runtime = StateStreamRuntime(self, q.input_stream,
                                                        factory)
        else:
            raise SiddhiAppCreationError(
                f"Unsupported input stream {type(q.input_stream).__name__}")

    def _build_single(self, s: SingleInputStream, factory):
        app = self.app_runtime
        definition = app.definition_of(s.stream_id, s.is_inner, s.is_fault)
        scope = Scope()
        scope.add_primary(s.stream_id, s.stream_ref, definition)

        chain: List[Processor] = []
        compiler = factory(scope)
        for h in s.handlers:
            if isinstance(h, Filter):
                chain.append(FilterProcessor(compiler.compile(h.expr)))
            elif isinstance(h, WindowHandler):
                wp = self._try_device_window(h, definition, compiler)
                if wp is None:
                    wp = create_window_processor(
                        h.name, h.params, app.app_ctx,
                        definition.attribute_names,
                        lambda e: compiler.compile(e),
                        namespace=h.namespace or "",
                        extension_registry=app.extension_registry)
                wp.lock = self.lock
                self.windows.append(wp)
                chain.append(wp)
            elif isinstance(h, StreamFunctionHandler):
                chain.append(self._make_stream_function(h, compiler))
        self._finish_chain(chain, scope, definition, factory)
        receiver = ProcessStreamReceiver(
            self._chain_head(chain), self.lock,
            app.latency_tracker_for(self.name), self.name, app.app_ctx)
        if app.has_named_window(s.stream_id):
            app.named_window_of(s.stream_id).subscribe(receiver)
        else:
            junction = app.junction_of(s.stream_id, s.is_inner, s.is_fault,
                                       self.partition_key)
            junction.subscribe(receiver)
        self.receivers[s.stream_id] = receiver

    def _try_device_window(self, h, definition, compiler):
        """Device window state (plan/dwin_compiler) in place of the host
        window processor when the kind/payload types have device lanes —
        the buffer of record and all eviction/flush math move to the
        device kernel; the selector stays host (hybrid recorded in
        docs/device_coverage.md).  Host partition clones keep host
        windows (one tiny device state per key would serialize)."""
        app = self.app_runtime
        if self.partition_key is not None or \
                getattr(app, "app", None) is None:
            return None
        from ..plan.dwin_compiler import (DEVICE_KINDS,
                                          DeviceWindowProcessor)
        from ..plan.planner import engine_mode
        mode = engine_mode(app.app)
        if mode == "host":
            return None
        # SiddhiQL's 'hoping' spelling maps onto the device hopping kernel
        hname = h.name.lower()
        if hname == "hoping":
            hname = "hopping"
        kind = next((k for k in DEVICE_KINDS
                     if k.lower() == hname), None) \
            if not h.namespace else None
        if kind is None:
            if mode == "device":
                # engine('device') is strict: no silent host fallback
                label = (f"#{h.namespace}:{h.name}" if h.namespace
                         else f"#window.{h.name}")
                raise SiddhiAppCreationError(
                    f"device window path: {label} has no device kernel")
            return None
        from ..plan.pipeline import resolve_depth
        try:
            depth = resolve_depth(app.app, [app.junction_of(definition.id)])
        except Exception:      # noqa: BLE001 — inner/fault stream ids
            depth = 0
        try:
            wp = DeviceWindowProcessor(app.app_ctx, definition, kind,
                                       h.params, compiler.compile,
                                       pipeline_depth=depth)
        except SiddhiAppCreationError:
            if mode == "device":
                raise
            return None
        # NOTE: dwin egress is deliberately NOT routed through the app's
        # EgressFuser.  Window steps (timer ticks especially) dispatch and
        # read back synchronously, so there is never a second runtime's
        # buffer to share the slab with — fusing would only add the
        # seal/rotate device ops per tick.  Fusion covers the per-block
        # pattern/filter/wagg/gagg egress (see plan/planner.py).
        self.backend = "device"
        self.backend_reason = ("hybrid: window state/evictions on device "
                               "(dwin kernel), selector host")
        return wp

    def _make_stream_function(self, h: StreamFunctionHandler, compiler):
        app = self.app_runtime
        low = h.name.lower()
        params = [compiler.compile(p) for p in h.params]
        if (h.namespace or "") == "" and low == "log":
            return LogStreamProcessor(params)
        ext = app.extension_registry.find_stream_processor(
            h.namespace or "", h.name) if app.extension_registry else None
        if ext is not None:
            return ext(params)
        raise SiddhiAppCreationError(
            f"Unknown stream function '#{h.name}'")

    def _chain_head(self, chain: List[Processor]) -> Processor:
        """Link chain → selector → rate limiter → output; return head."""
        full = chain + [self.selector, self.rate_limiter, self.output_processor]
        for a, b in zip(full, full[1:]):
            a.next = b
        return full[0]

    def _finish_chain(self, chain, scope, input_definition, factory):
        """Create selector / rate limiter / output (shared by all input kinds).
        Must be called before _chain_head."""
        q = self.query
        app = self.app_runtime
        target = getattr(q.output_stream, "target_id", "") or self.name
        self.selector = QuerySelector(q.selector, scope, input_definition,
                                      factory, output_id=target)
        self.output_definition = self.selector.output_definition
        if isinstance(q.input_stream, SingleInputStream):
            # table on/set expressions may qualify by the source stream name
            self.output_definition.source_alias = \
                q.input_stream.stream_ref or q.input_stream.stream_id
        self._finish_output_tail(factory)

    def _finish_output_tail(self, factory):
        """Rate limiter + output callback (shared by host and device
        chains); requires self.output_definition."""
        q = self.query
        app = self.app_runtime
        group_names = [v.attribute for v in q.selector.group_by]
        self.rate_limiter = build_rate_limiter(
            q.output_rate, app.app_ctx, group_names,
            windowed=self._query_is_windowed(q),
            has_aggregates=_selector_has_aggregates(q.selector))
        self.output_processor = self._make_output(q, factory)
        self.output_processor.query_name = self.name
        self.output_processor.app_ctx = app.app_ctx

    def _query_is_windowed(self, q: Query) -> bool:
        """Reference QueryParser marks a query 'windowed' when its (or either
        join side's) handler chain contains a window, or it reads a named
        window — drives snapshot-limiter dispatch
        (WrappedSnapshotOutputRateLimiter.java:86)."""
        app = self.app_runtime

        def single(s) -> bool:
            if not isinstance(s, SingleInputStream):
                return False
            if any(isinstance(h, WindowHandler) for h in s.handlers):
                return True
            return app.has_named_window(s.stream_id)

        ins = q.input_stream
        if isinstance(ins, JoinInputStream):
            return single(ins.left) or single(ins.right)
        return single(ins)

    def _finish_device_chain(self, output_definition: StreamDefinition,
                             factory):
        """Output tail for a device-compiled query (the select clause is
        folded into the device kernel's capture decode); returns the chain
        head the device runtime feeds."""
        self.output_definition = output_definition
        self._finish_output_tail(factory)
        self.rate_limiter.next = self.output_processor
        return self.rate_limiter

    def _make_output(self, q: Query, factory) -> OutputCallbackProcessor:
        app = self.app_runtime
        out = q.output_stream
        ef = out.events_for
        if isinstance(out, (DeleteStream, UpdateStream, UpdateOrInsertStream)) \
                and app.has_table(out.target_id):
            table = app.table_of(out.target_id)
            cc = table.compile_condition(out.on, self.output_definition,
                                         factory)
            if isinstance(out, DeleteStream):
                return DeleteTableCallback(table, cc, ef)
            cset = table.compile_set(out.set_assignments,
                                     self.output_definition, factory)
            if isinstance(out, UpdateOrInsertStream):
                return UpdateOrInsertTableCallback(table, cc, cset, ef)
            return UpdateTableCallback(table, cc, cset, ef)
        if isinstance(out, InsertIntoStream):
            if app.has_table(out.target_id):
                return InsertIntoTableCallback(app.table_of(out.target_id), ef)
            if app.has_named_window(out.target_id):
                return InsertIntoWindowCallback(
                    app.named_window_of(out.target_id), ef)
            junction = app.junction_of(out.target_id, out.is_inner,
                                       out.is_fault, self.partition_key,
                                       create_with=self.output_definition)
            target_def = junction.definition
            self._validate_output(target_def)
            return InsertIntoStreamCallback(junction, target_def, ef)
        return ReturnCallback(ef)

    def _validate_output(self, target_def: StreamDefinition):
        out_names = self.output_definition.attribute_names
        if len(out_names) != len(target_def.attributes):
            raise SiddhiAppCreationError(
                f"Query '{self.name}' output ({out_names}) does not match "
                f"stream '{target_def.id}' ({target_def.attribute_names})")

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self.state_runtime is not None:
            self.state_runtime.start()
        if self.device_runtime is not None and \
                hasattr(self.device_runtime, "start"):
            self.device_runtime.start()

    # ------------------------------------------------------------ callbacks

    def add_callback(self, cb):
        self.output_processor.query_callbacks.append(cb)

    # ------------------------------------------------------------ state

    def stateful_elements(self):
        """(element_id, obj) pairs registered with the snapshot service."""
        out = []
        if self.selector is not None:
            out.append((f"{self.name}:selector", self.selector))
        for i, w in enumerate(self.windows):
            out.append((f"{self.name}:window:{i}", w))
        if self.state_runtime is not None:
            out.append((f"{self.name}:state", self.state_runtime))
        if self.device_runtime is not None:
            out.append((f"{self.name}:state", self.device_runtime))
        if self.join_runtime is not None:
            for i, w in enumerate(self.join_runtime.windows):
                out.append((f"{self.name}:join:{i}", w))
        return out
