"""SiddhiManager + SiddhiAppRuntime — the top-level API.

(reference: SiddhiManager.java:46-253 — create/validate runtimes, persistence
stores, extensions; SiddhiAppRuntime.java:93-804 — per-app isolate: definition
maps, junctions, queries, partitions, lifecycle, persist/restore, store
queries, playback; util/SiddhiAppRuntimeBuilder.java — junction/table/window/
trigger wiring; util/parser/SiddhiAppParser.java — @app annotations.)
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..compiler import SiddhiCompiler
from ..plan.expr_compiler import ExprCompiler, Scope
from ..query_api import (AttrType, Query, SiddhiApp, StreamDefinition,
                         find_annotation)
from ..utils.errors import (DefinitionNotExistError, NoPersistenceStoreError,
                            SiddhiAppCreationError)
from ..utils.extension import ExtensionRegistry
from .context import SiddhiAppContext, SiddhiContext
from .named_window import NamedWindow
from .query_runtime import QueryRuntime
from .snapshot import PersistenceStore, SnapshotService
from .statistics import StatisticsManager
from .stream import InputHandler, QueryCallback, StreamCallback, StreamJunction
from .table import InMemoryTable
from .trigger import TriggerRuntime, trigger_stream_definition

log = logging.getLogger(__name__)


class ScriptFunction:
    """`define function f[python] return T { body }` — compiled python script
    (reference: function/Script SPI via JSR-223; here native python)."""

    def __init__(self, fn_def):
        self.fn_def = fn_def
        body = fn_def.body.strip()
        if fn_def.language not in ("python", "py"):
            raise SiddhiAppCreationError(
                f"Unsupported script language '{fn_def.language}' "
                f"(python only)")
        ns: Dict[str, Any] = {}
        if "\n" in body or body.startswith("return"):
            lines = body.split("\n")
            src = "def __fn__(data):\n" + "\n".join(
                "    " + ln for ln in lines)
        else:
            src = f"def __fn__(data):\n    return ({body})"
        exec(src, ns)  # noqa: S102 — user-defined function body, like the
        # reference's JSR-223 script engines
        self._fn = ns["__fn__"]

    def compile_call(self, compiled_args):
        from ..plan.expr_compiler import CompiledExpr
        from .event import dtype_for
        rt = self.fn_def.return_type or AttrType.OBJECT
        dt = dtype_for(rt)
        fn_ = self._fn

        def fn(ctx):
            n = ctx.n
            vals = []
            for a in compiled_args:
                v = a.fn(ctx)
                if isinstance(v, np.ndarray) and v.ndim > 0:
                    vals.append(v)
                else:
                    vals.append(np.full(n, v))
            out = np.empty(n, dt if dt is object else dt)
            for i in range(n):
                out[i] = fn_([v[i] for v in vals])
            return out
        from ..plan.expr_compiler import CompiledExpr
        return CompiledExpr(fn, rt)


class SiddhiAppRuntime:
    #: AnalysisResult from the compile-time semantic analyzer (set by
    #: SiddhiManager.create_siddhi_app_runtime; None for runtimes built
    #: directly).  Surfaced by GET /stats on the REST service.
    analysis = None
    #: StateSchemaReport over the registered snapshot elements (set by
    #: attach_schema_analysis at creation; None for runtimes built
    #: directly).  Also rides rt.analysis.schema and GET /stats.
    state_schema = None

    def __init__(self, app: SiddhiApp, siddhi_context: SiddhiContext,
                 app_string: Optional[str] = None):
        self.app = app
        self.siddhi_context = siddhi_context
        name = app.name
        if name is None:
            # stable content-derived default so persistence revisions of an
            # unnamed app resolve across restarts
            import hashlib
            basis = app_string if app_string else repr(app)
            name = "app_" + hashlib.sha1(basis.encode()).hexdigest()[:8]
        self.name = name
        self.app_ctx = SiddhiAppContext(siddhi_context, name)
        self.app_ctx.runtime = self
        self.extension_registry: ExtensionRegistry = getattr(
            siddhi_context, "extension_registry", None) or ExtensionRegistry()
        for k, v in siddhi_context.extensions.items():
            self.extension_registry.register(k, v)

        self.stream_definitions: Dict[str, StreamDefinition] = {}
        self.junctions: Dict[str, StreamJunction] = {}
        self.tables: Dict[str, InMemoryTable] = {}
        self.named_windows: Dict[str, NamedWindow] = {}
        self.aggregations: Dict[str, Any] = {}
        self.triggers: List[TriggerRuntime] = []
        self.query_runtimes: Dict[str, QueryRuntime] = {}
        self.partition_runtimes: List[Any] = []
        self.input_handlers: Dict[str, InputHandler] = {}
        self.sources: List[Any] = []
        self.sinks: List[Any] = []
        self._started = False
        # bounded LRU of compiled store-query runtimes (reference
        # SiddhiAppRuntime.query:280-316 uses a size-capped LRU map)
        from collections import OrderedDict
        self._store_query_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._store_query_cache_size = 50

        # resilience: always-on counters, optional error store and
        # periodic checkpointing (see core/resilience.py)
        from .resilience import ResilienceMetrics
        self.resilience_metrics = ResilienceMetrics(self.name)
        self.error_store = getattr(siddhi_context, "error_store", None)

        # ingest protection: always-on counters plus (unless the
        # SIDDHI_TPU_INGEST_GUARD kill switch is off) the dispatch-storm
        # watchdog riding every scheduler fire (see core/overload.py)
        from .overload import DispatchWatchdog, IngestMetrics, guard_enabled
        self.ingest_metrics = IngestMetrics(self.name)
        self.watchdog = None
        if guard_enabled():
            self.watchdog = DispatchWatchdog(self.name,
                                             metrics=self.ingest_metrics)
            self.watchdog.runtime = self
            self.app_ctx.watchdog = self.watchdog
            self.app_ctx.scheduler.watchdog = self.watchdog
        self.checkpoint_scheduler = None
        self.recovered_revision: Optional[str] = None

        self.snapshot_service = SnapshotService(self.app_ctx)
        self.app_ctx.snapshot_service = self.snapshot_service
        self.snapshot_service.pre_snapshot = self.flush
        self._parse_app_annotations()
        self._build()

    # ------------------------------------------------------------ build

    def _parse_app_annotations(self):
        ann = find_annotation(self.app.annotations, "app:playback")
        if ann is None:
            ann = find_annotation(self.app.annotations, "playback")
        if ann is not None:
            idle = ann.get("idle.time")
            inc = ann.get("increment")
            self.app_ctx.playback = True
            self.app_ctx.timestamp_generator.enable_playback(
                _parse_time_str(idle) if idle else None,
                _parse_time_str(inc) if inc else None)
        stats = find_annotation(self.app.annotations, "app:statistics")
        if stats is None:
            stats = find_annotation(self.app.annotations, "statistics")
        reporter, interval, enabled = "console", 60, False
        tracing_on = False
        telemetry_on = False
        if stats is not None:
            reporter = stats.get("reporter", "console")
            interval = int(stats.get("interval", "60"))
            enable_attr = stats.get("enable")
            pos = stats.positional()
            enabled = True
            if enable_attr is not None:
                enabled = str(enable_attr).lower() == "true"
            elif pos and str(pos[0]).lower() == "false":
                enabled = False
            tracing_on = str(stats.get("tracing", "false")).lower() == "true"
            telemetry_on = \
                str(stats.get("telemetry", "false")).lower() == "true"
        self.app_ctx.statistics_manager = StatisticsManager(
            self.name, reporter, interval)
        self.app_ctx.stats_enabled = enabled
        # @app:statistics(telemetry='true') — opt-in on-device NFA/window
        # state telemetry; compilers read the flag off app_ctx, the device
        # runtimes push host copies into the DeviceTelemetry holder
        self.app_ctx.telemetry_enabled = telemetry_on
        self.device_telemetry = None
        if telemetry_on:
            from .statistics import DeviceTelemetry
            self.device_telemetry = DeviceTelemetry(self.name)
        if enabled:
            # kernel profiling rides @app:statistics: the per-kernel
            # compile/device-time gauges feed the same /metrics surface
            from .profiling import profiler
            profiler().enable()
        if tracing_on:
            from .tracing import tracer
            tracer().enable()
        # @app:persist(interval='30 sec', incremental='true') — periodic
        # checkpointing through the app scheduler (playback-aware)
        pers = find_annotation(self.app.annotations, "app:persist")
        if pers is None:
            pers = find_annotation(self.app.annotations, "persist")
        if pers is not None:
            pos = pers.positional()
            interval = pers.get("interval") or (pos[0] if pos else "30 sec")
            inc = str(pers.get("incremental", "false")).lower() == "true"
            from .resilience import CheckpointScheduler
            self.checkpoint_scheduler = CheckpointScheduler(
                self, _parse_time_str(str(interval)), incremental=inc)
            self.checkpoint_scheduler.metrics = self.resilience_metrics
        # @app:errorStore(type='memory'|'sqlite') — app-level error store
        # for @OnError(action='STORE') and sink-exhausted events
        es = find_annotation(self.app.annotations, "app:errorstore")
        if es is None:
            es = find_annotation(self.app.annotations, "errorstore")
        if es is not None:
            etype = (es.get("type", "memory") or "memory").lower()
            if etype in ("memory", "inmemory"):
                from .resilience import InMemoryErrorStore
                self.error_store = InMemoryErrorStore(
                    capacity=int(es.get("capacity", "10000")))
            elif etype == "sqlite":
                from ..stores.sqlite import SqliteErrorStore
                self.error_store = SqliteErrorStore(
                    es.get("database", ":memory:"))
            else:
                raise SiddhiAppCreationError(
                    f"Unknown error store type '{etype}'")
        # @app:slo(latency.p99.ms='...', lag.ms='...') — per-app latency/
        # lag objectives for the always-on ledger (core/ledger.py):
        # burn-rate gauges on /metrics, /health degradation and an SLO001
        # flight bundle on sustained breach.  Parsed tolerantly like the
        # @Async overload options; the analyzer's SA07x diagnostics flag
        # malformed values
        self.slo_config = None
        slo = find_annotation(self.app.annotations, "app:slo")
        if slo is None:
            slo = find_annotation(self.app.annotations, "slo")
        if slo is not None:
            from .ledger import SloConfig, ledger
            self.slo_config = SloConfig.from_annotation(slo)
            ledger().register_slo(self.name, self.slo_config)
        # @app:quota(rate='1000', burst='2000') — fair-share ingest
        # admission for multi-tenant deployments (core/overload.py):
        # a token-bucket budget enforced at the InputHandler boundary,
        # layered UNDER the per-stream @Async overload policies.  Parsed
        # here (before _build) so junctions and input handlers see the
        # registered quota at construction
        self.quota = None
        qa = find_annotation(self.app.annotations, "app:quota")
        if qa is None:
            qa = find_annotation(self.app.annotations, "quota")
        if qa is not None:
            from .overload import TenantQuota, fair_share
            self.quota = TenantQuota.from_annotation(self.name, qa)
            if self.quota is not None:
                fair_share().register(self.quota)

    def _build(self):
        from .source_sink import attach_sources_and_sinks

        app = self.app
        # 1. streams → junctions
        for sid, d in app.stream_definitions.items():
            self.stream_definitions[sid] = d
            self._make_junction(sid, d)
        # 2. tables
        for tid, td in app.table_definitions.items():
            store_ann = find_annotation(td.annotations, "store")
            table = None
            if store_ann is not None and self.extension_registry is not None:
                store_cls = self.extension_registry.find_store(
                    store_ann.get("type", ""))
                if store_cls is not None:
                    table = store_cls(td, store_ann)
            # `is None`, not truthiness — an empty store has __len__() == 0
            self.tables[tid] = InMemoryTable(td) if table is None else table
            self.snapshot_service.register(f"table:{tid}", self.tables[tid])
        # 3. named windows
        for wid, wd in app.window_definitions.items():
            scope = Scope()
            scope.add_primary(wid, None, wd)
            compiler = ExprCompiler(scope, np, self.app_ctx.script_functions,
                                    self.extension_registry)
            nw = NamedWindow(wd, self.app_ctx, lambda e: compiler.compile(e),
                             extension_registry=self.extension_registry)
            self.named_windows[wid] = nw
            self.snapshot_service.register(f"window:{wid}", nw)
        # 4. triggers
        for tid, td in app.trigger_definitions.items():
            d = trigger_stream_definition(td)
            self.stream_definitions[tid] = d
            junction = self._make_junction(tid, d)
            self.triggers.append(TriggerRuntime(td, junction, self.app_ctx))
        # 5. script functions
        for fid, fd in app.function_definitions.items():
            self.app_ctx.script_functions[fid] = ScriptFunction(fd)
        # 6. aggregations (planner: slab-tensor device ingest unless the
        # app pins @app:engine('host') or the shape has no slab lane; a
        # device failure — no CUDA, a failed build or launch — raises)
        for aid, ad in app.aggregation_definitions.items():
            from ..plan.planner import engine_mode
            from .aggregation import AggregationRuntime
            ar = None
            if engine_mode(app) != "host":
                try:
                    from ..plan.iagg_compiler import DeviceAggregationRuntime
                    ar = DeviceAggregationRuntime(ad, self)
                except (TypeError, SiddhiAppCreationError):
                    ar = None     # unsupported shape (e.g. string lanes)
            if ar is None:
                ar = AggregationRuntime(ad, self)
            self.aggregations[aid] = ar
            self.snapshot_service.register(f"aggregation:{aid}", ar)
        # 7. queries + partitions
        qcount = 0
        for el in app.execution_elements:
            if isinstance(el, Query):
                qname = el.name or f"query_{qcount}"
                qr = QueryRuntime(el, self, qname)
                self.query_runtimes[qname] = qr
                for eid, obj in qr.stateful_elements():
                    self.snapshot_service.register(eid, obj)
            else:
                from .partition import PartitionRuntime
                pr = PartitionRuntime(el, self, f"partition_{qcount}")
                self.partition_runtimes.append(pr)
                self.snapshot_service.register(f"partition:{pr.name}", pr)
            qcount += 1
        # 8. sources & sinks from stream annotations
        attach_sources_and_sinks(self)
        # always-on saturation gauges for @Async buffers (read lazily at
        # /metrics scrape time; independent of @app:statistics)
        for sid, j in self.junctions.items():
            if j.is_async:
                self.ingest_metrics.ingest_saturation.set_fn(
                    j.saturation, stream=sid)
        # 9. statistics wiring
        if self.app_ctx.stats_enabled:
            sm = self.app_ctx.statistics_manager
            for sid, j in self.junctions.items():
                j.throughput_tracker = sm.throughput_tracker("Streams", sid)
                if j.is_async:
                    # @Async queue depth: backpressure is visible before
                    # it becomes an @OnError drop
                    sm.buffered_tracker("Streams", sid).register(
                        j.queue_depth)

    def _make_junction(self, sid: str, d: StreamDefinition) -> StreamJunction:
        fault_junction = None
        on_err = find_annotation(d.annotations, "onerror")
        if on_err is not None and \
                (on_err.get("action", "LOG") or "").upper() == "STREAM":
            fd = StreamDefinition("!" + sid,
                                  [a for a in d.attributes])
            fd.attribute("_error", AttrType.OBJECT)
            self.stream_definitions["!" + sid] = fd
            fault_junction = StreamJunction(fd, self.app_ctx)
            self.junctions["!" + sid] = fault_junction
        j = StreamJunction(d, self.app_ctx, fault_junction)
        self.junctions[sid] = j
        return j

    # ------------------------------------------------------------ lookups
    # (used by QueryRuntime wiring)

    def definition_of(self, stream_id: str, is_inner=False, is_fault=False):
        key = ("#" if is_inner else "!" if is_fault else "") + stream_id
        if is_fault:
            key = "!" + stream_id
        d = self.stream_definitions.get(key if not is_inner else stream_id)
        if d is None and stream_id in self.named_windows:
            return self.named_windows[stream_id].definition
        if d is None and stream_id in self.tables:
            return self.tables[stream_id].definition
        if d is None and stream_id in self.aggregations:
            return self.aggregations[stream_id].output_definition
        if d is None:
            raise DefinitionNotExistError(
                f"No stream/window/table '{stream_id}' defined")
        return d

    def junction_of(self, stream_id: str, is_inner=False, is_fault=False,
                    partition_key: Optional[str] = None,
                    create_with: Optional[StreamDefinition] = None
                    ) -> StreamJunction:
        key = ("!" + stream_id) if is_fault else stream_id
        j = self.junctions.get(key)
        if j is None:
            if create_with is None:
                raise DefinitionNotExistError(f"No stream '{key}' defined")
            d = StreamDefinition(stream_id, list(create_with.attributes))
            self.stream_definitions[stream_id] = d
            j = self._make_junction(stream_id, d)
        return j

    def has_table(self, tid: str) -> bool:
        return tid in self.tables

    def table_of(self, tid: str) -> InMemoryTable:
        return self.tables[tid]

    def has_named_window(self, wid: str) -> bool:
        return wid in self.named_windows

    def named_window_of(self, wid: str) -> NamedWindow:
        return self.named_windows[wid]

    def latency_tracker_for(self, query_name: str):
        if self.app_ctx.stats_enabled and self.app_ctx.statistics_manager:
            return self.app_ctx.statistics_manager.latency_tracker(
                "Queries", query_name)
        return None

    # ------------------------------------------------------------ public API
    # (reference SiddhiAppRuntime public surface)

    def get_input_handler(self, stream_id: str) -> InputHandler:
        h = self.input_handlers.get(stream_id)
        if h is None:
            j = self.junctions.get(stream_id)
            if j is None:
                raise DefinitionNotExistError(f"No stream '{stream_id}'")
            h = InputHandler(j, self.app_ctx)
            self.input_handlers[stream_id] = h
        return h

    def add_callback(self, target: str, callback) -> None:
        """StreamCallback on a stream id, or QueryCallback on a query name
        (reference SiddhiAppRuntime.addCallback overloads :251-270)."""
        if isinstance(callback, QueryCallback):
            qr = self.query_runtimes.get(target)
            if qr is None:
                for pr in self.partition_runtimes:
                    qr = pr.query_runtime_by_name(target)
                    if qr is not None:
                        break
            if qr is None:
                raise DefinitionNotExistError(f"No query '{target}'")
            qr.add_callback(callback)
            return
        j = self.junctions.get(target)
        if j is None:
            raise DefinitionNotExistError(f"No stream '{target}'")
        callback.stream_definition = j.definition
        j.subscribe(callback)

    def start(self):
        if self._started:
            return
        self._started = True
        for j in self.junctions.values():
            j.start()
        for qr in self.query_runtimes.values():
            qr.start()
        for t in self.triggers:
            t.start()
        for s in self.sources:
            s.connect_with_retry()
        for s in self.sinks:
            s.connect_with_retry()
        if self.app_ctx.stats_enabled:
            self.app_ctx.statistics_manager.start_reporting()
        if self.checkpoint_scheduler is not None:
            self.checkpoint_scheduler.start()

    def start_without_sources(self):
        self._started = True
        for j in self.junctions.values():
            j.start()
        for qr in self.query_runtimes.values():
            qr.start()
        for t in self.triggers:
            t.start()

    def flush(self):
        """Drain async junction queues and retire pipelined device work:
        when this returns, every match for events already sent has been
        delivered to callbacks.  The columnar analogue of waiting out the
        reference's @Async disruptor backlog.  One pass per junction:
        flushing stream S can enqueue matches into a downstream @Async
        junction that was flushed earlier in the pass, so iterate once
        per junction (an event can traverse at most every junction once
        per hop)."""
        for _ in range(max(len(self.junctions), 1)):
            for j in self.junctions.values():
                j.flush()
            if all(j.quiescent for j in self.junctions.values()):
                break       # nothing queued, no delivery in flight

    def shutdown(self):
        dbg = getattr(self.app_ctx, "debugger", None)
        if dbg is not None:
            dbg.detach()
        if self.checkpoint_scheduler is not None:
            self.checkpoint_scheduler.stop()
        for s in self.sources:
            s.shutdown()
        for s in self.sinks:
            s.shutdown()
        for t in self.triggers:
            t.stop()
        for j in self.junctions.values():
            j.stop()
        for qr in self.query_runtimes.values():
            dev = getattr(qr, "device_runtime", None)
            if dev is not None and hasattr(dev, "shutdown"):
                dev.shutdown()   # stops absent-state timer callbacks
        self.app_ctx.scheduler.shutdown()
        self.app_ctx.timestamp_generator.shutdown()
        if self.app_ctx.statistics_manager:
            self.app_ctx.statistics_manager.stop_reporting()
        from .ledger import ledger
        ledger().drop_app(self.name)
        if self.quota is not None:
            from .overload import fair_share
            fair_share().unregister(self.name)
        self._started = False

    def debug(self):
        """Start in debug mode: returns a SiddhiDebugger whose breakpoints
        block event threads at query IN/OUT terminals (reference
        SiddhiAppRuntime.debug :575)."""
        from .debugger import SiddhiDebugger
        dbg = SiddhiDebugger(self)
        self.app_ctx.debugger = dbg
        self.start()
        return dbg

    # ------------------------------------------------------------ persistence

    def _store(self) -> PersistenceStore:
        store = self.siddhi_context.persistence_store
        if store is None:
            raise NoPersistenceStoreError(
                "No persistence store set on SiddhiManager")
        return store

    def persist(self, incremental: bool = False) -> str:
        return self.snapshot_service.persist(self.name, self._store(),
                                             incremental=incremental)

    def restore_revision(self, revision: str):
        self.snapshot_service.restore_revision(self.name, self._store(),
                                               revision)

    def restore_last_revision(self) -> Optional[str]:
        return self.snapshot_service.restore_last_revision(self.name,
                                                           self._store())

    def clear_all_revisions(self):
        self._store().clear_all_revisions(self.name)

    def snapshot(self) -> bytes:
        return self.snapshot_service.full_snapshot()

    def restore(self, snapshot: bytes):
        self.snapshot_service.restore(snapshot)

    def recover(self) -> Optional[str]:
        """Restore the last persisted revision (crash recovery).  Returns
        the revision restored (None when the store has none) and records
        it as ``recovered_revision`` + the ``siddhi_recovered`` gauge."""
        rev = self.restore_last_revision()
        self.recovered_revision = rev
        if rev is not None:
            self.resilience_metrics.recovered.set(1)
            log.info("app %s recovered from revision %s", self.name, rev)
        return rev

    # ------------------------------------------------------------ error store

    def replay_errors(self, stream_id: Optional[str] = None,
                      ids: Optional[list] = None) -> int:
        """Re-deliver error-store entries for this app through their
        original path: sink-origin entries re-publish via that stream's
        sinks, stream-origin entries re-enter the junction.  Successful
        entries are purged; returns the number of events replayed
        (at-least-once — a replay that fails again re-enters the store
        through the normal failure path)."""
        store = self.error_store
        if store is None:
            return 0
        from .event import EventChunk
        id_set = set(ids) if ids is not None else None
        replayed = 0
        for entry in store.list(app_name=self.name, stream_id=stream_id):
            if id_set is not None and entry.id not in id_set:
                continue
            d = self.stream_definitions.get(entry.stream_id)
            if d is None:
                continue
            rows = [list(data) for _, data in entry.events]
            stamps = [ts for ts, _ in entry.events]
            if entry.origin == "sink":
                chunk = EventChunk.from_rows(d, rows, stamps)
                targets = [s for s in self.sinks
                           if s.stream_def.id == entry.stream_id]
                for s in targets:
                    s.receive_chunk(chunk)
            elif entry.origin == "ingest":
                # quarantined events re-enter through the input handler so
                # a replay is re-validated (a still-poison event goes
                # straight back to the store instead of device state)
                from .event import Event
                self.get_input_handler(entry.stream_id).send(
                    [Event(ts, data) for ts, data in entry.events])
            else:
                chunk = EventChunk.from_rows(d, rows, stamps)
                junction = self.junctions.get(entry.stream_id)
                if junction is None:
                    continue
                junction.send(chunk)
            store.purge(app_name=self.name, ids=[entry.id])
            replayed += len(entry.events)
            self.resilience_metrics.errors_replayed_total.inc(
                len(entry.events), stream=entry.stream_id)
        return replayed

    # ------------------------------------------------------------ playback & stats

    def enable_playback(self, idle_time_ms=None, increment_ms=None):
        self.app_ctx.playback = True
        self.app_ctx.timestamp_generator.enable_playback(idle_time_ms,
                                                         increment_ms)

    def enable_stats(self, enabled: bool = True):
        self.app_ctx.stats_enabled = enabled
        from .profiling import profiler
        if enabled:
            self.app_ctx.statistics_manager.start_reporting()
            profiler().enable()
            if not self.app_ctx.statistics_manager.throughput:
                # late enable: wire junction trackers now
                sm = self.app_ctx.statistics_manager
                for sid, j in self.junctions.items():
                    j.throughput_tracker = sm.throughput_tracker(
                        "Streams", sid)
                    if j.is_async:
                        sm.buffered_tracker("Streams", sid).register(
                            j.queue_depth)
        else:
            self.app_ctx.statistics_manager.stop_reporting()

    @property
    def statistics(self) -> dict:
        from .ledger import ledger
        from .profiling import profiler, rim_stats
        snap = self.app_ctx.statistics_manager.snapshot()
        snap["kernels"] = profiler().snapshot()
        # the always-on host-rim counters and the latency ledger ride
        # every snapshot surface (/metrics, flight records, here) —
        # rt.statistics must agree with them (tests/test_service.py
        # asserts the parity)
        snap["rim"] = rim_stats().snapshot()
        snap["ledger"] = ledger().snapshot(app=self.name)
        from ..plan.shapes import shape_registry
        snap["shapes"] = shape_registry().snapshot()
        if self.device_telemetry is not None:
            snap["telemetry"] = self.device_telemetry.snapshot()
        # partition shard-out rows (round 15): per-shard key/capacity/
        # dispatch counters for every sharded keyed runtime.  This
        # host-side gather is the shard set's one cross-device
        # aggregation point — the hot path never reduces across shards.
        shard_rows: Dict[str, list] = {}

        def _scan(label, qr):
            dev = getattr(qr, "device_runtime", None)
            ss = getattr(dev, "shard_stats", None)
            rows = ss() if ss is not None else None
            if rows:
                shard_rows[label] = rows

        for qname, qr in self.query_runtimes.items():
            _scan(qname, qr)
        for pr in self.partition_runtimes:
            for qname, qr in getattr(pr, "device_query_runtimes",
                                     {}).items():
                _scan(f"{pr.name}/{qname}", qr)
        if shard_rows:
            snap["shards"] = shard_rows
        return snap

    # ------------------------------------------------------------ tracing

    def enable_tracing(self):
        from .tracing import tracer
        tracer().enable()

    def dump_trace(self, path: str) -> str:
        """Export collected spans as Chrome trace-event JSON
        (Perfetto-loadable).  Spans cover parse → plan → jit-compile →
        ingest chunk → kernel step → match scatter → callback."""
        from .tracing import tracer
        return tracer().export(path)

    # ------------------------------------------------------------ store queries

    def query(self, store_query: Union[str, Any]):
        """On-demand query over tables/windows/aggregations
        (reference SiddhiAppRuntime.query:280-316, LRU-cached runtimes)."""
        from .store_query import StoreQueryRuntime
        if isinstance(store_query, str):
            rt = self._store_query_cache.get(store_query)
            if rt is None:
                sq = SiddhiCompiler.parse_store_query(store_query)
                rt = StoreQueryRuntime(sq, self)
                while len(self._store_query_cache) >= \
                        self._store_query_cache_size:
                    self._store_query_cache.popitem(last=False)
                self._store_query_cache[store_query] = rt
            else:
                self._store_query_cache.move_to_end(store_query)
        else:
            rt = StoreQueryRuntime(store_query, self)
        return rt.execute()


def _parse_time_str(s: str) -> int:
    """'100 millisec' / '2 sec' / bare int millis."""
    from ..compiler.parser import Parser
    p = Parser(s)
    return p._parse_time_value()


class SiddhiManager:
    """Top-level factory (reference SiddhiManager.java)."""

    def __init__(self, device=None):
        """``device``: the torch device of every device runtime's state
        and kernels — ``"cuda"`` when None.  Pass ``"cpu"`` to run the
        device engine's plain PyTorch versions on the host (tests)."""
        from ..plan.shapes import configure_compile_cache
        configure_compile_cache()
        self.siddhi_context = SiddhiContext()
        self.siddhi_context.device = str(device) if device is not None \
            else "cuda"
        self.siddhi_context.extension_registry = ExtensionRegistry()
        self.runtimes: Dict[str, SiddhiAppRuntime] = {}

    def create_siddhi_app_runtime(
            self, app: Union[str, SiddhiApp],
            strict: bool = False,
            recover: bool = False) -> SiddhiAppRuntime:
        """Parse → analyze → plan.  The semantic analyzer
        (siddhi_tpu_torch.analysis) always runs and its diagnostics ride the
        returned runtime as ``rt.analysis`` (and GET /stats on the REST
        service); with ``strict=True`` any error OR warning diagnostic
        raises SiddhiAppValidationException before anything is built —
        fail-fast for deployments that refuse hazardous apps.

        ``recover=True`` restores the app's last persisted revision from
        the manager's persistence store before returning (crash
        recovery); the revision restored is reported on
        ``rt.recovered_revision`` (None when the store holds none)."""
        from .tracing import trace_span
        app_string = app if isinstance(app, str) else None
        if isinstance(app, str):
            with trace_span("parse", cat="compile", chars=len(app)):
                app = SiddhiCompiler.parse(app)
        analysis = None
        try:
            from ..analysis import analyze
            with trace_span("analyze", cat="compile"):
                analysis = analyze(app)
        except Exception:   # noqa: BLE001 — advisory pass must never
            # take down app creation (strict mode excepted below)
            if strict:
                raise
        if strict and analysis is not None:
            analysis.raise_if(strict=True)
        with trace_span("plan", cat="compile", app=app.name or "?"):
            rt = SiddhiAppRuntime(app, self.siddhi_context, app_string)
        rt.analysis = analysis
        # plan-level verifier (analysis/plan_verify.py): automaton
        # well-formedness + liveness-pruning report + static cost model
        # over the COMPILED plan; findings merge into rt.analysis and the
        # full report rides rt.analysis.plan (and GET /stats).  The jaxpr
        # sanitizer is opt-in (analyze --plan) — tracing every step here
        # would tax app creation.
        try:
            from ..analysis.plan_verify import attach_plan_analysis
            with trace_span("plan.verify", cat="compile"):
                attach_plan_analysis(rt)
        except Exception:   # noqa: BLE001 — advisory pass must never
            # take down app creation (strict mode excepted below)
            if strict:
                rt.shutdown()
                raise
        # persistent-state schema report (analysis/state_schema.py):
        # cheap static description of every registered snapshot element —
        # rides rt.state_schema / rt.analysis.schema (and GET /stats),
        # and is the artifact t1_report digests for drift tracking
        try:
            from ..analysis.state_schema import attach_schema_analysis
            with trace_span("schema", cat="compile"):
                attach_schema_analysis(rt, strict=strict)
        except Exception:   # noqa: BLE001 — advisory pass must never
            # take down app creation (strict mode excepted below)
            if strict:
                rt.shutdown()
                raise
        # numeric-safety verifier (analysis/ranges.py): re-grounds the
        # NS0xx value-range verdicts on the compiled plan's dims; the
        # refined NumericReport rides rt.analysis.numeric (and GET
        # /stats), cross-validated live by the SIDDHI_TPU_NUMGUARD
        # sentinels (core/numguard.py)
        try:
            from ..analysis.ranges import attach_numeric_analysis
            with trace_span("numeric", cat="compile"):
                attach_numeric_analysis(rt)
        except Exception:   # noqa: BLE001 — advisory pass must never
            # take down app creation (strict mode excepted below)
            if strict:
                rt.shutdown()
                raise
        if strict and rt.analysis is not None:
            try:
                rt.analysis.raise_if(strict=True)
            except Exception:
                rt.shutdown()
                raise
        if recover:
            try:
                rt.recover()
            except Exception:
                rt.shutdown()
                raise
        self.runtimes[rt.name] = rt
        return rt

    def validate_siddhi_app(self, app: Union[str, SiddhiApp],
                            strict: bool = False):
        """Parse + build, then dispose (reference validateSiddhiApp)."""
        rt = self.create_siddhi_app_runtime(app, strict=strict)
        self.runtimes.pop(rt.name, None)
        rt.shutdown()

    def get_siddhi_app_runtime(self, name: str) -> Optional[SiddhiAppRuntime]:
        return self.runtimes.get(name)

    def set_extension(self, name: str, impl):
        self.siddhi_context.set_extension(name, impl)
        self.siddhi_context.extension_registry.register(name, impl)

    def set_persistence_store(self, store: PersistenceStore):
        self.siddhi_context.persistence_store = store

    def set_error_store(self, store):
        """Manager-level default ErrorStore (core/resilience.py) for
        @OnError(action='STORE') and sink-exhausted events; an
        @app:errorStore annotation overrides it per app.  Applies to
        runtimes created after this call."""
        self.siddhi_context.error_store = store

    def set_config_manager(self, config_manager):
        """System-parameter source for extensions (reference
        SiddhiManager.setConfigManager, util/config/)."""
        self.siddhi_context.config_manager = config_manager

    def set_source_handler_manager(self, manager):
        """HA hook factory for sources (reference SourceHandlerManager)."""
        self.siddhi_context.source_handler_manager = manager

    def set_sink_handler_manager(self, manager):
        """HA hook factory for sinks (reference SinkHandlerManager)."""
        self.siddhi_context.sink_handler_manager = manager

    def persist(self):
        for rt in self.runtimes.values():
            rt.persist()

    def restore_last_state(self):
        for rt in self.runtimes.values():
            rt.restore_last_revision()

    def shutdown(self):
        for rt in list(self.runtimes.values()):
            rt.shutdown()
        self.runtimes.clear()
