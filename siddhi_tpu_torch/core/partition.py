"""Partition runtime: per-key isolated query instances.

Host-oracle mirror of the reference (partition/PartitionRuntime.java:255-308 —
on the first event with a new key every query runtime + inner junction is
cloned for that key; partition/PartitionStreamReceiver.java:83-153 — per-event
key evaluation and routing to `<streamId>+key` local junctions; @purge idle-key
cleanup).  The TPU path replaces per-key clones with a partition-axis in the
state tensors (parallel/, SURVEY.md §2.8) — this runtime is the semantic spec
for it.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx, Scope
from ..query_api import (Partition, Query, RangePartitionType,
                         ValuePartitionType, find_annotation)
from ..query_api.definition import StreamDefinition
from ..utils.errors import DefinitionNotExistError, SiddhiAppCreationError
from .event import EventChunk
from .query_runtime import QueryRuntime
from .stateschema import PartitionState, persistent_schema
from .stream import StreamJunction


class _PartitionInstance:
    """One key's isolated clone group: local junctions + query runtimes.

    Presents the SiddhiAppRuntime surface QueryRuntime builds against,
    delegating everything non-local to the parent app runtime."""

    def __init__(self, pr: "PartitionRuntime", key: str,
                 template: bool = False):
        self.pr = pr
        self.parent = pr.app_runtime
        self.key = key
        self.local_junctions: Dict[str, StreamJunction] = {}
        self.local_definitions: Dict[str, StreamDefinition] = {}
        self.query_runtimes: Dict[str, QueryRuntime] = {}
        self.last_used = self.app_ctx.timestamp_generator.current_time()
        # local entry junction for each partitioned/broadcast input stream
        for sid in pr.partitioned_streams:
            d = self.parent.definition_of(sid)
            self.local_definitions[sid] = d
            self.local_junctions[sid] = StreamJunction(d, self.app_ctx)
        for i, q in enumerate(pr.partition.queries):
            name = q.name or f"{pr.name}_query_{i}"
            qr = QueryRuntime(q, self, name, partition_key=key)
            self.query_runtimes[name] = qr
            if not template:
                for cb in pr.pending_callbacks.get(name, []):
                    qr.add_callback(cb)
        if template:
            return  # built only to materialise output stream definitions
        for j in self.local_junctions.values():
            j.start()
        for qr in self.query_runtimes.values():
            qr.start()

    # ---- SiddhiAppRuntime surface used by QueryRuntime ----

    @property
    def app_ctx(self):
        return self.parent.app_ctx

    @property
    def extension_registry(self):
        return self.parent.extension_registry

    @property
    def aggregations(self):
        return self.parent.aggregations

    @property
    def tables(self):
        return self.parent.tables

    def latency_tracker_for(self, query_name):
        return self.parent.latency_tracker_for(query_name)

    def has_table(self, tid):
        return self.parent.has_table(tid)

    def table_of(self, tid):
        return self.parent.table_of(tid)

    def has_named_window(self, wid):
        return self.parent.has_named_window(wid)

    def named_window_of(self, wid):
        return self.parent.named_window_of(wid)

    def definition_of(self, stream_id: str, is_inner=False, is_fault=False):
        if is_inner or stream_id in self.local_definitions:
            d = self.local_definitions.get(stream_id)
            if d is None:
                raise DefinitionNotExistError(
                    f"No inner stream '#{stream_id}' in partition")
            return d
        return self.parent.definition_of(stream_id, is_inner, is_fault)

    def junction_of(self, stream_id: str, is_inner=False, is_fault=False,
                    partition_key=None, create_with=None) -> StreamJunction:
        if is_inner:
            j = self.local_junctions.get("#" + stream_id)
            if j is None:
                if create_with is None:
                    raise DefinitionNotExistError(
                        f"No inner stream '#{stream_id}' in partition")
                d = StreamDefinition(stream_id, list(create_with.attributes))
                self.local_definitions["#" + stream_id] = d
                self.local_definitions[stream_id] = d
                j = StreamJunction(d, self.app_ctx)
                j.start()
                self.local_junctions["#" + stream_id] = j
            return j
        if stream_id in self.local_junctions:
            return self.local_junctions[stream_id]
        return self.parent.junction_of(stream_id, is_inner, is_fault,
                                       partition_key, create_with)

    # ---- routing ----

    def send(self, stream_id: str, chunk: EventChunk):
        self.last_used = self.app_ctx.timestamp_generator.current_time()
        self.local_junctions[stream_id].send(chunk)

    def shutdown(self):
        for j in self.local_junctions.values():
            j.stop()


class _PartitionExecutor:
    """Per-event key evaluation (ValuePartitionExecutor /
    RangePartitionExecutor in the reference)."""

    def __init__(self, pt, definition, factory):
        scope = Scope()
        scope.add_primary(pt.stream_id, None, definition)
        compiler = factory(scope)
        self.pt = pt
        self.ranges: Optional[List] = None
        if isinstance(pt, ValuePartitionType):
            self.value_expr: Optional[CompiledExpr] = \
                compiler.compile(pt.expression)
        elif isinstance(pt, RangePartitionType):
            self.value_expr = None
            self.ranges = [(r.partition_key, compiler.compile(r.condition))
                           for r in pt.ranges]
        else:
            raise SiddhiAppCreationError(f"Unknown partition type {pt!r}")

    def keys(self, chunk: EventChunk) -> List[Optional[str]]:
        n = len(chunk)
        ctx = EvalCtx(chunk.columns, chunk.timestamps, n)
        if self.value_expr is not None:
            v = self.value_expr.fn(ctx)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.broadcast_to(arr, (n,))
            if arr.dtype != object:
                # typed column: no None, tolist() gives Python scalars
                return [str(x) for x in arr.tolist()]
            return [x if type(x) is str else None if x is None else
                    str(x.item() if isinstance(x, np.generic) else x)
                    for x in arr.tolist()]
        out: List[Optional[str]] = [None] * n
        for key, cond in self.ranges:
            m = np.asarray(cond.fn(ctx), bool)
            if m.ndim == 0:
                m = np.broadcast_to(m, (n,))
            for i in range(n):
                if out[i] is None and m[i]:
                    out[i] = key
        return out


class _PartitionStreamReceiver:
    def __init__(self, pr: "PartitionRuntime", stream_id: str,
                 executor: Optional[_PartitionExecutor]):
        self.pr = pr
        self.stream_id = stream_id
        self.executor = executor

    def receive_chunk(self, chunk: EventChunk):
        pr = self.pr
        with pr.lock:
            if self.executor is None:
                # non-partitioned stream used inside the partition:
                # broadcast to every live key instance (reference
                # PartitionStreamReceiver with no executors)
                for inst in list(pr.instances.values()):
                    inst.send(self.stream_id, chunk)
                return
            keys = self.executor.keys(chunk)
            # group contiguous same-key runs to keep event order per key
            order: List[str] = []
            groups: Dict[str, List[int]] = {}
            for i, k in enumerate(keys):
                if k is None:
                    continue  # no matching range → dropped
                if k not in groups:
                    groups[k] = []
                    order.append(k)
                groups[k].append(i)
            for k in order:
                inst = pr.instance_of(k)
                inst.send(self.stream_id, chunk.take(np.asarray(groups[k])))


class _CallbackProxy:
    def __init__(self, pr: "PartitionRuntime", query_name: str):
        self.pr = pr
        self.query_name = query_name

    def add_callback(self, cb):
        self.pr.pending_callbacks.setdefault(self.query_name, []).append(cb)
        for inst in self.pr.instances.values():
            qr = inst.query_runtimes.get(self.query_name)
            if qr is not None:
                qr.add_callback(cb)


@persistent_schema("partition", schema=PartitionState())
class PartitionRuntime:
    def __init__(self, partition: Partition, app_runtime, name: str):
        self.partition = partition
        self.app_runtime = app_runtime
        self.name = name
        self.lock = threading.RLock()
        self.instances: Dict[str, _PartitionInstance] = {}
        self.pending_callbacks: Dict[str, List] = {}

        from ..plan.expr_compiler import ExprCompiler

        def factory(scope):
            return ExprCompiler(scope, np,
                                app_runtime.app_ctx.script_functions,
                                app_runtime.extension_registry)

        self.executors: Dict[str, _PartitionExecutor] = {}
        for pt in partition.partition_types:
            d = app_runtime.definition_of(pt.stream_id)
            self.executors[pt.stream_id] = _PartitionExecutor(pt, d, factory)

        # streams consumed by partition queries
        self.partitioned_streams: List[str] = []
        used: List[str] = []
        for q in partition.queries:
            used.extend(self._input_stream_ids(q))
        for sid in dict.fromkeys(used):
            if sid.startswith("#"):
                continue
            self.partitioned_streams.append(sid)

        # device mode: partition keys become lanes of one NFA state slab
        # instead of per-key runtime clones (the TPU replacement for
        # PartitionRuntime.java:255-308's cloneIfNotExist)
        self.device_mode = False
        self.device_query_runtimes: Dict[str, QueryRuntime] = {}
        self.fallback_reason: Optional[str] = None
        if self._try_device_mode():
            return
        # parse queries once so global output streams exist before any key
        # arrives (reference: QueryParser runs per partition query at build
        # time, creating inferred output definitions)
        _PartitionInstance(self, "__template__", template=True)
        # subscribe receivers on the global junctions
        for sid in self.partitioned_streams:
            recv = _PartitionStreamReceiver(self, sid,
                                            self.executors.get(sid))
            app_runtime.junction_of(sid).subscribe(recv)
        # @purge(enable='true', interval='..', idle.period='..')
        purge = find_annotation(partition.annotations, "purge")
        if purge is not None and \
                str(purge.get("enable", "true")).lower() == "true":
            from .runtime import _parse_time_str
            self.purge_idle_ms = _parse_time_str(
                purge.get("idle.period", "5 min"))
            self.purge_interval_ms = _parse_time_str(
                purge.get("interval", "1 min"))
            self._schedule_purge()

    def shard_report(self) -> Dict[str, dict]:
        """Per-query partition shard-out status (round 15,
        parallel/shards.py): shard count when the keyed device runtime
        split out, else the recorded monolithic-fallback reason."""
        out: Dict[str, dict] = {}
        for name, qr in self.device_query_runtimes.items():
            dev = getattr(qr, "device_runtime", None)
            shards = getattr(dev, "shards", None)
            out[name] = {"shards": len(shards) if shards else 0,
                         "reason": getattr(dev, "shard_reason", None)}
        return out

    def _try_device_mode(self) -> bool:
        """Compile every partition query onto keyed device lanes; any
        incompatibility rolls back cleanly to the host clone machinery."""
        from ..plan.planner import engine_mode
        from ..query_api import StateInputStream

        app = self.app_runtime
        mode = engine_mode(app.app)
        reject = None
        if mode == "host":
            reject = "engine mode 'host'"
        elif find_annotation(self.partition.annotations, "purge") is not None:
            reject = "@purge needs host per-key instances"
        else:
            from ..query_api import SingleInputStream
            for q in self.partition.queries:
                if not isinstance(q.input_stream,
                                  (StateInputStream, SingleInputStream)):
                    reject = "join partition query needs host instances"
                    break
                # _input_stream_ids keeps the '#' prefix, so inner-stream
                # consumers fail the subset check → host per-key isolation
                ids = set(self._input_stream_ids(q))
                if not ids <= set(self.executors):
                    reject = "partition query reads a non-partitioned stream"
                    break
                out = q.output_stream
                if getattr(out, "is_inner", False):
                    reject = "inner-stream output needs host per-key " \
                        "instances"
                    break
        if reject is not None:
            if mode == "device":
                raise SiddhiAppCreationError(
                    f"engine mode 'device': partition not compilable "
                    f"({reject})")
            self.fallback_reason = reject
            return False
        try:
            for i, q in enumerate(self.partition.queries):
                name = q.name or f"{self.name}_query_{i}"
                qr = QueryRuntime(q, app, name,
                                  device_key_executors=self.executors)
                self.device_query_runtimes[name] = qr
                for cb in self.pending_callbacks.get(name, []):
                    qr.add_callback(cb)
            self.device_mode = True
            return True
        except SiddhiAppCreationError as e:
            if mode == "device":
                raise
            # roll back partial junction subscriptions before host fallback
            for qr in self.device_query_runtimes.values():
                for sid, recv in qr.receivers.items():
                    app.junction_of(sid).unsubscribe(recv)
            self.device_query_runtimes = {}
            self.fallback_reason = str(e)
            return False

    @staticmethod
    def _input_stream_ids(q: Query) -> List[str]:
        from ..query_api import (JoinInputStream, SingleInputStream,
                                 StateInputStream)
        s = q.input_stream
        if isinstance(s, SingleInputStream):
            return [("#" + s.stream_id) if s.is_inner else s.stream_id]
        if isinstance(s, JoinInputStream):
            return [x.stream_id for x in (s.left, s.right)]
        if isinstance(s, StateInputStream):
            return s.all_stream_ids()
        return []

    def instance_of(self, key: str) -> _PartitionInstance:
        inst = self.instances.get(key)
        if inst is None:
            inst = _PartitionInstance(self, key)
            self.instances[key] = inst
        return inst

    def query_runtime_by_name(self, target: str):
        if self.device_mode:
            return self.device_query_runtimes.get(target)
        for q in self.partition.queries:
            if q.name == target:
                return _CallbackProxy(self, target)
        return None

    # ------------------------------------------------------------ purge

    def _schedule_purge(self):
        ctx = self.app_runtime.app_ctx

        def fire(now):
            with self.lock:
                dead = [k for k, inst in self.instances.items()
                        if now - inst.last_used > self.purge_idle_ms]
                for k in dead:
                    self.instances.pop(k).shutdown()
            ctx.scheduler.notify_at(now + self.purge_interval_ms, fire)
        ctx.scheduler.notify_at(
            ctx.timestamp_generator.current_time() + self.purge_interval_ms,
            fire)

    # ------------------------------------------------------------ snapshot

    def current_state(self):
        if self.device_mode:
            out = {}
            for qname, qr in self.device_query_runtimes.items():
                with qr.lock:      # ingest holds qr.lock, not pr.lock
                    out[qname] = {eid: obj.current_state()
                                  for eid, obj in qr.stateful_elements()}
            return {"device": out}
        out = {}
        with self.lock:
            for key, inst in self.instances.items():
                qstates = {}
                for qname, qr in inst.query_runtimes.items():
                    qstates[qname] = {eid: obj.current_state()
                                      for eid, obj in qr.stateful_elements()}
                out[key] = qstates
        return {"keys": out}

    def restore_state(self, state):
        if self.device_mode:
            for qname, elems in state.get("device", {}).items():
                qr = self.device_query_runtimes.get(qname)
                if qr is None:
                    continue
                with qr.lock:
                    live = dict(qr.stateful_elements())
                    for eid, s in elems.items():
                        if eid in live and s is not None:
                            live[eid].restore_state(s)
            return
        with self.lock:
            for key, qstates in state["keys"].items():
                inst = self.instance_of(key)
                for qname, elems in qstates.items():
                    qr = inst.query_runtimes.get(qname)
                    if qr is None:
                        continue
                    live = dict(qr.stateful_elements())
                    for eid, s in elems.items():
                        if eid in live and s is not None:
                            live[eid].restore_state(s)
