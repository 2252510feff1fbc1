"""Device/host query planner — routes each query to the device engine or
the host oracle.

Counterpart of ``siddhi_tpu/plan/planner.py``, carrying what the torch
port's slices so far need: engine selection, keyed lanes, the pattern
NFA runtime (:class:`DevicePatternRuntime`) and the keyed length-window
aggregation runtime (:class:`DeviceWindowedAggRuntime`).  The other
device runtimes of the JAX package (grouped aggregation, stateless filter
program) are later slices: their classes here raise
``SiddhiAppCreationError("<kind> not yet ported to the torch backend")``,
so ``'auto'`` falls back to the host exactly as the JAX package's planner
does for a query its device path cannot express, and ``'device'`` raises.
On a CUDA device a pattern outside the NFA kernel's class is refused the
same way (plan/nfa_compiler.py).

Engine selection:
  - `@app:engine('host'|'device'|'auto')` app annotation, else
  - env `SIDDHI_TPU_ENGINE`, else 'auto'.
  'auto'   — try the device build, fall back to host on an expression or
             shape rejection (SiddhiAppCreationError).
  'device' — device or raise (surface the incompatibility).
  'host'   — never touch the device.
A missing CUDA device, or a kernel that fails to build, load or launch,
raises RuntimeError under every mode: it is never turned into a host run.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..query_api import StateInputStream, find_annotation
from ..query_api.definition import Attribute, AttrType, StreamDefinition
from ..query_api.expression import Variable
from ..query_api.query import OutputEventsFor
from ..utils.errors import SiddhiAppCreationError
from ..core.ledger import ledger as _ledger
from ..core.stateschema import Keyed, persistent_schema
from ..parallel.shards import build_shards, resolve_shards
from .pipeline import HostCopy, PipelinedDeviceIngest

ENGINE_ENV = "SIDDHI_TPU_ENGINE"
DEFAULT_SLOTS = 8
GROW_START = 8          # initial keyed-lane capacity (doubles on demand)


def initial_lanes(app, n_shards: int = 0) -> int:
    """``@app:lanes('N')`` — declared distinct-key population.  Keyed
    slabs start at the next power of two ≥ N instead of GROW_START, so a
    known-large key domain skips the grow ladder.  Sharded runtimes split
    the population: each shard pre-sizes to ceil(N/S)."""
    ann = find_annotation(app.annotations, "app:lanes") or \
        find_annotation(app.annotations, "lanes")
    n = GROW_START
    if ann is not None:
        pos = ann.positional()
        n = int(pos[0] if pos else ann.get("n", GROW_START))
    if n_shards >= 2:
        n = -(-n // n_shards)
    n = max(n, GROW_START)
    return 1 << (n - 1).bit_length()


def _record_block(rt_obj, prof, disp0: int, ticks0: int, stream: str,
                  batch: int, junction=None, telemetry=None) -> None:
    """Per-ingest-block accounting shared by every device runtime: the
    profiler's dispatches-per-block gauge (when profiling is on), the
    latency ledger's per-app stage fold + SLO evaluation (core/ledger.py,
    always-cheap), plus a flight-recorder ring record (core/flight.py)."""
    from ..core.flight import flight
    from ..core.ledger import ledger
    from ..core.profiling import rim_stats
    d = prof.total_dispatches() - disp0 if prof.enabled else 0
    t = prof.total_scan_ticks() - ticks0 if prof.enabled else 0
    if prof.enabled:
        prof.record_app_block(rt_obj.app_name, d)
    app = getattr(rt_obj.qr, "app_runtime", None)
    fl = flight()
    led = ledger()
    ledger_row = led.note_block(rt_obj.app_name, rt_obj, runtime=app,
                                want_row=fl.enabled) \
        if led.enabled else None
    if not fl.enabled:
        return
    sched = getattr(app.app_ctx, "scheduler", None) if app is not None \
        else None
    if junction is None and app is not None:
        junction = app.junctions.get(stream)
    fuser = getattr(app, "_egress_fuser", None) if app is not None else None
    extra = ({"egress_bytes": fuser.last_slab_bytes}
             if fuser is not None and fuser.last_slab_bytes else None)
    if ledger_row:
        extra = dict(extra or {}, ledger=ledger_row)
    # rim-vs-kernel ms split since this runtime's previous block
    rim_now = rim_stats().rim_ns
    kern_now = prof.total_dispatch_ns() if prof.enabled else 0
    rim_prev = getattr(rt_obj, "_flight_rim_ns0", None)
    if rim_prev is not None:
        split = {"rim_ms": (rim_now - rim_prev) / 1e6,
                 "kernel_ms": (kern_now - rt_obj._flight_kern_ns0) / 1e6}
        extra = dict(extra or {}, **split)
    rt_obj._flight_rim_ns0 = rim_now
    rt_obj._flight_kern_ns0 = kern_now
    fl.record_block(rt_obj.app_name, stream=stream, batch=batch,
                    dispatches=d, scan_ticks=t, junction=junction,
                    scheduler=sched, telemetry=telemetry, extra=extra)


class KeyLanes(dict):
    """key → lane map with a cached vectorized lookup for steady state.

    After the key population stops growing, per-batch work drops to one
    np.searchsorted over the batch's DISTINCT keys — zero dict probes.
    The cache is rebuilt lazily whenever the population size changed;
    lanes are append-only, so a length check is a complete staleness
    test."""

    __slots__ = ("_vkeys", "_vlanes", "_vn")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._vkeys = None
        self._vlanes = None
        self._vn = -1

    def lookup(self, uniq: np.ndarray) -> Optional[np.ndarray]:
        """Lanes for ``uniq`` (sorted distinct keys) when EVERY key is
        already mapped; None → caller falls back to the probing path."""
        if len(self) != self._vn:
            if not self:
                return None
            ks = np.asarray(list(self.keys()))
            if ks.dtype.kind not in "USiu":
                return None        # mixed/object keys: no vector order
            order = np.argsort(ks, kind="stable")
            self._vkeys = ks[order]
            self._vlanes = np.fromiter(self.values(), np.int64,
                                       len(self))[order]
            self._vn = len(self)
        vk = self._vkeys
        if vk is None or vk.dtype.kind != uniq.dtype.kind:
            return None
        pos = np.searchsorted(vk, uniq)
        if pos.size and int(pos.max()) >= len(vk):
            return None
        if not (vk[pos] == uniq).all():
            return None
        return self._vlanes[pos]


def map_keys_to_lanes(key_lanes: Dict[Any, int], keys: List[Any],
                      capacity: int, grow_fn) -> np.ndarray:
    """Assign each key a stable lane index, growing the device slab (via
    grow_fn(new_capacity)) when the key population exceeds capacity.
    Steady state (every key already mapped) is one dict probe per event
    straight off the key list; a batch with new keys takes the JAX
    package's path: string and integer keys probe once per DISTINCT key
    (np.unique), others once per event."""
    if key_lanes and len(keys) > 64:
        try:
            return np.fromiter(map(key_lanes.__getitem__, keys), np.int64,
                               len(keys))
        except (KeyError, TypeError):
            pass                   # a new (or unhashable) key: probe below
    arr = np.asarray(keys)
    if arr.dtype.kind in "USiu" and len(keys) > 64:
        uniq, inv = np.unique(arr, return_inverse=True)
        lane_of = None
        if isinstance(key_lanes, KeyLanes):
            lane_of = key_lanes.lookup(uniq)
        if lane_of is None:
            lane_of = np.empty(len(uniq), np.int64)
            for i, k in enumerate(uniq.tolist()):
                lane = key_lanes.get(k)
                if lane is None:
                    lane = len(key_lanes)
                    key_lanes[k] = lane
                lane_of[i] = lane
        lanes = lane_of[inv.reshape(-1)]
    else:
        lanes = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            lane = key_lanes.get(k)
            if lane is None:
                lane = len(key_lanes)
                key_lanes[k] = lane
            lanes[i] = lane
    if key_lanes and len(key_lanes) > capacity:
        cap = capacity
        while cap < len(key_lanes):
            cap *= 2
        grow_fn(cap)
    return lanes


def _scan_fns(e, pred) -> bool:
    """True if any AttributeFunction node in the expression satisfies pred."""
    from ..query_api.expression import AttributeFunction
    if isinstance(e, AttributeFunction) and pred(e):
        return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, list):
            if any(hasattr(x, "__dataclass_fields__") and _scan_fns(x, pred)
                   for x in v):
                return True
        elif hasattr(v, "__dataclass_fields__") and _scan_fns(v, pred):
            return True
    return False


def _is_time_fn(e) -> bool:
    return (e.namespace or "") == "" and \
        e.name.lower() in ("eventtimestamp", "currenttimemillis")


def engine_mode(app) -> str:
    ann = find_annotation(app.annotations, "app:engine") or \
        find_annotation(app.annotations, "engine")
    if ann is not None:
        pos = ann.positional()
        mode = str(pos[0] if pos else ann.get("mode", "auto")).lower()
    else:
        mode = os.environ.get(ENGINE_ENV, "auto").lower()
    if mode not in ("auto", "device", "host"):
        raise SiddhiAppCreationError(f"Unknown engine mode '{mode}'")
    return mode


class _DeviceIngress:
    """Junction-side adapter: one per input stream of a device query.
    Looks like a Processor head so ProcessStreamReceiver wraps it with the
    query lock / latency tracker / debugger IN check."""

    def __init__(self, runtime, stream_code: int, stream_id: str):
        self.runtime = runtime
        self.stream_code = stream_code
        self.stream_id = stream_id
        self.next = None

    def process(self, chunk):
        self.runtime.ingest(self.stream_code, self.stream_id, chunk)

    def flush(self):
        f = getattr(self.runtime, "flush", None)
        if f is not None:
            f()


class _NotYetPorted:
    """A device runtime of the JAX package that the torch port has not
    reached yet: building it raises SiddhiAppCreationError, which the
    planner and the partition runtime turn into a host run under 'auto'
    (with the reason in ``backend_reason``) and re-raise under 'device'."""

    kind = "device runtime"
    backend = "device"

    def __init__(self, *args, **kwargs):
        raise SiddhiAppCreationError(
            f"{self.kind} not yet ported to the torch backend")


@persistent_schema(
    "keyed-pattern", version=1, schema=Keyed("nfa"),
    doc="per-key NFA lanes: one flat slab keyed by the key→lane map")
class DevicePatternRuntime:
    """Pattern query running on the batched NFA step (plan/nfa_compiler
    → ops/nfa → csrc/nfa_step.cu on CUDA).

    Non-partitioned queries run a single lane (P=1); keyed mode (driven by
    core/partition.py) maps partition-key values to lanes of a slab that
    doubles on demand — the device replacement for the reference's per-key
    runtime clones (partition/PartitionRuntime.java:255-308).  Ingest is
    pipelined up to ``pipeline_depth`` chunks; a chunk whose slot ring
    overflowed is replayed from its pre-chunk carry on a doubled ring
    (grow-and-replay), so drops never lose matches.  Shard-out and the
    cross-tenant packer are not yet ported."""

    backend = "device"

    def __init__(self, query_runtime, sis: StateInputStream, factory,
                 key_executors: Optional[Dict[str, Any]] = None,
                 n_slots: Optional[int] = None):
        from ..core.event import dtype_for
        from ..core.query_runtime import ProcessStreamReceiver
        from .nfa_compiler import CompiledPatternNFA
        from .pipeline import egress_fuser_for, resolve_depth

        qr = query_runtime
        app = qr.app_runtime
        q = qr.query
        sel = q.selector
        if sel.group_by or sel.having is not None or sel.order_by or \
                sel.limit is not None or sel.offset is not None:
            raise SiddhiAppCreationError(
                "device pattern path: group-by/having/order-by/limit are "
                "host-only")
        self.keyed = key_executors is not None
        self.key_executors = key_executors or {}
        telemetry = bool(getattr(app.app_ctx, "telemetry_enabled", False))
        n_shards = resolve_shards() if self.keyed else 0
        if n_shards >= 2:
            build_shards(None, n_shards)          # raises: not yet ported
        capacity = initial_lanes(app.app) if self.keyed else 1
        self.nfa = CompiledPatternNFA(
            app.app, n_partitions=capacity,
            n_slots=DEFAULT_SLOTS if n_slots is None else n_slots, query=q,
            telemetry=telemetry, device=app.app_ctx.siddhi_context.device)
        self.key_lanes: Dict[Any, int] = KeyLanes()
        self.qr = qr
        self._dtype_for = dtype_for
        self._dropped_seen = 0
        self.slot_grows = 0         # K doublings by grow-and-replay
        self.replays = 0            # chunks re-run after a slot overflow

        # output definition straight from the capture-decode plan
        # (encoded string captures decode back to STRING)
        target = getattr(q.output_stream, "target_id", "") or qr.name
        attrs = [Attribute(name, self.nfa.output_type(attr))
                 for (name, _idx, attr, _w) in self.nfa.select_outputs]
        out_def = StreamDefinition(target, attrs)

        # run the condition programs and the step on an all-invalid block
        # BEFORE wiring the output tail: an expression the torch program
        # cannot evaluate rejects here (SiddhiAppCreationError, so the
        # fallback stays clean), while a copy, allocation or kernel that
        # fails raises as it is — it never becomes a host run
        self._warm()
        self.head = qr._finish_device_chain(out_def, factory)
        # outputs decoding from maybe-unmatched rows (or-sides, min-0
        # kleene) can be None → those columns ride object dtype
        self._nullable_out = {name for (name, row, _a, _w)
                              in self.nfa.select_outputs
                              if row in self.nfa.nullable_rows}
        self._scheduled_deadline = -1
        self._shutdown = False

        # one receiver per distinct input stream, on the global junctions
        for stream_id, code in self.nfa.stream_codes.items():
            recv = ProcessStreamReceiver(
                _DeviceIngress(self, code, stream_id), qr.lock,
                app.latency_tracker_for(qr.name), qr.name, app.app_ctx)
            app.junction_of(stream_id).subscribe(recv)
            qr.receivers[stream_id] = recv

        # ingest pipelining: keep up to `depth` chunks in flight so the
        # egress read overlaps later dispatches (plan/pipeline.py shares
        # the depth contract).  Absent patterns pipeline too: the earliest
        # pending deadline rides the egress tail
        self._inflight: "deque" = deque()
        self.pipeline_depth = resolve_depth(
            app.app, [app.junction_of(sid)
                      for sid in self.nfa.stream_codes])
        # fused per-app egress: the NFA's compacted match buffers ride
        # the app-wide slab — one D2H per ingest block across runtimes
        self.app_name = app.name
        self.nfa.egress_fuser = egress_fuser_for(app)
        self._junctions = {sid: app.junction_of(sid)
                           for sid in self.nfa.stream_codes}
        # on-device telemetry sink (@app:statistics(telemetry='true'))
        self._telemetry_sink = getattr(app, "device_telemetry", None)

    def _warm(self) -> None:
        """One all-invalid event per lane through the step (the state is
        unchanged by it: invalid events move nothing), its outputs
        discarded.  Only the condition programs' own rejections become
        SiddhiAppCreationError."""
        from .wagg_compiler import _EXPR_REJECTIONS
        nfa = self.nfa
        P = nfa.n_partitions
        warm = {a: np.zeros((P, 1), np.float32) for a in nfa.attr_names}
        warm["__ts"] = np.zeros((P, 1), np.int32)
        warm["__stream"] = np.zeros((P, 1), np.int32)
        warm["__valid"] = np.zeros((P, 1), bool)
        carry = nfa.carry
        try:
            nfa.process_block(warm)
        except _EXPR_REJECTIONS as e:
            raise SiddhiAppCreationError(
                f"device pattern path: condition rejected by the torch "
                f"program ({type(e).__name__}: {e})") from e
        finally:
            nfa.carry = carry

    # ------------------------------------------------------------ ingest

    def _lanes_for_keys(self, keys: List[Any]) -> np.ndarray:
        def grow(cap):
            # partition-axis growth invalidates the pre-carries held by
            # in-flight chunks (their P is the old width): retire them
            # first so grow-and-replay never mixes carry widths
            self.flush()
            self.nfa.grow(cap)
        return map_keys_to_lanes(self.key_lanes, keys,
                                 self.nfa.n_partitions, grow)

    def _event_cols(self, data, n: int) -> Dict[str, np.ndarray]:
        """Kernel input columns for a chunk (float32 lanes, raw string
        columns for dictionary encoding, exact-int companion lanes)."""
        cols = {}
        for a in self.nfa.attr_names:
            if a in self.nfa.derived:
                # string ORDER lane: computed by dispatch_events from the
                # raw source column (passed through below)
                src = self.nfa.derived[a][0]
                cols[src] = (data.columns.get(src)
                             if data.columns.get(src) is not None
                             else np.full(n, None, object))
                continue
            if a in self.nfa.int_exact_src:
                # exact integer companion lane: split from the RAW column
                # (the base f32 cast below would round above 2^24)
                src = self.nfa.int_exact_src[a]
                raw = data.columns.get(src)
                cols[a] = self.nfa.int_exact_lane(
                    a, raw if raw is not None else np.zeros(n, np.int64))
                continue
            col = data.columns.get(a)
            if a in self.nfa.encoded_attrs:
                # raw string column — the NFA dictionary-encodes it
                cols[a] = (col if col is not None
                           else np.full(n, None, object))
            else:
                cols[a] = (np.asarray(col, np.float32) if col is not None
                           else np.zeros(n, np.float32))
        return cols

    def ingest(self, stream_code: int, stream_id: str, chunk) -> None:
        from ..core.event import CURRENT
        from ..core.profiling import profiler
        data = chunk.only(CURRENT)
        if data.is_empty:
            return
        prof = profiler()
        disp0 = prof.total_dispatches() if prof.enabled else 0
        ticks0 = prof.total_scan_ticks() if prof.enabled else 0
        n = len(data)
        if self.keyed:
            ex = self.key_executors.get(stream_id)
            if ex is None:
                raise SiddhiAppCreationError(
                    f"device pattern path: stream '{stream_id}' has no "
                    f"partition key executor")
            keys = ex.keys(data)
            keep = np.asarray([k is not None for k in keys], bool)
            if not keep.all():
                data = data.mask(keep)
                keys = [k for k in keys if k is not None]
                n = len(data)
                if n == 0:
                    return
            pids = self._lanes_for_keys(keys)
        else:
            pids = np.zeros(n, np.int64)
        cols = self._event_cols(data, n)
        ts_arr = np.asarray(data.timestamps, np.int64)
        codes = np.full(n, stream_code, np.int32)
        with _ledger().span("device"):
            h = self.nfa.dispatch_events(pids, cols, ts_arr,
                                         stream_codes=codes)
        self._inflight.append(h)
        # retire down to the pipeline depth: with depth 0 matches are
        # delivered before ingest returns; with depth D the egress read of
        # chunk N overlaps chunks N+1..N+D's dispatch
        while len(self._inflight) > self.pipeline_depth:
            with _ledger().span("decode"):
                self._retire_one()
        tel = self.nfa.last_telemetry
        _record_block(self, prof, disp0, ticks0, stream_id, n,
                      junction=self._junctions.get(stream_id),
                      telemetry=(tel.sum(axis=0) if tel is not None
                                 else None))

    def _retire_one(self) -> None:
        """Block on the oldest in-flight chunk, handle slot-ring overflow
        (grow-and-replay: restore that chunk's pre-carry, double the ring,
        replay it and every later in-flight chunk), decode columnar,
        emit.  Callers hold the ledger's "decode" span; the slab read
        inside it is "egress_d2h", replayed dispatches "device"."""
        h = self._inflight.popleft()
        pids, ts, cols = self.nfa.retire_events(h)
        if self._telemetry_sink is not None and \
                self.nfa.last_telemetry is not None:
            self._telemetry_sink.update_nfa(
                self.qr.name, self.nfa.last_telemetry,
                len(self.nfa.spec.units),
                [u.kind for u in self.nfa.spec.units])
        dropped = self.nfa.last_dropped_total
        if dropped > self._dropped_seen and self.nfa.replayable:
            # slot overflow would LOSE matches (the oracle's pending lists
            # never drop): every chunk from this one on ran on a dropping
            # ring — rewind to this chunk's pre-carry, grow, replay all
            pending = [h] + list(self._inflight)
            self._inflight.clear()
            self.nfa.carry = h["pre_carry"]
            self.nfa.base_ts = h["pre_base"]
            self.nfa.grow_slots(self.nfa.spec.n_slots * 2)
            self.slot_grows += 1
            for e in pending:
                while True:
                    pre_carry, pre_base = self.nfa.carry, self.nfa.base_ts
                    self.replays += 1
                    with _ledger().span("device"):
                        r = self.nfa.replay_block(e)
                    pids, ts, cols = self.nfa.retire_events(r)
                    if self.nfa.last_dropped_total <= self._dropped_seen:
                        break
                    self.nfa.carry = pre_carry
                    self.nfa.base_ts = pre_base
                    self.nfa.grow_slots(self.nfa.spec.n_slots * 2)
                    self.slot_grows += 1
                self._emit_columns(pids, ts, cols)
            if self.nfa.has_absent:
                self._schedule_absent(self.nfa.last_min_deadline)
            return
        self._dropped_seen = max(dropped, self._dropped_seen)
        self._emit_columns(pids, ts, cols)
        if self.nfa.has_absent:
            # schedule off the retired chunk's carry — the deadline rode
            # the egress tail, no extra device read
            self._schedule_absent(self.nfa.last_min_deadline)

    def flush(self) -> None:
        """Retire every in-flight chunk (pipelined mode): called on idle/
        drain by the async junction, and before any state read.  Takes the
        query lock (re-entrant) — state reads can race the junction
        worker's ingest."""
        with self.qr.lock:
            while self._inflight:
                with _ledger().span("decode"):
                    self._retire_one()

    def _emit_columns(self, pids, ts, cols) -> None:
        from ..core.event import EventChunk
        from ..core.tracing import trace_span
        if not len(ts):
            return
        names = [o[0] for o in self.nfa.select_outputs]
        with trace_span("match.scatter", n=int(len(ts))):
            self.head.process(EventChunk.from_columns(names, ts, cols))

    def _emit(self, matches) -> None:
        from ..core.event import EventChunk
        if not matches:
            return
        names = [o[0] for o in self.nfa.select_outputs]
        out_cols: Dict[str, np.ndarray] = {}
        for (name, _idx, attr, _w) in self.nfa.select_outputs:
            vals = [m[2][name] for m in matches]
            dt = self._dtype_for(self.nfa.output_type(attr))
            if name in self._nullable_out or dt is object:
                col = np.empty(len(vals), object)
                col[:] = vals
            else:
                col = np.asarray(vals, dt)
            out_cols[name] = col
        ts = np.asarray([m[1] for m in matches], np.int64)
        self.head.process(EventChunk.from_columns(names, ts, out_cols))

    # -------------------------------------------------- absent-state timers

    def _schedule_absent(self, dl: Optional[int] = "read") -> None:
        """Arm a host TIMER at the earliest pending `not … for t` deadline
        (≙ AbsentStreamPreStateProcessor scheduling wakeups via
        util/Scheduler.java).  Retirement passes the egress-borne value;
        start/restore/timer paths read the live carry."""
        if dl == "read":
            dl = self.nfa.min_pending_deadline()
        if dl is None or dl == self._scheduled_deadline or self._shutdown:
            return
        self._scheduled_deadline = dl
        app_ctx = self.qr.app_runtime.app_ctx

        def fire(now, _dl=dl):
            if self._shutdown:
                return
            with self.qr.lock:
                self.flush()
                matches = self.nfa.process_timer(max(now, _dl))
                self._emit(matches)
                self._scheduled_deadline = -1
                self._schedule_absent()
        app_ctx.scheduler.notify_at(dl, fire)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self.nfa.spec.lead_absent and not self.keyed:
            # the leading absent partial waits from ENGINE START
            # (reference AbsentStreamPreStateProcessor.start).  Keyed
            # lanes arm on their FIRST event instead (kernel ensure-arm)
            now = self.qr.app_runtime.app_ctx.timestamp_generator \
                .current_time()
            self.nfa.arm_leading(now)
            self._schedule_absent()

    def shutdown(self) -> None:
        self.flush()
        self._shutdown = True

    # ------------------------------------------------------------ snapshot

    def current_state(self) -> dict:
        """The JAX package's runtime state dict (the engine's numpy state
        + key→lane map)."""
        with self.qr.lock:
            self.flush()
            return {"nfa": self.nfa.current_state(),
                    "key_lanes": dict(self.key_lanes)}

    def restore_state(self, state: dict) -> None:
        """Accepts this runtime's own ``current_state()`` or the JAX
        package's ``DevicePatternRuntime.current_state()`` unchanged."""
        with self.qr.lock:
            self.flush()
            if state.get("shards") is not None:
                raise SiddhiAppCreationError(
                    "sharded pattern state: shard-out not yet ported to "
                    "the torch backend")
            self.nfa.restore_state(state["nfa"])
            # the restored carry's lanes are only meaningful with the
            # snapshot's key→lane map; dropping it would hand restored
            # lanes of one key to fresh keys
            self.key_lanes = KeyLanes(state.get("key_lanes") or {})
        self._dropped_seen = int(self.nfa.carry["dropped"].sum())
        if self.nfa.has_absent:
            self._scheduled_deadline = -1
            self._schedule_absent()


class DeviceGroupedAggRuntime(_NotYetPorted):
    kind = "device grouped-aggregation path"


class DeviceFilterRuntime(_NotYetPorted):
    kind = "device filter path"


@persistent_schema(
    "keyed-window-agg", version=1, schema=Keyed("cwa"))
class DeviceWindowedAggRuntime(PipelinedDeviceIngest):
    """Partitioned length-window aggregation on the sliding-window step
    (ops/windowed_agg.py → csrc/wagg_length.cu): partition keys become
    group lanes of one ring slab (BASELINE config 2 — the reference's
    per-key window buffers + per-group aggregator maps,
    QuerySelector.java:171).  Ingest is pipelined (plan/pipeline.py)."""

    backend = "device"

    def __init__(self, query_runtime, sis, factory,
                 key_executors: Dict[str, Any]):
        from ..core.event import dtype_for
        from ..core.query_runtime import ProcessStreamReceiver
        from .expr_compiler import ExprCompiler, Scope
        from .wagg_compiler import CompiledWindowedAgg

        qr = query_runtime
        app = qr.app_runtime
        q = qr.query
        sel = q.selector
        if sel.having is not None or sel.order_by or \
                sel.limit is not None or sel.offset is not None:
            raise SiddhiAppCreationError(
                "device wagg path: having/order-by/limit are host-only")
        if getattr(q.output_stream, "events_for",
                   OutputEventsFor.CURRENT) != OutputEventsFor.CURRENT:
            raise SiddhiAppCreationError(
                "device wagg path: expired-event output is host-only")
        n_shards = resolve_shards()
        if n_shards >= 2:
            build_shards(None, n_shards)          # raises: not yet ported
        self.cwa = CompiledWindowedAgg(
            app.app, n_partitions=initial_lanes(app.app), query=q,
            device=app.app_ctx.siddhi_context.device)
        # the program sees int32 ts offsets while the host-twin emission
        # filter sees true int64 — absolute-timestamp filters would diverge
        if any(_scan_fns(e, _is_time_fn) for e in self.cwa.filter_exprs):
            raise SiddhiAppCreationError(
                "device wagg path: timestamp functions need int64 host "
                "evaluation")
        if self.cwa.value is not None and \
                self.cwa.value.type in (AttrType.INT, AttrType.LONG):
            raise SiddhiAppCreationError(
                "device wagg path: INT/LONG aggregate values ride float32 "
                "lanes (exact integer sums need the host path)")
        ex = key_executors.get(self.cwa.stream_id)
        if ex is None:
            raise SiddhiAppCreationError(
                f"device wagg path: stream '{self.cwa.stream_id}' has no "
                f"partition key executor")
        # group-by must be the partition key itself (lanes isolate keys)
        pt_expr = getattr(ex, "pt", None)
        pt_expr = getattr(pt_expr, "expression", None)
        for v in sel.group_by:
            if not (isinstance(pt_expr, Variable) and
                    v.attribute == pt_expr.attribute):
                raise SiddhiAppCreationError(
                    "device wagg path: group-by must equal the partition "
                    "key")
        self.key_executor = ex
        self.qr = qr
        self.key_lanes: Dict[Any, int] = KeyLanes()
        self._dtype_for = dtype_for

        # host-side twin of the filters for emission masking (same exprs,
        # numpy backend)
        scope = Scope()
        scope.add_primary(self.cwa.stream_id, sis.stream_ref,
                          self.cwa.input_definition)
        host_compiler = ExprCompiler(scope, np)
        self._host_filters = [host_compiler.compile(e)
                              for e in self.cwa.filter_exprs]

        # output definition with host-parity types
        vt = self.cwa.value.type if self.cwa.value is not None else None
        attrs = []
        for (name, kind, attr) in self.cwa.outputs:
            if kind == "key":
                t = dict((a.name, a.type) for a in
                         self.cwa.input_definition.attributes)[attr]
            elif kind == "count":
                t = AttrType.LONG
            elif kind == "sum":
                t = (AttrType.DOUBLE if vt in (AttrType.FLOAT,
                                               AttrType.DOUBLE, None)
                     else AttrType.LONG)
            elif kind in ("min", "max"):
                t = vt if vt is not None else AttrType.DOUBLE
            else:                                  # avg
                t = AttrType.DOUBLE
            attrs.append(Attribute(name, t))
        target = getattr(q.output_stream, "target_id", "") or qr.name
        out_def = StreamDefinition(target, attrs)

        # run the filter/value program, then the step, on an all-invalid
        # block BEFORE wiring the output tail: an expression the program
        # cannot evaluate rejects here (SiddhiAppCreationError, so the
        # fallback stays clean), while a copy, allocation or kernel that
        # fails raises as it is — it never becomes a host run
        P = self.cwa.n_partitions
        warm = {a.name: np.zeros((P, 1), np.float32)
                for a in self.cwa.input_definition.attributes
                if self._dtype_for(a.type) is not object}
        warm["__ts"] = np.zeros((P, 1), np.int32)
        warm["__valid"] = np.zeros((P, 1), bool)
        self.cwa.process_block(warm)
        self.head = qr._finish_device_chain(out_def, factory)

        recv = ProcessStreamReceiver(
            _DeviceIngress(self, 0, self.cwa.stream_id), qr.lock,
            app.latency_tracker_for(qr.name), qr.name, app.app_ctx)
        app.junction_of(self.cwa.stream_id).subscribe(recv)
        qr.receivers[self.cwa.stream_id] = recv
        self._init_pipeline(app, [self.cwa.stream_id])
        from .pipeline import egress_fuser_for
        self.app_name = app.name
        self._fuser = egress_fuser_for(app)

    # ------------------------------------------------------------ ingest

    def _grow(self, cap: int) -> None:
        # lane growth re-shapes the [P, ...] blocks: retire in-flight
        # work first so replay never mixes widths
        self.flush()
        self.cwa.grow(cap)

    def ingest(self, stream_code: int, stream_id: str, chunk) -> None:
        from ..core.event import CURRENT
        from ..core.profiling import profiler
        from ..ops.pack import pack_blocks
        data = chunk.only(CURRENT)
        if data.is_empty:
            return
        prof = profiler()
        disp0 = prof.total_dispatches() if prof.enabled else 0
        ticks0 = prof.total_scan_ticks() if prof.enabled else 0
        keys = self.key_executor.keys(data)
        keep = np.asarray([k is not None for k in keys], bool)
        if not keep.all():
            data = data.mask(keep)
            keys = [k for k in keys if k is not None]
            if data.is_empty:
                return
        n = len(data)
        lanes = map_keys_to_lanes(self.key_lanes, keys,
                                  self.cwa.n_partitions, self._grow)
        P = self.cwa.n_partitions
        cols = {a.name: np.asarray(data.columns[a.name])
                for a in self.cwa.input_definition.attributes
                if a.name in data.columns and
                data.columns[a.name].dtype != object}
        ts_arr = np.asarray(data.timestamps, np.int64)
        block, rows = pack_blocks(lanes, cols, ts_arr,
                                  np.zeros(n, np.int32), P,
                                  base_ts=int(ts_arr[0]), return_rows=True)
        with _ledger().span("device"):
            outs = self.cwa.process_block(block)
        token = None
        copy = None
        if self._fuser is not None:
            # outputs ride the app's per-ingest-block slab: one shared
            # D2H at retire instead of a read per runtime
            token = self._fuser.register(self, list(outs))
        else:
            copy = HostCopy(list(outs))
        self._submit({"fuse": token, "copy": copy, "data": data,
                      "lanes": lanes, "rows": rows})
        _record_block(self, prof, disp0, ticks0, stream_id, n)

    def _retire(self, work) -> None:
        from ..core.event import EventChunk
        data = work["data"]
        lanes, rows = work["lanes"], work["rows"]
        n = len(data)
        if work.get("fuse") is not None:
            outs = work["fuse"].fetch()
        else:
            with _ledger().span("egress_d2h"):
                outs = work["copy"].wait()
        sums = outs[0]
        counts = outs[1]
        mins = outs[2] if len(outs) > 2 else None
        maxs = outs[3] if len(outs) > 3 else None

        # host-side twin filter decides which input events emit output rows
        from .expr_compiler import EvalCtx
        okm = np.ones(n, bool)
        ctx = EvalCtx(data.columns, data.timestamps, n)
        for f in self._host_filters:
            m = np.asarray(f.fn(ctx), bool)
            okm &= np.broadcast_to(m, okm.shape)
        if not okm.any():
            return
        sel_l = lanes[okm]
        sel_r = rows[okm]
        ev_sums = sums[sel_l, sel_r].astype(np.float64)
        ev_counts = counts[sel_l, sel_r].astype(np.int64)
        names = [o[0] for o in self.cwa.outputs]
        cols: Dict[str, np.ndarray] = {}
        for (name, kind, attr) in self.cwa.outputs:
            if kind == "key":
                cols[name] = np.asarray(data.columns[attr])[okm]
            elif kind == "sum":
                cols[name] = ev_sums
            elif kind == "count":
                cols[name] = ev_counts
            elif kind == "min":
                cols[name] = mins[sel_l, sel_r]
            elif kind == "max":
                cols[name] = maxs[sel_l, sel_r]
            else:
                with np.errstate(invalid="ignore", divide="ignore"):
                    cols[name] = np.where(ev_counts > 0,
                                          ev_sums / np.maximum(ev_counts, 1),
                                          np.nan)
        out_ts = np.asarray(data.timestamps)[okm]
        self.head.process(EventChunk.from_columns(names, out_ts, cols))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        pass

    def shutdown(self) -> None:
        self.flush()

    # ------------------------------------------------------------ snapshot

    def current_state(self) -> dict:
        """The JAX package's runtime state dict (numpy carry leaves +
        key→lane map)."""
        with self.qr.lock:
            self.flush()
            return {"cwa": self.cwa.current_state(),
                    "key_lanes": dict(self.key_lanes)}

    def restore_state(self, state: dict) -> None:
        """Accepts this runtime's own ``current_state()`` or the JAX
        package's ``DeviceWindowedAggRuntime.current_state()`` unchanged."""
        with self.qr.lock:
            self.flush()
            if state.get("shards") is not None:
                raise SiddhiAppCreationError(
                    "sharded wagg state: shard-out not yet ported to the "
                    "torch backend")
            self.cwa.restore_state(state["cwa"])
            self.key_lanes = KeyLanes(state["key_lanes"])


def _plan(query_runtime, build):
    """Shared try-build: (runtime, reason) where exactly one side is None.
    'host' mode short-circuits; 'device' mode re-raises the incompatibility
    instead of falling back.  Only SiddhiAppCreationError is a fallback
    reason; anything else (RuntimeError from a missing device or a kernel
    failure) propagates."""
    app = query_runtime.app_runtime
    mode = engine_mode(app.app)
    if mode == "host":
        return None, "engine mode 'host'"
    try:
        return build(), None
    except SiddhiAppCreationError as e:
        if mode == "device":
            raise
        return None, str(e)


def plan_state_runtime(query_runtime, sis, factory):
    """Device pattern build (the NFA runtime; a rejection runs the query
    on the host under 'auto')."""
    return _plan(query_runtime,
                 lambda: DevicePatternRuntime(query_runtime, sis, factory))


def plan_single_runtime(query_runtime, sis, factory):
    """Device build for a single-stream query: aggregation/window shapes
    go to the grouped-agg path, stateless filter/project to the column
    program (both not yet ported: host under 'auto')."""
    from ..core.aggregator import is_aggregator
    from ..query_api import WindowHandler

    def is_agg(e):
        return is_aggregator(e.namespace, e.name, len(e.args))

    q = query_runtime.query
    has_window = any(isinstance(h, WindowHandler) for h in sis.handlers)
    has_agg = any(_scan_fns(oa.expr, is_agg)
                  for oa in q.selector.attributes) or \
        (q.selector.having is not None and
         _scan_fns(q.selector.having, is_agg))
    if has_window and not has_agg and not q.selector.group_by:
        # plain projection over a window: the dwin hybrid owns this shape
        return None, "window with plain projection → dwin hybrid path"
    if has_window or has_agg or q.selector.group_by:
        return _plan(query_runtime,
                     lambda: DeviceGroupedAggRuntime(query_runtime, sis,
                                                     factory))
    return _plan(query_runtime,
                 lambda: DeviceFilterRuntime(query_runtime, sis, factory))
