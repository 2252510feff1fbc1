"""Device/host query planner — routes each query to the device engine or
the host oracle.

Counterpart of ``siddhi_tpu/plan/planner.py``, carrying what the torch
port's slices so far need: engine selection, keyed lanes, the pattern
NFA runtime (:class:`DevicePatternRuntime`), the keyed length- and
time-window aggregation runtime (:class:`DeviceWindowedAggRuntime`),
the grouped / running / time-window aggregation runtime with its
selection tail (:class:`DeviceGroupedAggRuntime`) and the stateless
filter/project program (:class:`DeviceFilterRuntime`); device windows
under a host selector are plan/dwin_compiler.py's, wired by the query
runtime.  With ``SIDDHI_TPU_SHARDS=N`` (N >= 2) the keyed pattern,
wagg and gagg runtimes shard their key space over N engine clones
(parallel/shards.py); eligible pattern automata join the cross-tenant
packer (plan/xtenant.py).  A device path the port has not reached
raises ``SiddhiAppCreationError`` naming it "not yet ported", so
``'auto'`` falls back to the host exactly as the JAX package's planner
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
from ..parallel.shards import build_shards, resolve_shards, split_rows
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
    bucket = getattr(getattr(rt_obj, "nfa", None), "_tenant_bucket", None)
    if bucket is not None:
        # per-tenant attribution for packed runtimes: which shared bucket
        # this app's blocks ride, and how many tenants co-pay its gang
        extra = dict(extra or {}, xtenant={"bucket": bucket.label,
                                           "tenants": len(bucket.tenants)})
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


def _check_shard_count(shards, snap_shards) -> None:
    """Shard-count mismatch on restore is a routing change: key→shard
    assignment is modular in the shard count, so a snapshot taken at S
    shards only restores into S shards.  Raises the typed SC005 error
    naming expected-vs-found counts (the same diagnostic the envelope
    verifier emits before restore_state is reached — this guard covers
    snapshots restored through paths that skip the envelope)."""
    have = len(shards) if shards else 0
    want = len(snap_shards) if snap_shards else 0
    if have != want:
        from ..core.stateschema import shard_mismatch_message
        from ..utils.errors import CannotRestoreStateError
        raise CannotRestoreStateError(
            "SC005: " + shard_mismatch_message(have, want), code="SC005")


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


@persistent_schema(
    "keyed-pattern", version=1, schema=Keyed("nfa"),
    doc="per-key NFA lanes: one flat slab or per-shard sections keyed "
        "by the pinned FNV-1a routing")
class DevicePatternRuntime:
    """Pattern query running on the batched NFA step (plan/nfa_compiler
    → ops/nfa → csrc/nfa_step.cu on CUDA).

    Non-partitioned queries run a single lane (P=1); keyed mode (driven by
    core/partition.py) maps partition-key values to lanes of a slab that
    doubles on demand — the device replacement for the reference's per-key
    runtime clones (partition/PartitionRuntime.java:255-308).  Ingest is
    pipelined up to ``pipeline_depth`` chunks; a chunk whose slot ring
    overflowed is replayed from its pre-chunk carry on a doubled ring
    (grow-and-replay), so drops never lose matches.  Keyed runtimes shard
    out with ``SIDDHI_TPU_SHARDS``; the others join the cross-tenant
    packer (plan/xtenant.py)."""

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
        # partition shard-out (parallel/shards.py): with
        # SIDDHI_TPU_SHARDS=N (N >= 2) a keyed runtime splits its key
        # space over N engine clones
        want_shards = resolve_shards() if self.keyed else 0
        capacity = initial_lanes(app.app, want_shards) if self.keyed else 1
        self.nfa = CompiledPatternNFA(
            app.app, n_partitions=capacity,
            n_slots=DEFAULT_SLOTS if n_slots is None else n_slots, query=q,
            telemetry=telemetry, device=app.app_ctx.siddhi_context.device)
        self.shards: Optional[List[Any]] = None
        self.shard_reason: Optional[str] = None
        if want_shards >= 2:
            # shard-eligibility gates: these features aggregate across
            # the whole key space through ONE engine's carry, so the app
            # stays monolithic with the reason recorded (SA080 and the
            # partition's shard_report surface it)
            if self.nfa.has_absent:
                self.shard_reason = ("absent (`not ... for`) deadline "
                                     "timers arm off one engine's carry")
            elif telemetry:
                self.shard_reason = ("on-device telemetry aggregates one "
                                     "engine's occupancy planes")
            elif self.nfa.statically_dead:
                self.shard_reason = "statically dead automaton"
        self._shard_want = want_shards
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
        # cross-tenant packing (plan/xtenant.py): eligible small automata
        # of DIFFERENT apps bucket by shape class and step as one gang per
        # bucket per block.  A no-op when SIDDHI_TPU_XTENANT is off; with
        # pipeline depth 0 the bucket flushes inside every ingest
        from .xtenant import tenant_packer
        if self._shard_want >= 2 and self.shard_reason is None:
            # shard 0 adopts the template engine; siblings are fresh-state
            # clones sharing its step.  Each shard reads its own egress,
            # and sharded engines never join the packer
            self.nfa.egress_fuser = None
            self.shards = build_shards(self.nfa, self._shard_want)
            for sh in self.shards:
                sh.key_lanes = KeyLanes()
        else:
            tenant_packer().register(self.nfa, app=app.name, query=qr.name)

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

    # ------------------------------------------------------- sharded path

    def _ingest_sharded(self, stream_code: int, data, keys: List[Any],
                        n: int) -> None:
        """Route the chunk by consistent key hash and dispatch each
        shard's sub-block on that shard's own engine.  One hash pass per
        batch (split_rows); per-key event order is preserved (row indices
        ascend inside each sub-block); no step reduces across shards."""
        keys_arr = np.asarray(keys)
        cols = self._event_cols(data, n)
        ts_arr = np.asarray(data.timestamps, np.int64)
        for sid, rows in split_rows(keys_arr, len(self.shards)):
            sh = self.shards[sid]

            def grow(cap, sh=sh):
                # shard-local growth: only THIS engine's in-flight
                # pre-carries go stale, so only its queue is retired and
                # only its slab re-keys — sibling shards' carries are
                # untouched
                self._flush_shard(sh)
                sh.engine.grow(cap)
                sh.grows += 1

            pids = map_keys_to_lanes(sh.key_lanes, keys_arr[rows],
                                     sh.engine.n_partitions, grow)
            sub_cols = {k: np.asarray(v)[rows] for k, v in cols.items()}
            codes = np.full(len(rows), stream_code, np.int32)
            with _ledger().span("device"):
                h = sh.engine.dispatch_events(pids, sub_cols, ts_arr[rows],
                                              stream_codes=codes)
            sh.inflight.append(h)
            sh.events += len(rows)
            sh.dispatches += 1
            while len(sh.inflight) > self.pipeline_depth:
                with _ledger().span("decode"):
                    self._retire_shard(sh)

    def _retire_shard(self, sh) -> None:
        """Per-shard twin of _retire_one: wait for the shard's oldest
        in-flight chunk; on slot-ring overflow rewind/grow/replay THIS
        shard only."""
        h = sh.inflight.popleft()
        eng = sh.engine
        pids, ts, cols = eng.retire_events(h)
        dropped = eng.last_dropped_total
        if dropped > sh.dropped_seen and eng.replayable:
            pending = [h] + list(sh.inflight)
            sh.inflight.clear()
            eng.carry = h["pre_carry"]
            eng.base_ts = h["pre_base"]
            eng.grow_slots(eng.spec.n_slots * 2)
            sh.grows += 1
            for e in pending:
                while True:
                    pre_carry, pre_base = eng.carry, eng.base_ts
                    self.replays += 1
                    with _ledger().span("device"):
                        r = eng.replay_block(e)
                    pids, ts, cols = eng.retire_events(r)
                    if eng.last_dropped_total <= sh.dropped_seen:
                        break
                    eng.carry = pre_carry
                    eng.base_ts = pre_base
                    eng.grow_slots(eng.spec.n_slots * 2)
                    sh.grows += 1
                self._emit_columns(pids, ts, cols)
            return
        sh.dropped_seen = max(dropped, sh.dropped_seen)
        self._emit_columns(pids, ts, cols)

    def _flush_shard(self, sh) -> None:
        while sh.inflight:
            with _ledger().span("decode"):
                self._retire_shard(sh)

    def shard_stats(self) -> Optional[List[dict]]:
        if self.shards is None:
            return None
        return [sh.stats_row() for sh in self.shards]

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
            if self.shards is not None:
                self._ingest_sharded(stream_code, data, keys, n)
                _record_block(self, prof, disp0, ticks0, stream_id, n,
                              junction=self._junctions.get(stream_id))
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
            # packed tenant (plan/xtenant.py): later in-flight chunks may
            # still sit in the bucket queue; gang-step them NOW, before
            # the rewind.  Otherwise grow_slots' rebucket would flush them
            # onto the rewound carry AND the loop below would replay them
            # — the same block applied twice
            for e in pending:
                if "xpend" in e:
                    e["xpend"].resolve(e)
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
            if self.shards is not None:
                for sh in self.shards:
                    self._flush_shard(sh)
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
        # packed tenants leave their bucket on shutdown; co-tenants'
        # state is untouched (plan/xtenant.py evict contract).  Sharded
        # NFAs never registered, and evict is a no-op for them
        from .xtenant import tenant_packer
        tenant_packer().evict(self.nfa)

    # ------------------------------------------------------------ snapshot

    def current_state(self) -> dict:
        """The JAX package's runtime state dict (the engine's numpy state
        + key→lane map; per shard when sharded)."""
        with self.qr.lock:
            self.flush()
            if self.shards is not None:
                # shard-granular checkpoint: each slab snapshots on its
                # own (keys route by the pinned FNV hash, so a restored
                # shard's keys still land on it)
                return {"shards": [{"nfa": sh.engine.current_state(),
                                    "key_lanes": dict(sh.key_lanes)}
                                   for sh in self.shards]}
            return {"nfa": self.nfa.current_state(),
                    "key_lanes": dict(self.key_lanes)}

    def restore_state(self, state: dict) -> None:
        """Accepts this runtime's own ``current_state()`` or the JAX
        package's ``DevicePatternRuntime.current_state()`` unchanged."""
        with self.qr.lock:
            self.flush()
            snap_shards = state.get("shards")
            if snap_shards is not None or self.shards is not None:
                _check_shard_count(self.shards, snap_shards)
                for sh, st in zip(self.shards, snap_shards):
                    sh.engine.restore_state(st["nfa"])
                    sh.engine.pin_to_device(sh.device)
                    sh.key_lanes = KeyLanes(st.get("key_lanes") or {})
                    sh.dropped_seen = int(
                        sh.engine.carry["dropped"].sum())
                return
            self.nfa.restore_state(state["nfa"])
            # the restored carry's lanes are only meaningful with the
            # snapshot's key→lane map; dropping it would hand restored
            # lanes of one key to fresh keys
            self.key_lanes = KeyLanes(state.get("key_lanes") or {})
        self._dropped_seen = int(self.nfa.carry["dropped"].sum())
        if self.nfa.has_absent:
            self._scheduled_deadline = -1
            self._schedule_absent()


@persistent_schema(
    "keyed-grouped-agg", version=1, schema=Keyed("cga"))
class DeviceGroupedAggRuntime(PipelinedDeviceIngest):
    """Aggregation query on the grouped/running step (plan/gagg_compiler
    .CompiledGroupedAgg → ops/grouped_agg → csrc/grouped_agg.cu on CUDA):
    group-by keys finer than (or different from) the partition key,
    no-window running aggregates, minForever/maxForever, exact INT/LONG
    sums, time windows and an expressible selection tail (ops/select.py).
    Keyed mode maps partition keys to lanes (like DevicePatternRuntime);
    unkeyed mode runs one lane.  Ingest is pipelined (plan/pipeline.py):
    each chunk's step dispatches at once, its decode retires up to
    ``pipeline_depth`` chunks later.  Keyed runtimes shard out with
    ``SIDDHI_TPU_SHARDS`` (works carry their shard)."""

    backend = "device"

    def __init__(self, query_runtime, sis, factory,
                 key_executors: Optional[Dict[str, Any]] = None):
        from ..core.event import dtype_for
        from ..core.query_runtime import ProcessStreamReceiver
        from .gagg_compiler import CompiledGroupedAgg
        from .pipeline import egress_fuser_for

        qr = query_runtime
        app = qr.app_runtime
        q = qr.query
        sel = q.selector
        # having/order-by/limit lower into the selection step when
        # expressible (plan/select_compiler.py); the compiler rejects,
        # with the blocking reason, only what the host QuerySelector keeps
        if getattr(q.output_stream, "events_for",
                   OutputEventsFor.CURRENT) != OutputEventsFor.CURRENT:
            raise SiddhiAppCreationError(
                "device grouped-agg path: expired-event output is "
                "host-only")
        if any(_scan_fns(e, _is_time_fn)
               for e in [oa.expr for oa in sel.attributes] +
               [h.expr for h in sis.handlers
                if hasattr(h, "expr")]):
            raise SiddhiAppCreationError(
                "device grouped-agg path: timestamp functions need int64 "
                "host evaluation")
        if app.has_named_window(sis.stream_id):
            raise SiddhiAppCreationError(
                "device grouped-agg path: named-window input is host-only")
        self.keyed = key_executors is not None
        self._shard_want = resolve_shards() if self.keyed else 0
        self.cga = CompiledGroupedAgg(
            app.app, q,
            n_lanes=initial_lanes(app.app, self._shard_want)
            if self.keyed else 1,
            keyed=self.keyed, device=app.app_ctx.siddhi_context.device)
        # surfaced by service/rest.py stats: did the selection tail
        # (having/order/limit) compile to the device?
        self.selection_route = None
        if self.cga.selection is not None:
            self.selection_route = {"backend": "device",
                                    "sig": self.cga.selection.key}
        if self.keyed:
            ex = key_executors.get(self.cga.stream_id)
            if ex is None:
                raise SiddhiAppCreationError(
                    f"device grouped-agg path: stream "
                    f"'{self.cga.stream_id}' has no partition key executor")
            self.key_executor = ex
        self.key_lanes: Dict[Any, int] = KeyLanes()
        self.qr = qr
        self._dtype_for = dtype_for

        attrs = [Attribute(name,
                           self.cga.output_attr_type(kind, attr))
                 for (name, kind, attr) in self.cga.outputs]
        target = getattr(q.output_stream, "target_id", "") or qr.name
        out_def = StreamDefinition(target, attrs)
        self.head = qr._finish_device_chain(out_def, factory)

        recv = ProcessStreamReceiver(
            _DeviceIngress(self, 0, self.cga.stream_id), qr.lock,
            app.latency_tracker_for(qr.name), qr.name, app.app_ctx)
        app.junction_of(self.cga.stream_id, sis.is_inner,
                        sis.is_fault).subscribe(recv)
        qr.receivers[self.cga.stream_id] = recv
        self._init_pipeline(app, [self.cga.stream_id])
        self.cga.flush_hook = self.flush
        self.app_name = app.name
        # the compiler owns dispatch/decode, so it registers its own
        # output buffers on the app slab
        self.cga.egress_fuser = egress_fuser_for(app)
        self.shards: Optional[List[Any]] = None
        if self._shard_want >= 2:
            # each shard reads its own outputs; clones share the
            # template's programs but own fresh group dictionaries
            # (clone_for_shard), so group ids stay shard-local.  Every
            # shard's group growth funnels through the shared flush
            # (pre-carries of in-flight works go stale)
            self.cga.egress_fuser = None
            self.shards = build_shards(self.cga, self._shard_want)
            for sh in self.shards:
                sh.key_lanes = KeyLanes()
                sh.engine.flush_hook = self.flush

    # ------------------------------------------------------------ ingest

    def _grow_lanes(self, cap: int) -> None:
        # lane growth re-shapes the [P, ...] planes: retire in-flight
        # work first so replay never mixes widths
        self.flush()
        self.cga.grow_lanes(cap)

    def _ingest_sharded(self, data, keys: List[Any]) -> None:
        """Hash-route the chunk; each shard's sub-block dispatches on its
        own engine.  Works carry a "shard" tag so the retire path decodes
        (and, on overflow, rewinds/replays) against the right engine
        while sibling shards' in-flight works stay queued untouched."""
        keys_arr = np.asarray(keys)
        for sid, rows in split_rows(keys_arr, len(self.shards)):
            sh = self.shards[sid]
            m = np.zeros(len(data), bool)
            m[rows] = True
            sub = data.mask(m)

            def grow(cap, sh=sh):
                self.flush()
                sh.engine.grow_lanes(cap)
                sh.grows += 1

            lanes = map_keys_to_lanes(sh.key_lanes, keys_arr[rows],
                                      sh.engine.n_lanes, grow)
            with _ledger().span("device"):
                work = sh.engine.dispatch(lanes, sub)
            sh.events += len(rows)
            if work is None:
                continue
            sh.dispatches += 1
            work["shard"] = sh
            self._submit(work)

    def shard_stats(self) -> Optional[List[dict]]:
        if self.shards is None:
            return None
        return [sh.stats_row() for sh in self.shards]

    def _take_same_shard(self, sh) -> list:
        """Pull the failing engine's LATER in-flight works out of the
        shared queue for replay; other shards' works keep their queue
        positions (their pre-carries belong to other engines and stay
        valid).  Unsharded: takes everything."""
        if sh is None:
            rest = list(self._inflight)
            self._inflight.clear()
            return rest
        mine = [w for w in self._inflight if w.get("shard") is sh]
        keep = [w for w in self._inflight if w.get("shard") is not sh]
        self._inflight.clear()
        self._inflight.extend(keep)
        return mine

    def ingest(self, stream_code: int, stream_id: str, chunk) -> None:
        from ..core.event import CURRENT
        from ..core.profiling import profiler
        data = chunk.only(CURRENT)
        if data.is_empty:
            return
        prof = profiler()
        disp0 = prof.total_dispatches() if prof.enabled else 0
        ticks0 = prof.total_scan_ticks() if prof.enabled else 0
        if self.keyed:
            keys = self.key_executor.keys(data)
            keep = np.asarray([k is not None for k in keys], bool)
            if not keep.all():
                data = data.mask(keep)
                keys = [k for k in keys if k is not None]
                if data.is_empty:
                    return
            if self.shards is not None:
                self._ingest_sharded(data, keys)
                _record_block(self, prof, disp0, ticks0, stream_id,
                              len(data))
                return
            lanes = map_keys_to_lanes(self.key_lanes, keys,
                                      self.cga.n_lanes, self._grow_lanes)
        else:
            lanes = np.zeros(len(data), np.int64)
        with _ledger().span("device"):
            work = self.cga.dispatch(lanes, data)
        if work is None:
            return
        self._submit(work)
        _record_block(self, prof, disp0, ticks0, stream_id, len(data))

    def _retire(self, work) -> None:
        from ..utils.errors import SiddhiAppRuntimeException
        from .gagg_compiler import GaggOverflow
        sh = work.get("shard")
        eng = sh.engine if sh is not None else self.cga
        try:
            res = eng.decode(work)
        except GaggOverflow:
            # a still-in-window time-ring entry was evicted: rewind to
            # this chunk's pre-carry, grow the ring, replay it and every
            # later in-flight chunk OF THIS ENGINE (exact — no
            # undercounted windows); sibling shards are untouched
            pending = [work] + self._take_same_shard(sh)
            eng.carry = work["pre_carry"]
            eng.grow_time_window()
            if sh is not None:
                sh.grows += 1
            for w in pending:
                while True:
                    with _ledger().span("device"):
                        eng.redispatch(w)
                    try:
                        res = eng.decode(w)
                        break
                    except GaggOverflow:
                        eng.carry = w["pre_carry"]
                        eng.grow_time_window()
                        if sh is not None:
                            sh.grows += 1
                self._emit(w, res)
            return
        except SiddhiAppRuntimeException:
            # data error (the exact-sum bound of running configs; a time
            # window never trips it): drop the chunk — rewind its carry,
            # replay the LATER chunks, and re-raise at the @OnError
            # boundary.  A replayed chunk that trips the bound again is
            # un-applied and dropped the same way
            rest = self._take_same_shard(sh)
            eng.carry = work["pre_carry"]
            for w in rest:
                eng.redispatch(w)
                try:
                    res = eng.decode(w)
                except SiddhiAppRuntimeException:
                    eng.carry = w["pre_carry"]
                    continue
                self._emit(w, res)
            raise
        self._emit(work, res)

    def _emit(self, work, res) -> None:
        from ..core.event import EventChunk
        data = work["data"]
        sel = res.pop("sel_rows", None)
        if sel is not None:
            # the selection step already masked/ordered/limited the rows;
            # sel holds chunk-row indices in emission order
            if len(sel) == 0:
                return
            out_ts = np.asarray(data.timestamps)[sel]
        else:
            ok = res.pop("mask")
            out_ts = np.asarray(data.timestamps)[ok]
        names = [o[0] for o in self.cga.outputs]
        cols: Dict[str, np.ndarray] = {}
        for (name, kind, attr) in self.cga.outputs:
            dt = self._dtype_for(self.cga.output_attr_type(kind, attr))
            v = res[name]
            if dt is object:
                col = np.empty(len(v), object)
                col[:] = list(v)
                cols[name] = col
            else:
                cols[name] = np.asarray(v).astype(dt)
        self.head.process(EventChunk.from_columns(names, out_ts, cols))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        pass

    def shutdown(self) -> None:
        self.flush()

    # ------------------------------------------------------------ snapshot

    def current_state(self) -> dict:
        """The JAX package's runtime state dict (the engine's numpy state
        + key→lane map)."""
        with self.qr.lock:
            self.flush()
            if self.shards is not None:
                return {"shards": [{"cga": sh.engine.current_state(),
                                    "key_lanes": dict(sh.key_lanes)}
                                   for sh in self.shards]}
            return {"cga": self.cga.current_state(),
                    "key_lanes": dict(self.key_lanes)}

    def restore_state(self, state: dict) -> None:
        """Accepts this runtime's own ``current_state()`` or the JAX
        package's ``DeviceGroupedAggRuntime.current_state()`` unchanged."""
        with self.qr.lock:
            self.flush()
            snap_shards = state.get("shards")
            if snap_shards is not None or self.shards is not None:
                _check_shard_count(self.shards, snap_shards)
                for sh, st in zip(self.shards, snap_shards):
                    sh.engine.restore_state(st["cga"])
                    sh.engine.pin_to_device(sh.device)
                    sh.key_lanes = KeyLanes(st["key_lanes"])
                return
            self.cga.restore_state(state["cga"])
            self.key_lanes = KeyLanes(state["key_lanes"])


@persistent_schema("device-filter", schema=None,
                   doc="stateless: the deferred mask read needs no "
                       "replay machinery at all")
class DeviceFilterRuntime(PipelinedDeviceIngest):
    """Stateless filter/project query as one column program over the
    torch expression programs (plan/expr_compiler.TorchXP, K5) — the
    device replacement for the reference's per-event expression-tree DFS
    (FilterProcessor.java:55-67 + QuerySelector attribute processors).
    String predicates run on per-chunk code lanes (plan/str_lanes.py).
    Elementwise: no hand kernel.  Ingest is pipelined (plan/pipeline.py);
    stateless, so the deferred mask read needs no replay machinery."""

    backend = "device"

    def __init__(self, query_runtime, sis, factory):
        from ..core.aggregator import is_aggregator
        from ..core.event import dtype_for
        from ..core.query_runtime import ProcessStreamReceiver
        from ..ops.windowed_agg import kernel_device
        from ..query_api import Filter
        from ..query_api.query import OutputAttribute
        from .expr_compiler import EvalCtx, ExprCompiler, Scope, TorchXP
        from .pipeline import egress_fuser_for
        from .str_lanes import StringLanes, StringRewriteError
        from .wagg_compiler import _EXPR_REJECTIONS
        import torch

        qr = query_runtime
        app = qr.app_runtime
        q = qr.query
        sel = q.selector
        if sel.group_by or sel.having is not None or sel.order_by or \
                sel.limit is not None or sel.offset is not None:
            raise SiddhiAppCreationError(
                "device filter path: group-by/having/order-by/limit are "
                "host-only")
        if any(not isinstance(h, Filter) for h in sis.handlers):
            raise SiddhiAppCreationError(
                "device filter path: windows/stream functions are stateful")

        def is_agg(e):
            return is_aggregator(e.namespace, e.name, len(e.args))

        definition = app.definition_of(sis.stream_id, sis.is_inner,
                                       sis.is_fault)
        self.definition = definition
        numeric = {a.name for a in definition.attributes
                   if dtype_for(a.type) is not object}

        sel_attrs = sel.attributes
        if sel.select_all:            # `select *` → passthrough of all attrs
            sel_attrs = [OutputAttribute(a.name, Variable(a.name))
                         for a in definition.attributes]

        # string predicates lower onto per-chunk order-preserving code
        # lanes (plan/str_lanes.py) — ==/!=/order/is-null over STRING
        # attrs evaluate on the device via integer ranks; constructs with
        # no lane form reject with the rewrite's reason
        slanes = StringLanes({a.name for a in definition.attributes
                              if a.type == AttrType.STRING})
        try:
            filter_exprs = [slanes.rewrite(h.expr) for h in sis.handlers]
        except StringRewriteError as se:
            raise SiddhiAppCreationError(
                f"device filter path: {se}") from se
        out_rewritten = {}
        for oa in sel_attrs:
            try:
                out_rewritten[id(oa)] = slanes.rewrite(oa.expr)
            except StringRewriteError:
                pass                  # host-expr fallback handles it
        self._slanes = slanes

        scope = Scope()
        ext_def = definition
        if slanes.any:
            ext_def = StreamDefinition(
                definition.id, list(definition.attributes) +
                [Attribute(nm, AttrType.FLOAT)
                 for nm in slanes.lane_names()])
        scope.add_primary(sis.stream_id, sis.stream_ref, ext_def)
        self.device = kernel_device(app.app_ctx.siddhi_context.device)
        xp = TorchXP(self.device)
        compiler = ExprCompiler(scope, xp)
        filters = [compiler.compile(e) for e in filter_exprs]

        if any(_scan_fns(oa.expr, is_agg) for oa in sel_attrs):
            raise SiddhiAppCreationError(
                "device filter path: aggregates are stateful (host windows)")
        if any(_scan_fns(h.expr, _is_time_fn) for h in sis.handlers):
            # the device FILTER must be exact; output expressions with
            # time functions evaluate host-side below instead
            raise SiddhiAppCreationError(
                "device filter path: timestamp functions in filters need "
                "int64 host evaluation")

        # outputs: plain attribute passthroughs gather host-side by mask
        # (exact dtypes — INT/LONG would corrupt on float32 device lanes);
        # computed FLOAT/DOUBLE/BOOL outputs evaluate on the device;
        # computed outputs the device cannot express exactly (STRING/
        # OBJECT, INT/LONG, timestamp functions) evaluate host-side on
        # the device-masked rows
        self.outputs = []      # (name, 'host_col'|'dev'|'host_expr', ref)
        dev_exprs = []
        host_exprs = []
        attrs = []
        host_compiler = ExprCompiler(scope, np,
                                     app.app_ctx.script_functions,
                                     app.extension_registry)
        attr_types = {a.name: a.type for a in definition.attributes}
        for oa in sel_attrs:
            e = oa.expr
            if isinstance(e, Variable) and e.attribute in attr_types and \
                    e.stream_index is None:
                self.outputs.append((oa.rename, "host_col", e.attribute))
                attrs.append(Attribute(oa.rename, attr_types[e.attribute]))
                continue
            ce = None
            if not _scan_fns(e, _is_time_fn):
                try:
                    ce = compiler.compile(out_rewritten.get(id(oa), e))
                except Exception:       # noqa: BLE001 — host expr instead
                    ce = None
            if ce is None or dtype_for(ce.type) is object or \
                    ce.type in (AttrType.INT, AttrType.LONG):
                che = host_compiler.compile(e)
                self.outputs.append((oa.rename, "host_expr",
                                     len(host_exprs)))
                host_exprs.append(che)
                attrs.append(Attribute(oa.rename, che.type))
            else:
                self.outputs.append((oa.rename, "dev", len(dev_exprs)))
                dev_exprs.append(ce)
                attrs.append(Attribute(oa.rename, ce.type))
        if host_exprs and not filters:
            raise SiddhiAppCreationError(
                "device filter path: no filters and host-only computed "
                "outputs — nothing to run on the device")
        self._host_exprs = host_exprs
        self._dev_dtypes = [dtype_for(ce.type) for ce in dev_exprs]
        self.numeric = sorted(numeric)

        def program(cols, ts, valid):
            n = ts.shape[0]
            ctx = EvalCtx(cols, ts, n)
            ok = valid
            for f in filters:
                m = xp.asarray(f.fn(ctx), bool)
                ok = ok & m.expand(ok.shape)
            outs = [xp.asarray(ce.fn(ctx)).expand(n).contiguous()
                    for ce in dev_exprs]
            return ok, outs

        from ..core.profiling import wrap_kernel
        from .shapes import shape_registry
        self._program = wrap_kernel(
            "filter.program",
            shape_registry().jit(
                "filter.program",
                {"filters": len(filters), "outs": len(dev_exprs),
                 "lanes": len(self.numeric), "device": self.device.type},
                program),
            batch_of=lambda cols, ts, valid: int(ts.shape[0]))

        # run the program on one invalid row now, so an expression the
        # torch program cannot take rejects at plan time; a failed copy,
        # allocation or launch raises as it is (never a host run)
        warm = {a: torch.zeros((1,), dtype=torch.float32, device=self.device)
                for a in self.numeric + self._slanes.lane_names()}
        try:
            self._program(warm,
                          torch.zeros((1,), dtype=torch.int32,
                                      device=self.device),
                          torch.zeros((1,), dtype=torch.bool,
                                      device=self.device))
        except _EXPR_REJECTIONS as e:
            raise SiddhiAppCreationError(
                f"device filter path: program rejected by the torch "
                f"namespace ({type(e).__name__}: {e})") from e

        if app.has_named_window(sis.stream_id):
            raise SiddhiAppCreationError(
                "device filter path: named-window input is host-only")
        target = getattr(q.output_stream, "target_id", "") or qr.name
        self.head = qr._finish_device_chain(StreamDefinition(target, attrs),
                                            factory)
        self.qr = qr
        recv = ProcessStreamReceiver(
            _DeviceIngress(self, 0, sis.stream_id), qr.lock,
            app.latency_tracker_for(qr.name), qr.name, app.app_ctx)
        app.junction_of(sis.stream_id, sis.is_inner,
                        sis.is_fault).subscribe(recv)
        qr.receivers[sis.stream_id] = recv
        self._init_pipeline(app, [sis.stream_id])
        self.app_name = app.name
        self._fuser = egress_fuser_for(app)

    # ------------------------------------------------------------ ingest

    def ingest(self, stream_code: int, stream_id: str, chunk) -> None:
        import torch
        from ..core.profiling import profiler
        n = len(chunk)
        if n == 0:
            return
        prof = profiler()
        disp0 = prof.total_dispatches() if prof.enabled else 0
        ticks0 = prof.total_scan_ticks() if prof.enabled else 0
        n_pad = 1 << (n - 1).bit_length()
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        cols = {}
        for a in self.numeric:
            col = chunk.columns.get(a)
            arr = np.zeros(n_pad, np.float32)
            if col is not None:
                arr[:n] = np.asarray(col, np.float32)
            cols[a] = put(arr)
        if self._slanes.any:
            for nm, lane in self._slanes.encode(chunk.columns, n,
                                                n_pad).items():
                cols[nm] = put(np.ascontiguousarray(lane, np.float32))
        # int32 ts offsets — absolute-timestamp functions are planner-
        # rejected on this path, nothing else reads ctx.timestamps
        ts = np.zeros(n_pad, np.int32)
        ts_arr = np.asarray(chunk.timestamps)
        ts[:n] = (ts_arr - ts_arr[0]).astype(np.int32)
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        with _ledger().span("device"):
            ok, outs = self._program(cols, put(ts), put(valid))
        token = copy = None
        if self._fuser is not None:
            # mask + device columns ride the app's per-ingest-block slab
            token = self._fuser.register(self, [ok] + list(outs))
        else:
            copy = HostCopy([ok] + list(outs))
        self._submit({"fuse": token, "copy": copy, "chunk": chunk, "n": n})
        _record_block(self, prof, disp0, ticks0, stream_id, n)

    def _retire(self, work) -> None:
        from ..core.event import TIMER, RESET, EventChunk
        from ..core.tracing import trace_span
        chunk, n = work["chunk"], work["n"]
        if work.get("fuse") is not None:
            fetched = work["fuse"].fetch()
        else:
            with _ledger().span("egress_d2h"):
                fetched = work["copy"].wait()
        ok, outs = fetched[0][:n], fetched[1:]
        # TIMER/RESET rows always pass (host FilterProcessor parity)
        ok = ok | (chunk.types == TIMER) | (chunk.types == RESET)
        if not ok.any():
            return
        hctx = None
        if self._host_exprs:
            from .expr_compiler import EvalCtx
            masked = chunk.mask(ok)
            hctx = EvalCtx(masked.columns, masked.timestamps, len(masked))
        out_cols: Dict[str, np.ndarray] = {}
        for (name, kind, ref) in self.outputs:
            if kind == "host_col":
                out_cols[name] = np.asarray(chunk.columns[ref])[ok]
            elif kind == "host_expr":
                v = np.asarray(self._host_exprs[ref].fn(hctx))
                if v.ndim == 0:
                    v = np.broadcast_to(v, (hctx.n,))
                out_cols[name] = v
            else:
                arr = np.asarray(outs[ref])[:n][ok]
                out_cols[name] = arr.astype(self._dev_dtypes[ref])
        out = EventChunk.from_columns(
            [o[0] for o in self.outputs],
            np.asarray(chunk.timestamps)[ok], out_cols,
            types=chunk.types[ok])
        with trace_span("match.scatter", n=len(out)):
            self.head.process(out)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        pass

    def shutdown(self) -> None:
        self.flush()

    def current_state(self):
        self.flush()
        return None

    def restore_state(self, state):
        pass


@persistent_schema(
    "keyed-window-agg", version=1, schema=Keyed("cwa"))
class DeviceWindowedAggRuntime(PipelinedDeviceIngest):
    """Partitioned length- or time-window aggregation on the sliding-
    window steps (ops/windowed_agg.py → csrc/wagg_length.cu, K1, and
    csrc/wagg_time.cu, K6): partition keys become group lanes of one ring
    slab (BASELINE config 2 — the reference's per-key window buffers +
    per-group aggregator maps, QuerySelector.java:171).  Ingest is
    pipelined (plan/pipeline.py); ``SIDDHI_TPU_SHARDS`` shards the key
    space over engine clones."""

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
        # always keyed (partition-driven); shard-out splits the key space
        # over engine clones when SIDDHI_TPU_SHARDS >= 2
        self._shard_want = resolve_shards()
        self.cwa = CompiledWindowedAgg(
            app.app, n_partitions=initial_lanes(app.app, self._shard_want),
            query=q, device=app.app_ctx.siddhi_context.device)
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
        warm["__ts64"] = np.zeros((P, 1), np.int64)
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
        self.shards: Optional[List[Any]] = None
        if self._shard_want >= 2:
            # each shard's outputs are read on their own; built AFTER the
            # warm block so every clone shares the template's step
            self._fuser = None
            self.shards = build_shards(self.cwa, self._shard_want)
            for sh in self.shards:
                sh.key_lanes = KeyLanes()

    # ------------------------------------------------------------ ingest

    def _grow(self, cap: int) -> None:
        # lane growth re-shapes the [P, ...] blocks: retire in-flight
        # work first so replay never mixes widths
        self.flush()
        self.cwa.grow(cap)

    def ingest(self, stream_code: int, stream_id: str, chunk) -> None:
        from ..core.event import CURRENT
        from ..core.profiling import profiler
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
        if self.shards is not None:
            self._ingest_sharded(data, keys)
            _record_block(self, prof, disp0, ticks0, stream_id, n)
            return
        lanes = map_keys_to_lanes(self.key_lanes, keys,
                                  self.cwa.n_partitions, self._grow)
        self._dispatch_block(self.cwa, data, lanes, self._fuser)
        _record_block(self, prof, disp0, ticks0, stream_id, n)

    def _dispatch_block(self, eng, data, lanes: np.ndarray, fuser) -> None:
        """Pack one chunk's events into ``eng``'s [P, T] lanes, step it
        and submit the work (its outputs on the app slab, or read on
        their own)."""
        from ..ops.pack import pack_blocks
        n = len(data)
        P = eng.n_partitions
        cols = {a.name: np.asarray(data.columns[a.name])
                for a in eng.input_definition.attributes
                if a.name in data.columns and
                data.columns[a.name].dtype != object}
        ts_arr = np.asarray(data.timestamps, np.int64)
        block, rows = pack_blocks(lanes, cols, ts_arr,
                                  np.zeros(n, np.int32), P,
                                  base_ts=int(ts_arr[0]), return_rows=True)
        if eng.window_kind == "time":
            # absolute i64 ts lanes: the time step's expiry must be
            # comparable ACROSS blocks (packed __ts is per-block offsets);
            # externalTime reads the event's ts attribute instead
            src = (np.asarray(data.columns[eng.ts_attr], np.int64)
                   if eng.ts_attr else ts_arr)
            ts64 = np.zeros(block["__ts"].shape, np.int64)
            ts64[lanes, rows] = src
            block["__ts64"] = ts64
        with _ledger().span("device"):
            outs = eng.process_block(block)
        token = None
        copy = None
        if fuser is not None:
            # outputs ride the app's per-ingest-block slab: one shared
            # D2H at retire instead of a read per runtime
            token = fuser.register(self, list(outs))
        else:
            copy = HostCopy(list(outs))
        self._submit({"fuse": token, "copy": copy, "data": data,
                      "lanes": lanes, "rows": rows})

    def _ingest_sharded(self, data, keys: List[Any]) -> None:
        """Hash-route the chunk and run each shard's sub-block through its
        own window slab.  The retire path is untouched: a work carries its
        own lanes/rows/data, and _retire never mutates engine state, so
        shard works share the pipeline queue safely."""
        keys_arr = np.asarray(keys)
        for sid, rows_idx in split_rows(keys_arr, len(self.shards)):
            sh = self.shards[sid]
            m = np.zeros(len(data), bool)
            m[rows_idx] = True
            sub = data.mask(m)

            def grow(cap, sh=sh):
                # same width contract as _grow; the full flush is cheap
                # (retire only reads) and keeps one code path
                self.flush()
                sh.engine.grow(cap)
                sh.grows += 1

            lanes = map_keys_to_lanes(sh.key_lanes, keys_arr[rows_idx],
                                      sh.engine.n_partitions, grow)
            self._dispatch_block(sh.engine, sub, lanes, None)
            sh.events += len(sub)
            sh.dispatches += 1

    def shard_stats(self) -> Optional[List[dict]]:
        if self.shards is None:
            return None
        return [sh.stats_row() for sh in self.shards]

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
            if self.shards is not None:
                return {"shards": [{"cwa": sh.engine.current_state(),
                                    "key_lanes": dict(sh.key_lanes)}
                                   for sh in self.shards]}
            return {"cwa": self.cwa.current_state(),
                    "key_lanes": dict(self.key_lanes)}

    def restore_state(self, state: dict) -> None:
        """Accepts this runtime's own ``current_state()`` or the JAX
        package's ``DeviceWindowedAggRuntime.current_state()`` unchanged."""
        with self.qr.lock:
            self.flush()
            snap_shards = state.get("shards")
            if snap_shards is not None or self.shards is not None:
                _check_shard_count(self.shards, snap_shards)
                for sh, st in zip(self.shards, snap_shards):
                    sh.engine.restore_state(st["cwa"])
                    sh.engine.pin_to_device(sh.device)
                    sh.key_lanes = KeyLanes(st["key_lanes"])
                return
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
    program; a window with a plain projection is left to the dwin hybrid
    (device window state, host selector; core/query_runtime.py
    ``_try_device_window``)."""
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
