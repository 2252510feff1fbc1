"""Device window processor: window state as device ring slabs (ops/dwin).

Counterpart of ``siddhi_tpu/plan/dwin_compiler.py``.  Drops into the host
query chain in place of a host WindowProcessor (core/window.py) — same
Processor interface, same emission algebra — but the buffer of record is
a device ring slab and every eviction / batch flush is computed by the
device step (``ops.dwin.dwin_step``: the K9 kernel ``csrc/dwin_step.cu``
on CUDA, the plain PyTorch version on the CPU; closed-form index math,
one compacted egress buffer read by one device-to-host copy a step).
Downstream (QuerySelector, rate limiters, callbacks) is unchanged host
code, so the reference's
CURRENT/EXPIRED/RESET semantics (siddhi-architecture.md:253-268) hold by
construction; the hybrid split (device window state + host selector) is
recorded in docs/device_coverage.md.

Payload lanes: FLOAT→f32, INT/BOOL→i32, LONG→i32 hi/lo pair (exact
within ±2^62; values beyond raise at encode time), STRING→dictionary
code, DOUBLE→two bitcast i32 lanes (exact, incl. NaN/±0 — a reserved
quiet-NaN bit pattern is the null sentinel).  Only OBJECT payloads
reject at plan time.

The steps write a fresh carry: a work item keeps the carry it ran from,
and on a ring overflow (the egress tail's overflow word) the processor
rewinds to it, doubles the ring and replays, as the JAX package does.
State crosses between the packages unchanged (``current_state`` is the
JAX package's numpy dict; :func:`carry_from_reference`).

Reference: query/processor/stream/window/{Length,LengthBatch,Time,
TimeBatch,ExternalTime,ExternalTimeBatch,TimeLength,Delay,Batch}
WindowProcessor.java.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.event import CURRENT, EXPIRED, EventChunk, dtype_for
from ..core.stateschema import (Carry, ListOf, MapOf, Scalar, Struct,
                                persistent_schema)
from ..core.window import WindowProcessor, _interleave, _reset_row
from ..ops.dwin import (C_BATCH, C_EXPBATCH, C_TIME, TS_NONE, DwinSpec,
                        dwin_step, make_dwin_carry)
from ..ops.windowed_agg import kernel_device
from ..query_api.definition import AttrType
from ..query_api.expression import Constant, TimeConstant, Variable
from ..utils.errors import (SiddhiAppCreationError,
                            SiddhiAppRuntimeException)

#: window kinds with a device kernel (read off the AST by
#: analysis/state_schema.py, so keep it a literal)
DEVICE_KINDS = ("length", "lengthBatch", "time", "timeBatch",
                "externalTime", "externalTimeBatch", "timeLength",
                "delay", "batch", "sort", "session", "hopping")
_BATCH_KINDS = ("lengthBatch", "timeBatch", "externalTimeBatch", "batch")
W_START = 16
LONG_BASE = np.int64(1) << 31
INT_NONE = np.int32(-(2 ** 31))       # null sentinel on INT lanes
# null sentinel for DOUBLE lanes: a reserved quiet-NaN bit pattern (a
# real NaN payload of exactly this pattern would decode as None — the
# standard float64 NaN is 0x7ff8000000000000, so this never collides
# with arithmetic-produced NaNs)
DBL_NONE_BITS = 0x7FF8_DEAD_BEEF_0000

#: TEST HOOK (tests/test_flight.py, tests/test_overload.py): re-introduces
#: the session-timer re-arm pathology (the kernel once reported the min
#: live EVENT ts instead of the min key last-activity, so the re-arm
#: instant never advanced past live sessions and the nxt<=now guard
#: degenerated into a 1 ms timer crawl — 50k+ dispatches on a 60-event
#: stream) so the dispatch-storm watchdog regression test can exercise a
#: real storm.  Never enable outside tests.
SESSION_REARM_PATHOLOGY = False


def _reject(msg: str):
    raise SiddhiAppCreationError("device window path: " + msg)


def _const_ms(p) -> int:
    if isinstance(p, (TimeConstant, Constant)):
        return int(p.value)
    _reject("window parameters must be constants")


def carry_from_reference(state: dict, device=None) -> Dict[str,
                                                            torch.Tensor]:
    """The port's carry from the dict the JAX package's
    ``DeviceWindowProcessor.current_state()`` returns (its ``dwin`` leaves
    are numpy), placed on ``device`` (default: the card)."""
    if "dwin" not in state:
        raise SiddhiAppRuntimeException(
            "device window path: snapshot was taken by the host window "
            "processor")
    dev = kernel_device(device)
    return {k: torch.tensor(np.asarray(v)).to(dev)
            for k, v in state["dwin"].items()}


@persistent_schema(
    "device-window", version=1,
    schema=Struct(dwin=Carry(), base=Scalar("opt_int"),
                  capacity=Scalar("int"), fill=Scalar("int"),
                  exp_fill=Scalar("int"), next_emit=Scalar("opt_int"),
                  window_end=Scalar("opt_int"), hop_ts=ListOf("int"),
                  hop_prev=ListOf("int"), strs=MapOf("str-dict"),
                  skey=Scalar("opt_list")),
    dims={"cap": "free", "wkind": "exact"},
    doc="ring capacity is adopted by restore (it grows by doubling but "
        "the snapshot carries the ring itself); the window kind decides "
        "the carry planes and is plan-fixed")
class DeviceWindowProcessor(WindowProcessor):
    """One window's state on device (see module docstring)."""

    backend = "device"
    requires_scheduler = True            # per-kind below

    def __init__(self, app_ctx, definition, kind: str, params: List,
                 compile_expr, pipeline_depth: int = 0):
        super().__init__(app_ctx, definition.attribute_names)
        self.kind = kind
        self.definition = definition
        if kind not in DEVICE_KINDS:
            _reject(f"#window.{kind} has no device kernel")
        sc = getattr(app_ctx, "siddhi_context", None)
        self.device = kernel_device(getattr(sc, "device", None))

        # ---- window parameters (mirror core/window.create_window_processor)
        self.window_ms = 0
        self.length = 0
        self.hop_ms = 0
        self.ts_expr = None
        need = {"length": 1, "lengthBatch": 1, "time": 1, "timeBatch": 1,
                "delay": 1, "externalTime": 2, "externalTimeBatch": 2,
                "timeLength": 2, "batch": 0, "sort": 2, "session": 1,
                "hopping": 2}[kind]
        if len(params) < need:
            _reject(f"#window.{kind} needs {need} parameter(s)")
        if kind == "length" or kind == "lengthBatch":
            self.length = _const_ms(params[0])
            if self.length <= 0:
                _reject("length must be positive")
        elif kind in ("time", "timeBatch", "delay"):
            self.window_ms = _const_ms(params[0])
            if kind == "timeBatch" and len(params) > 1:
                self.start_time = _const_ms(params[1])
            else:
                self.start_time = None
        elif kind in ("externalTime", "externalTimeBatch"):
            if not isinstance(params[0], Variable):
                _reject(f"{kind} needs a timestamp attribute")
            self.ts_expr = compile_expr(params[0])
            self.window_ms = _const_ms(params[1])
            self.start_time = _const_ms(params[2]) \
                if kind == "externalTimeBatch" and len(params) > 2 else None
        elif kind == "timeLength":
            self.window_ms = _const_ms(params[0])
            self.length = _const_ms(params[1])
        elif kind == "hopping":
            self.window_ms = _const_ms(params[0])
            self.hop_ms = _const_ms(params[1])
            if self.window_ms <= 0 or self.hop_ms <= 0:
                _reject("hopping needs positive window and hop")
        elif kind == "sort":
            # sort(n, attr [, 'asc'|'desc', attr2, ...])
            self.length = _const_ms(params[0])
            if self.length <= 0:
                _reject("sort length must be positive")
            self.sort_attrs: List[Tuple[str, bool]] = []
            i = 1
            while i < len(params):
                p = params[i]
                if not isinstance(p, Variable):
                    _reject("sort keys must be plain attributes")
                asc = True
                if i + 1 < len(params) and \
                        isinstance(params[i + 1], Constant) and \
                        isinstance(params[i + 1].value, str):
                    asc = params[i + 1].value.lower() != "desc"
                    i += 1
                self.sort_attrs.append((p.attribute, asc))
                i += 1
            if not self.sort_attrs:
                _reject("sort needs at least one key attribute")
        elif kind == "session":
            # session(gap [, key_attr]); allowedLatency (the
            # late-event merge window) stays host
            self.window_ms = _const_ms(params[0])
            self.session_key: Optional[str] = None
            if len(params) > 1:
                if not isinstance(params[1], Variable):
                    _reject("session key must be a plain attribute")
                self.session_key = params[1].attribute
            if len(params) > 2:
                _reject("session allowedLatency is host-only")
        # batch(): no params

        # ---- payload lane assignment
        self.f_lanes: Dict[str, int] = {}
        self.i_lanes: Dict[str, Tuple[int, ...]] = {}
        self.str_attrs: Dict[str, Tuple[Dict, List]] = {}
        self.attr_types = {a.name: a.type for a in definition.attributes}
        nf = ni = 0
        self.dbl_attrs: set = set()
        for a in definition.attributes:
            t = a.type
            if t == AttrType.FLOAT:
                self.f_lanes[a.name] = nf
                nf += 1
            elif t in (AttrType.INT, AttrType.BOOL):
                self.i_lanes[a.name] = (ni,)
                ni += 1
            elif t == AttrType.LONG:
                self.i_lanes[a.name] = (ni, ni + 1)
                ni += 2
            elif t == AttrType.DOUBLE:
                # exact: the float64 bit pattern rides two i32 lanes
                # (bitcast hi/lo) — no f32 rounding anywhere
                self.dbl_attrs.add(a.name)
                self.i_lanes[a.name] = (ni, ni + 1)
                ni += 2
            elif t == AttrType.STRING:
                self.i_lanes[a.name] = (ni,)
                self.str_attrs[a.name] = ({}, [])
                ni += 1
            else:
                _reject(f"{t.name} payload attributes ride no exact device "
                        f"lane")
        if kind == "externalTimeBatch":
            # batch CURRENT rows keep their ORIGINAL arrival timestamps
            # while the ring is keyed by event time — carry arrival ts on
            # two extra i32 lanes
            self._arr_lanes = (ni, ni + 1)
            ni += 2
        self._skey_lane = -1
        if kind == "session":
            # dict-encoded session key rides an extra i32 lane (keyless
            # sessions share one code)
            self._skey_lane = ni
            ni += 1
            self._skey_enc: Dict = {}
        self._sort_keys: Tuple = ()
        if kind == "sort":
            keys = []
            for attr, asc in self.sort_attrs:
                t = self.attr_types.get(attr)
                if t is None:
                    _reject(f"sort key '{attr}' is not a stream attribute")
                if attr in self.f_lanes:
                    keys.append((0, self.f_lanes[attr], asc))
                elif t in (AttrType.INT, AttrType.BOOL):
                    keys.append((1, self.i_lanes[attr][0], asc))
                elif t == AttrType.LONG:
                    # (hi, lo) lex order IS int64 order (lo in [0, 2^31))
                    hi, lo = self.i_lanes[attr]
                    keys.append((1, hi, asc))
                    keys.append((1, lo, asc))
                else:
                    _reject(f"sort key '{attr}' ({t.name}) has no ordered "
                            "device lane (STRING/DOUBLE sort stays host)")
            self._sort_keys = tuple(keys)
        self.n_f, self.n_i = nf, ni

        self.capacity = max(W_START, 2 * self.length or 0)
        # @app:statistics(telemetry='true'): ring fill / eviction /
        # overflow counters ride the carry + egress buffer
        self.telemetry = bool(getattr(app_ctx, "telemetry_enabled", False))
        self.last_telemetry = None        # [P, 3] host int32 after retire
        self._base: Optional[int] = None
        self.carry = None                 # device dict (lazy at first use)
        self._steps: Dict[Tuple[int, int], callable] = {}
        # control state (host-side, mirrors the host processors)
        self.next_emit: Optional[int] = None
        self.window_end: Optional[int] = None
        self._fill_host = 0               # pre-step fill (interleave c0)
        self._exp_fill_host = 0
        self._fill_disp = 0               # dispatch-side fill (lengthBatch)
        # hopping control mirrors (dispatch-side): the live event
        # timestamps and the previous hop's window timestamps — pure host
        # arithmetic over chunk timestamps the dispatcher already holds,
        # so provable no-op boundaries (everything empty) skip the kernel
        # step instead of storming one dispatch per silent hop
        self._hop_ts = np.empty(0, np.int64)
        self._hop_prev = np.empty(0, np.int64)
        # ingest pipelining (plan/pipeline.py): the query
        # runtime's chain flush + timer/state paths drain _inflight
        from collections import deque
        self._inflight: "deque" = deque()
        self.pipeline_depth = pipeline_depth

    # ------------------------------------------------------------ encode

    def _spec(self) -> DwinSpec:
        return DwinSpec(self.kind, self.capacity, self.n_f, self.n_i,
                        self.window_ms, self.length,
                        sort_keys=self._sort_keys,
                        skey_lane=self._skey_lane,
                        telemetry=self.telemetry,
                        hop_ms=self.hop_ms)

    def _ensure_carry(self):
        if self.carry is None:
            self.carry = make_dwin_carry(self._spec(), 1, self.device)

    def _step_for(self, T: int):
        key = (self.capacity, T)
        fn = self._steps.get(key)
        if fn is None:
            from ..core.profiling import wrap_kernel
            from .shapes import shape_registry
            spec = self._spec()

            def step(carry, ev_f, ev_i, ev_ts, valid, now, directive, cap):
                # a fresh carry: _step_work keeps the pre-carry of each
                # work item and _read_work rewinds to it on ring overflow
                # (grow-and-replay)
                return dwin_step(spec, carry, ev_f, ev_i, ev_ts, valid, now,
                                 directive, cap)
            fn = wrap_kernel(
                f"dwin.{self.kind}.step",
                shape_registry().jit(
                    f"dwin.{self.kind}.step",
                    {"cap": self.capacity, "T": T, "nf": self.n_f,
                     "ni": self.n_i, "telem": self.telemetry},
                    step,
                    # a second (capacity, T) key on a live window is a
                    # ring grow, not a first build
                    trigger="build" if not self._steps else "grow"))
            self._steps[key] = fn
        return fn

    def _code(self, attr: str, v) -> int:
        enc, dec = self.str_attrs[attr]
        if v is None:
            return 0
        c = enc.get(v)
        if c is None:
            c = len(dec) + 1
            enc[v] = c
            dec.append(v)
        return c

    def _offsets(self, ts64: np.ndarray) -> np.ndarray:
        if self._base is None:
            self._base = int(ts64[0]) if len(ts64) else 0
        off = ts64 - self._base
        lim = int(TS_NONE) - max(self.window_ms, 1) - 1
        if len(off) and int(off.max()) > lim:
            # rebase shifts the carried ring timestamps: retire in-flight
            # work first so every queued step shares one base
            self.flush()
            delta = int(off.min())
            for k in ("ring_ts", "exp_ts"):
                if k not in self.carry:
                    continue
                ring = self.carry[k].cpu().numpy().astype(np.int64)
                ring = np.where(ring == int(TS_NONE), ring,
                                np.maximum(ring - delta,
                                           -(self.window_ms + 1)))
                self.carry[k] = torch.from_numpy(
                    ring.astype(np.int32)).to(self.device)
            self._base += delta
            off = ts64 - self._base
            if len(off) and int(off.max()) > lim:
                raise SiddhiAppRuntimeException(
                    "device window path: one batch spans more stream time "
                    "than int32 ms offsets can represent")
        return off.astype(np.int32)

    def _encode_chunk(self, chunk: EventChunk, ring_ts64: np.ndarray):
        T = len(chunk)
        F, I = max(self.n_f, 1), max(self.n_i, 1)
        ev_f = np.zeros((1, T, F), np.float32)
        ev_i = np.zeros((1, T, I), np.int32)
        for name, lane in self.f_lanes.items():
            col = chunk.columns[name]
            if col.dtype == object:
                if any(v is None for v in col):
                    raise SiddhiAppRuntimeException(
                        "device window path: null FLOAT payloads have no "
                        "exact lane encoding")
                col = col.astype(np.float64)
            ev_f[0, :, lane] = np.asarray(col, np.float32)
        for name, lanes in self.i_lanes.items():
            col = chunk.columns[name]
            if name in self.str_attrs:
                ev_i[0, :, lanes[0]] = [self._code(name, v) for v in col]
            elif name in self.dbl_attrs:
                none = np.asarray([x is None for x in col], bool) \
                    if col.dtype == object else np.zeros(T, bool)
                vals = np.asarray(
                    [0.0 if x is None else float(x) for x in col]
                    if col.dtype == object else col, np.float64)
                bits = vals.view(np.int64)
                bits = np.where(none, np.int64(DBL_NONE_BITS), bits)
                ev_i[0, :, lanes[0]] = (bits >> 32).astype(np.int32)
                ev_i[0, :, lanes[1]] = bits.astype(np.int32)
            elif len(lanes) == 2:
                v = np.asarray([0 if x is None else int(x) for x in col],
                               np.int64)
                none = np.asarray([x is None for x in col], bool)
                hi = np.floor_divide(v, LONG_BASE)
                # hi must survive the int32 cast AND stay clear of the
                # null sentinel: |v| >= 2^62 wraps, and v in
                # [-2^62, -2^62+2^31) lands exactly on INT_NONE and would
                # decode as null.
                bad = ~none & ((hi < np.int64(-(2 ** 31))) |
                               (hi >= np.int64(2 ** 31)) |
                               (hi == np.int64(INT_NONE)))
                if bad.any():
                    raise SiddhiAppRuntimeException(
                        "device window path: LONG value outside ±2^62 "
                        "(or whose hi word collides with the null "
                        "sentinel) has no exact lane encoding")
                lo = (v - hi * LONG_BASE).astype(np.int64)
                hi = np.where(none, np.int64(INT_NONE), hi)
                ev_i[0, :, lanes[0]] = hi.astype(np.int32)
                ev_i[0, :, lanes[1]] = lo.astype(np.int32)
            else:
                vals = [INT_NONE if x is None else np.int32(x)
                        for x in col]
                if any(x is not None and np.int32(x) == INT_NONE
                       for x in col):
                    raise SiddhiAppRuntimeException(
                        "device window path: INT value -2^31 collides "
                        "with the null sentinel lane encoding")
                ev_i[0, :, lanes[0]] = vals
        if self.kind == "externalTimeBatch":
            # batch CURRENT rows keep their ORIGINAL arrival timestamps
            arr = np.asarray(chunk.timestamps, np.int64)
            hi = np.floor_divide(arr, LONG_BASE)
            lo = arr - hi * LONG_BASE
            ev_i[0, :, self._arr_lanes[0]] = hi.astype(np.int32)
            ev_i[0, :, self._arr_lanes[1]] = lo.astype(np.int32)
        if self.kind == "session":
            if self.session_key is None:
                ev_i[0, :, self._skey_lane] = 1
            else:
                col = chunk.columns.get(self.session_key)
                vals = (np.asarray(col, object) if col is not None
                        else np.full(T, None, object))
                ev_i[0, :, self._skey_lane] = [
                    self._skey_code(v) for v in vals]
        ts_off = self._offsets(ring_ts64)
        return ev_f, ev_i, ts_off.reshape(1, T)

    def _skey_code(self, v) -> int:
        v = v.item() if hasattr(v, "item") else v
        c = self._skey_enc.get(v)
        if c is None:
            c = len(self._skey_enc) + 1
            self._skey_enc[v] = c
        return c

    # ------------------------------------------------------------ decode

    def _rows_to_chunk(self, rows_f: np.ndarray, rows_i: np.ndarray,
                      ts: np.ndarray, types_val: int) -> EventChunk:
        n = len(ts)
        cols: Dict[str, np.ndarray] = {}
        for name in self.names:
            t = self.attr_types[name]
            if name in self.f_lanes:
                cols[name] = rows_f[:, self.f_lanes[name]].astype(
                    dtype_for(t))
            elif name in self.str_attrs:
                _enc, dec = self.str_attrs[name]
                codes = rows_i[:, self.i_lanes[name][0]]
                out = np.full(n, None, object)
                ok = codes >= 1
                if ok.any():
                    d = np.asarray(dec, object)
                    out[ok] = d[codes[ok] - 1]
                cols[name] = out
            elif name in self.dbl_attrs:
                lanes = self.i_lanes[name]
                bits = (rows_i[:, lanes[0]].astype(np.int64) << 32) | \
                    (rows_i[:, lanes[1]].astype(np.int64) &
                     np.int64(0xFFFFFFFF))
                vals = bits.view(np.float64)
                none = bits == np.int64(DBL_NONE_BITS)
                if none.any():
                    out = np.full(n, None, object)
                    out[~none] = vals[~none]
                    cols[name] = out
                else:
                    cols[name] = vals.copy()
            else:
                lanes = self.i_lanes[name]
                if len(lanes) == 2:
                    hi = rows_i[:, lanes[0]].astype(np.int64)
                    lo = rows_i[:, lanes[1]].astype(np.int64)
                    v = hi * LONG_BASE + lo
                    none = rows_i[:, lanes[0]] == INT_NONE
                else:
                    v = rows_i[:, lanes[0]].astype(np.int64)
                    none = rows_i[:, lanes[0]] == INT_NONE
                if none.any():
                    out = np.full(n, None, object)
                    if t == AttrType.BOOL:
                        out[~none] = v[~none].astype(bool)
                    else:
                        out[~none] = v[~none].astype(dtype_for(t))
                    cols[name] = out
                elif t == AttrType.BOOL:
                    cols[name] = v.astype(bool)
                else:
                    cols[name] = v.astype(dtype_for(t))
        return EventChunk(self.names, np.asarray(ts, np.int64),
                          np.full(n, types_val, np.int8), cols)

    # ------------------------------------------------------------ step

    def _dispatch_step(self, chunk: Optional[EventChunk], now_val: int,
                       directive: Optional[np.ndarray],
                       n_done: int = 0) -> dict:
        """Encode + dispatch one kernel step without reading the egress
        (chunk may be None for timer steps); returns a work dict for
        `_read_work` — the pipelined ingest keeps a few in flight so the
        D2H round-trip overlaps later dispatches (plan/pipeline.py)."""
        self._ensure_carry()
        if chunk is not None and not chunk.is_empty:
            if self.ts_expr is not None:
                from .expr_compiler import EvalCtx
                ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
                ring_ts = np.asarray(self.ts_expr.fn(ctx), np.int64)
            else:
                ring_ts = np.asarray(chunk.timestamps, np.int64)
            T = len(chunk)
            ev_f, ev_i, ts_off = self._encode_chunk(chunk, ring_ts)
            valid = np.ones((1, T), bool)
        else:
            T = 1
            F, I = max(self.n_f, 1), max(self.n_i, 1)
            ev_f = np.zeros((1, 1, F), np.float32)
            ev_i = np.zeros((1, 1, I), np.int32)
            ts_off = np.zeros((1, 1), np.int32)
            valid = np.zeros((1, 1), bool)
        if self.kind in _BATCH_KINDS:
            now_arr = np.asarray([n_done], np.int32)
        elif self.kind == "externalTime":
            # driven purely by event time — the kernel never reads `now`,
            # and routing the ARRIVAL clock through _offsets would rebase
            # the external-time base (different scale → ring corruption)
            now_arr = np.zeros(1, np.int32)
        else:
            now_arr = np.asarray(
                [self._offsets(np.asarray([now_val], np.int64))[0]
                 if self._base is not None or chunk is not None
                 else 0], np.int32)
        if directive is None:
            directive = np.zeros((1, T), np.int32)
        # a chunk larger than the ring overflows unconditionally: grow
        # up-front (rarer overflows are caught exactly by the kernel's
        # overflow flag → rewind-and-replay at retirement)
        if T > self.capacity:
            self.flush()
            while self._fill_host + T > self.capacity:
                self._grow(self.capacity * 2)
        work = {"inputs": (ev_f, ev_i, ts_off, valid, now_arr, directive),
                "T": T, "base": self._base}
        self._step_work(work)
        return work

    def _step_work(self, work: dict) -> None:
        """(Re)run a work item's kernel step on the current carry; the
        egress buffer's device-to-host copy starts at once (pinned,
        non-blocking) and ``_host_buf`` waits for it."""
        from .pipeline import HostCopy
        ev_f, ev_i, ts_off, valid, now_arr, directive = work["inputs"]
        work["pre"] = dict(self.carry)
        cap = 2 * self.capacity + work["T"]
        step = self._step_for(work["T"])
        dev = self.device
        self.carry, buf = step(
            self.carry, *[torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, non_blocking=True)
                for a in (ev_f, ev_i, ts_off, valid, now_arr, directive)],
            cap)
        work["copy"] = HostCopy([buf])
        work["buf_host"] = None             # invalidate any prior read

    def _read_work(self, work: dict):
        """Block on a work item's egress; on ring overflow rewind to ITS
        pre-carry, grow, and re-step until clean (the caller has already
        drained any later in-flight work).  Updates the host fill mirrors
        and splits the egress rows."""
        while True:
            buf = self._host_buf(work)
            tail = buf[-1]
            if int(tail[4]) == 0:         # no overflow
                break
            self.carry = work["pre"]
            self._grow(self.capacity * 2)
            self._step_work(work)
        count = int(tail[0])
        self._fill_host = int(tail[1])
        self._exp_fill_host = int(tail[2])
        if self.telemetry:
            # summary row rides just before the tail (see _pack_egress):
            # [fill gauge, evictions total, overflow total]
            self.last_telemetry = buf[-2, :3].copy()
            rt = getattr(self.app_ctx, "runtime", None)
            holder = getattr(rt, "device_telemetry", None)
            if holder is not None:
                holder.update_window(self.definition.id, self.last_telemetry)
        rows = buf[:count]
        F = max(self.n_f, 1)
        rows_f = rows[:, 4:4 + F].view(np.float32)
        rows_i = rows[:, 4 + F:]
        return (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3],
                rows_f, rows_i, int(tail[3]))

    def _run_step(self, chunk: Optional[EventChunk], now_val: int,
                  directive: Optional[np.ndarray], n_done: int = 0):
        """Synchronous dispatch + read (timer steps and non-pipelined
        callers).  The caller must have flushed in-flight work first."""
        return self._read_work(self._dispatch_step(chunk, now_val,
                                                   directive, n_done))

    def _grow(self, new_cap: int):
        c = dict(self.carry)
        pad = new_cap - self.capacity
        for k in ("ring_f", "ring_i", "exp_f", "exp_i"):
            if k in c:
                c[k] = torch.cat([c[k], c[k].new_zeros(
                    (1, pad) + tuple(c[k].shape[2:]))], dim=1)
        for k in ("ring_ts", "exp_ts"):
            if k in c:
                c[k] = torch.cat([c[k], c[k].new_full((1, pad), TS_NONE)],
                                 dim=1)
        self.carry = c
        self.capacity = new_cap

    # ------------------------------------------------------------ emission

    def on_data(self, chunk: EventChunk):
        from ..core.profiling import profiler
        prof = profiler()
        disp0 = prof.total_dispatches() if prof.enabled else 0
        ticks0 = prof.total_scan_ticks() if prof.enabled else 0
        now = int(chunk.timestamps[-1])
        if self.kind in ("time", "delay", "timeLength", "session"):
            self.app_ctx.scheduler.notify_at(now + self.window_ms,
                                             self._on_timer)
        if self.kind == "hopping":
            for work in self._hop_dispatch(chunk):
                self._submit(work)
        elif self.kind in _BATCH_KINDS:
            work = self._batch_dispatch(chunk, now)
            self._submit(work)
        else:
            work = self._dispatch_step(chunk, now, None)
            work["emit"] = ("slide", chunk, None, None)
            self._submit(work)
        from ..core.flight import flight
        fl = flight()
        if fl.enabled:
            rt = getattr(self.app_ctx, "runtime", None)
            sid = self.definition.id
            fl.record_block(
                getattr(rt, "name", ""), stream=sid,
                batch=len(chunk.timestamps),
                dispatches=(prof.total_dispatches() - disp0
                            if prof.enabled else 0),
                scan_ticks=(prof.total_scan_ticks() - ticks0
                            if prof.enabled else 0),
                junction=(rt.junctions.get(sid) if rt is not None
                          else None),
                scheduler=self.app_ctx.scheduler,
                telemetry=self.last_telemetry)

    # ------------------------------------------------------------ pipeline

    def _submit(self, work: dict) -> None:
        self._inflight.append(work)
        while len(self._inflight) > self.pipeline_depth:
            self._retire_work(self._inflight.popleft())

    def flush(self):
        """Retire every in-flight chunk — called on junction idle/drain,
        before timer steps, and before any state read.  Takes the OWNING
        query's lock (RLock, re-entrant for the junction worker): cross-
        query callers — a named-window join's find_chunk, store queries,
        snapshots — run on other queries' threads and would otherwise
        race the worker's _submit."""
        def run():
            while self._inflight:
                self._retire_work(self._inflight.popleft())
        self._locked(run)

    def _host_buf(self, work: dict) -> np.ndarray:
        """Host copy of a work item's egress buffer, cached per step so
        the retire-time overflow pre-check and the decode share one
        transfer; _step_work invalidates on replay."""
        buf = work.get("buf_host")
        if buf is None:
            buf = work["copy"].wait()[0]
            work["buf_host"] = buf
        return buf

    def _retire_work(self, work: dict) -> None:
        buf = self._host_buf(work)
        if int(buf[-1][4]) != 0:
            # ring overflow: later in-flight steps ran on the overflowed
            # carry — rewind to this work's pre-carry, grow, replay all
            # in order (exact: the kernel's overflow flag marks any step
            # that lost a live entry)
            pending = [work] + list(self._inflight)
            self._inflight.clear()
            self.carry = work["pre"]
            self._grow(self.capacity * 2)
            for w in pending:
                self._step_work(w)
                fill_pre = self._fill_host
                exp_pre = self._exp_fill_host
                parts = self._read_work(w)
                self._emit_work(w, parts, fill_pre, exp_pre)
            return
        fill_pre = self._fill_host
        exp_pre = self._exp_fill_host
        parts = self._read_work(work)
        self._emit_work(work, parts, fill_pre, exp_pre)

    def _emit_work(self, work: dict, parts, fill_pre: int,
                   exp_fill_pre: int) -> None:
        mode, chunk, n_done, flush_ts = work["emit"]
        (_idx, evt, cause, ts_off, rf, ri, _mn) = parts
        if mode == "slide":
            self._emit_slide(chunk, work, evt, cause, ts_off, rf, ri,
                             fill_pre)
        elif mode == "hop":
            self._emit_hop(work["base"] or 0, parts, flush_ts)
        else:
            if self.kind == "lengthBatch":
                # flush ts = each batch's last member arrival ts
                base = work["base"] or 0
                flush_ts = list(flush_ts)
                for f in range(n_done):
                    sel = (cause == C_BATCH) & (evt == f)
                    flush_ts.append(int(ts_off[sel][-1]) + base)
            self._emit_flushes(n_done, flush_ts, evt, cause, ts_off,
                               rf, ri, exp_fill_pre)

    def _emit_slide(self, chunk, work, evt, cause, ts_off, rf, ri,
                    fill_pre: int) -> None:
        base = work["base"] or 0
        if self.kind == "length":
            exp_ts = chunk.timestamps[np.minimum(evt, len(chunk) - 1)]
            expired = self._rows_to_chunk(rf, ri, exp_ts, EXPIRED)
            c0 = max(0, self.length - fill_pre)
            self.send_next(_interleave(expired, chunk.with_types(CURRENT),
                                       c0))
        elif self.kind == "time":
            expired = self._rows_to_chunk(
                rf, ri, ts_off.astype(np.int64) + base + self.window_ms,
                EXPIRED)
            out = chunk.with_types(CURRENT)
            if len(expired):
                out = EventChunk.concat([expired, out])
            self.send_next(out)
        elif self.kind == "sort":
            # one eviction per overflowing arrival: order by the
            # triggering event, then interleave like length (reference
            # SortWindowProcessor emits the evicted extremum right after
            # the arrival that displaced it)
            order = np.argsort(evt, kind="stable")
            exp_ts = chunk.timestamps[np.minimum(evt[order],
                                                 len(chunk) - 1)]
            expired = self._rows_to_chunk(rf[order], ri[order], exp_ts,
                                          EXPIRED)
            c0 = max(0, self.length - fill_pre)
            self.send_next(_interleave(expired, chunk.with_types(CURRENT),
                                       c0))
        elif self.kind == "session":
            # due sessions emit BEFORE the chunk (the host expires first,
            # so same-key chunk events start a fresh session), grouped in
            # session-first-arrival order; the EXPIRED timestamp is
            # last-activity + gap (the kernel's evict column).  The host
            # emits that expiry batch as its OWN callback (its
            # _expire_sessions runs before the append), so the split —
            # not a concat — is what parity observes
            if len(rf):
                self.send_next(self._session_expired_chunk(evt, rf, ri,
                                                           base))
            self.send_next(chunk.with_types(CURRENT))
        elif self.kind == "delay":
            if len(rf):
                self.send_next(self._rows_to_chunk(
                    rf, ri, ts_off.astype(np.int64) + base, CURRENT))
        elif self.kind == "externalTime":
            from .expr_compiler import EvalCtx
            ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
            etimes = np.asarray(self.ts_expr.fn(ctx), np.int64)
            cur = chunk.with_timestamps(etimes).with_types(CURRENT)
            outs = []
            for i in range(len(chunk)):
                sel = evt == i
                if sel.any():
                    outs.append(self._rows_to_chunk(
                        rf[sel], ri[sel],
                        np.full(int(sel.sum()), etimes[i], np.int64),
                        EXPIRED))
                outs.append(cur.slice(i, i + 1))
            self.send_next(EventChunk.concat(outs))
        else:                            # timeLength
            outs = []
            nv = len(chunk)
            for i in range(nv):
                sel = evt == i
                if sel.any():
                    out_ts = np.where(
                        cause[sel] == C_TIME,
                        ts_off[sel].astype(np.int64) + base +
                        self.window_ms,
                        int(chunk.timestamps[i]))
                    outs.append(self._rows_to_chunk(rf[sel], ri[sel],
                                                    out_ts, EXPIRED))
                outs.append(chunk.slice(i, i + 1).with_types(CURRENT))
            self.send_next(EventChunk.concat(outs))

    def _batch_dispatch(self, chunk: EventChunk, now: int) -> dict:
        """Host-side flush arithmetic + kernel dispatch for the batch
        kinds.  The flush count (n_done) is computed from host mirrors
        (`_fill_disp` for lengthBatch, next_emit / window_end for the
        time kinds) so dispatch never reads the device."""
        T = len(chunk)
        flush_ts: List[int] = []
        directive = None
        n_done = 0
        if self.kind == "lengthBatch":
            total = self._fill_disp + T
            n_done = total // self.length
            self._fill_disp = total % self.length
        elif self.kind == "timeBatch":
            if self.next_emit is None:
                base = self.start_time if self.start_time is not None \
                    else int(chunk.timestamps[0])
                self.next_emit = base + self.window_ms
                self.app_ctx.scheduler.notify_at(self.next_emit,
                                                 self._on_timer)
            while now >= self.next_emit:
                flush_ts.append(self.next_emit)
                self.next_emit += self.window_ms
            n_done = len(flush_ts)
            directive = np.full((1, T), n_done, np.int32)
        elif self.kind == "externalTimeBatch":
            from .expr_compiler import EvalCtx
            ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
            etimes = np.asarray(self.ts_expr.fn(ctx), np.int64)
            directive = np.zeros((1, T), np.int32)
            for i in range(T):
                t = int(etimes[i])
                if self.window_end is None:
                    b = self.start_time if self.start_time is not None \
                        else t
                    self.window_end = b + self.window_ms
                while t >= self.window_end:
                    flush_ts.append(self.window_end)
                    self.window_end += self.window_ms
                directive[0, i] = len(flush_ts)
            n_done = len(flush_ts)
        else:                            # batch()
            n_done = 1
            flush_ts = [now]

        work = self._dispatch_step(chunk, now, directive, n_done=n_done)
        work["emit"] = ("batch", chunk, n_done, flush_ts)
        return work

    def _hop_dispatch(self, chunk: EventChunk) -> List[dict]:
        """Split a chunk at hop boundaries (host control arithmetic,
        mirrors HopingWindowProcessor.on_data) and dispatch one kernel
        step per due boundary — a row can be CURRENT in many overlapping
        windows, so a single per-entry flush id cannot express hopping —
        plus an append-only step for the trailing remainder."""
        works: List[dict] = []
        if self.next_emit is None:
            self.next_emit = int(chunk.timestamps[0]) + self.hop_ms
            self.app_ctx.scheduler.notify_at(self.next_emit,
                                             self._on_timer)
        while not chunk.is_empty and \
                int(chunk.timestamps[-1]) >= self.next_emit:
            pre = chunk.timestamps <= self.next_emit
            seg = None
            if pre.any():
                seg = chunk.mask(pre)
                chunk = chunk.mask(~pre)
            work = self._hop_step_work(seg)
            if work is not None:
                works.append(work)
            self.next_emit += self.hop_ms
        if not chunk.is_empty:
            self._hop_ts = np.concatenate(
                [self._hop_ts, np.asarray(chunk.timestamps, np.int64)])
            work = self._dispatch_step(chunk, int(chunk.timestamps[-1]),
                                       None)
            work["emit"] = ("hop", None, None, None)
            works.append(work)
        return works

    def _hop_step_work(self, seg: Optional[EventChunk]) -> Optional[dict]:
        """One boundary flush at self.next_emit (seg = the rows that
        belong to this hop's window; may be None).  Returns None when the
        step is a provable no-op — nothing appended since the last
        dispatched flush, and both the live window and the previous hop's
        window are empty on device — so a large timestamp gap advances
        next_emit without a kernel dispatch per silent hop."""
        b = self.next_emit
        if seg is not None and len(seg):
            self._hop_ts = np.concatenate(
                [self._hop_ts, np.asarray(seg.timestamps, np.int64)])
        if seg is None and not len(self._hop_ts) and \
                not len(self._hop_prev):
            return None
        cur = self._hop_ts[self._hop_ts > b - self.window_ms]
        self._hop_ts = cur
        self._hop_prev = cur
        T = len(seg) if seg is not None and len(seg) else 1
        work = self._dispatch_step(seg, b, np.ones((1, T), np.int32))
        work["emit"] = ("hop", None, None, b)
        return work

    def _emit_hop(self, base: int, parts, ts_f: Optional[int]) -> None:
        """Compose one hop's emission — EXPIRED (the previous window's
        rows that slid out, restamped at the boundary), RESET, CURRENT
        (original timestamps) — exactly HopingWindowProcessor._hop."""
        if ts_f is None:                  # append-only step: no emission
            return
        (_idx, _evt, cause, ts_off, rf, ri, _mn) = parts
        outs = []
        exp_sel = cause == C_EXPBATCH
        if exp_sel.any():
            outs.append(self._rows_to_chunk(
                rf[exp_sel], ri[exp_sel],
                np.full(int(exp_sel.sum()), ts_f, np.int64), EXPIRED))
        cur_sel = cause == C_BATCH
        if cur_sel.any():
            cur = self._rows_to_chunk(
                rf[cur_sel], ri[cur_sel],
                ts_off[cur_sel].astype(np.int64) + base, CURRENT)
            outs.append(_reset_row(cur, ts_f))
            outs.append(cur)
        if outs:
            self.send_next(EventChunk.concat(outs))

    def _emit_flushes(self, n_done, flush_ts, evt, cause, ts_off, rf, ri,
                      exp_fill_pre):
        base = self._base or 0
        exp_sel = cause == C_EXPBATCH
        state = None                   # (rf, ri) of the pending expired set
        if exp_fill_pre or exp_sel.any():
            state = (rf[exp_sel], ri[exp_sel])
        for f in range(n_done):
            sel = (cause == C_BATCH) & (evt == f)
            members = (rf[sel], ri[sel]) if sel.any() else None
            outs = []
            ts_f = flush_ts[f]
            if state is not None and len(state[0]):
                outs.append(self._rows_to_chunk(
                    state[0], state[1],
                    np.full(len(state[0]), ts_f, np.int64), EXPIRED))
            if members is not None:
                if self.kind == "externalTimeBatch":
                    hi = members[1][:, self._arr_lanes[0]].astype(np.int64)
                    lo = members[1][:, self._arr_lanes[1]].astype(np.int64)
                    mts = hi * LONG_BASE + lo
                else:
                    mts = ts_off[sel].astype(np.int64) + base
                cur = self._rows_to_chunk(members[0], members[1], mts,
                                          CURRENT)
                outs.append(_reset_row(cur, ts_f))
                outs.append(cur)
            if self.kind == "timeBatch":
                state = members            # even when empty
            elif members is not None:
                state = members            # lengthBatch / extTimeBatch /
                #                            batch: only non-empty batches
            if len(outs) > 1 or (outs and len(outs[0])):
                out = EventChunk.concat(
                    [o for o in outs if len(o)]) if len(outs) > 1 \
                    else outs[0]
                out.is_batch = True
                self.send_next(out)

    # ------------------------------------------------------------ timers

    def _on_timer(self, now: int):
        def run():
            self.on_timer_event(now)
            if self.kind in ("timeBatch", "hopping"):
                if self.next_emit is not None:
                    self.app_ctx.scheduler.notify_at(self.next_emit,
                                                     self._on_timer)
            elif SESSION_REARM_PATHOLOGY and self.kind == "session":
                # TEST HOOK ONLY (tests/test_overload.py): the pre-fix
                # session re-arm — the old kernel reported the min live
                # EVENT ts, whose +gap instant stays <= now while its
                # session remains active, so the nxt<=now crawl guard
                # re-armed at now+1 on every fire: a 1 ms timer crawl
                # with zero ingest progress.  Re-introduced behind this
                # flag so the dispatch-storm watchdog regression test
                # can prove the storm now trips instead of crawling.
                if self._fill_host:
                    self.app_ctx.scheduler.notify_at(now + 1,
                                                     self._on_timer)
            elif self._fill_host and self.kind != "session":
                # no re-arm for session: every data chunk already
                # schedules chunk_end + gap (on_data), which covers all
                # its sessions (last activity <= chunk end), and the
                # reference SessionWindowProcessor observes expiry ONLY
                # at those instants — a min-activity re-arm would emit
                # the same rows grouped at instants the host never fires
                mn = self._last_min_live
                if mn is not None:
                    nxt = mn + self.window_ms
                    if nxt <= now:
                        # the kernel evicts strictly AFTER the gap, so a
                        # wakeup at exactly min+gap re-observes the same
                        # min and would re-arm at the same instant — in
                        # playback advance_to() that is an infinite loop
                        # at one virtual ms (seen: 300k+ dispatches on a
                        # 60-event session stream)
                        nxt = now + 1
                    self.app_ctx.scheduler.notify_at(nxt, self._on_timer)
        self._locked(run)

    _last_min_live: Optional[int] = None

    def _session_expired_chunk(self, evt, rf, ri, base) -> EventChunk:
        """Expired-session rows → chunk, grouped in session-first-arrival
        order (the host's dict-insertion iteration); EXPIRED ts =
        last-activity + gap (the kernel's evict column)."""
        keys = ri[:, self._skey_lane]
        first: Dict[int, int] = {}
        for i, k in enumerate(keys):
            first.setdefault(int(k), i)
        order = np.argsort([first[int(k)] for k in keys], kind="stable")
        return self._rows_to_chunk(
            rf[order], ri[order],
            evt[order].astype(np.int64) + base, EXPIRED)

    def on_timer_event(self, ts: int):
        if self.kind in ("length", "lengthBatch", "batch", "sort",
                         "externalTime", "externalTimeBatch"):
            return
        self.flush()       # timer steps read/advance the live carry
        if self.kind == "session":
            if self._fill_host == 0:
                return
            (_i, evt, _c, _to, rf, ri, mn) = self._run_step(None, ts,
                                                            None)
            base = self._base or 0
            self._last_min_live = mn + base if mn != int(TS_NONE) else None
            if len(rf):
                self.send_next(self._session_expired_chunk(evt, rf, ri,
                                                           base))
            return
        if self.kind == "hopping":
            if self.next_emit is None:
                return
            while ts >= self.next_emit:
                work = self._hop_step_work(None)
                if work is not None:
                    self._emit_hop(work["base"] or 0,
                                   self._read_work(work), self.next_emit)
                self.next_emit += self.hop_ms
            return
        if self.kind == "timeBatch":
            if self.next_emit is None:
                return
            flush_ts = []
            while ts >= self.next_emit:
                flush_ts.append(self.next_emit)
                self.next_emit += self.window_ms
            n_done = len(flush_ts)
            if n_done == 0:
                return
            exp_fill_pre = self._exp_fill_host
            (_i, evt, cause, ts_off, rf, ri, _mn) = self._run_step(
                None, ts, None, n_done=n_done)
            self._emit_flushes(n_done, flush_ts, evt, cause, ts_off,
                               rf, ri, exp_fill_pre)
            return
        if self._fill_host == 0:
            return
        (_i, evt, cause, ts_off, rf, ri, mn) = self._run_step(None, ts,
                                                              None)
        base = self._base or 0
        self._last_min_live = mn + base if mn != int(TS_NONE) else None
        if not len(rf):
            return
        if self.kind == "delay":
            self.send_next(self._rows_to_chunk(
                rf, ri, ts_off.astype(np.int64) + base, CURRENT))
        else:                            # time / timeLength
            self.send_next(self._rows_to_chunk(
                rf, ri, ts_off.astype(np.int64) + base + self.window_ms,
                EXPIRED))

    # ------------------------------------------------------------ find/state

    def find_chunk(self) -> Optional[EventChunk]:
        """Materialize the device ring for join probes / store queries —
        rare control-plane reads, so a full D2H here is fine."""
        self.flush()
        self._ensure_carry()
        fill = self._fill_host
        if fill == 0:
            return None
        rf = self.carry["ring_f"][0, :fill].cpu().numpy()
        ri = self.carry["ring_i"][0, :fill].cpu().numpy()
        ts = self.carry["ring_ts"][0, :fill].cpu().numpy().astype(
            np.int64) + (self._base or 0)
        return self._rows_to_chunk(rf, ri, ts, CURRENT)

    def schema_dims(self):
        return {"cap": int(self.capacity), "wkind": self.kind}

    def current_state(self):
        self.flush()
        self._ensure_carry()
        return {"dwin": {k: v.cpu().numpy().copy()
                         for k, v in self.carry.items()},
                "base": self._base, "capacity": self.capacity,
                "fill": self._fill_host, "exp_fill": self._exp_fill_host,
                "next_emit": self.next_emit,
                "window_end": self.window_end,
                "hop_ts": self._hop_ts.tolist(),
                "hop_prev": self._hop_prev.tolist(),
                "strs": {a: list(dec) for a, (_e, dec)
                         in self.str_attrs.items()},
                "skey": (list(self._skey_enc.items())
                         if self._skey_lane >= 0 else None)}

    def restore_state(self, state):
        """Accepts this processor's own ``current_state()`` or the JAX
        package's unchanged."""
        carry = carry_from_reference(state, self.device)
        self.flush()
        self.capacity = state["capacity"]
        self._steps = {}
        self.carry = carry
        self._base = state["base"]
        self._fill_host = state["fill"]
        self._fill_disp = state["fill"]
        self._exp_fill_host = state["exp_fill"]
        self.next_emit = state["next_emit"]
        self.window_end = state["window_end"]
        self._hop_ts = np.asarray(state.get("hop_ts", []), np.int64)
        self._hop_prev = np.asarray(state.get("hop_prev", []), np.int64)
        for a, dec in state["strs"].items():
            self.str_attrs[a] = ({v: i + 1 for i, v in enumerate(dec)},
                                 list(dec))
        if state.get("skey") is not None:
            self._skey_enc = dict(state["skey"])
