"""Flight recorder + incident bundles.

The engine's most important state lives on-device in batched carries —
after a fault, counters alone cannot reconstruct what the automata were
doing.  This module is the black-box layer production streaming stacks
(and training stacks) carry: an always-cheap bounded ring of per-block
structured records, plus an incident hook bus that dumps a full bundle
(recent ring + metrics snapshot + Chrome-trace spans + analyzer/plan
report + env/config) when something trips.

  * ``FlightRecorder.record_block`` — called by every device runtime's
    ingest path (plan/planner.py, next to ``record_app_block``): block
    id, stream, batch size, per-kernel dispatch/scan-tick deltas from
    ``KernelProfiler``, junction queue depth/saturation, scheduler
    fires, device telemetry, last errors.  A deque append under a lock —
    O(1), no device work, no allocation beyond the record dict.
  * ``FlightRecorder.emit`` — the incident bus.  Wired triggers:
    watchdog trips (WD001, core/overload.py), circuit-breaker OPEN
    transitions (core/source_sink.py), quarantine bursts over
    ``SIDDHI_TPU_FLIGHT_QUARANTINE_BURST`` rejects, ingest
    ``BufferOverflowError`` and uncaught junction exceptions
    (core/stream.py).  ``POST /siddhi/apps/{app}/debug/bundle`` emits on
    demand.  Bundles are kept in memory for ``GET /incidents`` /
    ``GET /incidents/{id}/bundle`` and written as JSON under
    ``SIDDHI_TPU_FLIGHT_DIR`` (default: <tmp>/siddhi_tpu_flight).

Kill switch: ``SIDDHI_TPU_FLIGHT=0`` disables both the ring and the
bus.  Knobs: ``SIDDHI_TPU_FLIGHT_RING`` (ring capacity, default 256),
``SIDDHI_TPU_FLIGHT_KEEP`` (retained bundles, default 16).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .hotpath import hot_path

log = logging.getLogger(__name__)

#: Kill switch for the whole flight-recorder subsystem.
FLIGHT_ENV = "SIDDHI_TPU_FLIGHT"
#: Ring capacity (per-block records kept).
RING_ENV = "SIDDHI_TPU_FLIGHT_RING"
#: Bundle dump directory.
DIR_ENV = "SIDDHI_TPU_FLIGHT_DIR"
#: Retained bundles (memory AND directory pruning).
KEEP_ENV = "SIDDHI_TPU_FLIGHT_KEEP"
#: Quarantine rejects in one routing call that count as a burst.
QUARANTINE_BURST_ENV = "SIDDHI_TPU_FLIGHT_QUARANTINE_BURST"

DEFAULT_RING = 256
DEFAULT_KEEP = 16
DEFAULT_QUARANTINE_BURST = 50


# record_block asks "am I on?" once per ingest block; os.environ.get
# pays ~0.9 us per call (key encode + value decode), so the check rides
# the same direct-``_data`` read as core/ledger.py's ledger_enabled —
# still re-read per call, so flipping SIDDHI_TPU_FLIGHT mid-process
# keeps working.  Falls back to the public API if the internals move.
_ENV_DATA = getattr(os.environ, "_data", None)
_FLIGHT_KEY = (os.environ.encodekey(FLIGHT_ENV)
               if _ENV_DATA is not None and hasattr(os.environ, "encodekey")
               else FLIGHT_ENV)
if _ENV_DATA is not None and _FLIGHT_KEY not in _ENV_DATA and \
        FLIGHT_ENV in os.environ:
    _ENV_DATA = None        # key codec mismatch: use the public API

_PARSED: Dict[Any, bool] = {}       # raw env value -> parsed verdict


def flight_enabled() -> bool:
    if _ENV_DATA is not None:
        raw = _ENV_DATA.get(_FLIGHT_KEY)
    else:
        raw = os.environ.get(FLIGHT_ENV)
    if raw is None:
        return True
    v = _PARSED.get(raw)
    if v is None:
        s = os.fsdecode(raw) if isinstance(raw, bytes) else raw
        v = s.strip().lower() not in ("0", "false", "off", "no")
        _PARSED[raw] = v
    return v


def _env_int(key: str, default: int) -> int:
    try:
        v = int(os.environ.get(key, ""))
        return v if v > 0 else default
    except (TypeError, ValueError):
        return default


def quarantine_burst_threshold() -> int:
    return _env_int(QUARANTINE_BURST_ENV, DEFAULT_QUARANTINE_BURST)


def bundle_dir() -> str:
    d = os.environ.get(DIR_ENV, "").strip()
    if d:
        return d
    import tempfile
    return os.path.join(tempfile.gettempdir(), "siddhi_tpu_flight")


def _jsonable(v):
    """Best-effort JSON coercion: numpy scalars/arrays → python."""
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        pass
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    return repr(v)


class FlightRecorder:
    """Process-global bounded ring of per-block records + incident bus.

    Everything is host-side and lock-guarded; the hot path
    (``record_block``) is one dict build and one deque append."""

    def __init__(self, capacity: Optional[int] = None,
                 keep: Optional[int] = None):
        self.capacity = capacity or _env_int(RING_ENV, DEFAULT_RING)
        self.keep = keep or _env_int(KEEP_ENV, DEFAULT_KEEP)
        self._lock = threading.RLock()
        self._ring: "deque" = deque(maxlen=self.capacity)
        self._errors: "deque" = deque(maxlen=32)
        self._incidents: List[Dict[str, Any]] = []
        self._bundles: Dict[str, Dict[str, Any]] = {}
        self._seq = 0
        self._inc_seq = 0

    @property
    def enabled(self) -> bool:
        return flight_enabled()

    # ------------------------------------------------------------ ring

    @hot_path("per-block flight-ring append")
    def record_block(self, app: str, stream: str = "", batch: int = 0,
                     dispatches: int = 0, scan_ticks: int = 0,
                     junction=None, scheduler=None,
                     telemetry=None, extra: Optional[dict] = None) -> None:
        """One ingest block's structured record.  Called by the device
        runtimes' ingest paths; cheap enough to stay always-on."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {
            "block": self._seq, "t": time.time(), "app": app,
            "stream": stream, "batch": int(batch),
            "dispatches": int(dispatches), "scan_ticks": int(scan_ticks),
        }
        if junction is not None:
            try:
                rec["queue_depth"] = int(junction.queue_depth())
                rec["saturation"] = float(junction.saturation())
            except Exception:   # noqa: BLE001 — recording must never raise
                pass
        if scheduler is not None:
            rec["scheduler_fires"] = int(getattr(scheduler, "fires", 0))
        if telemetry is not None:
            rec["telemetry"] = _jsonable(telemetry)
        if extra:
            rec.update(_jsonable(extra))
        with self._lock:
            self._seq += 1
            rec["block"] = self._seq
            if self._errors:
                rec["last_error"] = self._errors[-1]
            self._ring.append(rec)

    def record_compile(self, kind: str, signature: str, trigger: str,
                       blocked_s: float) -> None:
        """One XLA compile on the ring — the same timeline as the ingest
        blocks, so a bundle shows exactly which compile interleaved with
        (or blocked) which block.  Called by plan/shapes.py."""
        if not self.enabled:
            return
        rec = {"t": time.time(), "compile": signature, "kernel": kind,
               "trigger": trigger, "blocked_s": round(blocked_s, 4)}
        with self._lock:
            self._seq += 1
            rec["block"] = self._seq
            self._ring.append(rec)

    def note_error(self, app: str, where: str, err: BaseException) -> None:
        """Track the most recent errors so block records and bundles can
        carry them (stream junction delivery failures, sink errors)."""
        if not self.enabled:
            return
        with self._lock:
            self._errors.append({"t": time.time(), "app": app,
                                 "where": where,
                                 "error": f"{type(err).__name__}: {err}"})

    def ring(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------------ bus

    def emit(self, kind: str, app: str = "", detail: Optional[dict] = None,
             runtime=None) -> Optional[Dict[str, Any]]:
        """Incident: build a bundle from the current ring + observability
        surfaces, retain it for the REST endpoints, and dump it as JSON
        under ``bundle_dir()``.  Returns the bundle (None when the
        recorder is disabled).  Never raises — incident handling must not
        make a fault worse."""
        if not self.enabled:
            return None
        with self._lock:
            self._inc_seq += 1
            bid = f"inc-{self._inc_seq:04d}"
        bundle: Dict[str, Any] = {
            "id": bid, "kind": kind, "app": app, "time": time.time(),
            "detail": _jsonable(detail or {}),
            "ring": self.ring(),
            "errors": list(self._errors),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith("SIDDHI_TPU_") or
                    k in ("JAX_PLATFORMS",)},
            "config": {"ring_capacity": self.capacity,
                       "bundles_kept": self.keep,
                       "bundle_dir": bundle_dir()},
        }
        try:
            from .profiling import profiler
            prof = profiler()
            bundle["kernels"] = prof.snapshot()
            bundle["metrics"] = prof.prometheus_lines()
        except Exception:   # noqa: BLE001
            log.exception("flight bundle: kernel snapshot failed")
        try:
            from .tracing import tracer
            # drop an incident marker so the span timeline shows WHERE
            # the trip happened, then embed the (bounded) trace
            tracer().instant(f"incident.{kind}", cat="incident",
                             id=bid, app=app)
            bundle["trace"] = tracer().to_dict(limit=20_000)
        except Exception:   # noqa: BLE001
            log.exception("flight bundle: trace export failed")
        if runtime is not None:
            try:
                sm = runtime.app_ctx.statistics_manager
                if sm is not None:
                    bundle["statistics"] = sm.snapshot()
                dt = getattr(runtime, "device_telemetry", None)
                if dt is not None:
                    bundle.setdefault("statistics", {})["telemetry"] = \
                        dt.snapshot()
                im = getattr(runtime, "ingest_metrics", None)
                if im is not None:
                    bundle.setdefault("metrics", []).extend(
                        im.prometheus_lines())
                rm = getattr(runtime, "resilience_metrics", None)
                if rm is not None:
                    bundle.setdefault("metrics", []).extend(
                        rm.prometheus_lines())
                analysis = getattr(runtime, "analysis", None)
                if analysis is not None:
                    bundle["analysis"] = analysis.as_dicts()
                    plan = getattr(analysis, "plan", None)
                    if plan is not None:
                        bundle["plan"] = plan.as_dict()
                wd = getattr(runtime, "watchdog", None)
                if wd is not None and wd.incidents:
                    bundle["watchdog_incidents"] = list(wd.incidents)
            except Exception:   # noqa: BLE001
                log.exception("flight bundle: runtime snapshot failed")
        bundle = _jsonable(bundle)
        with self._lock:
            self._incidents.append({"id": bid, "kind": kind, "app": app,
                                    "time": bundle["time"]})
            self._bundles[bid] = bundle
            # retention: oldest bundles age out (summaries stay listed)
            for inc in self._incidents:
                if len(self._bundles) <= self.keep:
                    break
                self._bundles.pop(inc["id"], None)
        self._dump(bundle)
        log.error("flight incident %s (%s) on app '%s': bundle dumped to "
                  "%s", bid, kind, app, bundle_dir())
        return bundle

    def _dump(self, bundle: Dict[str, Any]) -> None:
        try:
            d = bundle_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{bundle['id']}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1)
            kept = sorted(p for p in os.listdir(d)
                          if p.startswith("inc-") and p.endswith(".json"))
            for p in kept[:-self.keep]:
                os.unlink(os.path.join(d, p))
        except Exception:   # noqa: BLE001 — dumping must never raise
            log.exception("flight bundle dump failed")

    # ------------------------------------------------------------ REST

    def incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._incidents)

    def bundle(self, incident_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._bundles.get(incident_id)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._errors.clear()
            self._incidents.clear()
            self._bundles.clear()
            self._seq = 0
            self._inc_seq = 0


_GLOBAL = FlightRecorder()


def flight() -> FlightRecorder:
    return _GLOBAL
