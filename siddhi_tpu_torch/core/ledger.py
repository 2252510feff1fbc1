"""Per-chunk latency ledger, event-time lag watermarks and the SLO engine.

BENCH rounds report one end-to-end number (188 ms p99 match latency as of
round 11) with zero stage attribution.  This module generalizes the
round-11 ``rim_ns`` discipline — one always-on counter, kill-switchable,
overhead-bounded in ``bench --smoke`` — into a stage-bucketed wall-clock
ledger over the whole ingest→publish path:

  ingress     input-handler admit (validate/encode, before junction.send)
  queue       @Async buffer wait (enqueue → worker dequeue; 0 when sync)
  dispatch    junction fan-out + host-side query processing not otherwise
              attributed (exclusive of the nested stages below)
  device      device step issue + blocking retire waits (NFA dispatch,
              retire_events, window/group process_block, filter program)
  egress_d2h  the fused egress slab's single device→host read
  decode      columnar slab decode back into EventChunks
  publish     terminal callback / sink delivery

Stages are recorded through nest-aware spans: a span's *exclusive* time
(elapsed minus enclosed child spans) goes to its stage, so the per-stage
sums reconcile against an independently measured end-to-end wall clock
without double counting (``bench --phase waterfall`` asserts >= 95%
coverage).  Per-block deltas are folded into per-app/per-stage HDR
histograms (core/statistics.py) and a ``ledger`` waterfall row on each flight
ring record — same global-accumulator-delta convention as the ring's
existing rim/kernel ms split.

On top of the ledger:

  * event-time lag watermarks: per-(app, stream) gauges of admitted-event
    timestamps vs the wall/playback clock
    (``siddhi_event_time_lag_ms`` / ``siddhi_processing_lag_ms``);
  * an SLO engine: ``@app:slo(latency.p99.ms=..., lag.ms=...)`` targets,
    per-app burn-rate gauges, ``/health`` degradation on sustained breach
    and an ``SLO001`` incident bundle through the flight bus carrying the
    breaching window's waterfall.

Always-on with a ``SIDDHI_TPU_LEDGER=0`` kill switch; the env is re-read
per call so the bench overhead phase can toggle it per block.  Like
``RimStats`` this is NOT gated on the profiler's ``enabled``.
"""
from __future__ import annotations

import os
import threading
import time

from collections import deque
from typing import Any, Dict, List, Optional

from .hotpath import hot_path
from .statistics import Histogram

LEDGER_ENV = "SIDDHI_TPU_LEDGER"

#: stage keys in pipeline order (waterfall rows and /stats render in this
#: order; see module docstring for the boundary definitions)
STAGES = ("ingress", "queue", "dispatch", "device", "egress_d2h",
          "decode", "publish")

_STAGE_SET = frozenset(STAGES)


# os.environ.get pays ~0.9 us per call (key encode + value decode);
# the ledger asks "am I on?" ~10x per ingest block, so that alone would
# eat a fifth of the < 5% overhead budget.  os._Environ keeps the live
# mapping in ``_data`` (mutated in place by os.environ[...] = ..., so
# per-block toggling still works); reading it directly is a plain dict
# get.  Fall back to the public API if the internals ever move.
_ENV_DATA = getattr(os.environ, "_data", None)
_LEDGER_KEY = (os.environ.encodekey(LEDGER_ENV)
               if _ENV_DATA is not None and hasattr(os.environ, "encodekey")
               else LEDGER_ENV)
if _ENV_DATA is not None and _LEDGER_KEY not in _ENV_DATA and \
        LEDGER_ENV in os.environ:
    _ENV_DATA = None        # key codec mismatch: use the public API

_PARSED: Dict[Any, bool] = {}       # raw env value -> parsed verdict


def ledger_enabled() -> bool:
    """Kill switch, re-read per call (same contract as flight_enabled):
    ``SIDDHI_TPU_LEDGER=0`` disables every stamp mid-process."""
    if _ENV_DATA is not None:
        raw = _ENV_DATA.get(_LEDGER_KEY)
    else:
        raw = os.environ.get(LEDGER_ENV)
    if raw is None:
        return True
    v = _PARSED.get(raw)
    if v is None:
        s = os.fsdecode(raw) if isinstance(raw, bytes) else raw
        v = s.strip().lower() not in ("0", "false", "off", "no")
        _PARSED[raw] = v
    return v


# --------------------------------------------------------------- SLO config


class SloConfig:
    """Targets from ``@app:slo(...)``, parsed tolerantly like the @Async
    overload options (bad values clamp to defaults with a log warning;
    the analyzer's SA07x diagnostics are where the author learns why)."""

    __slots__ = ("latency_p99_ms", "lag_ms", "window_blocks",
                 "breach_blocks")

    def __init__(self, latency_p99_ms: Optional[float] = None,
                 lag_ms: Optional[float] = None,
                 window_blocks: int = 128, breach_blocks: int = 3):
        if latency_p99_ms is not None and latency_p99_ms <= 0:
            latency_p99_ms = None
        if lag_ms is not None and lag_ms <= 0:
            lag_ms = None
        self.latency_p99_ms = latency_p99_ms
        self.lag_ms = lag_ms
        self.window_blocks = max(4, int(window_blocks))
        self.breach_blocks = max(1, int(breach_blocks))

    @staticmethod
    def from_annotation(ann) -> "SloConfig":
        def num(key, default):
            raw = ann.get(key, None)
            if raw is None:
                return default
            try:
                return float(raw)
            except (TypeError, ValueError):
                return default      # malformed: analyzer diagnostic SA070
        wb = num("window.blocks", 128.0)
        bb = num("breach.blocks", 3.0)
        return SloConfig(
            latency_p99_ms=num("latency.p99.ms", None),
            lag_ms=num("lag.ms", None),
            window_blocks=int(wb) if wb and wb > 0 else 128,
            breach_blocks=int(bb) if bb and bb > 0 else 3)

    def as_dict(self) -> Dict[str, Any]:
        return {"latency.p99.ms": self.latency_p99_ms,
                "lag.ms": self.lag_ms,
                "window.blocks": self.window_blocks,
                "breach.blocks": self.breach_blocks}


class _SloState:
    """Rolling evaluation state for one app's SLO.  A breach needs
    ``breach_blocks`` CONSECUTIVE over-target evaluations — one slow
    block is tail, a run of them is an incident (same philosophy as the
    dispatch-storm watchdog's sustained-window trip)."""

    __slots__ = ("config", "window", "consecutive", "breached",
                 "breach_total", "burn_latency", "burn_lag",
                 "observed_p99_ms", "blocks")

    def __init__(self, config: SloConfig):
        self.config = config
        self.window: "deque" = deque(maxlen=config.window_blocks)
        self.consecutive = 0
        self.breached = False
        self.breach_total = 0
        self.burn_latency = 0.0
        self.burn_lag = 0.0
        self.observed_p99_ms = 0.0
        self.blocks = 0

    def observe(self, total_ms: Optional[float],
                lag_ms: Optional[float]) -> bool:
        """One evaluation; returns True exactly on the transition into
        breach (the caller emits the SLO001 bundle then, once)."""
        cfg = self.config
        if total_ms is not None:
            self.window.append(total_ms)
            self.blocks += 1
        if cfg.latency_p99_ms and len(self.window) >= 4:
            ordered = sorted(self.window)
            self.observed_p99_ms = ordered[
                min(len(ordered) - 1, int(0.99 * len(ordered)))]
            self.burn_latency = self.observed_p99_ms / cfg.latency_p99_ms
        if cfg.lag_ms and lag_ms is not None:
            self.burn_lag = max(0.0, lag_ms) / cfg.lag_ms
        burn = max(self.burn_latency, self.burn_lag)
        if burn > 1.0:
            self.consecutive += 1
        else:
            self.consecutive = 0
            self.breached = False       # sustained recovery clears it
        if self.consecutive >= cfg.breach_blocks and not self.breached:
            self.breached = True
            self.breach_total += 1
            return True
        return False

    def as_dict(self) -> Dict[str, Any]:
        return {"config": self.config.as_dict(),
                "burn_rate": {"latency_p99": round(self.burn_latency, 4),
                              "lag": round(self.burn_lag, 4)},
                "observed_p99_ms": round(self.observed_p99_ms, 3),
                "window_blocks_observed": len(self.window),
                "consecutive_over_target": self.consecutive,
                "breached": self.breached,
                "breach_total": self.breach_total}


# ------------------------------------------------------------------ spans


_pcns = time.perf_counter_ns


class _Span:
    """Nest-aware stage span.  On exit the span's EXCLUSIVE time
    (elapsed minus enclosed child spans on this thread) is credited to
    its stage and its full elapsed time is charged to the parent's
    child accumulator — so ``sum(stage_ns)`` over a fully-spanned path
    equals the wall clock once, not once per nesting level.

    The hot path runs cold-cache right next to device dispatches, where
    every attribute chase costs real time — frames are plain two-int
    lists ``[t0, child_ns]`` on a thread-local stack, no per-frame
    object."""

    __slots__ = ("ledger", "stage", "frame", "stack")

    def __init__(self, ledger: "LatencyLedger", stage: str):
        self.ledger = ledger
        self.stage = stage

    def __enter__(self):
        if ledger_enabled():
            tls = self.ledger._tls
            st = getattr(tls, "stack", None)
            if st is None:
                st = tls.stack = []
            frame = [_pcns(), 0]
            st.append(frame)
            self.frame = frame
            self.stack = st
        else:
            self.frame = None
        return self

    def __exit__(self, *exc):
        frame = self.frame
        if frame is None:
            return False
        elapsed = _pcns() - frame[0]
        st = self.stack
        st.pop()
        if st:
            st[-1][1] += elapsed
        ns = elapsed - frame[1]
        led = self.ledger
        if ns > 0:
            led._ns[self.stage] += ns
        led._spans[self.stage] += 1
        return False


# ------------------------------------------------------------------ ledger


class LatencyLedger:
    """Process-global stage accumulators + per-app histograms + lag
    watermarks + SLO state.

    Hot-path writes are plain int adds under the GIL (the RimStats
    contract: exact single-threaded, monotone everywhere); dict creation
    for new (app, stage) keys is the only locked path."""

    #: per-app block deltas buffered before the histogram fold — the
    #: fold (6-8 locked Histogram.records) costs ~10x its isolated time
    #: right after a device block (cold caches), so the hot path only
    #: appends the integer deltas and the fold runs once per
    #: _FOLD_EVERY blocks / lazily on any read surface
    _FOLD_EVERY = 64

    def __init__(self):
        self._ns: Dict[str, int] = {s: 0 for s in STAGES}
        self._spans: Dict[str, int] = {s: 0 for s in STAGES}
        self._lock = threading.Lock()
        self._tls = threading.local()
        # (app, stage) -> Histogram of per-block stage ns; stage "total"
        # is the per-block all-stage sum (the e2e estimator SLOs burn on)
        self._hist: Dict[tuple, Histogram] = {}
        # app -> buffered per-block delta lists awaiting the fold
        self._pending: Dict[str, list] = {}
        # app -> the most recent block's stage deltas (waterfall row)
        self._last_deltas: Dict[str, list] = {}
        # (app, stream) -> lag watermark state
        self._lag: Dict[tuple, Dict[str, float]] = {}
        self._slo: Dict[str, _SloState] = {}

    # -------------------------------------------------------- hot path

    @property
    def enabled(self) -> bool:
        return ledger_enabled()

    def _tls_stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, stage: str) -> _Span:
        return _Span(self, stage)

    def record(self, stage: str, ns: int) -> None:
        """Credit ``ns`` of exclusive wall time to ``stage``."""
        if ns < 0:
            ns = 0
        self._ns[stage] += ns
        self._spans[stage] += 1

    def note_ingress(self, app: str, stream: str, event_ts_ms: int,
                     now_ms: float, dur_ns: int) -> None:
        """Per-chunk admit stamp: ingress stage time + the event-time lag
        watermark (max admitted event timestamp vs the wall clock — or
        the playback clock when the app replays history)."""
        self.record("ingress", dur_ns)
        ent = self._lag.get((app, stream))
        if ent is None:
            ent = self._lag[(app, stream)] = {}
        ent["event_ts_ms"] = float(event_ts_ms)
        ent["admit_wall_ms"] = time.time() * 1000.0
        ent["lag_ms"] = float(now_ms) - float(event_ts_ms)

    # ------------------------------------------------------ block fold

    def stage_ns(self) -> Dict[str, int]:
        return dict(self._ns)

    def _hist_for(self, app: str, stage: str) -> Histogram:
        h = self._hist.get((app, stage))
        if h is None:
            with self._lock:
                h = self._hist.setdefault((app, stage), Histogram())
        return h

    @hot_path("per-block stage-delta banking + SLO evaluation")
    def note_block(self, app: str, owner, runtime=None,
                   want_row: bool = True) -> Optional[Dict[str, float]]:
        """Bank one ingest block's stage deltas (global accumulators vs
        ``owner``'s last snapshot — the flight ring's rim/kernel-split
        convention), evaluate the app's SLO, and return the waterfall
        row for the flight record (only built when ``want_row``; the
        histogram fold is deferred — see ``_FOLD_EVERY``)."""
        if not ledger_enabled():
            return None
        ns = self._ns
        cur = [ns[s] for s in STAGES]
        prev = getattr(owner, "_ledger_ns0", None)
        owner._ledger_ns0 = cur
        if prev is None:
            return None
        deltas = [c - p if c > p else 0 for c, p in zip(cur, prev)]
        total_ns = sum(deltas)
        self._last_deltas[app] = deltas
        pend = self._pending.get(app)
        if pend is None:
            with self._lock:
                pend = self._pending.setdefault(app, [])
        pend.append(deltas)
        if len(pend) >= self._FOLD_EVERY:
            self._fold_pending(app)
        st = self._slo.get(app)
        if st is not None and st.observe(
                total_ns / 1e6 if total_ns > 0 else None,
                self._app_lag_ms(app)):
            self._emit_breach(app, st, runtime)
        if not want_row or total_ns <= 0:
            return None
        return self._row_ms(deltas)

    @staticmethod
    def _row_ms(deltas) -> Dict[str, float]:
        return {s: round(d / 1e6, 4)
                for s, d in zip(STAGES, deltas) if d > 0}

    def _fold_pending(self, app: Optional[str] = None) -> None:
        """Drain buffered block deltas into the per-app histograms
        (cold path: every read surface calls this first)."""
        apps = [app] if app is not None else list(self._pending)
        for a in apps:
            pend = self._pending.get(a)
            if not pend:
                continue
            drained = pend[:]
            del pend[:len(drained)]     # GIL-safe vs concurrent appends
            for deltas in drained:
                tot = 0
                for s, d in zip(STAGES, deltas):
                    if d > 0:
                        tot += d
                        self._hist_for(a, s).record(d)
                if tot > 0:
                    self._hist_for(a, "total").record(tot)

    def _app_lag_ms(self, app: str) -> Optional[float]:
        lags = [v["lag_ms"] for (a, _s), v in list(self._lag.items())
                if a == app]
        return max(lags) if lags else None

    def _emit_breach(self, app: str, st: _SloState, runtime) -> None:
        """SLO001 through the flight bus: the breach ships its own
        waterfall evidence (last block row + the per-stage histogram
        summaries of the breaching window)."""
        from .flight import flight
        try:
            flight().emit("slo_breach", app=app, detail={
                "code": "SLO001",
                "slo": st.config.as_dict(),
                "observed": st.as_dict(),
                "waterfall": self._row_ms(
                    self._last_deltas.get(app, [])),
                "stage_summary_ms": self._stage_summary(app),
            }, runtime=runtime)
        except Exception:   # noqa: BLE001 — SLO accounting must not raise
            pass

    # ----------------------------------------------------- SLO registry

    def register_slo(self, app: str, config: SloConfig) -> None:
        with self._lock:
            self._slo[app] = _SloState(config)

    def drop_app(self, app: str) -> None:
        """Forget one app's SLO + lag + histogram state (runtime
        shutdown; process-global stage counters are left alone)."""
        with self._lock:
            self._slo.pop(app, None)
            self._pending.pop(app, None)
            self._last_deltas.pop(app, None)
            for key in [k for k in self._lag if k[0] == app]:
                self._lag.pop(key, None)
            for key in [k for k in self._hist if k[0] == app]:
                self._hist.pop(key, None)

    def slo_breached(self, app: str) -> bool:
        st = self._slo.get(app)
        return bool(st is not None and st.breached)

    # ------------------------------------------------------- snapshots

    def _stage_summary(self, app: str) -> Dict[str, Dict[str, float]]:
        self._fold_pending(app)
        out: Dict[str, Dict[str, float]] = {}
        for stage in STAGES + ("total",):
            h = self._hist.get((app, stage))
            if h is not None and h.count:
                out[stage] = h.summary(scale=1e-6)      # ns -> ms
        return out

    def snapshot(self, app: Optional[str] = None) -> Dict[str, Any]:
        self._fold_pending()
        doc: Dict[str, Any] = {
            "enabled": ledger_enabled(),
            "stage_seconds": {s: self._ns[s] / 1e9 for s in STAGES},
            "stage_spans": dict(self._spans),
        }
        apps = sorted({a for (a, _s) in self._hist}
                      ) if app is None else [app]
        per_app = {}
        for a in apps:
            entry: Dict[str, Any] = {"stages_ms": self._stage_summary(a)}
            lags = {s: {"lag_ms": round(v["lag_ms"], 3),
                        "processing_lag_ms": round(
                            time.time() * 1000.0 - v["admit_wall_ms"], 3)}
                    for (aa, s), v in list(self._lag.items()) if aa == a}
            if lags:
                entry["lag"] = lags
            st = self._slo.get(a)
            if st is not None:
                entry["slo"] = st.as_dict()
            last = self._last_deltas.get(a)
            if last:
                entry["last_block_ms"] = self._row_ms(last)
            per_app[a] = entry
        doc["apps"] = per_app
        return doc

    def prometheus_lines(self) -> List[str]:
        from .statistics import _fmt_labels
        self._fold_pending()
        lines: List[str] = []
        for stage in STAGES:
            lab = _fmt_labels({"stage": stage})
            lines.append(f"siddhi_ledger_stage_seconds_total{lab} "
                         f"{self._ns[stage] / 1e9:.9g}")
            lines.append(f"siddhi_ledger_stage_spans_total{lab} "
                         f"{self._spans[stage]}")
        for (app, stage), h in sorted(self._hist.items()):
            if not h.count:
                continue
            s = h.summary(scale=1e-6)
            for q in ("p50", "p99"):
                lab = _fmt_labels({"app": app, "stage": stage, "q": q})
                lines.append(
                    f"siddhi_ledger_stage_latency_ms{lab} {s[q]:.6g}")
        now_ms = time.time() * 1000.0
        for (app, stream), v in sorted(self._lag.items()):
            lab = _fmt_labels({"app": app, "stream": stream})
            lines.append(f"siddhi_event_time_lag_ms{lab} "
                         f"{v['lag_ms']:.6g}")
            lines.append(f"siddhi_processing_lag_ms{lab} "
                         f"{now_ms - v['admit_wall_ms']:.6g}")
        for app, st in sorted(self._slo.items()):
            for slo_kind, burn in (("latency_p99", st.burn_latency),
                                   ("lag", st.burn_lag)):
                lab = _fmt_labels({"app": app, "slo": slo_kind})
                lines.append(f"siddhi_slo_burn_rate{lab} {burn:.6g}")
            lab = _fmt_labels({"app": app})
            lines.append(f"siddhi_slo_breach_active{lab} "
                         f"{1 if st.breached else 0}")
            lines.append(f"siddhi_slo_breach_total{lab} {st.breach_total}")
        return lines

    def reset(self) -> None:
        """Test/bench isolation (mirrors flight().reset())."""
        with self._lock:
            for s in STAGES:
                self._ns[s] = 0
                self._spans[s] = 0
            self._hist.clear()
            self._pending.clear()
            self._last_deltas.clear()
            self._lag.clear()
            self._slo.clear()


_GLOBAL = LatencyLedger()


def ledger() -> LatencyLedger:
    return _GLOBAL
