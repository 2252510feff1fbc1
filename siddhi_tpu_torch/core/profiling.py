"""Device/kernel profiling.

Wraps every jitted step function the planner and the plan/* compilers
build (NFA step, bank step, egress pack, dwin/gagg/wagg steps, device
filter program) in a ``ProfiledKernel`` that — when profiling is enabled
— records per kernel:

  * call count and host-side dispatch time,
  * compile/retrace count (via the jitted callable's ``_cache_size()``
    when JAX exposes it, argument-signature tracking otherwise) — so a
    BENCH regression can be attributed to "NFA step retraced 40x"
    instead of guessed at,
  * blocked device time (``torch.cuda.synchronize()`` deltas) when
    ``device_timing`` is on — this serializes the pipeline, so it is a
    separate, opt-in level,
  * batch sizes (events carried per call, from a per-site hint) and
    host→device transfer bytes (host-resident ndarray arguments);
    device→host bytes are reported by the egress/retire sites via
    ``record_d2h``.

Disabled (the default) the wrapper is one attribute check + a passthrough
call per *block* — zero extra device syncs, nothing registered.  The
profiler is process-global (kernels are built by standalone compiled
objects as well as app runtimes); ``@app:statistics`` enables it for the
process, ``enable_profiling()`` does so explicitly.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class KernelStats:
    __slots__ = ("name", "calls", "compile_count", "dispatch_ns",
                 "device_ns", "batch_events", "h2d_bytes", "d2h_bytes",
                 "max_batch", "signatures", "live_bytes", "scan_ticks",
                 "batch_b", "dispatch_count")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.compile_count = 0
        self.dispatch_ns = 0
        self.device_ns = 0
        self.batch_events = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.max_batch = 0
        self.signatures: set = set()
        # persistent device state bytes (a gauge, not a counter): set by
        # the carry-placement sites; the measured side of the static cost
        # model's HBM prediction (analysis/cost_model.py, bench.py)
        self.live_bytes = 0
        # sequential scan ticks issued (counter) and events-per-tick B
        # (gauge) — set by scan-shaped kernels via a ticks_of hint; the
        # T→⌈T/B⌉ reduction of the fatter-tick NFA restructuring shows up
        # here (and is asserted in tests/test_nfa_batch.py)
        self.scan_ticks = 0
        self.batch_b = 0
        # device executions launched (counter).  Usually == calls, but a
        # site that launches several executables per wrapper call (or
        # none, e.g. a cache hit) can correct it via record_dispatches;
        # the C→1 claim of the stacked bank is asserted against this
        self.dispatch_count = 0

    def as_dict(self) -> Dict[str, Any]:
        return {"calls": self.calls,
                "dispatch_count": self.dispatch_count,
                "compile_count": self.compile_count,
                "dispatch_time_s": self.dispatch_ns / 1e9,
                "device_time_s": self.device_ns / 1e9,
                "batch_events": self.batch_events,
                "max_batch": self.max_batch,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "live_bytes": self.live_bytes,
                "scan_ticks": self.scan_ticks,
                "batch_b": self.batch_b}


def _signature(args) -> tuple:
    """Shape/dtype signature of the positional args — retrace detector
    for callables that don't expose a compile-cache size."""
    import numpy as np
    sig: List[Any] = []
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            sig.append((tuple(a.shape), str(a.dtype)))
        elif isinstance(a, dict):
            sig.append(tuple(sorted(
                (k, tuple(v.shape), str(v.dtype))
                for k, v in a.items()
                if hasattr(v, "shape") and hasattr(v, "dtype"))))
        elif isinstance(a, (int, float, bool, str, type(None))):
            sig.append(a)
        elif isinstance(a, np.ndarray):
            sig.append((tuple(a.shape), str(a.dtype)))
        else:
            sig.append(type(a).__name__)
    return tuple(sig)


def _host_bytes(args) -> int:
    """nbytes of host-resident ndarray leaves (≈ the H2D transfer the
    call implies; device-resident jax arrays transfer nothing)."""
    import numpy as np
    total = 0
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, np.ndarray):
            total += a.nbytes
        elif isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
    return total


class ProfiledKernel:
    """Transparent wrapper around a jitted callable."""

    __slots__ = ("fn", "stats", "profiler", "batch_of", "ticks_of",
                 "_cache_size_fn", "_last_cs")

    def __init__(self, fn: Callable, stats: KernelStats,
                 profiler: "KernelProfiler",
                 batch_of: Optional[Callable[..., int]] = None,
                 ticks_of: Optional[Callable[..., tuple]] = None):
        self.fn = fn
        self.stats = stats
        self.profiler = profiler
        self.batch_of = batch_of
        self.ticks_of = ticks_of
        self._cache_size_fn = getattr(fn, "_cache_size", None)
        self._last_cs = 0

    def __call__(self, *args, **kwargs):
        prof = self.profiler
        if not prof.enabled:
            return self.fn(*args, **kwargs)
        st = self.stats
        t0 = time.perf_counter_ns()
        out = self.fn(*args, **kwargs)
        t1 = time.perf_counter_ns()
        compiled = False
        with prof._lock:
            st.calls += 1
            st.dispatch_count += 1
            st.dispatch_ns += t1 - t0
            if self._cache_size_fn is not None:
                try:
                    # per-wrapper delta: stats with one name can span
                    # several rebuilt jit instances (slot growth rebuilds
                    # the step), each with its own compile cache
                    cs = self._cache_size_fn()
                    if cs > self._last_cs:
                        compiled = True
                        st.compile_count += cs - self._last_cs
                        self._last_cs = cs
                except Exception:   # noqa: BLE001 — fall back to sigs
                    self._cache_size_fn = None
            if self._cache_size_fn is None:
                sig = _signature(args)
                if sig not in st.signatures:
                    st.signatures.add(sig)
                    st.compile_count += 1
                    compiled = True
            if self.batch_of is not None:
                try:
                    b = int(self.batch_of(*args, **kwargs))
                    st.batch_events += b
                    if b > st.max_batch:
                        st.max_batch = b
                except Exception:   # noqa: BLE001 — hint only
                    pass
            if self.ticks_of is not None:
                try:
                    ticks, bb = self.ticks_of(*args, **kwargs)
                    st.scan_ticks += int(ticks)
                    st.batch_b = int(bb)
                except Exception:   # noqa: BLE001 — hint only
                    pass
            st.h2d_bytes += _host_bytes(args)
        from .tracing import tracer
        tr = tracer()
        if tr.enabled:
            if compiled:
                tr.instant(f"jit-compile:{st.name}", cat="jit")
            tr.complete(f"kernel.{st.name}", t0, t1, cat="kernel")
        if prof.device_timing:
            import torch
            t2 = time.perf_counter_ns()
            if torch.cuda.is_available():
                # kernels launch asynchronously on the current stream
                torch.cuda.synchronize()
            with prof._lock:
                st.device_ns += (t1 - t0) + (time.perf_counter_ns() - t2)
        return out


class KernelProfiler:
    def __init__(self):
        self.kernels: Dict[str, KernelStats] = {}
        # per-app {name: [dispatches, ingest_blocks]} — the runtimes
        # report the device-dispatch delta of every ingest block here;
        # the exported gauge is the running dispatches/block average
        self.app_blocks: Dict[str, List[int]] = {}
        self.enabled = False
        self.device_timing = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------ control

    def enable(self, device_timing: bool = False):
        self.enabled = True
        self.device_timing = device_timing

    def disable(self):
        self.enabled = False
        self.device_timing = False

    def reset(self):
        with self._lock:
            self.kernels.clear()
            self.app_blocks.clear()

    # ------------------------------------------------------------ recording

    def stats(self, name: str) -> KernelStats:
        with self._lock:
            return self.kernels.setdefault(name, KernelStats(name))

    def wrap(self, name: str, fn: Callable,
             batch_of: Optional[Callable[..., int]] = None,
             ticks_of: Optional[Callable[..., tuple]] = None
             ) -> ProfiledKernel:
        return ProfiledKernel(fn, self.stats(name), self, batch_of,
                              ticks_of)

    def record_d2h(self, name: str, nbytes: int):
        if not self.enabled:
            return
        self.stats(name).d2h_bytes += int(nbytes)

    def record_dispatches(self, name: str, n: int):
        """Adjust a kernel's device-execution counter out-of-band: a
        site that re-launches (egress overflow re-pack) adds, a cached
        result subtracts nothing — __call__ already counted one."""
        if not self.enabled:
            return
        self.stats(name).dispatch_count += int(n)

    def total_dispatches(self) -> int:
        """Sum of every kernel's dispatch_count — the runtimes diff this
        around an ingest block to report dispatches/block per app."""
        with self._lock:
            return sum(st.dispatch_count for st in self.kernels.values())

    def total_scan_ticks(self) -> int:
        """Sum of every kernel's scan_ticks — the flight recorder diffs
        this around an ingest block for the per-block record."""
        with self._lock:
            return sum(st.scan_ticks for st in self.kernels.values())

    def total_dispatch_ns(self) -> int:
        """Sum of every kernel's host-side dispatch time — diffed per
        ingest block for the flight ring's rim-vs-kernel ms split."""
        with self._lock:
            return sum(st.dispatch_ns for st in self.kernels.values())

    def record_app_block(self, app: str, dispatches: int):
        """One ingest block for `app` cost `dispatches` device launches."""
        if not self.enabled:
            return
        with self._lock:
            tot = self.app_blocks.setdefault(app, [0, 0])
            tot[0] += int(dispatches)
            tot[1] += 1

    def dispatches_per_block(self, app: str) -> float:
        with self._lock:
            tot = self.app_blocks.get(app)
        if not tot or not tot[1]:
            return 0.0
        return tot[0] / tot[1]

    def set_live_bytes(self, name: str, nbytes: int):
        """Gauge: current persistent device state owned by a kernel
        (carry slabs, rings, capture banks).  Overwritten on growth/
        restore so it always reflects the live footprint."""
        if not self.enabled:
            return
        self.stats(name).live_bytes = int(nbytes)

    # ------------------------------------------------------------ reads

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: st.as_dict() for name, st in self.kernels.items()}

    def prometheus_lines(self) -> List[str]:
        lines: List[str] = []
        for name, st in list(self.kernels.items()):
            lb = '{kernel="' + name + '"}'
            lines.append(f"siddhi_kernel_calls_total{lb} {st.calls}")
            lines.append(
                f"siddhi_kernel_compile_count{lb} {st.compile_count}")
            lines.append("siddhi_kernel_device_time_seconds_total"
                         f"{lb} {st.device_ns / 1e9:.9g}")
            lines.append("siddhi_kernel_dispatch_time_seconds_total"
                         f"{lb} {st.dispatch_ns / 1e9:.9g}")
            lines.append(f"siddhi_kernel_h2d_bytes_total{lb} {st.h2d_bytes}")
            lines.append(f"siddhi_kernel_d2h_bytes_total{lb} {st.d2h_bytes}")
            lines.append(f"siddhi_kernel_live_bytes{lb} {st.live_bytes}")
            lines.append(
                f"siddhi_kernel_batch_events_total{lb} {st.batch_events}")
            lines.append(
                f"siddhi_kernel_scan_ticks_total{lb} {st.scan_ticks}")
            lines.append(f"siddhi_kernel_batch_b{lb} {st.batch_b}")
            lines.append(
                f"siddhi_kernel_dispatches_total{lb} {st.dispatch_count}")
        for app, (disp, blocks) in list(self.app_blocks.items()):
            if not blocks:
                continue
            lines.append('siddhi_app_dispatches_per_block{app="' + app +
                         f'"}} {disp / blocks:.9g}')
        return lines


class RimStats:
    """Always-on host-rim accounting (the measured side of the columnar
    end-to-end claim).  Two process-global counters:

      * ``events_materialized`` — per-event ``Event`` objects built from
        columnar chunks (``EventChunk.to_events``).  Zero across a
        columnar ingest→match→columnar-sink run IS the zero-copy
        property; bench ``--smoke`` asserts it and
        ``--fail-on-rim-materialize`` gates on it.
      * ``rim_ns`` — host-rim wall time (ingress conversion/validation +
        egress callback/sink delivery), so the flight ring can carry a
        per-block rim-vs-kernel ms split.

    Unlike ``KernelProfiler`` this is NOT gated on ``enabled`` — the
    counters must hold even when @app:statistics is off (the smoke gate
    runs unprofiled).  Increments are plain int adds under the GIL: the
    materialization counter's contract is exact on single-threaded
    paths and monotone everywhere, which is all the gates need."""

    __slots__ = ("events_materialized", "rim_ns")

    def __init__(self):
        self.events_materialized = 0
        self.rim_ns = 0

    # hot paths add to the attributes directly; these are for readers
    def snapshot(self) -> Dict[str, Any]:
        return {"events_materialized": self.events_materialized,
                "host_rim_seconds": self.rim_ns / 1e9}

    def reset(self) -> None:
        self.events_materialized = 0
        self.rim_ns = 0

    def prometheus_lines(self) -> List[str]:
        return [
            f"siddhi_events_materialized_total {self.events_materialized}",
            f"siddhi_host_rim_seconds_total {self.rim_ns / 1e9:.9g}",
        ]


_GLOBAL = KernelProfiler()
_RIM = RimStats()


def profiler() -> KernelProfiler:
    return _GLOBAL


def rim_stats() -> RimStats:
    return _RIM


def storm_snapshot() -> Dict[str, Any]:
    """Dispatch context attached to watchdog WD0xx incidents while
    profiling is on: total kernel dispatches plus per-app
    dispatches-per-block averages (the session-timer storm signature was
    this ratio exploding — 300k+ dispatches on 60 events)."""
    p = _GLOBAL
    with p._lock:
        per_block = {app: (tot[0] / tot[1] if tot[1] else 0.0)
                     for app, tot in p.app_blocks.items()}
    return {"total_dispatches": p.total_dispatches(),
            "dispatches_per_block": per_block}


def wrap_kernel(name: str, fn: Callable,
                batch_of: Optional[Callable[..., int]] = None,
                ticks_of: Optional[Callable[..., tuple]] = None
                ) -> ProfiledKernel:
    """Wrap a device step under the process-global profiler.  The
    wrapper is always installed (so later enabling profiles already-built
    kernels); while disabled it is a single-attribute-check passthrough.
    ``ticks_of(*args) -> (scan_ticks, batch_b)`` lets scan-shaped kernels
    report their sequential tick count per call."""
    return _GLOBAL.wrap(name, fn, batch_of, ticks_of)


def enable_profiling(device_timing: bool = False):
    _GLOBAL.enable(device_timing=device_timing)


def disable_profiling():
    _GLOBAL.disable()
