"""Runtime lock-witness: acquisition-order validation for engine locks.

The static lock-graph (analysis/engine/lockgraph.py) proves what the
source *can* do; the witness watches what threads *actually* do.  When
armed, engine locks are wrapped at construction time via
:func:`maybe_wrap`; each wrapped lock reports first acquisitions and
final releases to a process-global :class:`LockWitness`, which keeps a
per-thread held-lock stack and a global observed-edge set.  Acquiring B
while holding A records the edge ``A -> B``; if the reverse edge has
been observed at runtime — or exists in the static graph — that is a
lock-order inversion (two threads can interleave into a deadlock) and an
``LW001`` incident bundle goes through the flight-recorder bus.  Holding
any witnessed lock longer than ``SIDDHI_TPU_LOCKWITNESS_HOLD_MS``
(default 100) reports ``LW002``.

Off by default and zero-cost when off: :func:`maybe_wrap` returns the
lock unchanged unless the witness is armed (programmatically, or via
``SIDDHI_TPU_LOCKWITNESS=1`` at lock-construction time).  The witness's
own mutex only guards its bookkeeping dictionaries and is never held
while an engine lock is being acquired, so the witness cannot introduce
an ordering of its own.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

WITNESS_ENV = "SIDDHI_TPU_LOCKWITNESS"
HOLD_ENV = "SIDDHI_TPU_LOCKWITNESS_HOLD_MS"
DEFAULT_HOLD_MS = 100.0


def witness_enabled() -> bool:
    """Env opt-in, read at lock-construction time (cold path)."""
    return os.environ.get(WITNESS_ENV, "").strip().lower() in (
        "1", "true", "on", "yes")


def _hold_threshold_ms() -> float:
    try:
        v = float(os.environ.get(HOLD_ENV, ""))
        return v if v > 0 else DEFAULT_HOLD_MS
    except (TypeError, ValueError):
        return DEFAULT_HOLD_MS


class LockWitness:
    """Observed-order recorder + validator.  Thread-safe; one global
    instance serves the engine (see :func:`witness`), tests may build
    private instances for seeded scenarios."""

    def __init__(self, hold_ms: Optional[float] = None,
                 static_edges: Optional[Iterable[Tuple[str, str]]] = None,
                 emit_incidents: bool = True):
        self.armed = False
        self.hold_ms = hold_ms if hold_ms is not None else _hold_threshold_ms()
        self.emit_incidents = emit_incidents
        self._mu = threading.Lock()         # guards the dicts below only
        self._tls = threading.local()       # .stack: List[str] held names
        self._edges: Dict[Tuple[str, str], str] = {}   # edge -> first thread
        self._inversions: List[Dict[str, Any]] = []
        self._holds: List[Dict[str, Any]] = []
        self._reported: Set[frozenset] = set()         # deduped emit pairs
        self._static: Set[Tuple[str, str]] = set(static_edges or ())

    # ------------------------------------------------------------ control

    def arm(self):
        self.armed = True

    def disarm(self):
        self.armed = False

    def reset(self):
        with self._mu:
            self._edges.clear()
            self._inversions.clear()
            self._holds.clear()
            self._reported.clear()

    def load_static_edges(self, edges: Iterable[Tuple[str, str]]):
        with self._mu:
            self._static.update(tuple(e) for e in edges)

    # ------------------------------------------------------------ reports

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def inversions(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._inversions)

    def holds(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._holds)

    # ------------------------------------------------------------ wrapping

    def wrap(self, lock: Any, name: str) -> "_WitnessedLock":
        return _WitnessedLock(lock, name, self)

    # ------------------------------------------------------ lock callbacks

    def _stack(self) -> List[str]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _on_acquired(self, name: str):
        stack = self._stack()
        if stack:
            tname = threading.current_thread().name
            new_inversions = []
            with self._mu:
                for held in stack:
                    if held == name:
                        continue
                    edge = (held, name)
                    if edge not in self._edges:
                        self._edges[edge] = tname
                    rev = (name, held)
                    if rev in self._edges or rev in self._static:
                        pair = frozenset(edge)
                        if pair not in self._reported:
                            self._reported.add(pair)
                            inv = {"code": "LW001",
                                   "first": list(rev), "second": list(edge),
                                   "thread": tname,
                                   "other_thread": self._edges.get(rev),
                                   "static": rev in self._static}
                            self._inversions.append(inv)
                            new_inversions.append(inv)
            for inv in new_inversions:      # emit outside _mu
                self._emit("lock_inversion", inv)
        stack.append(name)

    def _on_release(self, name: str, t0_ns: Optional[int]):
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break
        if t0_ns is None:
            return
        held_ms = (time.perf_counter_ns() - t0_ns) / 1e6
        if held_ms > self.hold_ms:
            rec = {"code": "LW002", "lock": name,
                   "held_ms": round(held_ms, 3),
                   "threshold_ms": self.hold_ms,
                   "thread": threading.current_thread().name}
            with self._mu:
                self._holds.append(rec)
            self._emit("lock_hold", rec)

    def _emit(self, kind: str, detail: Dict[str, Any]):
        if not self.emit_incidents:
            return
        try:
            from .flight import flight
            flight().emit(kind, detail=detail)
        except Exception:  # noqa: BLE001 — witness must never take the app down
            pass


class _WitnessedLock:
    """Transparent wrapper: same acquire/release/context protocol as the
    wrapped Lock/RLock.  Tracks per-thread depth so reentrant
    re-acquisitions don't double-report, and stays balanced even if the
    witness is disarmed while a lock is held."""

    __slots__ = ("_lock", "_name", "_w", "_tls")

    def __init__(self, lock: Any, name: str, w: LockWitness):
        self._lock = lock
        self._name = name
        self._w = w
        self._tls = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            d = getattr(self._tls, "depth", 0)
            self._tls.depth = d + 1
            if d == 0:
                self._tls.armed_entry = self._w.armed
                if self._w.armed:
                    self._tls.t0 = time.perf_counter_ns()
                    self._w._on_acquired(self._name)
        return ok

    def release(self):
        d = getattr(self._tls, "depth", 1) - 1
        self._tls.depth = d
        if d == 0 and getattr(self._tls, "armed_entry", False):
            t0 = getattr(self._tls, "t0", None)
            self._tls.t0 = None
            if self._w.armed:
                self._w._on_release(self._name, t0)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    @property
    def name(self) -> str:
        return self._name


# ------------------------------------------------------------------ global

_GLOBAL: Optional[LockWitness] = None
_GLOBAL_MU = threading.Lock()


def witness() -> LockWitness:
    global _GLOBAL
    w = _GLOBAL
    if w is None:
        with _GLOBAL_MU:
            w = _GLOBAL
            if w is None:
                w = _GLOBAL = LockWitness()
    return w


def arm(static_edges: Optional[Iterable[Tuple[str, str]]] = None,
        hold_ms: Optional[float] = None) -> LockWitness:
    w = witness()
    if static_edges is not None:
        w.load_static_edges(static_edges)
    if hold_ms is not None:
        w.hold_ms = hold_ms
    w.arm()
    return w


def disarm():
    w = _GLOBAL
    if w is not None:
        w.disarm()


def maybe_wrap(lock: Any, name: str) -> Any:
    """Construction-time hook: wrap `lock` when the witness is armed (or
    the env knob is on), else hand it back untouched — the off path is a
    plain attribute check plus one function call, nothing per-acquire."""
    w = _GLOBAL
    if w is not None and w.armed:
        return w.wrap(lock, name)
    if witness_enabled():
        return arm().wrap(lock, name)
    return lock
