"""Shape-class registry of built device steps.

Counterpart of ``siddhi_tpu/plan/shapes.py``.  The JAX package routes
every ``jax.jit`` through this registry to attribute XLA compiles to a
shape class (``kind`` plus static dims).  PyTorch runs eagerly and the
port's kernels are built once per process (``ops/_kernels.py``), so
there is nothing to trace: :meth:`ShapeRegistry.jit` keeps the same
surface, records the shape class and counts calls, and returns the step
unchanged.  The compile counters stay at zero; ``configure_compile_cache``
reports that a persistent compile cache does not apply.

The signature helper is the JAX package's own (plan-IR dumps and
schema reports pin the key format).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List


def _fmt_dim(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (tuple, list)):
        return "x".join(_fmt_dim(x) for x in v)
    return str(v)


def shape_signature(kind: str, dims: Dict[str, Any]) -> str:
    """Stable, hashable shape-class key: ``kind[d1=v1,d2=v2,...]`` with
    dims sorted by name."""
    body = ",".join(f"{k}={_fmt_dim(v)}" for k, v in sorted(dims.items()))
    return f"{kind}[{body}]"


def nfa_shape_dims(spec, n_partitions: int, batch_b: int,
                   **extra) -> Dict[str, Any]:
    """The canonical NFA step dims — S/K/P/B plus capture geometry and
    telemetry (the JAX package's key, without its donation flag: the
    port's step never donates its carry)."""
    d = {"S": len(spec.units), "K": spec.n_slots, "P": n_partitions,
         "B": max(batch_b, 1), "R": max(spec.n_rows, 1),
         "C": max(spec.n_caps, 1), "telem": bool(spec.telemetry)}
    d.update(extra)
    return d


_CACHE_STATE: Dict[str, Any] = {
    "configured": True, "enabled": False, "dir": "", "ephemeral": False,
    "reason": "not applicable under torch (eager execution; kernels are "
              "built once per process by ops/_kernels.py)"}


def configure_compile_cache() -> Dict[str, Any]:
    """No-op: there is no XLA compile to cache under torch."""
    return dict(_CACHE_STATE)


class ShapeEntry:
    """Per-shape-class ledger line (calls only; no compiles under torch)."""

    __slots__ = ("signature", "kind", "dims", "calls", "triggers",
                 "last_trigger")

    def __init__(self, signature: str, kind: str, dims: Dict[str, Any]):
        self.signature = signature
        self.kind = kind
        self.dims = dict(dims)
        self.calls = 0
        self.triggers: Dict[str, int] = {}
        self.last_trigger = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"signature": self.signature, "kind": self.kind,
                "dims": dict(self.dims), "compiles": 0,
                "compile_seconds": 0.0, "blocked_seconds": 0.0,
                "cache_hits": 0, "cache_misses": 0,
                "calls": self.calls, "triggers": dict(self.triggers),
                "last_trigger": self.last_trigger,
                "last_compile_unix": 0.0, "prewarmed": False}


class RegisteredStep:
    """The registry's wrapper around one built step: counts calls."""

    __slots__ = ("fn", "entry")

    def __init__(self, fn: Callable, entry: ShapeEntry):
        self.fn = fn
        self.entry = entry

    def __call__(self, *args, **kwargs):
        self.entry.calls += 1
        return self.fn(*args, **kwargs)


class ShapeRegistry:
    """Process-global shape-class registry."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[str, ShapeEntry] = {}

    def entry(self, kind: str, dims: Dict[str, Any]) -> ShapeEntry:
        sig = shape_signature(kind, dims)
        with self._lock:
            e = self._entries.get(sig)
            if e is None:
                e = self._entries[sig] = ShapeEntry(sig, kind, dims)
            return e

    def jit(self, kind: str, dims: Dict[str, Any], fn: Callable, *,
            trigger: str = "build", **_unused) -> RegisteredStep:
        """Register ``fn`` under its shape class and return it wrapped
        (same surface as the JAX registry's ``jit``; nothing is traced)."""
        e = self.entry(kind, dims)
        with self._lock:
            e.triggers[trigger] = e.triggers.get(trigger, 0) + 1
            e.last_trigger = trigger
        return RegisteredStep(fn, e)

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._entries)
        return {"shape_classes": n, "compiles": 0, "compile_seconds": 0.0,
                "blocked_seconds": 0.0, "cache_hits": 0, "cache_misses": 0}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            entries = [e.as_dict() for e in self._entries.values()]
        entries.sort(key=lambda d: d["signature"])
        return {"cache": dict(_CACHE_STATE),
                "prewarm": {"enabled": False, "compiled": 0, "skipped": 0,
                            "errors": 0, "handoffs": 0, "pending": 0,
                            "seconds": 0.0},
                "totals": self.totals(), "entries": entries,
                "recent_compiles": []}

    def prometheus_lines(self) -> List[str]:
        with self._lock:
            n = len(self._entries)
        return [f"siddhi_shape_classes {n}"]


#: /metrics HELP/TYPE headers — rendered once by
#: core/statistics.prometheus_text before any samples.
SHAPES_TYPES = [
    ("siddhi_shape_classes", "gauge",
     "Shape classes registered with the step registry"),
]


_REGISTRY = ShapeRegistry()


def shape_registry() -> ShapeRegistry:
    return _REGISTRY
