"""Hot-path registry: mark per-event / per-block functions for lint.

``@hot_path("...")`` is a zero-cost marker — it registers the function's
dotted name and hands the function back untouched.  The engine hot-path
lint (analysis/engine/hotpath.py) discovers decorated functions purely
from the AST, so ``python -m siddhi_tpu_torch.analyze --engine`` never imports
the decorated modules (the no-jax guarantee); this runtime registry
exists so tests can cross-check that the static scan found exactly the
functions the engine actually marked.

The reason string is part of the contract: it should say *why* the
function is hot (per-event, per-block, per-span), because that decides
which CE1xx checks are proportionate.
"""
from __future__ import annotations

from typing import Callable, Dict, TypeVar

F = TypeVar("F", bound=Callable)

#: dotted name -> reason, filled at import time by @hot_path sites.
_REGISTRY: Dict[str, str] = {}


def hot_path(reason: str) -> Callable[[F], F]:
    def mark(fn: F) -> F:
        _REGISTRY[f"{fn.__module__}.{fn.__qualname__}"] = reason
        return fn
    return mark


def registry() -> Dict[str, str]:
    return dict(_REGISTRY)
