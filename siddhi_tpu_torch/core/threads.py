"""Named-thread registry for the engine's host rim.

Every thread (or timer) the engine starts carries a ``siddhi-`` prefixed
name minted through :func:`engine_thread_name`, so a leaked thread in a
test teardown — or a stack dump from a wedged production process — is
attributable to the component that started it without guessing from the
target function.  The registry below is the single source of truth; the
concurrency auditor (analysis/engine/lockgraph.py, CE008) statically
rejects ``threading.Thread``/``Timer`` construction sites that do not
name their thread, and the tier-1 thread-leak sentinel
(tests/conftest.py) uses :func:`engine_threads` to report leftovers per
test file.
"""
from __future__ import annotations

import threading
from typing import Dict, List

#: prefix -> owning component + its lifecycle contract (who joins it).
#: Adding a thread to the engine means adding its prefix here first —
#: tests/test_engine_lint.py asserts every live siddhi- thread matches.
ENGINE_THREAD_PREFIXES: Dict[str, str] = {
    "siddhi-junction-": "core/stream.py StreamJunction @Async workers; "
                        "stop() drain-joins them (bounded by "
                        "drain.timeout.ms)",
    "siddhi-retry-": "core/resilience.py SinkRetryWorker; stop() "
                     "interrupts backoff and joins (bounded)",
    "siddhi-stats-reporter": "core/statistics.py periodic reporter; "
                             "stop_reporting() joins (bounded 5s)",
    "siddhi-rest": "service/rest.py HTTP server; stop() shuts the "
                   "server down",
    "siddhi-sched-timer": "core/scheduler.py one-shot re-armed Timer; "
                          "shutdown() cancels",
    "siddhi-heartbeat": "core/timestamp.py playback idle-time Timer; "
                        "shutdown() cancels and disarms re-arming",
    "siddhi-prewarm": "plan/shapes.py AOT shape-ladder worker; transient "
                      "(exits when the ladder queue drains), "
                      "prewarm_join() waits for idle + thread exit",
}


def engine_thread_name(prefix: str, *parts: object) -> str:
    """Mint a thread name under a registered prefix.  Unregistered
    prefixes raise immediately — the registry must stay exhaustive for
    leak attribution to work."""
    if prefix not in ENGINE_THREAD_PREFIXES:
        raise ValueError(
            f"thread prefix {prefix!r} is not in ENGINE_THREAD_PREFIXES; "
            f"register it in core/threads.py so leaks stay attributable")
    if not parts:
        return prefix.rstrip("-") if prefix.endswith("-") else prefix
    return prefix + "-".join(str(p) for p in parts) if prefix.endswith("-") \
        else prefix + "-" + "-".join(str(p) for p in parts)


def engine_threads(include_daemon: bool = True) -> List[threading.Thread]:
    """Live engine threads (name starts with ``siddhi-``)."""
    return [t for t in threading.enumerate()
            if t.name.startswith("siddhi-")
            and (include_daemon or not t.daemon)]


def attribute(thread_name: str) -> str:
    """Owning-component line for a thread name, or 'unregistered'."""
    for prefix, owner in ENGINE_THREAD_PREFIXES.items():
        if thread_name == prefix or thread_name.startswith(prefix):
            return owner
    return "unregistered (not in ENGINE_THREAD_PREFIXES)"
