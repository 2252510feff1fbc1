"""Step-debugger over live streams.

(reference: core/debugger/SiddhiDebugger.java:37-213 — acquireBreakPoint on a
query's IN/OUT terminal blocks event threads there; next() steps to the next
terminal, play() runs to the next acquired breakpoint; getQueryState exposes
the query's live state — wired through ProcessStreamReceiver.receive
checks :103-106.)

Columnar twist: a breakpoint fires once per event *chunk* arriving at the
terminal; the callback receives the chunk's events.  `next()`/`play()` may be
called from the callback (synchronous stepping) or from another thread (the
blocked event thread resumes).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Set, Tuple

from .event import EventChunk


class SiddhiDebugger:
    IN = "IN"
    OUT = "OUT"

    def __init__(self, app_runtime):
        self.app_runtime = app_runtime
        self._break_points: Set[Tuple[str, str]] = set()
        self._step_mode = False
        self._resume = threading.Event()
        self._resume.set()
        self._callback: Optional[Callable] = None
        self._enabled = True

    # ------------------------------------------------------------ control

    def acquire_break_point(self, query_name: str, terminal: str):
        self._break_points.add((query_name, terminal))

    def release_break_point(self, query_name: str, terminal: str):
        self._break_points.discard((query_name, terminal))

    def release_all_break_points(self):
        self._break_points.clear()

    def next(self):
        """Step: resume and break again at the very next terminal."""
        self._step_mode = True
        self._resume.set()

    def play(self):
        """Resume until the next acquired breakpoint."""
        self._step_mode = False
        self._resume.set()

    def set_debugger_callback(self, cb: Callable):
        """cb(events, query_name, terminal, debugger)"""
        self._callback = cb

    def get_query_state(self, query_name: str) -> dict:
        qr = self.app_runtime.query_runtimes.get(query_name)
        if qr is None:
            return {}
        return {eid: obj.current_state()
                for eid, obj in qr.stateful_elements()}

    def detach(self):
        self._enabled = False
        self._resume.set()

    # ------------------------------------------------------------ hook

    def check(self, query_name: str, terminal: str, chunk: EventChunk):
        """Called from query terminals on the event thread."""
        if not self._enabled:
            return
        if not (self._step_mode or
                (query_name, terminal) in self._break_points):
            return
        self._step_mode = False
        self._resume.clear()
        if self._callback is not None:
            self._callback(chunk.to_events(), query_name, terminal, self)
        self._resume.wait(timeout=60.0)
