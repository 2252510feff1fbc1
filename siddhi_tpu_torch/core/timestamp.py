"""Timestamp generation + playback virtual time.

(reference: util/timestamp/TimestampGeneratorImpl.java — wall clock by default;
in @app:playback mode currentTime() returns the last seen event timestamp,
optionally advanced by an idle-time heartbeat.)
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .lockwitness import maybe_wrap
from .threads import engine_thread_name


class TimestampGenerator:
    def __init__(self):
        self._playback = False
        self._last_event_time = -1
        self._idle_time_ms: Optional[int] = None
        self._increment_ms: Optional[int] = None
        self._listeners: List[Callable[[int], None]] = []
        self._heartbeat: Optional[threading.Timer] = None
        self._stopped = False
        self._lock = maybe_wrap(
            threading.Lock(), "core.timestamp.TimestampGenerator._lock")

    # ------------------------------------------------------------ config
    def enable_playback(self, idle_time_ms: Optional[int] = None,
                        increment_ms: Optional[int] = None):
        self._playback = True
        self._idle_time_ms = idle_time_ms
        self._increment_ms = increment_ms
        self._arm_heartbeat()

    @property
    def in_playback(self) -> bool:
        return self._playback

    # ------------------------------------------------------------ use
    def current_time(self) -> int:
        if self._playback:
            return self._last_event_time
        return int(time.time() * 1000)

    def observe_event_time(self, ts: int):
        if self._playback:
            with self._lock:
                if ts > self._last_event_time:
                    self._last_event_time = ts
            self._arm_heartbeat()

    def add_time_change_listener(self, fn: Callable[[int], None]):
        self._listeners.append(fn)

    def _arm_heartbeat(self):
        if not self._playback or self._idle_time_ms is None:
            return

        def tick():
            with self._lock:
                if self._stopped:
                    return
                self._last_event_time += (self._increment_ms or 0)
                now = self._last_event_time
            for fn in list(self._listeners):
                fn(now)
            self._arm_heartbeat()

        # Timer swap rides _lock: two racing observe_event_time callers
        # used to cancel/replace unguarded and orphan a live timer, and a
        # tick in flight across shutdown() would re-arm forever.
        with self._lock:
            if self._stopped:
                return
            if self._heartbeat is not None:
                self._heartbeat.cancel()
            t = threading.Timer(self._idle_time_ms / 1000.0, tick)
            t.daemon = True
            t.name = engine_thread_name("siddhi-heartbeat")
            self._heartbeat = t
            t.start()

    def shutdown(self):
        with self._lock:
            self._stopped = True
            if self._heartbeat is not None:
                self._heartbeat.cancel()
                self._heartbeat = None
