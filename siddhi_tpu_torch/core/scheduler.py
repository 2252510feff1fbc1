"""Timer-event scheduler.

(reference: util/Scheduler.java — `notifyAt(t)` queue backed by a
ScheduledExecutorService that injects TIMER StreamEvents into processor chains;
playback-aware so virtual time drives expiry deterministically.)

Each stateful processor that needs time-based wakeups (time windows, absent
patterns, cron triggers, output rate timers) registers a target callable; the
scheduler calls `target.on_timer(ts)` when wall clock (or playback virtual
time) passes the requested instant.
"""
from __future__ import annotations

import heapq
import threading
from typing import Callable, List, Optional, Tuple

from .lockwitness import maybe_wrap
from .threads import engine_thread_name
from .timestamp import TimestampGenerator


class Scheduler:
    #: Optional core/overload.py DispatchWatchdog.  When set, every fire
    #: is consulted (`allow`) so a runaway re-arm loop trips instead of
    #: spinning forever, and registrations for disarmed targets are
    #: dropped at the door.
    watchdog = None

    def __init__(self, ts_gen: TimestampGenerator):
        self._ts_gen = ts_gen
        self._heap: List[Tuple[int, int, Callable[[int], None]]] = []
        self._seq = 0
        self._lock = maybe_wrap(
            threading.RLock(), "core.scheduler.Scheduler._lock")
        self._timer: Optional[threading.Timer] = None
        self._stopped = False
        #: cumulative fired-target count (flight-recorder block records)
        self.fires = 0
        if ts_gen.in_playback:
            ts_gen.add_time_change_listener(self._on_virtual_time)

    def notify_at(self, ts: int, target: Callable[[int], None]):
        wd = self.watchdog
        if wd is not None and wd.is_disarmed(target):
            return
        with self._lock:
            heapq.heappush(self._heap, (int(ts), self._seq, target))
            self._seq += 1
            if not self._ts_gen.in_playback:
                self._arm()

    # ------------------------------------------------------------ real time

    def _arm(self):
        if self._stopped or not self._heap:
            return
        next_ts = self._heap[0][0]
        delay = max(0.0, (next_ts - self._ts_gen.current_time()) / 1000.0)
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(delay, self._fire)
        self._timer.daemon = True
        self._timer.name = engine_thread_name("siddhi-sched-timer")
        self._timer.start()

    def _fire(self):
        now = self._ts_gen.current_time()
        due = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                due.append(heapq.heappop(self._heap))
        wd = self.watchdog
        for _ts, _, target in due:
            if wd is not None and not wd.allow(target, now):
                continue
            self.fires += 1
            try:
                target(now)
            except Exception:  # noqa: BLE001 — scheduler thread must survive
                import logging
                logging.getLogger(__name__).exception("timer target failed")
        with self._lock:
            self._arm()

    # ------------------------------------------------------------ playback

    def _on_virtual_time(self, now: int):
        self.advance_to(now)

    def advance_to(self, now: int):
        """Fire all timers due at or before `now` (playback / test use)."""
        while True:
            due = []
            with self._lock:
                while self._heap and self._heap[0][0] <= now:
                    due.append(heapq.heappop(self._heap))
            if not due:
                return
            wd = self.watchdog
            for ts, _, target in due:
                if wd is not None and not wd.allow(target, ts):
                    continue
                self.fires += 1
                target(ts)

    def shutdown(self):
        self._stopped = True
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._heap.clear()
