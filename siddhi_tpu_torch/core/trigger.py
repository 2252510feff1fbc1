"""Triggers: event generators into their own stream.

(reference: trigger/{PeriodicTrigger,StartTrigger,CronTrigger}.java — a trigger
defines a stream `<id> (triggered_time long)` receiving one event at start /
every period / on cron fire.)
"""
from __future__ import annotations

import numpy as np

from ..query_api.definition import AttrType, StreamDefinition, TriggerDefinition
from .event import EventChunk


def trigger_stream_definition(td: TriggerDefinition) -> StreamDefinition:
    d = StreamDefinition(td.id, annotations=td.annotations)
    d.attribute("triggered_time", AttrType.LONG)
    return d


class TriggerRuntime:
    def __init__(self, td: TriggerDefinition, junction, app_ctx):
        self.td = td
        self.junction = junction
        self.app_ctx = app_ctx
        self.cron = None
        if td.at_cron:
            from ..utils.cron import CronSchedule
            self.cron = CronSchedule(td.at_cron)
        self._running = False

    def start(self):
        self._running = True
        now = self.app_ctx.current_time()
        if self.td.at_start:
            self._emit(now)
        elif self.td.at_every_ms:
            self.app_ctx.scheduler.notify_at(now + self.td.at_every_ms,
                                             self._tick)
        elif self.cron is not None:
            self.app_ctx.scheduler.notify_at(self.cron.next_after(now),
                                             self._tick)

    def stop(self):
        self._running = False

    def _tick(self, now: int):
        if not self._running:
            return
        self._emit(now)
        if self.td.at_every_ms:
            self.app_ctx.scheduler.notify_at(now + self.td.at_every_ms,
                                             self._tick)
        elif self.cron is not None:
            self.app_ctx.scheduler.notify_at(self.cron.next_after(now),
                                             self._tick)

    def _emit(self, ts: int):
        chunk = EventChunk(["triggered_time"], np.asarray([ts], np.int64),
                           np.zeros(1, np.int8),
                           {"triggered_time": np.asarray([ts], np.int64)})
        self.junction.send(chunk)
