"""Execution contexts.

(reference: config/SiddhiContext.java — shared across apps: extensions,
persistence store, config manager; config/SiddhiAppContext.java — per app:
executors, ThreadBarrier, SnapshotService, TimestampGenerator, scheduler list,
statistics; config/SiddhiQueryContext.java — per query.)
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .scheduler import Scheduler
from .statistics import StatisticsManager
from .timestamp import TimestampGenerator


class SiddhiContext:
    """Shared, manager-level context."""

    def __init__(self):
        self.extensions: Dict[str, Any] = {}
        self.persistence_store = None
        self.incremental_persistence_store = None
        self.error_store = None             # manager-level default
        self.config_manager = None
        self.attributes: Dict[str, Any] = {}
        # torch device every device runtime builds its state on
        # (SiddhiManager(device=...); "cuda" unless the caller asks)
        self.device = "cuda"

    def set_extension(self, name: str, impl):
        self.extensions[name.lower()] = impl

    def get_extension(self, name: str):
        return self.extensions.get(name.lower())


class ThreadBarrier:
    """Ingestion gate: snapshots lock it so no events are in flight while state
    is captured (reference util/ThreadBarrier.java)."""

    def __init__(self):
        self._lock = threading.RLock()

    def pass_through(self):
        with self._lock:
            pass

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()


class SiddhiAppContext:
    def __init__(self, siddhi_context: SiddhiContext, name: str):
        self.siddhi_context = siddhi_context
        self.name = name
        self.timestamp_generator = TimestampGenerator()
        self.scheduler = Scheduler(self.timestamp_generator)
        self.thread_barrier = ThreadBarrier()
        self.snapshot_service = None        # set by runtime builder
        self.statistics_manager: Optional[StatisticsManager] = None
        self.stats_enabled = False
        self.playback = False
        self.root_metrics_level = 0
        self.script_functions: Dict[str, Any] = {}
        self.exception_listeners: List[Any] = []
        self.runtime = None                 # back-pointer (set by runtime)
        self.watchdog = None                # DispatchWatchdog (core/overload)
        self.async_mode = False

    def current_time(self) -> int:
        return self.timestamp_generator.current_time()


class SiddhiQueryContext:
    def __init__(self, app_ctx: SiddhiAppContext, query_name: str,
                 partition_id: Optional[str] = None):
        self.app_ctx = app_ctx
        self.name = query_name
        self.partition_id = partition_id
        self.latency_tracker = None
