"""Output callbacks: route selector results to streams/tables/callbacks.

(reference: query/output/callback/*.java — InsertIntoStreamCallback,
InsertIntoTableCallback, DeleteTableCallback, UpdateTableCallback,
UpdateOrInsertTableCallback + QueryCallback split of current/expired.)
"""
from __future__ import annotations

from typing import List


from ..query_api.query import OutputEventsFor
from .event import CURRENT, EXPIRED, EventChunk
from .processor import Processor


class OutputCallbackProcessor(Processor):
    """Terminal processor adapting the selector's output chunk to the query's
    output action + any registered QueryCallbacks."""

    def __init__(self, events_for: OutputEventsFor):
        super().__init__()
        self.events_for = events_for
        self.query_callbacks: List = []
        self.query_name = ""          # set by QueryRuntime (debugger OUT)
        self.app_ctx = None

    def _filter_for_action(self, chunk: EventChunk) -> EventChunk:
        if self.events_for == OutputEventsFor.CURRENT:
            return chunk.only(CURRENT)
        if self.events_for == OutputEventsFor.EXPIRED:
            return chunk.only(EXPIRED)
        return chunk.only(CURRENT, EXPIRED)

    def notify_callbacks(self, chunk: EventChunk):
        for cb in self.query_callbacks:
            cb.receive_chunk(chunk)

    def process(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        dbg = getattr(self.app_ctx, "debugger", None) if self.app_ctx \
            else None
        if dbg is not None:
            dbg.check(self.query_name, dbg.OUT, chunk)
        self.notify_callbacks(chunk)
        self.emit(self._filter_for_action(chunk))

    def emit(self, chunk: EventChunk):
        raise NotImplementedError


class ReturnCallback(OutputCallbackProcessor):
    """Query with no insert target — callbacks only."""

    def emit(self, chunk: EventChunk):
        pass


class InsertIntoStreamCallback(OutputCallbackProcessor):
    """Re-publishes into a stream junction; expired events are converted to
    CURRENT on insertion (reference InsertIntoStreamCallback.java:59-71)."""

    def __init__(self, junction, target_definition, events_for):
        super().__init__(events_for)
        self.junction = junction
        self.target_definition = target_definition

    def emit(self, chunk: EventChunk):
        if chunk.is_empty:
            return
        out = chunk.rename(self.target_definition.attribute_names) \
            if chunk.names != self.target_definition.attribute_names else chunk
        out = out.with_types(CURRENT)
        self.junction.send(out)


class InsertIntoTableCallback(OutputCallbackProcessor):
    def __init__(self, table, events_for):
        super().__init__(events_for)
        self.table = table

    def emit(self, chunk: EventChunk):
        if not chunk.is_empty:
            self.table.insert(chunk)


class DeleteTableCallback(OutputCallbackProcessor):
    def __init__(self, table, compiled_condition, events_for):
        super().__init__(events_for)
        self.table = table
        self.compiled_condition = compiled_condition

    def emit(self, chunk: EventChunk):
        if not chunk.is_empty:
            self.table.delete(chunk, self.compiled_condition)


class UpdateTableCallback(OutputCallbackProcessor):
    def __init__(self, table, compiled_condition, compiled_set, events_for):
        super().__init__(events_for)
        self.table = table
        self.compiled_condition = compiled_condition
        self.compiled_set = compiled_set

    def emit(self, chunk: EventChunk):
        if not chunk.is_empty:
            self.table.update(chunk, self.compiled_condition, self.compiled_set)


class UpdateOrInsertTableCallback(UpdateTableCallback):
    def emit(self, chunk: EventChunk):
        if not chunk.is_empty:
            self.table.update_or_insert(chunk, self.compiled_condition,
                                        self.compiled_set)


class InsertIntoWindowCallback(OutputCallbackProcessor):
    """Insert into a named window (reference InsertIntoWindowCallback.java)."""

    def __init__(self, window, events_for):
        super().__init__(events_for)
        self.window = window

    def emit(self, chunk: EventChunk):
        if not chunk.is_empty:
            self.window.add(chunk.with_types(CURRENT))
