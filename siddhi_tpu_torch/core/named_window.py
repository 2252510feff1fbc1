"""Named windows: `define window W (...) length(5) output all events`.

(reference: core/window/Window.java — a shared window definition usable by
many queries: inserts go through the inner window processor, published events
(current/expired per the output clause) reach every subscribed query, and
joins probe its buffer via the Findable interface.)
"""
from __future__ import annotations

import threading

from ..query_api.definition import WindowDefinition
from .event import CURRENT, EXPIRED, EventChunk
from .processor import Processor
from .stateschema import Sub, persistent_schema
from .window import create_window_processor


class _Publisher(Processor):
    def __init__(self, named_window: "NamedWindow"):
        super().__init__()
        self.named_window = named_window

    def process(self, chunk: EventChunk):
        self.named_window._publish(chunk)


@persistent_schema("named-window", schema=Sub("processor"),
                   doc="persists exactly its wrapped window processor's state")
class NamedWindow:
    def __init__(self, definition: WindowDefinition, app_ctx, compile_expr,
                 extension_registry=None):
        self.definition = definition
        self.app_ctx = app_ctx
        self.lock = threading.RLock()
        name = definition.window_name or "length"
        self.processor = create_window_processor(
            name, definition.window_params, app_ctx,
            definition.attribute_names, compile_expr,
            namespace=definition.window_namespace or "",
            extension_registry=extension_registry)
        self.processor.lock = self.lock
        self.processor.next = _Publisher(self)
        self.subscribers = []        # query receivers (receive_chunk)
        self.output_event_type = definition.output_event_type

    def add(self, chunk: EventChunk):
        with self.lock:
            self.processor.process(chunk)

    def _publish(self, chunk: EventChunk):
        if self.output_event_type == "current":
            chunk = chunk.only(CURRENT)
        elif self.output_event_type == "expired":
            chunk = chunk.only(EXPIRED)
        if chunk.is_empty:
            return
        for s in list(self.subscribers):
            s.receive_chunk(chunk)

    def subscribe(self, receiver):
        self.subscribers.append(receiver)

    def unsubscribe(self, receiver):
        if receiver in self.subscribers:
            self.subscribers.remove(receiver)

    # joins / store queries probe the live buffer
    def find_chunk(self):
        return self.processor.find_chunk()

    # snapshot
    def current_state(self):
        return self.processor.current_state()

    def restore_state(self, s):
        self.processor.restore_state(s)
