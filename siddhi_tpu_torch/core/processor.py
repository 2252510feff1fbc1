"""Processor chain primitives.

(reference: query/processor/Processor.java chain-of-responsibility;
query/processor/filter/FilterProcessor.java;
query/processor/stream/StreamFunctionProcessor.java.)

Processors receive columnar EventChunks and push results to `next`.  A filter
is a single vectorised boolean mask over the batch — the per-event expression
DFS of the reference collapses into one fused column program.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..plan.expr_compiler import CompiledExpr, EvalCtx
from .event import RESET, TIMER, EventChunk
from .stateschema import persistent_schema


@persistent_schema("processor-base", schema=None,
                   doc="abstract chain link: the default current_state "
                       "is the stateless None")
class Processor:
    def __init__(self):
        self.next: Optional[Processor] = None

    def process(self, chunk: EventChunk):
        raise NotImplementedError

    def send_next(self, chunk: EventChunk):
        if self.next is not None and not chunk.is_empty:
            self.next.process(chunk)

    def set_next(self, p: "Processor") -> "Processor":
        self.next = p
        return p

    # state hooks (overridden by stateful processors)
    def current_state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: dict):
        pass


class FilterProcessor(Processor):
    """Boolean column program over the chunk; TIMER/RESET events always pass
    (they carry no data — reference FilterProcessor only sees data events, but
    our chunks are mixed)."""

    def __init__(self, condition: CompiledExpr):
        super().__init__()
        self.condition = condition

    def process(self, chunk: EventChunk):
        n = len(chunk)
        if n == 0:
            return
        ctx = EvalCtx(chunk.columns, chunk.timestamps, n)
        mask = np.asarray(self.condition.fn(ctx), bool)
        if mask.ndim == 0:
            mask = np.full(n, bool(mask))
        passthrough = (chunk.types == TIMER) | (chunk.types == RESET)
        mask = mask | passthrough
        if mask.all():
            self.send_next(chunk)
        else:
            self.send_next(chunk.mask(mask))


class StreamFunctionProcessor(Processor):
    """Per-event function appending computed attributes
    (reference query/processor/stream/StreamFunctionProcessor.java SPI).
    Concrete stream functions (e.g. `#log()`, extensions) subclass this."""

    def __init__(self, compiled_params, out_names, out_types):
        super().__init__()
        self.compiled_params = compiled_params
        self.out_names = out_names
        self.out_types = out_types

    def apply(self, chunk: EventChunk, param_values):
        raise NotImplementedError

    def process(self, chunk: EventChunk):
        ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
        params = [p.fn(ctx) for p in self.compiled_params]
        out_cols = self.apply(chunk, params)
        cols = dict(chunk.columns)
        cols.update(out_cols)
        names = chunk.names + [n for n in self.out_names if n not in chunk.names]
        self.send_next(EventChunk(names, chunk.timestamps, chunk.types, cols))


class LogStreamProcessor(StreamFunctionProcessor):
    """#log('prefix') — logs and passes through (reference
    query/processor/stream/LogStreamProcessor.java)."""

    def __init__(self, compiled_params):
        super().__init__(compiled_params, [], [])

    def process(self, chunk: EventChunk):
        import logging
        prefix = ""
        if self.compiled_params:
            ctx = EvalCtx(chunk.columns, chunk.timestamps, len(chunk))
            v = self.compiled_params[0].fn(ctx)
            prefix = str(v if not isinstance(v, np.ndarray) else v[0])
        for ev in chunk.to_events():
            logging.getLogger("siddhi").info("%s %s", prefix, ev)
        self.send_next(chunk)
