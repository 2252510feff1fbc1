"""Query object model: input streams, pattern state elements, selectors, outputs.

TPU-native counterpart of reference modules/siddhi-query-api/.../execution/**:
  - Query, OnDemandQuery/StoreQuery     (execution/query/Query.java, StoreQuery.java)
  - SingleInputStream / JoinInputStream / StateInputStream
        (execution/query/input/stream/*.java)
  - StateElement tree (pattern IR)      (execution/query/input/state/*.java)
  - Selector / OutputAttribute          (execution/query/selection/*)
  - OutputStream actions + rate limiting (execution/query/output/**)
  - Partition IR                        (execution/partition/*)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple, Union

from .annotation import Annotation
from .expression import Expression, Variable


# ---------------------------------------------------------------- handlers

@dataclass
class StreamHandler:
    """A step in a single-stream handler chain: filter, window or stream function."""


@dataclass
class Filter(StreamHandler):
    expr: Expression


@dataclass
class WindowHandler(StreamHandler):
    """``#window.length(5)`` — name + args."""
    namespace: Optional[str]
    name: str
    params: List[Expression] = field(default_factory=list)


@dataclass
class StreamFunctionHandler(StreamHandler):
    """``#str:tokenize(...)`` style per-event stream functions."""
    namespace: Optional[str]
    name: str
    params: List[Expression] = field(default_factory=list)


# ---------------------------------------------------------------- input streams

@dataclass
class InputStream:
    pass


@dataclass
class SingleInputStream(InputStream):
    stream_id: str
    stream_ref: Optional[str] = None          # `as e1` alias
    handlers: List[StreamHandler] = field(default_factory=list)
    is_inner: bool = False                    # '#InnerStream' inside partitions
    is_fault: bool = False                    # '!FaultStream'

    def filter(self, expr: Expression) -> "SingleInputStream":
        self.handlers.append(Filter(expr))
        return self

    def window(self, name: str, *params: Expression,
               namespace: Optional[str] = None) -> "SingleInputStream":
        self.handlers.append(WindowHandler(namespace, name, list(params)))
        return self

    def function(self, name: str, *params: Expression,
                 namespace: Optional[str] = None) -> "SingleInputStream":
        self.handlers.append(StreamFunctionHandler(namespace, name, list(params)))
        return self

    @property
    def window_handler(self) -> Optional[WindowHandler]:
        for h in self.handlers:
            if isinstance(h, WindowHandler):
                return h
        return None


class JoinType(Enum):
    JOIN = "join"               # inner
    LEFT_OUTER = "left outer"
    RIGHT_OUTER = "right outer"
    FULL_OUTER = "full outer"


class EventTrigger(Enum):
    """Which side's arrivals trigger join output (`unidirectional`)."""
    LEFT = "left"
    RIGHT = "right"
    ALL = "all"


@dataclass
class JoinInputStream(InputStream):
    left: SingleInputStream
    join_type: JoinType
    right: SingleInputStream
    on: Optional[Expression] = None
    trigger: EventTrigger = EventTrigger.ALL
    within: Optional[Expression] = None
    per: Optional[Expression] = None


class StateType(Enum):
    PATTERN = "pattern"
    SEQUENCE = "sequence"


# ---------------------------------------------------------------- state elements
# (pattern IR — reference execution/query/input/state/*.java, 8 classes)

@dataclass
class StateElement:
    within_ms: Optional[int] = None


@dataclass
class StreamStateElement(StateElement):
    """A single condition: ``e1=StreamA[filter]``."""
    stream: SingleInputStream = None


@dataclass
class AbsentStreamStateElement(StreamStateElement):
    """``not StreamA[filter] for 5 sec`` (waiting_time_ms) or logical-not partner."""
    waiting_time_ms: Optional[int] = None


@dataclass
class NextStateElement(StateElement):
    """``A -> B`` (pattern) or ``A, B`` (sequence strict next)."""
    state: StateElement = None
    next: StateElement = None


@dataclass
class EveryStateElement(StateElement):
    """``every (...)`` — re-arm on each match start.  within_ms is the
    group-scoped ``every (...) within t`` bound (SiddhiQL.g4: EVERY
    '(' chain ')' within_time?)."""
    state: StateElement = None
    within_ms: Optional[int] = None


class LogicalOp(Enum):
    AND = "and"
    OR = "or"


@dataclass
class LogicalStateElement(StateElement):
    state1: StreamStateElement = None
    op: LogicalOp = LogicalOp.AND
    state2: StreamStateElement = None


@dataclass
class CountStateElement(StateElement):
    """``A<m:n>`` / ``A+``(1:ANY) / ``A*``(0:ANY) / ``A?``(0:1)."""
    ANY = -1
    state: StreamStateElement = None
    min_count: int = 1
    max_count: int = 1


@dataclass
class StateInputStream(InputStream):
    state_type: StateType = StateType.PATTERN
    state: StateElement = None
    within_ms: Optional[int] = None

    def all_stream_ids(self) -> List[str]:
        out: List[str] = []

        def rec(el: StateElement):
            if isinstance(el, StreamStateElement):
                out.append(el.stream.stream_id)
            elif isinstance(el, NextStateElement):
                rec(el.state)
                rec(el.next)
            elif isinstance(el, EveryStateElement):
                rec(el.state)
            elif isinstance(el, LogicalStateElement):
                rec(el.state1)
                rec(el.state2)
            elif isinstance(el, CountStateElement):
                rec(el.state)
        rec(self.state)
        return out


# ---------------------------------------------------------------- selection

@dataclass
class OutputAttribute:
    rename: str
    expr: Expression


@dataclass
class OrderByAttribute:
    variable: Variable
    ascending: bool = True


@dataclass
class Selector:
    select_all: bool = False                      # `select *`
    attributes: List[OutputAttribute] = field(default_factory=list)
    group_by: List[Variable] = field(default_factory=list)
    having: Optional[Expression] = None
    order_by: List[OrderByAttribute] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None

    def select(self, rename: str, expr: Expression) -> "Selector":
        self.attributes.append(OutputAttribute(rename, expr))
        return self


# ---------------------------------------------------------------- output

class OutputEventsFor(Enum):
    CURRENT = "current"
    EXPIRED = "expired"
    ALL = "all"


@dataclass
class OutputStream:
    target_id: str = ""
    events_for: OutputEventsFor = OutputEventsFor.CURRENT
    is_inner: bool = False
    is_fault: bool = False


@dataclass
class InsertIntoStream(OutputStream):
    pass


@dataclass
class ReturnStream(OutputStream):
    """Query with no `insert into` — results go to the query callback only."""


@dataclass
class DeleteStream(OutputStream):
    on: Expression = None


@dataclass
class UpdateSetAssignment:
    table_variable: Variable = None
    value: Expression = None


@dataclass
class UpdateStream(OutputStream):
    on: Expression = None
    set_assignments: List[UpdateSetAssignment] = field(default_factory=list)


@dataclass
class UpdateOrInsertStream(UpdateStream):
    pass


# ---------------------------------------------------------------- rate limiting

class OutputRateType(Enum):
    ALL = "all"
    FIRST = "first"
    LAST = "last"
    SNAPSHOT = "snapshot"


@dataclass
class OutputRate:
    type: OutputRateType = OutputRateType.ALL
    every_events: Optional[int] = None
    every_ms: Optional[int] = None


# ---------------------------------------------------------------- query

@dataclass
class Query:
    input_stream: InputStream = None
    selector: Selector = field(default_factory=Selector)
    output_stream: OutputStream = field(default_factory=ReturnStream)
    output_rate: Optional[OutputRate] = None
    annotations: List[Annotation] = field(default_factory=list)

    @staticmethod
    def query() -> "Query":
        return Query()

    def from_(self, input_stream: InputStream) -> "Query":
        self.input_stream = input_stream
        return self

    def select(self, selector: Selector) -> "Query":
        self.selector = selector
        return self

    def insert_into(self, stream_id: str,
                    events_for: OutputEventsFor = OutputEventsFor.CURRENT) -> "Query":
        self.output_stream = InsertIntoStream(stream_id, events_for)
        return self

    def annotation(self, ann: Annotation) -> "Query":
        self.annotations.append(ann)
        return self

    @property
    def name(self) -> Optional[str]:
        for a in self.annotations:
            if a.name.lower() == "info":
                return a.get("name")
        return None


# ---------------------------------------------------------------- partition

@dataclass
class RangePartitionProperty:
    partition_key: str       # label routed to
    condition: Expression = None


@dataclass
class PartitionType:
    stream_id: str = ""


@dataclass
class ValuePartitionType(PartitionType):
    expression: Expression = None


@dataclass
class RangePartitionType(PartitionType):
    ranges: List[RangePartitionProperty] = field(default_factory=list)


@dataclass
class Partition:
    partition_types: List[PartitionType] = field(default_factory=list)
    queries: List[Query] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)

    def with_(self, pt: PartitionType) -> "Partition":
        self.partition_types.append(pt)
        return self

    def add_query(self, q: Query) -> "Partition":
        self.queries.append(q)
        return self


# ---------------------------------------------------------------- store (on-demand) query

class StoreQueryType(Enum):
    FIND = "find"
    INSERT = "insert"
    DELETE = "delete"
    UPDATE = "update"
    UPDATE_OR_INSERT = "update_or_insert"


@dataclass
class InputStore:
    store_id: str
    store_ref: Optional[str] = None
    on: Optional[Expression] = None
    within: Optional[Tuple[Expression, Expression]] = None   # aggregation within
    per: Optional[Expression] = None


@dataclass
class StoreQuery:
    type: StoreQueryType = StoreQueryType.FIND
    input_store: Optional[InputStore] = None
    selector: Selector = field(default_factory=Selector)
    output_stream: Optional[OutputStream] = None
    select_values: List[Expression] = field(default_factory=list)  # insert payload


ExecutionElement = Union[Query, Partition]
