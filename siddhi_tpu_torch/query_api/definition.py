"""Definitions: streams, tables, windows, triggers, functions, aggregations.

TPU-native counterpart of reference modules/siddhi-query-api/.../definition/*.java
(8 files).  An `Attribute` carries a Siddhi type which maps onto a columnar
dtype for the device arrays (see siddhi_tpu_torch/core/event.py):

    int    -> int32      long  -> int64
    float  -> float32    double-> float64
    bool   -> bool_      string-> host object column (dict-encoded on device)
    object -> host object column (never shipped to device)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional

from .annotation import Annotation
from .expression import Expression


class AttrType(Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    @staticmethod
    def of(name: str) -> "AttrType":
        try:
            return AttrType(name.lower())
        except ValueError:
            from ..utils.errors import SiddhiParserException
            raise SiddhiParserException(
                f"Invalid attribute type {name!r}") from None


@dataclass
class Attribute:
    name: str
    type: AttrType


@dataclass
class AbstractDefinition:
    id: str
    attributes: List[Attribute] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)

    def attribute(self, name: str, type: "AttrType | str") -> "AbstractDefinition":
        if isinstance(type, str):
            type = AttrType.of(type)
        if any(a.name == name for a in self.attributes):
            from ..utils.errors import DuplicateAttributeError
            raise DuplicateAttributeError(
                f"'{name}' is already defined for {self.id}")
        self.attributes.append(Attribute(name, type))
        return self

    def annotation(self, ann: Annotation) -> "AbstractDefinition":
        self.annotations.append(ann)
        return self

    @property
    def attribute_names(self) -> List[str]:
        return [a.name for a in self.attributes]

    def attribute_type(self, name: str) -> AttrType:
        for a in self.attributes:
            if a.name == name:
                return a.type
        from ..utils.errors import AttributeNotExistError
        raise AttributeNotExistError(f"No attribute '{name}' in '{self.id}'")

    def index_of(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        return -1


@dataclass
class StreamDefinition(AbstractDefinition):
    @staticmethod
    def id_(stream_id: str) -> "StreamDefinition":
        return StreamDefinition(stream_id)


@dataclass
class TableDefinition(AbstractDefinition):
    @staticmethod
    def id_(table_id: str) -> "TableDefinition":
        return TableDefinition(table_id)


@dataclass
class WindowDefinition(AbstractDefinition):
    """Named window: ``define window W (a int) length(5) output all events``.
    (reference definition/WindowDefinition.java)"""
    window_name: Optional[str] = None
    window_namespace: Optional[str] = None
    window_params: List[Expression] = field(default_factory=list)
    output_event_type: str = "all"  # current | expired | all

    @staticmethod
    def id_(window_id: str) -> "WindowDefinition":
        return WindowDefinition(window_id)


@dataclass
class TriggerDefinition:
    """``define trigger T at {'start' | every <time> | '<cron>'}``
    (reference definition/TriggerDefinition.java).  Trigger streams carry a
    single long attribute ``triggered_time``."""
    id: str
    at_start: bool = False
    at_every_ms: Optional[int] = None
    at_cron: Optional[str] = None
    annotations: List[Annotation] = field(default_factory=list)


@dataclass
class FunctionDefinition:
    """``define function F[lang] return type { body }`` — script functions.
    Language for this framework is python (reference supported JS/scala via JSR-223;
    definition/FunctionDefinition.java)."""
    id: str
    language: str = "python"
    return_type: Optional[AttrType] = None
    body: str = ""


@dataclass
class AggregationDefinition:
    """``define aggregation A from S select ... group by ... aggregate [by attr]
    every sec...year`` — incremental aggregation (reference
    definition/AggregationDefinition.java + aggregation/TimePeriod.java)."""
    id: str
    basic_single_input_stream: Any = None     # SingleInputStream
    selector: Any = None                      # Selector
    aggregate_attribute: Optional[str] = None  # timestamp attribute (external time)
    time_periods: List[str] = field(default_factory=list)  # ['sec','min',...]
    annotations: List[Annotation] = field(default_factory=list)


DURATION_ORDER = ["sec", "min", "hour", "day", "month", "year"]
DURATION_MS = {
    "sec": 1_000,
    "min": 60_000,
    "hour": 3_600_000,
    "day": 86_400_000,
    # month/year are calendar durations; fixed sizes used for bucketing
    "month": 2_592_000_000,   # 30 days
    "year": 31_536_000_000,   # 365 days
}
