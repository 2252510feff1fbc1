"""SiddhiApp container — holds definitions + execution elements.

(reference: modules/siddhi-query-api/.../SiddhiApp.java — duplicate-definition
validation, definition maps, execution element list)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .annotation import Annotation
from .definition import (AggregationDefinition, FunctionDefinition,
                         StreamDefinition, TableDefinition, TriggerDefinition,
                         WindowDefinition)
from .query import ExecutionElement, Partition, Query


@dataclass
class SiddhiApp:
    stream_definitions: Dict[str, StreamDefinition] = field(default_factory=dict)
    table_definitions: Dict[str, TableDefinition] = field(default_factory=dict)
    window_definitions: Dict[str, WindowDefinition] = field(default_factory=dict)
    trigger_definitions: Dict[str, TriggerDefinition] = field(default_factory=dict)
    function_definitions: Dict[str, FunctionDefinition] = field(default_factory=dict)
    aggregation_definitions: Dict[str, AggregationDefinition] = field(default_factory=dict)
    execution_elements: List[ExecutionElement] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)

    @staticmethod
    def siddhi_app() -> "SiddhiApp":
        return SiddhiApp()

    def _check_unique(self, id_: str):
        from ..utils.errors import DuplicateDefinitionError
        for m in (self.stream_definitions, self.table_definitions,
                  self.window_definitions, self.trigger_definitions,
                  self.aggregation_definitions):
            if id_ in m:
                raise DuplicateDefinitionError(
                    f"'{id_}' is already defined in this Siddhi app")

    def define_stream(self, d: StreamDefinition) -> "SiddhiApp":
        existing = self.stream_definitions.get(d.id)
        if existing is not None:
            # identical redefinition is tolerated (reference merges equal defs)
            if [(a.name, a.type) for a in existing.attributes] == \
               [(a.name, a.type) for a in d.attributes]:
                return self
            from ..utils.errors import DuplicateDefinitionError
            raise DuplicateDefinitionError(
                f"Stream '{d.id}' already defined with different attributes")
        self._check_unique(d.id)
        self.stream_definitions[d.id] = d
        return self

    def define_table(self, d: TableDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.table_definitions[d.id] = d
        return self

    def define_window(self, d: WindowDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.window_definitions[d.id] = d
        return self

    def define_trigger(self, d: TriggerDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.trigger_definitions[d.id] = d
        return self

    def define_function(self, d: FunctionDefinition) -> "SiddhiApp":
        self.function_definitions[d.id] = d
        return self

    def define_aggregation(self, d: AggregationDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.aggregation_definitions[d.id] = d
        return self

    def add_query(self, q: Query) -> "SiddhiApp":
        self.execution_elements.append(q)
        return self

    def add_partition(self, p: Partition) -> "SiddhiApp":
        self.execution_elements.append(p)
        return self

    def annotation(self, ann: Annotation) -> "SiddhiApp":
        self.annotations.append(ann)
        return self

    @property
    def name(self) -> Optional[str]:
        for a in self.annotations:
            if a.name.lower() == "app" and a.get("name"):
                return a.get("name")
            if a.name.lower() == "app:name":
                pos = a.positional()
                if pos:
                    return pos[0]
        return None
