"""Annotation tree: ``@name(key='value', 'positional', @nested(...))``.

(reference: modules/siddhi-query-api/.../annotation/{Annotation,Element}.java)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Element:
    key: Optional[str]
    value: str


@dataclass
class Annotation:
    name: str
    elements: List[Element] = field(default_factory=list)
    annotations: List["Annotation"] = field(default_factory=list)

    def element(self, key: Optional[str], value: str) -> "Annotation":
        self.elements.append(Element(key, value))
        return self

    def get(self, key: Optional[str], default: Optional[str] = None) -> Optional[str]:
        for e in self.elements:
            if e.key == key:
                return e.value
        return default

    def positional(self) -> List[str]:
        return [e.value for e in self.elements if e.key is None]

    def as_dict(self) -> dict:
        return {e.key: e.value for e in self.elements if e.key is not None}


def find_annotation(annotations: List[Annotation], name: str) -> Optional[Annotation]:
    for a in annotations:
        if a.name.lower() == name.lower():
            return a
    return None


def find_all(annotations: List[Annotation], name: str) -> List[Annotation]:
    return [a for a in annotations if a.name.lower() == name.lower()]
